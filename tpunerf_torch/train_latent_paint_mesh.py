"""CLI: latent-paint-mesh (texture and shape) on PyTorch/CUDA.

Usage:
    python -m tpunerf_torch.train_latent_paint_mesh \\
        --guide.text "A goldfish" --guide.shape_path sphere \\
        --optim.mode 0 --render.body_prob 0.7 --log.exp_name goldfish

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given (under torchrun on `cuda:$LOCAL_RANK`, one model in data parallel on
the `--dist` mesh, as `train_latent_nerf`). `optim.mode` is 0 (latent SDS
at the train grid), 1 (TADA: give `--render.train_grid_size 512`) or 2
(SDEdit). `render.body_prob` below 1 turns on the body and head cameras.
Guidance is text-conditioned SD v1, or depth-conditioned SD where "depth"
is in `guide.diffusion_name` (mode 0 only), as eval config #5 runs it:

    python -m tpunerf_torch.train_latent_paint_mesh \
        --config_path demo_configs/latent_paint_mesh/nascar_depth.yaml \
        --guide.shape_path sphere

(B = 2 views a step; `nascar.obj` is not in the repo, hence the sphere),
or Paint-by-Example conditioned on an exemplar PNG (mode 0 only), with the
CLIP branch of `optim.use_clip` at low t:

    python -m tpunerf_torch.train_latent_paint_mesh --guide.use_sd false \\
        --guide.image exemplar.png --optim.use_clip true \\
        --guide.shape_path sphere

`guide.sampled_texture` seeds the textures from a PNG. The stack is read
from `--guide.model_dir` (the diffusers-layout directory of the backend
the flags choose: SD v1, SD2-depth or Paint-by-Example) and the CLIP tower
from `--guide.clip_model_dir` (a transformers CLIP vision directory);
without them they are random-initialised from `optim.seed`.
`guide.concept_name` names a textual-inversion concept directory
(`learned_embeds.bin`, `token_identifier.txt`) for the SD-v1 stack.
Checkpoints, eval frames, train-render images, the final orbit and the
export of the displaced mesh land as in `train_latent_nerf`;
`--optim.resume true`, `--log.eval_only true` and `--optim.train_chunk k`
(chunks of k replays of the step captured in a CUDA graph on the card, in
every mode and with every backend; k eager steps on the CPU) work the same
way.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from tpunerf_torch.core.config import parse
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.train_latent_nerf import run, split_device
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    with dist_mesh.launched(device) as device:
        app = LatentPaintMeshApp.create(cfg, device=device)
        run(Trainer(cfg, app, device=device))


if __name__ == "__main__":
    main()
