"""CLI: volumetric latent-NeRF text-to-3D on PyTorch/CUDA.

Usage:
    python -m tpunerf_torch.train_latent_nerf \\
        --config_path demo_configs/latent_nerf/sand_castle.yaml

or sketch-guided (eval config #3; `shapes/teddy.obj` is not in the repo,
so the procedural sphere stands in for it):

    python -m tpunerf_torch.train_latent_nerf \\
        --config_path demo_configs/latent_nerf/lego_man.yaml \\
        --guide.shape_path sphere

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given. `--guide.model_dir DIR` reads the SD-v1 stack from a diffusers-layout
directory (unet/, vae/, text_encoder/ in .safetensors or .bin, and
tokenizer/ where it has one); without it the stack is random-initialised
from `optim.seed`. Under `<log.exp_root>/<log.exp_name>/` a run writes
`checkpoints/step_%06d.ckpt` every `log.save_interval` steps with the eval
frames `vis/eval/step_%06d_%03d_rgb.png`, train-render images
`vis/train/step_%06d.png` (PNG, where the JAX package writes JPEG), and
after the last step the orbit in `results/` and the 64³ iso-surface in
`mesh/` (logged as skipped where it is empty). `--optim.resume true`
continues from the newest checkpoint; `--log.eval_only true` renders the
final orbit of the newest checkpoint and takes no step. A checkpoint feeds
the NeRF→mesh bridge, `tpunerf_torch.train_latent_nerf_mesh`.

Under `torchrun --nproc_per_node N -m tpunerf_torch.train_latent_nerf ...`
the N ranks train one model in data parallel on the (data, rays) mesh of
`--dist.data_axis` x `--dist.rays_axis` (`dist/mesh.py`; default: every
rank on data): each rank runs on `cuda:$LOCAL_RANK` over NCCL, or with
`--device cpu` on the CPU over gloo, and rank 0 writes the files.
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

from tpunerf_torch.core.config import parse
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
from tpunerf_torch.training.trainer import Trainer


def split_device(argv: Sequence[str]) -> Tuple[Optional[str], List[str]]:
    """Take the port-only `--device X` / `--device=X` flag out of argv (it
    is not a TrainConfig field)."""
    rest, device, i = [], None, 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        if tok == "--device" and i + 1 < len(argv):
            device, i = argv[i + 1], i + 2
        elif tok.startswith("--device="):
            device, i = tok.split("=", 1)[1], i + 1
        else:
            rest.append(tok)
            i += 1
    return device, rest


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    cfg.render.backbone = "latent-nerf"
    with dist_mesh.launched(device) as device:
        app = LatentNeRFApp.create(cfg, device=device)
        run(Trainer(cfg, app, device=device))


def run(trainer: Trainer) -> None:
    """`log.eval_only`: the final eval of the loaded checkpoint, no step;
    otherwise the training run."""
    if trainer.cfg.log.eval_only:
        trainer.full_eval()
    else:
        trainer.train()


if __name__ == "__main__":
    main()
