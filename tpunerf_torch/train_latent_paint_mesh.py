"""CLI: latent-paint-mesh (texture and shape) on PyTorch/CUDA.

Usage:
    python -m tpunerf_torch.train_latent_paint_mesh \\
        --guide.text "A goldfish" --guide.shape_path sphere \\
        --optim.mode 0 --render.body_prob 0.7 --log.exp_name goldfish \\
        --log.log_images false --log.save_interval 100000

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given. `optim.mode` is 0 (latent SDS at the train grid), 1 (TADA: give
`--render.train_grid_size 512`) or 2 (SDEdit). `render.body_prob` below 1
turns on the body and head cameras. Guidance is text-conditioned SD v1;
depth-conditioned SD, Paint-by-Example, the CLIP losses and
`guide.sampled_texture` are refused by name until their slice of the port.
Checkpoints and train-render images are not ported yet, so
`log.save_interval` must exceed `optim.iters` and `log.log_images` must be
off. Eval frames, the final orbit and the mesh export (with the displaced
vertices) work as in `train_latent_paint`.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from tpunerf_torch.core.config import parse
from tpunerf_torch.train_latent_nerf import split_device
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
from tpunerf_torch.training.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    app = LatentPaintMeshApp.create(cfg, device=device)
    Trainer(cfg, app, device=device).train()


if __name__ == "__main__":
    main()
