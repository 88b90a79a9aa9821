"""CLI: latent-paint texture painting on PyTorch/CUDA.

Usage:
    python -m tpunerf_torch.train_latent_paint \\
        --guide.text "A goldfish" --guide.shape_path sphere \\
        --log.exp_name goldfish

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given (under torchrun on `cuda:$LOCAL_RANK`, one model in data parallel on
the `--dist` mesh, as `train_latent_nerf`). `guide.shape_path` takes a
procedural name (`sphere`, `icosphere`) or an OBJ/OFF file;
`--guide.model_dir` reads the SD-v1 stack as in `train_latent_nerf`.
Checkpoints, eval frames, train-render images, the final orbit and the mesh
export land as in `train_latent_nerf`; `--optim.resume true` and
`--log.eval_only true` work the same way.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from tpunerf_torch.core.config import parse
from tpunerf_torch.dist import mesh as dist_mesh
from tpunerf_torch.train_latent_nerf import run, split_device
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    with dist_mesh.launched(device) as device:
        app = LatentPaintApp.create(cfg, device=device)
        run(Trainer(cfg, app, device=device))


if __name__ == "__main__":
    main()
