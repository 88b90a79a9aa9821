"""CLI: latent-paint texture painting on PyTorch/CUDA.

Usage:
    python -m tpunerf_torch.train_latent_paint \\
        --guide.text "A goldfish" --guide.shape_path sphere \\
        --log.exp_name goldfish --log.log_images false \\
        --log.save_interval 100000

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given. `guide.shape_path` takes a procedural name (`sphere`, `icosphere`)
or an OBJ/OFF file. Checkpoints and train-render images are not ported yet,
so `log.save_interval` must exceed `optim.iters` and `log.log_images` must
be off. The eval frames of `log.eval_size` are written before the first
step, the final orbit of `log.full_eval_size` and the mesh export of
`log.save_mesh` after the last.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from tpunerf_torch.core.config import parse
from tpunerf_torch.train_latent_nerf import split_device
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    app = LatentPaintApp.create(cfg, device=device)
    Trainer(cfg, app, device=device).train()


if __name__ == "__main__":
    main()
