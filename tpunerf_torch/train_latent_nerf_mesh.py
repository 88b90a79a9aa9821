"""CLI: the NeRF→mesh bridge on PyTorch/CUDA: a latent-NeRF checkpoint's
density iso-surface, textured by latent-paint.

Usage:
    python -m tpunerf_torch.train_latent_nerf_mesh \\
        --log.exp_name sand_castle --guide.text "a sand castle" \\
        --optim.ckpt experiments/sand_castle/checkpoints/step_005000.ckpt

Runs on the CUDA device unless `--device cpu` (or another torch device) is
given. The field of `optim.ckpt` (or, without it, of the newest checkpoint
under `<log.exp_root>/<log.exp_name>/checkpoints/`) is evaluated on the
device on a `render.mc_resolution`³ grid (128), and its `render.iso_level`
surface (10.0) is extracted by marching tetrahedra on the host. The mesh is
then painted by the latent-paint app as a fresh experiment,
`<log.exp_name>_mesh` (no checkpoint loaded, no resume), which writes what
`train_latent_paint` writes; `--log.eval_only true` renders its final orbit
instead of training.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

import torch

from tpunerf_torch.core.config import parse
from tpunerf_torch.fields.scene import LatentNeRFScene
from tpunerf_torch.meshrep.mesh import Mesh
from tpunerf_torch.train_latent_nerf import run, split_device
from tpunerf_torch.training.checkpoints import CheckpointManager
from tpunerf_torch.training.config import TrainConfig
from tpunerf_torch.training.latent_paint import LatentPaintApp
from tpunerf_torch.training.trainer import Trainer


def extract_mesh_from_checkpoint(cfg: TrainConfig,
                                 resolution: Optional[int] = None,
                                 iso: Optional[float] = None,
                                 device: Optional[torch.device] = None
                                 ) -> Mesh:
    """Restore the NeRF field of `cfg`'s checkpoint and extract its density
    iso-surface (host tensors). Only the scene is built: the guidance stack
    plays no part in the mesh, and the guide shape's SDF neither (it is
    kept out of checkpoints)."""
    scene = LatentNeRFScene.from_config(cfg, with_shape=False,
                                        device=device)
    params, _, _ = CheckpointManager(cfg.log.exp_dir / "checkpoints").load(
        cfg.optim.ckpt)
    if params is None:
        raise FileNotFoundError(
            "no NeRF checkpoint found — pass --optim.ckpt")
    scene.load_state_dict(params)
    render = cfg.render
    resolution = render.mc_resolution if resolution is None else resolution
    iso = render.iso_level if iso is None else iso
    verts, faces = scene.extract_mesh(resolution=resolution, iso=iso)
    if len(faces) == 0:
        raise RuntimeError(f"no surface at isolevel {iso}")
    return Mesh(vertices=torch.from_numpy(verts),
                faces=torch.from_numpy(faces))


def paint_config(cfg: TrainConfig) -> TrainConfig:
    """The paint stage's config: a fresh experiment `<exp_name>_mesh` that
    loads no checkpoint and does not resume."""
    return dataclasses.replace(
        cfg,
        log=dataclasses.replace(cfg.log, exp_name=cfg.log.exp_name + "_mesh"),
        optim=dataclasses.replace(cfg.optim, ckpt=None, resume=False),
        render=dataclasses.replace(cfg.render, backbone="texture-mesh"))


def main(argv: Optional[Sequence[str]] = None) -> None:
    device, args = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse(TrainConfig, args)
    mesh = extract_mesh_from_checkpoint(cfg, device=device)
    paint_cfg = paint_config(cfg)
    app = LatentPaintApp.create(paint_cfg, mesh=mesh, device=device)
    run(Trainer(paint_cfg, app, device=device))


if __name__ == "__main__":
    main()
