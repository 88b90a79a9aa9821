"""Occupied fraction → rays/s of the latent-NeRF train render, on the card.

Counterpart of the JAX package's scripts/occ_rate_curve.py: the full-width
scene at B = 1 (64² rays, S=128 samples a ray compacted to K=64) with its
128³ occupancy grid set to controlled states, centred blobs of increasing
volume (`blob_grid`: the shape a trained scene's grid converges to) and the
`teddy` point, the converged state of a sketch-shape run on
shapes/teddy.obj (the cells within 0.3 of its surface or inside it, from
the port's SDF grid of the mesh). For each point: the occupied fraction,
the render fwd+bwd's rays/s (H·W over the time of a frame) and ms a frame;
then the points as one JSON line.

The port compacts each ray to a fixed K, so the field runs on B·H·W·K
points at every fraction; only the lookup and compaction see the grid.

A frame's time is `--iters` fwd+bwd renders captured in one CUDA graph and
replayed (`card.graph_times`), the median of the replays (the best and the
eager median printed beside it). The stratified jitter and the pose are
drawn once, before the capture (outside the timed region). The grid and
its packed bitfield are set in place, as `scene.update_occupancy` sets them.

    python -m tpunerf_torch.scripts.occ_rate_curve
        [--points teddy,0.02,0.05,0.1,0.185,0.3,0.5,1.0] [--iters 100]
        [--seed 0] [--device cuda] [--tiny]

`shapes/teddy.obj` is not in the repository: where it is absent the
`teddy` point raises, naming the file. It runs on the card; `--device cpu`
renders each point once through the plain versions and prints no times
(`--tiny`: the tiny scene at 16², S=32, K=16, for tests). Without a card
and without `--device cpu` it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Union

import numpy as np
import torch

from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
from tpunerf_torch.fields import occupancy as occ_lib
from tpunerf_torch.fields.scene import LatentNeRFScene
from tpunerf_torch.fields.sketch_shape import SDFGrid
from tpunerf_torch.meshrep import shapes
from tpunerf_torch.scripts import card
from tpunerf_torch.scripts.profile_render import SIZES, render_loss
from tpunerf_torch.utils import make_generator

ITERS = 100
POINTS = "teddy,0.02,0.05,0.1,0.185,0.3,0.5,1.0"
TEDDY = "shapes/teddy.obj"


def blob_grid(G: int, frac: float) -> np.ndarray:
    """(G³,) occupancy values: a centred ball whose volume ≈ frac·G³,
    above the threshold inside and zero outside (the converged grid of a
    centred object)."""
    r = (3.0 * frac / (4.0 * np.pi)) ** (1.0 / 3.0)  # in [0, 0.5·side] units
    ax = (np.arange(G) + 0.5) / G - 0.5
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    inside = (gx ** 2 + gy ** 2 + gz ** 2) <= r ** 2
    return np.where(inside.ravel(), 1.0, 0.0).astype(np.float32)


def teddy_grid(G: int, bound: float, device) -> np.ndarray:
    """(G³,) occupancy of a converged sketch-shape run on the teddy mesh:
    1 where the mesh's SDF (48³, the mesh normalised to 0.6, lifted 0.25)
    at the cell centre is below 0.3."""
    try:
        mesh = shapes.load_shape(TEDDY).normalize(target_scale=0.6, dy=0.25)
    except FileNotFoundError as exc:
        raise FileNotFoundError(
            f"the 'teddy' point needs {TEDDY}, which is not in the "
            f"repository; pass --points without it ({exc})") from None
    sdf = SDFGrid.from_mesh(mesh.vertices.numpy(), mesh.faces.numpy(),
                            resolution=48, bound=bound, device=device)
    ax = (np.arange(G) + 0.5) / G * 2.0 - 1.0
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.from_numpy((np.stack([gx, gy, gz], -1).reshape(-1, 3)
                            * bound).astype(np.float32)).to(device)
    d = sdf.sample(pts).cpu().numpy()
    return np.where(d < 0.3, 1.0, 0.0).astype(np.float32)


def parse_points(spec: str) -> List[Union[str, float]]:
    return [p if p == "teddy" else float(p) for p in spec.split(",")]


def point_grid(point: Union[str, float], G: int, bound: float, device
               ) -> torch.Tensor:
    if point == "teddy":
        grid = teddy_grid(G, bound, device)
    elif point < 1.0:
        grid = blob_grid(G, point)
    else:
        grid = np.ones((G ** 3,), np.float32)
    return torch.from_numpy(grid).to(device)


def run(args) -> dict:
    device = card.device_of(args.device)
    on_card = device.type == "cuda"
    gen = make_generator(args.seed, device)
    H, S, K = SIZES[args.tiny]
    scene = LatentNeRFScene.create(nerf_type="latent", tiny=args.tiny,
                                   num_samples=S, num_compacted=K,
                                   train_grid_size=H, device=device,
                                   generator=gen)
    cfg = scene.occ_cfg
    views = rand_poses(1, ViewSamplerConfig(), device, generator=gen)
    u = torch.rand((1, H * H, S), generator=gen, device=device)
    params = list(scene.field.parameters())
    points = parse_points(args.points)
    # every grid first: a point that cannot be built fails before any time
    grids = [point_grid(p, cfg.resolution, scene.march.bound, device)
             for p in points]

    def frame():
        return torch.autograd.grad(render_loss(scene, views, u), params)

    out = []
    for point, grid in zip(points, grids):
        scene.occ_grid.copy_(grid)
        scene.occ_packed.copy_(occ_lib.packed_bitfield(grid, cfg))
        actual = float((grid > cfg.density_threshold).float().mean())
        if not on_card:
            frame()
            print(f"[{point}] occ={actual:.3f}: rendered (cpu: plain "
                  f"versions, no time)", flush=True)
            out.append({"tag": str(point), "occ_frac": round(actual, 4),
                        "rays_per_s": None, "ms_per_frame": None})
            continue
        t = card.graph_times(frame, args.iters)
        ms = t["median"]
        rays_per_s = H * H / (ms * 1e-3)
        print(f"[{point}] occ={actual:.3f}: {rays_per_s / 1e3:8.1f}k rays/s "
              f"({ms:.4f} ms a frame; graph best {t['best']:.4f}, eager "
              f"median {t['eager']:.4f})", flush=True)
        out.append({"tag": str(point), "occ_frac": round(actual, 4),
                    "rays_per_s": round(rays_per_s, 1),
                    "ms_per_frame": round(ms, 4)})
    return {"metric": "occ_frac_to_rays_per_s", "points": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", default=POINTS,
                    help="comma-separated fractions, or teddy")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny scene (tests)")
    print(json.dumps(run(ap.parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
