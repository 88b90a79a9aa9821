"""Stage by stage timing of the latent-NeRF train render on the card.

Counterpart of the JAX package's scripts/profile_render.py: the full-width
scene (hash grid L=12, T=2^11, F=2; 128³ occupancy grid; S=128 samples a
ray compacted to K=64 at 64², B poses), its occupancy grid warmed by
`--occ-warm` EMA refreshes, then each stage of the render alone, fwd and
fwd+bwd, in the JAX script's rows and order, each beside its bound where
the stage is one of the kernels' (#1/#2 hash grid, #3 occupancy lookup) or
the compaction (by bytes: each input read once, each output written once,
at `card.MEM_BYTES_PER_S`).

A row's time is ms a call: `--iters` calls captured in one CUDA graph and
replayed (`card.graph_times`: best and median of the replays), beside the
median of the same calls issued eagerly. The random draws (the poses, the
stratified jitter, the refreshes' jitter) are made once, before the
capture, and passed in: they lie outside the timed region. (The JAX script
chains a `lax.scan` carry and stops its clock on a host fetch, because its
TPU backend did not reliably block; a graph's calls run in order on one
stream, and PyTorch removes no unused result.)

    python -m tpunerf_torch.scripts.profile_render [--batch 1]
        [--occ-warm 100] [--iters 100] [--seed 0] [--device cuda] [--tiny]

It runs on the card; `--device cpu` runs each stage once through the plain
versions and prints no times (`--tiny`: the tiny scene at 16², S=32,
K=16, for tests).
Without a card and without `--device cpu` it exits non-zero. The last line
is the rows as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, Optional

import torch

from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
from tpunerf_torch.fields import occupancy as occ_lib
from tpunerf_torch.fields import volume_render as vr
from tpunerf_torch.fields.scene import LatentNeRFScene
from tpunerf_torch.kernels.hashgrid import hash_encode_auto
from tpunerf_torch.scripts import card
from tpunerf_torch.utils import make_generator

# (train grid side, samples a ray S, compacted K): the JAX script's
# full-width render, and the tiny one of the CPU tests
SIZES = {False: (64, 128, 64), True: (16, 32, 16)}
ITERS = 100
OCC_WARM = 100   # EMA refreshes: the optimistic grid needs ~90 to decay


def stratified_xyz(rays: vr.Rays, u: torch.Tensor, S: int):
    """(t (B, P, S), xyz (B, P, S, 3) clipped to [−1, 1]): S stratified
    samples a ray jittered by the uniform draw `u` (B, P, S), as the JAX
    script's `make_xyz`."""
    ts = (torch.arange(S, dtype=torch.float32, device=u.device) + 0.5) / S
    ts = ts + (u - 0.5) / S
    t = rays.near[..., None] + (rays.far - rays.near)[..., None] * ts
    xyz = rays.origins[..., None, :] + rays.dirs[..., None, :] * t[..., None]
    return t, torch.clamp(xyz, -1.0, 1.0)


def sample_occupancy(rays, u, S, grid, packed, occ_cfg) -> torch.Tensor:
    """The samples' occupancy (B, P, S) bool (#3 on the card)."""
    _, xyz = stratified_xyz(rays, u, S)
    return occ_lib.occupied(grid, xyz, occ_cfg, packed=packed)


def sample_compact(rays, u, S, K, grid, packed, occ_cfg):
    """(valid, t_k, xyz_k): the first K occupied samples a ray."""
    t, xyz = stratified_xyz(rays, u, S)
    occ = occ_lib.occupied(grid, xyz, occ_cfg, packed=packed)
    return occ_lib.compact_gather(occ, K, t, xyz)


def render_loss(scene, views, u) -> torch.Tensor:
    """The JAX script's fwd+bwd loss: Σ image² + the sparsity loss."""
    out = scene.render_train(views, u=u)
    return torch.sum(out["image"] ** 2) + out["sparsity_loss"]


def _grads(loss_fn: Callable[[], torch.Tensor], params: List[torch.Tensor]):
    return lambda: torch.autograd.grad(loss_fn(), params, allow_unused=True)


def measure(name: str, fn: Callable, iters: int, on_card: bool,
            nbytes: Optional[float] = None) -> dict:
    """One row: graph and eager times on the card (with the bound by
    bytes where given), one plain call on the CPU."""
    row = {"name": name, "best_ms": None, "median_ms": None,
           "eager_ms": None, "bound_ms": None, "bound_by": None}
    if nbytes is not None:
        row["bound_ms"], row["bound_by"] = card.bound(nbytes, 0.0, "f32")
    if not on_card:
        fn()
        print(f"{name:<44s} ran (cpu: plain versions, no time)", flush=True)
        return row
    t = card.graph_times(fn, iters)
    row.update(best_ms=t["best"], median_ms=t["median"], eager_ms=t["eager"])
    bound = ("" if nbytes is None else
             f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
             f"{nbytes / 1e6:.2f} MB)")
    print(f"{name:<44s} {t['best']:9.4f} ms  (graph median "
          f"{t['median']:.4f}, eager median {t['eager']:.4f}){bound}",
          flush=True)
    return row


def run(args) -> dict:
    device = card.device_of(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    gen = make_generator(args.seed, device)
    B = args.batch
    H, S, K = SIZES[args.tiny]
    scene = LatentNeRFScene.create(nerf_type="latent", tiny=args.tiny,
                                   num_samples=S, num_compacted=K,
                                   train_grid_size=H, device=device,
                                   generator=gen)
    occ_cfg = scene.occ_cfg
    views = rand_poses(B, ViewSamplerConfig(), device, generator=gen)
    G = occ_cfg.resolution
    for _ in range(args.occ_warm):
        scene.update_occupancy(u=torch.rand((G ** 3, 3), generator=gen,
                                            device=device))
    occ_frac = float((scene.occ_grid > occ_cfg.density_threshold)
                     .float().mean())
    print(f"occupancy grid: {args.occ_warm} EMA updates, occupied fraction "
          f"{occ_frac:.3f}", flush=True)
    P = H * H
    N = B * P * K
    print(f"device={torch.cuda.get_device_name(0) if on_card else 'cpu'}  "
          f"rays={B * P}  S={S} K={K}  field pts={N}", flush=True)

    u = torch.rand((B, P, S), generator=gen, device=device)
    params = list(scene.field.parameters())
    rows = []

    def row(name, fn, nbytes=None):
        rows.append(measure(name, fn, args.iters, on_card, nbytes))

    row("full render fwd",
        torch.no_grad()(lambda: scene.render_train(views, u=u)["image"]))
    row("full render fwd+bwd",
        _grads(lambda: render_loss(scene, views, u), params))

    def rays_of():
        return vr.generate_rays(views.theta, views.phi, views.radius, H, H,
                                fovy=scene.fovy, look_at_height=scene.dy,
                                bound=scene.march.bound)

    row("generate_rays", rays_of)
    rays = rays_of()
    grid, packed = scene.occ_grid, scene.occ_packed
    ray_bytes = B * P * 8 * 4 + u.numel() * 4 + packed.numel() * 4
    row("sample+occ-lookup+compact+gather",
        lambda: sample_compact(rays, u, S, K, grid, packed, occ_cfg),
        ray_bytes + B * P * K * (1 + 4 + 12))
    row("  sample+occ lookup",
        lambda: sample_occupancy(rays, u, S, grid, packed, occ_cfg),
        ray_bytes + B * P * S)
    _, xyz0 = stratified_xyz(rays, u, S)
    occ0 = occ_lib.occupied(grid, xyz0, occ_cfg, packed=packed)
    row("  compact_samples alone",
        lambda: occ_lib.compact_samples(occ0, K), B * P * (S + K * 5))

    gcfg = scene.field.config.grid
    L, T, F = gcfg.n_levels, gcfg.table_size, gcfg.n_features_per_level
    print(f"CUDA kernels take these calls: hash grid #1/#2 {on_card}, "
          f"occupancy lookup #3 {on_card}  (L={L} T={T} F={F})", flush=True)
    table = scene.field.hash_table
    flat_x = xyz0[..., :K, :].reshape(-1, 3)
    flat_d = torch.broadcast_to(rays.dirs[..., None, :],
                                xyz0[..., :K, :].shape).reshape(-1, 3)
    x01 = torch.clamp((flat_x + 1.0) / 2.0, 0.0, 1.0)
    table_bytes = L * T * F * 4
    row("hash encode fwd",
        torch.no_grad()(lambda: hash_encode_auto(x01, table, gcfg)),
        N * 3 * 4 + table_bytes + N * L * F * 4)
    row("hash encode fwd+bwd",
        _grads(lambda: torch.sum(hash_encode_auto(x01, table, gcfg) ** 2),
               [table]),
        N * 3 * 4 + 2 * table_bytes)
    row("field apply fwd (hash+MLPs)",
        torch.no_grad()(lambda: scene.field(flat_x, flat_d)))

    def field_loss():
        s, c = scene.field(flat_x, flat_d)
        return torch.sum(s) + torch.sum(c ** 2)

    row("field apply fwd+bwd", _grads(field_loss, params))
    with torch.no_grad():
        sigma, color = scene.field(flat_x, flat_d)
    sigma = sigma.reshape(B, P, K)
    color = color.reshape(B, P, K, -1)
    t_k = torch.broadcast_to(torch.linspace(0.1, 2.0, K, device=device),
                             (B, P, K))
    dt_full = ((rays.far - rays.near) / S)[..., None]
    valid = torch.ones((B, P, K), dtype=sigma.dtype, device=device)
    row("composite", lambda: vr.composite(sigma, color, dt_full, valid, t_k))
    peak = None
    if on_card:
        peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        print(f"peak memory {peak:.3f} GiB above what was allocated before "
              f"(B={B})", flush=True)
    return {"tool": "profile_render", "batch": B, "occ_warm": args.occ_warm,
            "occ_frac": occ_frac, "peak_gib": peak, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--occ-warm", type=int, default=OCC_WARM)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny scene (tests)")
    report = run(ap.parse_args(argv))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
