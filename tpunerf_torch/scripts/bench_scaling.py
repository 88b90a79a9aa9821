"""Scaling harness: data-parallel latent-NeRF steps over 1 → N ranks (the
JAX package's `bench_scaling.py`), through the port's Trainer on the
(data, rays) mesh of `dist/mesh.py`.

The JAX package's configuration: tiny guidance, 64² train grid, 128
samples a ray, one view a data rank (the batch grows with the ranks, so
perfect scaling keeps the step rate constant: efficiency = step rate at N
ranks / step rate at 1). Each size runs in its own ranks (processes,
rendezvous through a file): one rank a visible card over NCCL, or with
`--ranks-per-card K` K ranks sharing a card over gloo (NCCL refuses two
ranks on one device; such a run checks the split, it is not a scaling
figure), or with `--device cpu --ranks N` N ranks on the CPU over gloo.
Where N is even, the N ranks also run as (N/2 data x 2 rays).

Prints the card's name and power limit (`nvidia-smi`), then one JSON line:
{"devices": [...], "steps_per_s": [...], "views_per_s": [...],
"efficiency": e, "rays2_mesh": [N/2, 2], "rays2_steps_per_s": r,
"rays2_views_per_s": v}.

    python -m tpunerf_torch.scripts.bench_scaling [--iters 8]
    python -m tpunerf_torch.scripts.bench_scaling --ranks-per-card 2
    python -m tpunerf_torch.scripts.bench_scaling --device cpu --ranks 2 \\
        --grid 16 --samples 16 --iters 1
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

from tpunerf_torch.dist import launch
from tpunerf_torch.dist import mesh as dist_mesh

RANK_TIMEOUT_S = 600.0


def rank_main(args: argparse.Namespace) -> None:
    """One rank of one size: a warm-up step, then `iters` timed steps; rank
    0 prints its steps/s."""
    from tpunerf_torch.training.config import (DistConfig, GuideConfig,
                                               LogConfig, OptimConfig,
                                               RenderConfig, TrainConfig)
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer

    rank, world = dist_mesh.rank_from_env(), args.world
    if args.device == "cpu":
        torch.set_num_threads(1)
        device, backend = "cpu", "gloo"
    else:
        card = rank // args.ranks_per_card
        torch.cuda.set_device(card)
        device = f"cuda:{card}"
        backend = "gloo" if args.ranks_per_card > 1 else "nccl"
    dist_mesh.initialize(backend, args.init_method, device=device,
                         timeout_s=RANK_TIMEOUT_S)
    n_data = world // args.n_rays
    cfg = TrainConfig(
        log=LogConfig(exp_name="scale", exp_root=Path(args.exp_root),
                      eval_size=0, full_eval_size=0, save_mesh=False,
                      log_images=False, save_interval=10 ** 9),
        render=RenderConfig(train_grid_size=args.grid,
                            num_samples_per_ray=args.samples,
                            batch_size=n_data),
        optim=OptimConfig(iters=args.iters + 1, seed=0),
        guide=GuideConfig(text="bench", tiny_diffusion=True),
        dist=DistConfig(rays_axis=args.n_rays))
    trainer = Trainer(cfg, LatentNeRFApp.create(cfg, device=device),
                      device=device)
    assert trainer.layout is not None or world == 1
    trainer.train_step()
    trainer._sync()
    dist_mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        loss, _ = trainer.train_step()
    float(loss)                          # the last step done
    trainer._sync()
    rate = args.iters / (time.perf_counter() - t0)
    trainer.close()
    if rank == 0:
        print(json.dumps({"steps_per_s": rate}))
    dist_mesh.dist.destroy_process_group()


def measure(world: int, n_rays: int = 1, device: str = "cuda",
            ranks_per_card: int = 1, iters: int = 8, grid: int = 64,
            samples: int = 128, log_dir: Optional[Path] = None) -> float:
    """Steps per second of `world` ranks at (world / n_rays data x n_rays
    rays), each step one view a data rank."""
    tmp = Path(tempfile.mkdtemp(prefix="bench_scaling_"))
    argv = [sys.executable, "-m", "tpunerf_torch.scripts.bench_scaling",
            "--rank-of", str(world), "--n-rays", str(n_rays),
            "--init-method", launch.rendezvous_file(tmp),
            "--exp-root", str(tmp / "exp"), "--device", device,
            "--ranks-per-card", str(ranks_per_card), "--iters", str(iters),
            "--grid", str(grid), "--samples", str(samples)]
    outs = launch.run_ranks(argv, world, timeout=RANK_TIMEOUT_S,
                            cwd=Path(__file__).resolve().parents[2],
                            log_dir=log_dir or tmp / "logs")
    line = [ln for ln in outs[0].splitlines() if ln.startswith("{")][-1]
    return json.loads(line)["steps_per_s"]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the largest size (default: the visible "
                         "cards times --ranks-per-card)")
    ap.add_argument("--ranks-per-card", type=int, default=1)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--samples", type=int, default=128)
    # one rank of one size (started by `measure`)
    ap.add_argument("--rank-of", dest="world", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--n-rays", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--exp-root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.world is not None:
        rank_main(args)
        return
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to run on the CPU")
        from tpunerf_torch.scripts.card import nvidia_smi
        smi = nvidia_smi("name,power.limit")
        print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")
        n = args.ranks or torch.cuda.device_count() * args.ranks_per_card
    else:
        n = args.ranks or 1
    kw = dict(device=args.device, ranks_per_card=args.ranks_per_card,
              iters=args.iters, grid=args.grid, samples=args.samples)
    sizes = sorted({1, 2, n} & set(range(1, n + 1)))
    results = {s: measure(s, **kw) for s in sizes}
    out = {"devices": sizes,
           "steps_per_s": [round(results[s], 3) for s in sizes],
           "views_per_s": [round(results[s] * s, 3) for s in sizes],
           "efficiency": round(results[n] / results[1], 3) if n > 1 else 1.0}
    if n >= 2 and n % 2 == 0:
        r2 = measure(n, n_rays=2, **kw)
        out["rays2_mesh"] = [n // 2, 2]
        out["rays2_steps_per_s"] = round(r2, 3)
        out["rays2_views_per_s"] = round(r2 * (n // 2), 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
