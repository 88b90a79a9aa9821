"""Structural ablation of the SD-v1 UNet forward: in-graph family costs.

Counterpart of the JAX package's scripts/exp_unet_ablate.py. Whole UNet
variants with families removed are timed, and the marginal cost of a
family is read off the differences:

    full            SD v1
    no-downup-attn  the 15 down/up cross-attention transformers stripped
                    (the mid block's stays)
    layers1         `layers_per_block` 1: one resnet a down block and two
                    an up block (8 fewer resnets, 6 fewer transformers)

each in f32 and bf16 (the bf16 copy made from the f32 one), one variant
resident on the card at a time; then the 15 transformers' in-graph ms and
share of the pass per dtype. `no-downup-attn` launches no kernel #4: its
only attention is the mid block's, at 8×8 tokens, which takes the plain
path.

A time is ms a forward at B = 2 on a 64×64×4 latent: `--iters` forwards
captured in one CUDA graph and replayed (`card.graph_times`: best and
median of the replays), beside the median of eager forwards. The input is
drawn once, before the capture (outside the timed region).

    python -m tpunerf_torch.scripts.exp_unet_ablate [--skip-bf16]
        [--iters 30] [--seed 0] [--device cuda] [--tiny]

It runs on the card; `--device cpu` runs each variant once, plain, and
prints no times (`--tiny`: the tiny UNet on a 16×16 latent, for tests).
Without a card and without `--device cpu` it exits non-zero. The last line
is the rows as one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys

import torch

from tpunerf_torch.guidance.unet import UNetConfig
from tpunerf_torch.scripts import card
from tpunerf_torch.scripts.profile_unet import B, CTX_LEN, DTYPES, build_unet
from tpunerf_torch.utils import make_generator

ITERS = 30
VARIANTS = ("full", "no-downup-attn", "layers1")


def variant(cfg: UNetConfig, name: str) -> UNetConfig:
    n = len(cfg.block_out_channels)
    if name == "no-downup-attn":
        return dataclasses.replace(cfg, down_block_has_attn=(False,) * n,
                                   up_block_has_attn=(False,) * n)
    if name == "layers1":
        return dataclasses.replace(cfg, layers_per_block=1)
    return cfg


def downup_transformers(cfg: UNetConfig) -> int:
    """The down and up blocks' transformers (15 in SD v1)."""
    L = cfg.layers_per_block
    return (L * sum(cfg.down_block_has_attn)
            + (L + 1) * sum(cfg.up_block_has_attn))


def run(args) -> dict:
    device = card.device_of(args.device)
    on_card = device.type == "cuda"
    gen = make_generator(args.seed, device)
    base = UNetConfig.tiny() if args.tiny else UNetConfig.sd_v1()
    size = 16 if args.tiny else 64
    x = torch.randn((B, size, size, base.in_channels), generator=gen,
                    device=device)
    t0 = torch.zeros((B,), dtype=torch.int64, device=device)
    ctx = torch.zeros((B, CTX_LEN, base.cross_attention_dim), device=device)
    dtypes = ["f32"] if args.skip_bf16 else ["f32", "bf16"]
    rows = []
    for name in VARIANTS:
        unet = build_unet(variant(base, name), torch.float32, device, gen)
        for tag in dtypes:
            unet.to(DTYPES[tag])
            fn = torch.no_grad()(lambda: unet(x, t0, ctx))
            label = f"{name} {tag}"
            if on_card:
                t = card.graph_times(fn, args.iters)
                print(f"{label:<46s} {t['best']:9.4f} ms  (graph median "
                      f"{t['median']:.4f}, eager {t['eager']:.4f})",
                      flush=True)
            else:
                fn()
                t = {"best": None, "median": None, "eager": None}
                print(f"{label:<46s} ran (cpu: plain, no time)", flush=True)
            rows.append({"name": label, "variant": name, "dtype": tag,
                         "best_ms": t["best"], "median_ms": t["median"],
                         "eager_ms": t["eager"]})
        del unet, fn
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    n = downup_transformers(base)
    shares = {}
    for tag in dtypes:
        best = {r["variant"]: r["best_ms"] for r in rows if r["dtype"] == tag}
        if not on_card:
            print(f"[{tag}] {n} down/up transformers in-graph: (cpu: no "
                  f"time)", flush=True)
            continue
        diff = best["full"] - best["no-downup-attn"]
        shares[tag] = {"ms": diff, "share": diff / best["full"]}
        print(f"[{tag}] {n} down/up transformers in-graph: {diff:.4f} ms "
              f"({diff / best['full'] * 100:.0f}% of the pass)", flush=True)
    return {"tool": "exp_unet_ablate", "downup_transformers": n,
            "transformer_share": shares, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-bf16", action="store_true")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny UNet on a 16x16 latent (tests)")
    report = run(ap.parse_args(argv))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
