"""The SD-v1 UNet's CFG pass by layer family, on the card.

Counterpart of the JAX package's scripts/profile_unet.py: the whole UNet
forward at B = 2 (the CFG batch) on a 64×64×4 latent and its forward and
backward (which runs the attention kernels #4, #12 and #13), then each
layer family alone at each resolution with its count in the UNet (resnet
blocks, transformer blocks), the sum of family times × counts against the
whole pass, self-attention at the 64² level's 4096 tokens (kernel #4) and
at 1024 tokens (the plain path, as the JAX package sends only N ≥ 2048 to
its flash kernel), and a 3×3 convolution in f32 and bf16. Each row prints
ms a call, its TF/s as a share of the card's peak for the dtype (the JAX
script's FLOP counts) and the least time its weights take to read once at
`card.MEM_BYTES_PER_S`. The UNet runs NCHW: family blocks take NCHW
inputs. On the card it then names the operations that issue the f32 SIMT
GEMMs (`sgemm` kernels) of one bf16 or f32 forward, from a
`profiling.trace` of it.

A row's time is ms a call: `--iters` calls captured in one CUDA graph and
replayed (`card.graph_times`: best and median of the replays), beside the
median of the same calls issued eagerly. Inputs are drawn once, before the
capture (outside the timed region), as the JAX script fixes its family
inputs. The first line prints the TF32 settings, which the f32 rows depend
on; the tool does not change them.

    python -m tpunerf_torch.scripts.profile_unet [--dtype f32|bf16]
        [--skip-bwd] [--iters 50] [--seed 0] [--device cuda] [--tiny]

(the fwd+bwd row takes at most 20 calls a graph, as the JAX script's)

It runs on the card; `--device cpu` runs each row once, plain, and prints
no times (`--tiny`: the tiny UNet on a 16×16 latent, for tests). Without a
card and without `--device cpu` it exits non-zero. The last line is the
rows as one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from tpunerf_torch import profiling
from tpunerf_torch.guidance.stable_diffusion import _build
from tpunerf_torch.guidance.unet import (_FLASH_MIN_SEQ, Attention,
                                         ResnetBlock, Transformer2D,
                                         UNet2DCondition, UNetConfig)
from tpunerf_torch.scripts import card
from tpunerf_torch.utils import init_like_flax_, make_generator

B = 2            # the CFG batch
CTX_LEN = 77     # text tokens
ITERS = 50
BWD_ITERS = 20
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def resnet_flops(b: int, h: int, ci: int, co: int) -> int:
    """A resnet block's two 3×3 convolutions (the JAX script's count)."""
    return 2 * 2 * b * h * h * 9 * ci * co


def transformer_flops(b: int, h: int, ch: int, ctx_dim: int = 768) -> int:
    """A transformer block: self-attention's two products, its q/k/v/out
    and cross-attention's q/out projections, the context's k/v, the
    cross-attention products and the GEGLU feed-forward (the JAX script's
    count)."""
    n = h * h
    return (2 * 2 * b * n * n * ch
            + 2 * b * n * ch * ch * 4
            + 2 * b * n * ch * ch * 2
            + 2 * b * CTX_LEN * ctx_dim * ch * 2
            + 2 * 2 * b * n * CTX_LEN * ch
            + 2 * b * n * ch * (8 * ch + 4 * ch))


def conv_flops(b: int, h: int, ci: int, co: int) -> int:
    return 2 * b * h * h * 9 * ci * co


def families(cfg: UNetConfig, size: int
             ) -> Tuple[List[Tuple[int, int, int, int]],
                        List[Tuple[int, int, int]]]:
    """([(side, c_in, c_out, count)] of resnet blocks, [(side, channels,
    count)] of transformer blocks) at each level of `cfg` on a `size`²
    latent: SD v1 at 64² gives the JAX script's lists (counts 5, 5, 5, 7
    and 5, 5, 5, 1)."""
    ch, L = cfg.block_out_channels, cfg.layers_per_block
    n = len(ch)
    resnets, transformers = [], []
    for i, c in enumerate(ch):
        side = size >> i
        last = i == n - 1
        resnets.append((side, c, c, L + (L + 1) + (2 if last else 0)))
        count = (L * cfg.down_block_has_attn[i]
                 + (L + 1) * cfg.up_block_has_attn[n - 1 - i]
                 + (1 if last else 0))
        if count:
            transformers.append((side, c, count))
    return resnets, transformers


def param_bytes(module: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def build_unet(cfg: UNetConfig, dtype: torch.dtype, device,
               gen: torch.Generator) -> UNet2DCondition:
    """A random UNet as the guidance builds one (flax's init on the
    device), in `dtype`."""
    return _build(UNet2DCondition, cfg, device, gen).to(dtype)


def _block(module: nn.Module, dtype, device, gen) -> nn.Module:
    return init_like_flax_(module.to(device), gen).to(dtype).eval()


def gemm_issuers(trace: dict) -> Counter:
    """{operation chain: kernels} of the f32 SIMT GEMM kernels (`sgemm` in
    the name) in a Chrome trace of `torch.profiler`: each kernel's launch
    (the runtime call with its correlation id) and the host operations
    around that launch on its thread, outermost first."""
    events = trace.get("traceEvents", [])
    ops = [e for e in events if e.get("cat") == "cpu_op" and "dur" in e]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    found = Counter()
    for k in events:
        if k.get("cat") != "kernel" or "sgemm" not in k.get("name", ""):
            continue
        call = launch.get(k.get("args", {}).get("correlation"))
        chain = [] if call is None else sorted(
            (e for e in ops if e.get("tid") == call.get("tid")
             and e["ts"] <= call["ts"] <= e["ts"] + e["dur"]),
            key=lambda e: (e["ts"], -e["dur"]))
        found[" > ".join(e["name"] for e in chain) or "?"] += 1
    return found


def measure(name: str, fn: Callable, iters: int, on_card: bool, dtype: str,
            flops: Optional[int] = None,
            weight_bytes: Optional[int] = None) -> dict:
    """One row: graph and eager times on the card, its TF/s against the
    dtype's peak and its weights' read bound; one plain call on the CPU."""
    row = {"name": name, "best_ms": None, "median_ms": None,
           "eager_ms": None, "flops": flops, "weight_bytes": weight_bytes}
    if not on_card:
        fn()
        print(f"{name:<52s} ran (cpu: plain, no time)", flush=True)
        return row
    t = card.graph_times(fn, iters)
    row.update(best_ms=t["best"], median_ms=t["median"], eager_ms=t["eager"])
    rate = ""
    if flops:
        per_s = flops / (t["best"] * 1e-3)
        rate = (f"  ({per_s / 1e12:6.1f} TF/s, "
                f"{per_s / card.PEAK_FLOPS[dtype]:.3f} of {dtype} peak)")
    wb = ""
    if weight_bytes is not None:
        wb = (f"  [w {weight_bytes / 2 ** 20:7.1f} MB >= "
              f"{weight_bytes / card.MEM_BYTES_PER_S * 1e3:.4f} ms]")
    print(f"{name:<52s} {t['best']:9.4f} ms  (graph median "
          f"{t['median']:.4f}, eager {t['eager']:.4f}){rate}{wb}",
          flush=True)
    return row


def sgemm_issuers(unet, x, t, ctx) -> Dict[str, int]:
    """The f32 SIMT GEMM kernels of one forward, by issuing operations."""
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(Path(d)), torch.no_grad():
            unet(x, t, ctx)
        trace = json.loads((Path(d) / profiling.TRACE_FILE).read_text())
    return dict(gemm_issuers(trace))


def run(args) -> dict:
    device = card.device_of(args.device)
    on_card = device.type == "cuda"
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}  "
          f"torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    gen = make_generator(args.seed, device)
    dt = DTYPES[args.dtype]
    cfg = UNetConfig.tiny() if args.tiny else UNetConfig.sd_v1()
    size = 16 if args.tiny else 64
    unet = build_unet(cfg, dt, device, gen)
    ctx_dim = cfg.cross_attention_dim
    x = torch.randn((B, size, size, cfg.in_channels), generator=gen,
                    device=device)
    t0 = torch.zeros((B,), dtype=torch.int64, device=device)
    ctx = torch.zeros((B, CTX_LEN, ctx_dim), device=device)
    print(f"device={torch.cuda.get_device_name(0) if on_card else 'cpu'}  "
          f"B={B}  dtype={args.dtype}", flush=True)
    rows = []

    def row(name, fn, iters=args.iters, flops=None, weight_bytes=None,
            dtype=args.dtype):
        rows.append(measure(name, torch.no_grad()(fn), iters, on_card, dtype,
                            flops, weight_bytes))
        return rows[-1]

    whole_row = row(f"UNet fwd (B={B}, {size}x{size}x{cfg.in_channels})",
                    lambda: unet(x, t0, ctx), weight_bytes=param_bytes(unet))
    if not args.skip_bwd:
        params = list(unet.parameters())
        unet.requires_grad_(True)

        def whole_bwd():
            return torch.autograd.grad(torch.sum(unet(x, t0, ctx) ** 2),
                                       params)

        rows.append(measure("UNet fwd+bwd", whole_bwd,
                            min(args.iters, BWD_ITERS), on_card, args.dtype))
        unet.requires_grad_(False)
    issuers = None
    if on_card:
        issuers = sgemm_issuers(unet, x, t0, ctx)
        print(f"f32 SIMT GEMMs (sgemm) of one UNet fwd: "
              f"{sum(issuers.values())} kernels" + "".join(
                  f"\n  {n} x {op}" for op, n in sorted(issuers.items())),
              flush=True)
    del unet
    if on_card:
        torch.cuda.empty_cache()

    temb_dim = cfg.block_out_channels[0] * 4
    temb = torch.zeros((B, temb_dim), device=device, dtype=dt)
    resnets, transformers = families(cfg, size)
    total, whole_ms = 0.0, whole_row["best_ms"]
    for side, ci, co, n in resnets:
        blk = _block(ResnetBlock(ci, co, temb_dim, cfg.norm_num_groups),
                     dt, device, gen)
        xb = torch.randn((B, ci, side, side), generator=gen,
                         device=device).to(dt)
        r = row(f"resnet {side}x{side} c{ci}->{co}  (x{n} in UNet)",
                lambda blk=blk, xb=xb: blk(xb, temb),
                flops=resnet_flops(B, side, ci, co),
                weight_bytes=param_bytes(blk))
        total += (r["best_ms"] or 0.0) * n
    ctx_b = torch.randn((B, CTX_LEN, ctx_dim), generator=gen,
                        device=device).to(dt)
    for side, ch, n in transformers:
        blk = _block(Transformer2D(ch, ctx_dim, cfg.attention_num_heads,
                                   cfg.norm_num_groups), dt, device, gen)
        xb = torch.randn((B, ch, side, side), generator=gen,
                         device=device).to(dt)
        r = row(f"transformer2d {side}x{side} c{ch}  (x{n} in UNet)",
                lambda blk=blk, xb=xb: blk(xb, ctx_b),
                flops=transformer_flops(B, side, ch, ctx_dim),
                weight_bytes=param_bytes(blk))
        total += (r["best_ms"] or 0.0) * n
    # up-path resnets see concatenated skips (c_in up to 2·c_out): the
    # family rows undercount them; the gap to the whole pass is that and
    # the glue between blocks
    name = "sum of family times x counts (approx)"
    if on_card:
        print(f"{name:<52s} {total:9.4f} ms   vs whole {whole_ms:.4f} ms",
              flush=True)
    else:
        print(f"{name:<52s} (cpu: no time)", flush=True)
    rows.append({"name": name, "best_ms": total if on_card else None,
                 "whole_ms": whole_ms})

    for level in (0, 1):
        side, ch = size >> level, cfg.block_out_channels[level]
        n_tok = side * side
        attn = _block(Attention(ch, ch, cfg.attention_num_heads), dt,
                      device, gen)
        xa = torch.randn((B, n_tok, ch), generator=gen, device=device).to(dt)
        path = ("flash path: kernel #4"
                if n_tok >= _FLASH_MIN_SEQ and n_tok % 1024 == 0
                else "naive path: plain")
        row(f"self-attn {n_tok} tokens c{ch} ({path})",
            lambda attn=attn, xa=xa: attn(xa))

    ch0 = cfg.block_out_channels[0]
    for tag, cdt in DTYPES.items():
        conv = _block(nn.Conv2d(ch0, ch0, 3, padding=1), cdt, device, gen)
        xc = torch.randn((B, ch0, size, size), generator=gen,
                         device=device).to(cdt)
        row(f"conv3x3 {size}x{size} c{ch0}->{ch0} {tag}",
            lambda conv=conv, xc=xc: conv(xc),
            flops=conv_flops(B, size, ch0, ch0), dtype=tag)
    return {"tool": "profile_unet", "dtype": args.dtype,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32},
            "sgemm_issuers": issuers, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f32")
    ap.add_argument("--skip-bwd", action="store_true")
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
