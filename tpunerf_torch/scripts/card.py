"""The H100's published peaks, the least time a piece of work can take on
it, CUDA-event timing and `nvidia-smi` queries: one home for what
chip_smoke.py and the experiments under tpunerf_torch/scripts/ both use."""
from __future__ import annotations

import subprocess
from typing import List, Tuple

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W): memory rate,
# arithmetic per type, SMs, lanes of a warp
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SMS = 132
WARP = 32


def bound(nbytes: float, flops: float, kind: str) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of `nbytes` at the memory
    rate and `flops` at the peak for `kind`."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """ms per call of `fn` issued eagerly between CUDA events, after
    `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi(query: str) -> List[str]:
    """`nvidia-smi --query-gpu=<query> --format=csv,noheader` lines."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()
