"""The H100's published peaks, the least time a piece of work can take on
it, CUDA-event timing and `nvidia-smi` queries: one home for what
chip_smoke.py and the experiments under tpunerf_torch/scripts/ both use."""
from __future__ import annotations

import subprocess
from typing import Dict, List, Optional, Tuple

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W): memory rate,
# arithmetic per type, SMs, lanes of a warp; special-function results (ex2)
# a clock per SM (Hopper's 4 sub-partitions x 4 lanes)
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SMS = 132
WARP = 32
SFU_PER_CLOCK = 16


def bound_terms(nbytes: float, flops: float, kind: str, sfu_ops: float = 0,
                sm_mhz: Optional[float] = None) -> Dict[str, float]:
    """ms of each term: "bytes" at the memory rate, `kind` for `flops` at
    its peak and, where `sfu_ops` is given, "ex2" for that many
    special-function operations at SFU_PER_CLOCK a clock per SM at
    `sm_mhz`."""
    terms = {"bytes": nbytes / MEM_BYTES_PER_S * 1e3,
             kind: flops / PEAK_FLOPS[kind] * 1e3}
    if sfu_ops:
        if sm_mhz is None:
            raise ValueError("an ex2 bound needs the SM clock")
        terms["ex2"] = sfu_ops / (SMS * SFU_PER_CLOCK * sm_mhz * 1e6) * 1e3
    return terms


def bound(nbytes: float, flops: float, kind: str, sfu_ops: float = 0,
          sm_mhz: Optional[float] = None) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the largest of `bound_terms`."""
    terms = bound_terms(nbytes, flops, kind, sfu_ops, sm_mhz)
    unit = max(terms, key=terms.get)
    return terms[unit], "bytes" if unit == "bytes" else "operations"


def max_sm_mhz() -> Optional[float]:
    """The card's maximum SM clock in MHz, None where nvidia-smi gives none."""
    clock = nvidia_smi("clocks.max.sm")
    return float(clock[0].split()[0]) if clock else None


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


def sass_functions(source: str) -> Dict[str, str]:
    """{kernel's mangled name: its SASS} from `cuobjdump -sass` of the built
    library of `tpunerf_torch/csrc/<source>.cu`."""
    from pathlib import Path
    from tpunerf_torch.kernels import _build
    lib = _build._library_path(_build.CSRC / f"{source}.cu")
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {chunk.split("\n", 1)[0]: chunk
            for chunk in sass.split("Function : ")[1:]}

