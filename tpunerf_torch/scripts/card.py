"""The H100's published peaks, the least time a piece of work can take on
it, CUDA-event timing (eager, and on replays of a CUDA graph) and
`nvidia-smi` queries: one home for what chip_smoke.py and the tools under
tpunerf_torch/scripts/ all use."""
from __future__ import annotations

import statistics
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


def device_of(spec: Optional[str]):
    """The device a tool runs on: the card unless `spec` names another
    (`utils.resolve_device`); raises where the card it names is absent."""
    import torch
    from tpunerf_torch.utils import resolve_device
    device = resolve_device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device='cpu') to run the plain versions")
    return device


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


def capture(fn, iters: int, warmup: int = 3):
    """(replay, the last captured call's output): `iters` calls of `fn`
    captured in one CUDA graph, after `warmup` calls on a side stream that
    set up the lazy state (cuBLAS and cuDNN handles, the kernels' occupancy
    queries, autograd's buffers). The capture runs no kernel; `replay()`
    replays the graph and counts the repo's kernels that run
    (`_build.CAPTURED` during the capture). A `fn` that differentiates
    returns its gradients (`torch.autograd.grad`) rather than adding them
    into `.grad`, so that every replay writes the graph's own memory."""
    import torch
    from tpunerf_torch.kernels import _build
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    before = dict(_build.CAPTURED)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            out = fn()
    per_replay = {n: c - before.get(n, 0) for n, c in _build.CAPTURED.items()
                  if c > before.get(n, 0)}

    def replay():
        graph.replay()
        for name, times in per_replay.items():
            _build.count_launch(name, times)

    return replay, out


def graph_times(fn, iters: int, reps: int = 5) -> Dict[str, float]:
    """ms a call of `fn`: "best" and "median" of `reps` replays of `iters`
    calls captured in one graph (`capture`), each replay between CUDA
    events after an untimed one, and "eager", the median of `reps` runs of
    `iters` calls issued eagerly (`cuda_ms`)."""
    import torch
    replay, _ = capture(fn, iters)
    replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph = []
    for _ in range(reps):
        start.record()
        replay()
        end.record()
        torch.cuda.synchronize()
        graph.append(start.elapsed_time(end) / iters)
    del replay
    eager = [cuda_ms(fn, iters, warmup=0) for _ in range(reps)]
    return {"best": min(graph), "median": statistics.median(graph),
            "eager": statistics.median(eager)}


def report_times(report: dict) -> List[float]:
    """Every time in a measuring tool's JSON report (its last line): the
    rows' ms (graph best and median, eager median) and the points' ms a
    frame and rays/s; none where it ran on the CPU."""
    keys = ("best_ms", "median_ms", "eager_ms", "ms_per_frame", "rays_per_s")
    return [v for item in report.get("rows", []) + report.get("points", [])
            for k, v in item.items() if k in keys and v is not None]


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

