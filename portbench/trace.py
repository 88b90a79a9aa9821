"""A profiler window of the card and what the benchmark reads from it: the
seconds in which a device operation ran (the union of their intervals),
the window's length, the device operations that took most time and the
longest idle gaps with what the host was doing when each began.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the profiler keeps a kernel only where its end, moved from the card's
# clock onto the host's, falls inside its session: wait past the last one
TAIL_S = 0.1
TOP = 10


def traced(fn: Callable[[], None], path: Path) -> Path:
    """Run `fn` inside a profiler session of host operations and the card's
    kernels, marked as the window; write the Chrome trace to `path`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        time.sleep(TAIL_S)
    finally:
        prof.stop()
    prof.export_chrome_trace(str(path))
    return path


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(path: Path) -> Dict:
    """{"busy_s", "window_s", "device_ops", "idle_gaps", "kernels"} of a
    trace written by `traced` (seconds; `kernels`: [(name, start µs, end
    µs)] inside the window)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"{path} holds no {WINDOW} range")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
            if b > a:
                dev.append((e["name"], a, b))
    merged = _merge([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    host = [e for e in spans if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW]
    labelled = []
    for a, b in sorted(gaps, key=lambda ab: ab[0] - ab[1])[:TOP]:
        cover = [e for e in host if float(e["ts"]) <= a
                 <= float(e["ts"]) + float(e.get("dur", 0))]
        inner = max(cover, key=lambda e: float(e["ts"]), default=None)
        label = inner["name"] if inner is not None else "no traced host op"
        labelled.append([f"host in {label}", (b - a) * 1e-6])
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, s * 1e-6] for n, s in ops],
            "idle_gaps": labelled, "kernels": dev}
