"""One run of one cell: `python3 -m portbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout.

The run finds the cell in `BENCHMARK.json`, its configuration file, its
traffic file (`portbench/workloads/<traffic>.json`) and that file's driver
(`portbench/drivers/<driver>.py`) by name; sets up the program (weights
from the seed, the app, its captured step and its first steps); measures
for `--seconds`; with `--trace 1` traces a window of replays, times the
step's pieces alone and reads each per-layer metric with its reader
(`portbench/metrics/<name>.py`); then frees the program, runs the
reference over the same first steps (`portbench/reference/`) and judges
them (`portbench/judge.py`). It prints the numbers it compared beside
their limits as the last lines of standard error and, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics`, `device` (and with `--trace 1` `breakdown`), then `compared`.

It exits with another code than 0, and prints no result, where no card or
too few cards are visible, and where JAX or the JAX package has been
loaded into the process.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "tpunerf")
TRACE_CHUNKS = 4          # chunks of the traced window


def process_start() -> float:
    """The process's start on the `time.time()` clock (from /proc where it
    can be read, else now)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - ticks / hz)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load(root: Path, workload: str) -> Dict:
    """The cell `workload` of `root/BENCHMARK.json` with its configuration,
    traffic and driver."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = json.loads((root / "portbench" / "workloads"
                          / f"{cell['traffic']}.json").read_text())
    return {"bench": bench, "cell": cell,
            "config": json.loads((root / config["file"]).read_text()),
            "traffic": traffic,
            "driver": importlib.import_module(
                f"portbench.drivers.{traffic['driver']}")}


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics that `cell` reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            moved = e2e[m["moves"]].get("workloads")
            if moved is not None and cell not in moved:
                continue
        elif cell not in cells:
            continue
        out.append(m)
    return out


def reader(name: str) -> Callable:
    return importlib.import_module(f"portbench.metrics.{name}").read


def window(program, seconds: float) -> Dict[str, float]:
    """Chunks until `seconds` have passed on the host's clock, then the
    device's last work: their steps and wall seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        steps += program.chunk()
    program.read_back()
    torch.cuda.synchronize()
    return {"steps": steps, "seconds": time.perf_counter() - t0}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault: Optional[str] = None,
        started: Optional[float] = None) -> Dict:
    """One run; returns the result line's object. `device` "cpu" (the
    tests' rehearsal at a configuration's tiny size) skips the look for a
    card and times nothing on it."""
    started = process_start() if started is None else started
    spec = load(root, workload)
    cell, traffic, driver = spec["cell"], spec["traffic"], spec["driver"]
    import torch
    on_card = device == "cuda"
    if on_card:
        _require_cards(cell["chips"])
        from tpunerf_torch.kernels import _build
        _build.build_all()
    cfg = driver.resolve(spec["config"], traffic)
    program = driver.Program(cfg, traffic, seed, device, fault=fault)
    first = program.first_steps()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - started
    if on_card:
        timed = window(program, seconds)
    else:
        timed = {"steps": program.chunk(), "seconds": float("nan")}
        program.read_back()
    step_ms = 1e3 * timed["seconds"] / timed["steps"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = _traced(program, cfg, traffic, step_ms, on_card)
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        extra["breakdown"] = {"device_ops": ctx["device_ops"],
                              "idle_gaps": ctx["idle_gaps"]}
        for m in per_layer(spec["bench"], workload):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {"step_ms": {"value": step_ms, "unit": "ms"},
                   "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    attempted = len(first["losses"]) + timed["steps"]
    program.close()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from portbench import judge
    from portbench.reference import train as reference
    ref = _reference(reference, traffic, cfg, seed, device)
    numbers = judge.readings(first, ref)
    limits = traffic["limits"]
    correct = judge.verdict(numbers, limits)
    return {"correct": correct, "attempted": attempted,
            "failed": 0 if correct else len(first["losses"]),
            "metrics": metrics, "device": dev, **extra,
            "compared": {k: {"value": numbers[k], "limit": limit}
                         for k, limit in limits.items()}}


def _reference(reference, traffic: Dict, cfg: Dict, seed: int, device: str,
               **kw) -> Dict:
    """The reference's first steps in float32 with TF32 off."""
    import torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return reference.run(traffic["app"], cfg, traffic, seed, device, **kw)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _traced(program, cfg: Dict, traffic: Dict, step_ms: float,
            on_card: bool) -> Dict:
    """What the per-layer readers read: the traced window's device time,
    the pieces' graph times, the counts of the cell's work."""
    from portbench import timing
    from portbench import trace as tr
    ctx: Dict = {"cfg": cfg, "traffic": traffic, "step_ms": step_ms,
                 "parts_ms": {}, "busy_s": 0.0, "window_s": 0.0,
                 "device_ops": [], "idle_gaps": [], "kernels": []}
    from portbench.drivers import parts
    ctx.update(parts.counts(program))
    if on_card:
        with tempfile.TemporaryDirectory(prefix="portbench_trace_") as tmp:
            path = tr.traced(lambda: [program.chunk()
                                      for _ in range(TRACE_CHUNKS)]
                             + [program.read_back()],
                             Path(tmp) / "trace.json")
            ctx.update(tr.read(path))
        for name, fn in program.parts().items():
            ctx["parts_ms"][name] = timing.graph_ms(fn)
    else:
        for fn in program.parts().values():
            fn()
    return ctx


def _require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(
            f"this cell needs {n} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")


def report(result: Dict) -> None:
    """The compared numbers beside their limits on standard error, then the
    result line on standard output."""
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))


def main(argv: Optional[List[str]] = None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    build = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    result = run(root, args.workload, args.seed, args.seconds,
                 bool(args.trace), started=started)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    report(result)
    return 0
