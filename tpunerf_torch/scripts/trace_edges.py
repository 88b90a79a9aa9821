"""The trainer's trace window at its edges, on the card.

Runs `chip_smoke.py`'s chunked stage-1 run (full width, `--log.trace_steps
5,9`: the window holds the replays of steps 1-12 and the refresh after
step 1) `--runs` times in one process, with `profiling.TRACE_TAIL_S` 0 (the
window closes right after the synchronisation) and its default in turns.
For each run it prints whether `chip_smoke.py`'s check of the trace passed,
the device records (kernels, copies, fills) of every replay in the window
(a replay that lost records shows fewer than the fullest, and the names of
what it lost are printed beside it), and `ahead_us`: how far the last
device record's end lies after the end of the synchronisation that waited
for it, on the trace's (host) clock. The device was idle when that
synchronisation returned, so a positive `ahead_us` is what the move of the
card's times onto the host's clock added, and a window that closes sooner
after the synchronisation than that drops the replay's last records.

    python -m tpunerf_torch.scripts.trace_edges [--runs 16] [--seed 0]

Run it from the repo's root, on a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _events(path: Path) -> List[dict]:
    return json.loads(Path(path).read_text())["traceEvents"]


def replay_records(path: Path) -> List[Counter]:
    """The names of the device records of each CUDA graph replay in the
    Chrome trace at `path`, in launch order (fills under one name: the
    profiler names a replay's fills now "Device", now "Unknown")."""
    events = _events(path)
    launches = sorted((e["ts"], e["args"].get("correlation"))
                      for e in events if e.get("name") == "cudaGraphLaunch")
    records = {c: Counter() for _, c in launches}
    for e in events:
        c = e.get("args", {}).get("correlation")
        if c in records and e.get("cat") in DEVICE:
            name = ("Memset" if e["cat"] == "gpu_memset"
                    else str(e.get("name"))[:60])
            records[c][name] += 1
    return [records[c] for _, c in launches]


def ahead_us(path: Path) -> float:
    """The last device record's end less the end of the first device
    synchronisation that began after the last graph launch (µs)."""
    events = _events(path)
    last_launch = max(e["ts"] for e in events
                      if e.get("name") == "cudaGraphLaunch")
    sync_end = min(e["ts"] + e.get("dur", 0) for e in events
                   if e.get("name") == "cudaDeviceSynchronize"
                   and e["ts"] > last_launch)
    return max(e["ts"] + e.get("dur", 0) for e in events
               if e.get("cat") in DEVICE) - sync_end


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trace_edges needs a card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from tpunerf_torch import profiling
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.scripts.card import nvidia_smi

    class Refused(Exception):
        pass

    def refuse(msg: str) -> None:
        raise Refused(msg)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    guidance = cs.build_guidance(args.seed)
    cs.fail = refuse
    tail = profiling.TRACE_TAIL_S
    trace = (ROOT / "experiments" / "chip_smoke" / "sand_castle_chunked"
             / "trace" / "trace.json")
    runs = []
    try:
        for i in range(args.runs):
            profiling.TRACE_TAIL_S = 0.0 if i % 2 == 0 else tail
            try:
                cs.train_chunked_full_width(cs.STEPS, args.seed, guidance)
                refused = None
            except Refused as e:
                refused = str(e)
            replays = replay_records(trace)
            most = max(sum(r.values()) for r in replays)
            full = next(r for r in replays if sum(r.values()) == most)
            run = {"tail_s": profiling.TRACE_TAIL_S, "refused": refused,
                   "check_passed": refused is None,
                   "records": [sum(r.values()) for r in replays],
                   "lost": {k: dict((full - r).most_common(3))
                            for k, r in enumerate(replays)
                            if sum(r.values()) < most},
                   "ahead_us": round(ahead_us(trace), 1)}
            print(f"trace_edges run {i}: {json.dumps(run)}", flush=True)
            runs.append(run)
            cs._free_card()
    finally:
        profiling.TRACE_TAIL_S = tail
    summary = {}
    for t in sorted({r["tail_s"] for r in runs}):
        mine = [r for r in runs if r["tail_s"] == t]
        last = len(mine[0]["records"]) - 1
        summary[str(t)] = {
            "runs": len(mine),
            "check_passed": sum(r["check_passed"] for r in mine),
            "first_replay_short": sum(0 in r["lost"] for r in mine),
            "last_replay_short": sum(last in r["lost"] for r in mine),
            "ahead_us_max": max(r["ahead_us"] for r in mine)}
    smi = nvidia_smi("name,power.limit")
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")
    print(json.dumps({"trace_edges": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
