"""The readings that a cell's limits are set from, on the card at the cell's
own size: `python3 -m portbench.control --workload <name> --seeds a,b,…
[--control-seeds …] [--faults unchanged,half_batch,altered]`.

For each seed, in one process: the program's first steps against the
reference's (the lower readings); for each control seed, the reference
itself with every product one precision below the configuration's
(`control` of the traffic file) against the reference (the upper
readings); for each fault and control seed, the program with the fault
planted (`drivers.sds_train.FAULTS`) against the reference. Each reading
is one JSON line on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import harness, judge
from portbench.reference import train as reference


def readings(root: Path, workload: str, seeds: List[int],
             control_seeds: List[int], faults: List[str],
             device: str = "cuda") -> List[Dict]:
    spec = harness.load(root, workload)
    traffic, driver = spec["traffic"], spec["driver"]
    cfg = driver.resolve(spec["config"], traffic)
    if device == "cuda":
        from tpunerf_torch.kernels import _build
        _build.build_all()
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        ref = harness._reference(reference, traffic, cfg, seed, device)
        runs = [("program", None)] if seed in seeds else []
        if seed in control_seeds:
            runs += [("fault:" + f, f) for f in faults]
        for label, fault in runs:
            t0 = time.time()
            program = driver.Program(cfg, traffic, seed, device, fault=fault)
            first = program.first_steps()
            program.close()
            del program
            gc.collect()
            out.append({"workload": workload, "seed": seed, "run": label,
                        "seconds": time.time() - t0,
                        **judge.readings(first, ref),
                        "worst": _worst(first, ref)})
            print(json.dumps(out[-1]), flush=True)
        if seed in control_seeds:
            ctl = harness._reference(reference, traffic, cfg, seed, device,
                                     kinds=traffic["control"])
            out.append({"workload": workload, "seed": seed,
                        "run": "control " + json.dumps(traffic["control"]),
                        **judge.readings(ctl, ref), "worst": _worst(ctl, ref)})
            print(json.dumps(out[-1]), flush=True)
        del ref
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _worst(prog: Dict, ref: Dict) -> Dict:
    """Where each number's widest gap lies (a step or a leaf), and every
    gap with the reference's gradient norm and size of each leaf."""
    g = judge.gaps(prog, ref)
    return {**{k: max(v, key=v.get) for k, v in g.items()}, "gaps": g,
            "ref_grad": {n: [float(t.double().norm()), t.numel()]
                         for n, t in ref["first_grad"].items()}}


def _ints(s: Optional[str]) -> List[int]:
    return [int(v) for v in s.split(",")] if s else []


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    args = p.parse_args(argv)
    readings(Path.cwd(), args.workload, _ints(args.seeds),
             _ints(args.control_seeds),
             [f for f in args.faults.split(",") if f])
    return 0


if __name__ == "__main__":
    sys.exit(main())
