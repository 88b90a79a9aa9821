"""The comparison that decides `correct`: the program's first steps against
the reference's, on the same weights and draws.

Three numbers; those the cell's traffic file gives a limit ("limits") are
compared, each with its own:

* "loss": the widest gap of a step's loss, |L_prog − L_ref|, over the
  reference's scale of that step, Σ|latents·(w·(ε̂ − ε))| plus the
  regularisers (the SDS loss is a sum of terms of both signs);
* "grad": of the first step's gradient, the widest gap of a leaf's norm,
  |‖g_prog‖ − ‖g_ref‖|, over the larger of the reference's norm of that
  leaf and of the median leaf;
* "change": the same of each leaf's change over the steps, ‖p_end −
  p_start‖.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of "grad" and "change": Adam moves them by round-off
alone.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss", "grad", "change")
NOUGHT = 1e-3


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves: List[str]) -> Dict[str, float]:
    median = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in leaves}


def counted_leaves(ref: dict) -> List[str]:
    g = _norms(ref["first_grad"])
    median = statistics.median(g.values())
    return sorted(n for n, v in g.items() if v >= NOUGHT * median)


def gaps(prog: dict, ref: dict) -> Dict[str, Dict[str, float]]:
    """Each number's gaps before the widest is taken: "loss" by step,
    "grad" and "change" by leaf."""
    leaves = counted_leaves(ref)
    change = {}
    for side, r in (("prog", prog), ("ref", ref)):
        change[side] = _norms({n: r["end"][n].cpu() - r["start"][n].cpu()
                               for n in leaves})
    return {"loss": {f"step {i + 1}": abs(lp - lr) / max(s, 1e-30)
                     for i, (lp, lr, s) in enumerate(zip(
                         prog["losses"], ref["losses"], ref["scales"]))},
            "grad": _leaf_gaps(_norms({n: prog["first_grad"][n].cpu()
                                       for n in leaves}),
                               _norms({n: ref["first_grad"][n].cpu()
                                       for n in leaves}), leaves),
            "change": _leaf_gaps(change["prog"], change["ref"], leaves)}


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of the program's readings `prog` against the
    reference's `ref` (each: "losses", "first_grad", "start", "end"; the
    reference's also "scales")."""
    return {k: max(v.values()) for k, v in gaps(prog, ref).items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit is within it (NaN is not)."""
    return all(numbers[k] <= limit for k, limit in limits.items())
