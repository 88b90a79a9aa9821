"""A captured training step against the same step run eagerly.

`graphed_against_eager` runs step `train_step_idx + 1` of a trainer three
times from one state: eagerly, eagerly again, and as a replay of its
captured step (`Trainer.capture`). `graph_agreement` judges the result by
group and by tensor. `chip_smoke.py` and the card tests use both; the
trainer does not.
"""
from __future__ import annotations

from typing import Dict

import torch

# of a tensor's largest value: the least a replay may differ from the eager
# step where two eager runs differ too
TOL = 1e-5


def graphed_against_eager(trainer) -> Dict[str, Dict[str, float]]:
    """Step `train_step_idx + 1` from the trainer's state three times:
    eagerly, eagerly again, and as a replay of its captured step, each with
    the post-step hook, the state put back in place between (it is left
    as the replay leaves it). Returns {"replay": ..., "eager": ...,
    "scale": ...}: the largest |difference| to the first eager run, by what
    was compared (the loss, every gradient, every parameter and buffer of
    the app, Adam's state, the generator's state), of the replay and of the
    second eager run (which shows what in the step is not deterministic),
    and the first run's largest |value|."""
    graph = trainer.capture()
    snap, step0 = trainer.snapshot(), trainer.train_step_idx

    def record(loss, grads) -> Dict[str, torch.Tensor]:
        out = {"loss": loss.detach().clone()}
        out.update({f"grad {i}": g.detach().clone()
                    for i, g in enumerate(grads)})
        out.update({f"app {n}": v.detach().clone()
                    for n, v in trainer.app.state_dict().items()})
        for i, p in enumerate(trainer.params):
            for n, v in trainer.optimizer.state[p].items():
                out[f"adam {i} {n}"] = v.detach().clone()
        out["generator"] = trainer.generator.get_state()
        return out

    def eager() -> Dict[str, torch.Tensor]:
        trainer.restore(snap)
        trainer.train_step_idx = step0
        loss, _ = trainer.train_step()
        return record(loss, [p.grad for p in trainer.params])

    first, second = eager(), eager()
    trainer.restore(snap)
    trainer.train_step_idx = step0 + 1
    graph.replay()
    trainer.post_step()
    replay = record(graph.loss, graph.grads)

    def diffs(run):
        return {k: (run[k].double() - first[k].double()).abs().max().item()
                if run[k].numel() else 0.0 for k in first}
    scale = {k: v.double().abs().max().item() if v.numel() else 0.0
             for k, v in first.items()}
    return {"replay": diffs(replay), "eager": diffs(second), "scale": scale}


def graph_agreement(d: Dict[str, Dict[str, float]]
                    ) -> Dict[str, Dict[str, float]]:
    """Judge `graphed_against_eager`'s result by group of what was
    compared ("loss", "grad", "app", "adam", "generator"): the group's
    tensors, how many of them the replay equals bit for bit, the replay's
    and the eager runs' largest difference, the largest |value|, the
    largest share of its allowance that a tensor's replay uses (`worst`)
    and whether the group agreed (`ok`). Where the two eager runs are equal
    bit for bit on the whole group (the step is deterministic there), the
    replay must be too (its allowance is 0). Otherwise (a kernel that adds
    with atomics reorders sums from run to run) each tensor's allowance is
    the larger of 4x its own eager runs' difference and TOL of its own
    largest value."""
    groups: Dict[str, list] = {}
    for k in d["replay"]:
        groups.setdefault(k.split(" ")[0], []).append(k)
    out = {}
    for group, keys in groups.items():
        rep = [d["replay"][k] for k in keys]
        eag = [d["eager"][k] for k in keys]
        deterministic = max(eag) == 0.0
        allow = [0.0 if deterministic else max(4 * e, TOL * d["scale"][k])
                 for e, k in zip(eag, keys)]
        shares = [r / a if a > 0 else (0.0 if r == 0 else float("inf"))
                  for r, a in zip(rep, allow)]
        out[group] = {"tensors": len(keys),
                      "equal": sum(r == 0.0 for r in rep),
                      "replay": max(rep), "eager": max(eag),
                      "scale": max(d["scale"][k] for k in keys),
                      "worst": max(shares), "ok": max(shares) <= 1.0}
    return out
