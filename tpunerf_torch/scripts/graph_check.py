"""A captured training step against the same step run eagerly.

`graphed_against_eager` runs step `train_step_idx + 1` of a trainer three
times from one state: eagerly, eagerly again, and as a replay of its
captured step (`Trainer.capture`). `graph_agreement` judges the result by
group and by tensor. Where the step branches on a draw (Paint-by-Example's
CLIP branch), `advance_to_branch` moves the trainer's generator on until
the next step takes a given branch, so that each branch's graph is judged.
`chip_smoke.py` and the card tests use them; the trainer does not.
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
    was compared (the loss, every gradient (a parameter that a step gives
    none has an empty one), every parameter and buffer of the app, Adam's
    state, the generator's state), of the replay and of the
    second eager run (which shows what in the step is not deterministic),
    and the first run's largest |value|; and "update": the largest
    |difference| of the replay's parameters, buffers and Adam state to the
    eager optimizer step (and post-step hook) taken from the same state on
    the replay's own gradients, which is exact whatever the gradients'
    spread from run to run."""
    graph = trainer.capture()
    snap, step0 = trainer.snapshot(), trainer.train_step_idx

    def record(loss, grads) -> Dict[str, torch.Tensor]:
        out = {"loss": loss.detach().clone()}
        out.update({f"grad {i}": g.detach().clone() if g is not None
                    else torch.zeros(0) for i, g in enumerate(grads)})
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
    drawn = trainer.generator.get_state()     # the step's draws taken
    trainer.post_step()
    replay = record(graph.loss, graph.grads)
    after = trainer.snapshot()

    # the eager update on the replay's gradients
    trainer.restore(snap)
    for p, g in zip(trainer.params, graph.grads):
        p.grad = None if g is None else g.detach().clone()
    trainer.optimizer.step()
    trainer.generator.set_state(drawn)
    trainer.post_step()
    update = record(graph.loss, graph.grads)
    trainer.restore(after)

    def diffs(run, ref):
        return {k: float("inf") if run[k].shape != ref[k].shape
                else (run[k].double() - ref[k].double()).abs().max().item()
                if run[k].numel() else 0.0 for k in ref}
    scale = {k: v.double().abs().max().item() if v.numel() else 0.0
             for k, v in first.items()}
    return {"replay": diffs(replay, first), "eager": diffs(second, first),
            "scale": scale,
            "update": {k: v for k, v in diffs(replay, update).items()
                       if k.split(" ")[0] in ("app", "adam")}}


def graph_agreement(d: Dict[str, Dict[str, float]]
                    ) -> Dict[str, Dict[str, float]]:
    """Judge `graphed_against_eager`'s result by group of what was
    compared ("loss", "grad", "app", "adam", "generator"): the group's
    tensors, how many of them the replay equals bit for bit, the replay's
    and the eager runs' largest difference, the largest |value|, the
    largest share of its allowance that a tensor's replay uses (`worst`)
    and whether the group agreed (`ok`). Where the two eager runs are equal
    bit for bit on the whole group and on what it follows from (the step is
    deterministic there), the replay must be too (its allowance is 0).
    Otherwise (a kernel that adds with atomics reorders sums from run to
    run) each tensor's allowance is the larger of 4x its own eager runs'
    difference and TOL of its own largest value. The parameters and Adam's
    state after the step ("app", "adam") follow from the gradients: where
    the gradients differ between the eager runs, two runs that happen to
    round an update alike do not make it deterministic; instead these
    groups must equal the eager update on the replay's own gradients
    ("update") bit for bit, always (`update` in the result: its largest
    difference)."""
    groups: Dict[str, list] = {}
    for k in d["replay"]:
        groups.setdefault(k.split(" ")[0], []).append(k)
    spread = {g: max(d["eager"][k] for k in keys)
              for g, keys in groups.items()}
    out = {}
    for group, keys in groups.items():
        rep = [d["replay"][k] for k in keys]
        eag = [d["eager"][k] for k in keys]
        deterministic = spread[group] == 0.0 and (
            group not in ("app", "adam") or spread.get("grad", 0.0) == 0.0)
        allow = [0.0 if deterministic else max(4 * e, TOL * d["scale"][k])
                 for e, k in zip(eag, keys)]
        shares = [r / a if a > 0 else (0.0 if r == 0 else float("inf"))
                  for r, a in zip(rep, allow)]
        upd = max((d.get("update", {}).get(k, 0.0) for k in keys),
                  default=0.0)
        out[group] = {"tensors": len(keys),
                      "equal": sum(r == 0.0 for r in rep),
                      "replay": max(rep), "eager": max(eag),
                      "scale": max(d["scale"][k] for k in keys),
                      "worst": max(shares), "update": upd,
                      "ok": max(shares) <= 1.0 and upd == 0.0}
    return out


def advance_to_branch(trainer, branch: bool, tries: int = 64) -> int:
    """Move the trainer's generator on, one step's leading draws
    (`Trainer.draw`) at a time, until the next step's branch flag names
    `branch`; the state it draws from is otherwise left as it was. Returns
    how many draws were skipped. For a trainer whose app branches on a
    draw (`Trainer.branches`)."""
    if not trainer.branches():
        raise ValueError("the trainer's steps do not branch")
    for skipped in range(tries):
        state = trainer.generator.get_state()
        flag = bool(trainer.draw()[2])
        trainer.generator.set_state(state)
        if flag == branch:
            return skipped
        trainer.draw()
    raise RuntimeError(f"no step took the {branch} branch in {tries} draws")
