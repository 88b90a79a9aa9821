"""On the card, at each cell's own size: the control (the reference one
precision below the configuration) comes out as not correct, and a short
run of the cell comes out as correct. `python -m pytest portbench/tests -q
-m cuda` from the repository's root on a machine with a card."""
import json

import pytest

from portbench import harness, judge
from portbench.reference import train as reference

from conftest import REPO

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 4242


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(card, cell):
    spec = harness.load(REPO, cell)
    traffic = spec["traffic"]
    cfg = spec["driver"].resolve(spec["config"], traffic)
    ref = harness._reference(reference, traffic, cfg, SEED, "cuda")
    ctl = harness._reference(reference, traffic, cfg, SEED, "cuda",
                             kinds=traffic["control"])
    assert not judge.verdict(judge.readings(ctl, ref), traffic["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_on_the_card(card, cell):
    out = harness.run(REPO, cell, SEED, 1.0, trace=False)
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu"
