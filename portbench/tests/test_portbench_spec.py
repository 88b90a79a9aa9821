"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its file: configuration, traffic, driver, metric reader."""
import importlib
import json
import re

import pytest

from portbench import harness, judge

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert c["name"] in used


def test_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for cell in CELLS:
        assert harness.per_layer(BENCH, cell), cell


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves(cell):
    spec = harness.load(REPO, cell)
    cfg = spec["driver"].resolve(spec["config"], spec["traffic"])
    limits = spec["traffic"]["limits"]
    assert limits and set(limits) <= set(judge.NUMBERS)
    assert cfg["unet"]["block_out_channels"] == [320, 640, 1280, 1280]
    for m in harness.per_layer(BENCH, cell):
        assert callable(importlib.import_module(
            f"portbench.metrics.{m['name']}").read)


def test_a_cell_is_added_by_files_and_an_entry(tiny_root):
    """The tiny cells live only in the files the fixture adds and in their
    BENCHMARK.json entries; the harness finds them by name."""
    for cell in ("tiny_stage1", "tiny_refine", "tiny_mesh0"):
        spec = harness.load(tiny_root, cell)
        assert spec["config"]["tiny"] is True
        assert spec["driver"].__name__ == "portbench.drivers.sds_train"
    with pytest.raises(SystemExit):
        harness.load(REPO, "tiny_stage1")
