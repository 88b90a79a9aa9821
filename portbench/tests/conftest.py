"""The benchmark's tests: `python -m pytest portbench/tests -q` from the
repository's root (CPU: the harness at the port's tiny configuration);
`python -m pytest portbench/tests -q -m cuda` on a card."""
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
# the test-only cells, added as a later change adds one: a configuration
# file, a traffic file and an entry in BENCHMARK.json
TINY_CONFIGS = {"tiny_nerf": "tiny_nerf.json", "tiny_mesh": "tiny_mesh.json"}
TINY_CELLS = {"tiny_stage1": "tiny_nerf", "tiny_refine": "tiny_nerf",
              "tiny_mesh0": "tiny_mesh"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and skips without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout's root holding the repository's BENCHMARK.json with the
    tiny cells added, and only their files beside it."""
    root = tmp_path_factory.mktemp("checkout")
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "workloads").mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, file in TINY_CONFIGS.items():
        shutil.copy(DATA / file, root / "portbench" / "configs" / file)
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"portbench/configs/{file}",
                                 "reduced": [], "why": "tests"})
    for cell, config in TINY_CELLS.items():
        shutil.copy(DATA / f"{cell}.json",
                    root / "portbench" / "workloads" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": cell, "chips": 1,
                                   "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
