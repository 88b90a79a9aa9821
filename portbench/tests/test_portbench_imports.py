"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import subprocess
import sys

from conftest import REPO

PORTBENCH = REPO / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_running_modules_load_no_jax():
    mods = ["portbench.harness", "portbench.control", "portbench.judge",
            "portbench.trace", "portbench.timing"]
    mods += [f"portbench.drivers.{p.stem}"
             for p in (PORTBENCH / "drivers").glob("[a-z]*.py")]
    mods += [f"portbench.metrics.{p.stem}"
             for p in (PORTBENCH / "metrics").glob("[a-z]*.py")]
    mods += [f"portbench.reference.{p.stem}"
             for p in (PORTBENCH / "reference").glob("[a-z]*.py")]
    mods += [f"portbench.arith.{p.stem}"
             for p in (PORTBENCH / "arith").glob("[a-z]*.py")]
    mods += ["tpunerf_torch.training.trainer",
             "tpunerf_torch.training.latent_nerf_app",
             "tpunerf_torch.training.latent_paint_mesh"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from portbench.harness import forbidden_modules\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("tpunerf_torch", "tpunerf",
                                              "jax", "jaxlib", "flax"), \
                (path.name, name)


def test_no_file_imports_jax_or_reads_the_old_benchmark():
    for path in PORTBENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("tpunerf", "jax", "jaxlib",
                                              "flax"), (path, name)
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and '"benchmark"' not in text, path
