"""The port's CheckpointManager (tpunerf_torch.training.checkpoints)
against the JAX package's on the same save sequences: file names after
rolling retention, latest and explicit loads, `next_step`, and the debug
save outside retention. Then what only the port promises: atomic writes
(an injected crash leaves the previous checkpoint loadable and no partial
`step_*.ckpt`), a failed asynchronous write re-raised at `flush()`,
`save_debug` writing its file after such a failure without replacing the
error, and asynchronous saves that copy the tensors before they return."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunerf.training.checkpoints import CheckpointManager as JManager
from tpunerf_torch.training import checkpoints as tck
from tpunerf_torch.training.checkpoints import CheckpointManager as TManager


def _names(path):
    return sorted(p.name for p in path.glob("*.ckpt"))


@pytest.mark.parametrize("async_write", [False, True])
def test_rolling_retention_and_loads_match_jax(tmp_path, async_write):
    jm, tm = JManager(tmp_path / "jax", 2), TManager(tmp_path / "torch", 2)
    for step in (1, 2, 5, 7):
        w = np.full(3, float(step), np.float32)
        jm.save(step, {"w": jnp.asarray(w)}, {"m": jnp.asarray(w + 1)},
                async_write=async_write)
        tm.save(step, {"w": torch.from_numpy(w)},
                {"m": torch.from_numpy(w + 1)}, async_write=async_write)
    jm.flush()
    tm.flush()
    assert _names(tmp_path / "torch") == _names(tmp_path / "jax") == [
        "step_000005.ckpt", "step_000007.ckpt"]
    assert [p.name for p in tm.existing()] == [p.name for p in jm.existing()]
    # the newest, and an explicit path
    jp, jo, jn = jm.load(params_template={"w": jnp.zeros(3)},
                         opt_state_template={"m": jnp.zeros(3)})
    tp, to, tn = tm.load()
    assert tn == jn == 8
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    np.testing.assert_array_equal(to["m"].numpy(), np.asarray(jo["m"]))
    jp, _, jn = jm.load(tmp_path / "jax" / "step_000005.ckpt",
                        params_template={"w": jnp.zeros(3)})
    tp, _, tn = tm.load(tmp_path / "torch" / "step_000005.ckpt")
    assert tn == jn == 6 and tp["w"].tolist() == [5.0] * 3
    # no checkpoint at all
    assert TManager(tmp_path / "empty").load() == (None, None, 0)
    # model-only saves carry no optimizer state
    tm.save(9, {"w": torch.zeros(3)}, {"m": torch.zeros(3)}, full=False)
    assert tm.load()[1] is None


def test_save_debug_outside_retention_and_never_resumed(tmp_path):
    """The sequence of tests/test_checkpoints.py, on both managers."""
    jm, tm = JManager(tmp_path / "jax", 2), TManager(tmp_path / "torch", 2)
    for step in (1, 2):
        jm.save(step, {"w": jnp.ones(3)})
        tm.save(step, {"w": torch.ones(3)})
    jm.save_debug("nan_debug", 2, {"w": jnp.full((3,), 7.0)})
    path, failed = tm.save_debug("nan_debug", 2, {"w": torch.full((3,), 7.0)})
    assert failed is None
    jm.save(3, {"w": jnp.ones(3)})
    tm.save(3, {"w": torch.ones(3)})
    assert _names(tmp_path / "torch") == _names(tmp_path / "jax") == [
        "nan_debug.ckpt", "step_000002.ckpt", "step_000003.ckpt"]
    assert tm.load()[2] == jm.load(params_template={"w": jnp.ones(3)})[2] == 4
    params, _, _ = tm.load(path)
    assert params["w"].tolist() == [7.0] * 3


def test_a_crash_during_a_save_leaves_the_previous_checkpoint(tmp_path,
                                                              monkeypatch):
    mgr = TManager(tmp_path, 2)
    mgr.save(1, {"w": torch.ones(4)}, {"m": torch.zeros(4)})
    real_save = torch.save

    def torn(obj, f):                  # half a file, then the crash
        real_save(obj, f)
        f.truncate(f.tell() // 2)
        raise OSError("disk full")

    monkeypatch.setattr(tck.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, {"w": torch.full((4,), 2.0)})
    monkeypatch.setattr(tck.torch, "save", real_save)

    def no_replace(src, dst):
        raise OSError("replace failed")

    monkeypatch.setattr(tck.os, "replace", no_replace)
    with pytest.raises(OSError, match="replace failed"):
        mgr.save(3, {"w": torch.full((4,), 3.0)})
    monkeypatch.undo()
    assert _names(tmp_path) == ["step_000001.ckpt"]
    assert not list(tmp_path.glob("*.tmp"))
    params, opt, nxt = mgr.load()
    assert nxt == 2 and params["w"].tolist() == [1.0] * 4 and opt is not None
    # a temporary file a killed process left is removed at the next save
    (tmp_path / "step_000004.ckpt.tmp").write_bytes(b"partial")
    mgr.save(5, {"w": torch.zeros(4)})
    assert not list(tmp_path.glob("*.tmp"))
    assert _names(tmp_path) == ["step_000001.ckpt", "step_000005.ckpt"]


def test_a_failed_async_write_is_raised_at_flush(tmp_path, monkeypatch):
    mgr = TManager(tmp_path, 2)

    def broken(path, state):
        raise OSError("no space left")

    monkeypatch.setattr(tck, "_write_atomic", broken)
    mgr.save(1, {"w": torch.ones(2)}, async_write=True)
    with pytest.raises(OSError, match="no space left"):
        mgr.flush()
    mgr.flush()                        # raised once, then forgotten
    assert not any(t.name == "ckpt-writer" for t in threading.enumerate())


def test_save_debug_after_a_failed_async_write_keeps_both(tmp_path,
                                                          monkeypatch):
    mgr = TManager(tmp_path, 2)
    real = tck._write_atomic
    failure = OSError("writer failed")

    def broken_steps(path, state):
        if path.name.startswith("step_"):
            raise failure
        real(path, state)

    monkeypatch.setattr(tck, "_write_atomic", broken_steps)
    mgr.save(1, {"w": torch.ones(2)}, async_write=True)
    path, failed = mgr.save_debug("nan_debug", 1, {"w": torch.zeros(2)})
    assert failed is failure and path.exists()
    assert mgr.load(path)[0]["w"].tolist() == [0.0, 0.0]
    mgr.flush()                        # the failure was handed back once


def test_async_save_copies_the_tensors_before_it_returns(tmp_path,
                                                         monkeypatch):
    """A write that starts only after the caller has changed its tensors in
    place (as the next Adam step does) still holds the values of the
    save."""
    mgr = TManager(tmp_path, 2)
    go = threading.Event()
    real = tck._write_atomic

    def late(path, state):
        assert go.wait(10)
        real(path, state)

    monkeypatch.setattr(tck, "_write_atomic", late)
    w = torch.arange(6.0)
    exp_avg = torch.ones(6)
    opt = {"state": {0: {"step": torch.tensor(3.0), "exp_avg": exp_avg}},
           "param_groups": [{"lr": 0.01, "params": [0]}]}
    mgr.save(4, {"w": w}, opt, async_write=True)
    w.mul_(-1.0)
    exp_avg.add_(5.0)
    opt["param_groups"][0]["lr"] = 1.0
    go.set()
    params, opt_state, nxt = mgr.load()
    assert nxt == 5 and params["w"].tolist() == list(range(6))
    assert opt_state["state"][0]["exp_avg"].tolist() == [1.0] * 6
    assert opt_state["param_groups"][0]["lr"] == 0.01


def test_optimizer_state_that_does_not_fit_is_dropped(tmp_path):
    a = torch.nn.Parameter(torch.zeros(3))
    b = torch.nn.Parameter(torch.zeros(2, 2))
    adam = torch.optim.Adam([a, b])
    (a.sum() + b.sum()).backward()
    adam.step()
    mgr = TManager(tmp_path, 2)
    mgr.save(1, {"a": a}, adam.state_dict())
    assert mgr.load(optimizer=adam)[1] is not None
    other = torch.optim.Adam([torch.nn.Parameter(torch.zeros(4)), b])
    assert mgr.load(optimizer=other)[1] is None       # a shape differs
    fewer = torch.optim.Adam([a])
    assert mgr.load(optimizer=fewer)[1] is None       # a parameter short
    assert mgr.load()[1] is not None                  # nothing to fit
