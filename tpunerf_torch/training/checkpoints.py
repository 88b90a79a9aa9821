"""Checkpoint save and resume with rolling retention.

The counterpart of the JAX package's `training/checkpoints.py`: one file a
checkpoint, `step_%06d.ckpt`, holding {"train_step", "params",
"opt_state"?}; a rolling window of `max_keep` (`step_*` names only, the
oldest evicted); load of the newest checkpoint or of a named file, the
optimizer state on a best-effort basis. A file is one `torch.save` of host
tensors: `params` is the app's scene `state_dict()` (buffers included: the
latent-NeRF occupancy grid and its bitfield), `opt_state` the optimizer's
`state_dict()`. Files are read back with `weights_only=True`.

Three things differ from the reference, on purpose:

* Writes are atomic. A checkpoint is written to `<name>.tmp`, flushed and
  fsynced, then `os.replace`d into place, and retention evicts only after
  the replace; a `.tmp` left by a crash is removed at the next save. So the
  `step_*.ckpt` glob never sees a partial file.
* Torch tensors are updated in place (Adam steps parameters and moments),
  so a save first copies every tensor to host memory on the calling
  thread; only serialisation, fsync, replace and retention run on the
  writer thread of an asynchronous save. At most one write is in flight: a
  new save joins the previous one, and `flush()` re-raises a failed write.
* `save_debug` joins the writer without raising, writes its file, and
  hands the writer's failure back, so the error that asked for the debug
  save is the one the caller raises.

As in the JAX package, `save` and `save_debug` take `is_main_process`: on
any other rank of a process group they write nothing and return the path.
The directory is made by the first save.
"""
from __future__ import annotations

import copy
import logging
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

logger = logging.getLogger("tpunerf_torch")


def snapshot(tree: Any) -> Any:
    """A copy of a state dict (nested dicts, lists and tuples of tensors and
    plain values) with every tensor copied to host memory, detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, snapshot(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return copy.deepcopy(tree)


def _write_atomic(path: Path, state: Dict[str, Any]) -> None:
    """torch.save to `<path>.tmp`, fsync, replace into `path`, fsync the
    directory; the temporary file is removed if any of it fails."""
    tmp = path.with_name(path.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    fd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def optimizer_state_fits(opt_state: Dict[str, Any],
                         optimizer: torch.optim.Optimizer) -> bool:
    """Whether a saved `optimizer.state_dict()` can be loaded into
    `optimizer`: the same groups of the same sizes, and every saved
    per-parameter tensor of its parameter's shape."""
    groups = optimizer.param_groups
    saved = opt_state.get("param_groups", [])
    if len(saved) != len(groups) or any(
            len(s["params"]) != len(g["params"])
            for s, g in zip(saved, groups)):
        return False
    params = dict(zip((i for s in saved for i in s["params"]),
                      (p for g in groups for p in g["params"])))
    for i, st in opt_state.get("state", {}).items():
        p = params.get(i)
        if p is None:
            return False
        for v in st.values():
            if (isinstance(v, torch.Tensor) and v.dim() > 0
                    and v.shape != p.shape):
                return False
    return True


class CheckpointManager:
    def __init__(self, ckpt_dir: Path, max_keep: int = 2):
        self.ckpt_dir = Path(ckpt_dir)
        self.max_keep = max_keep
        self._thread: Optional[threading.Thread] = None
        self._worker_exc: Optional[BaseException] = None

    def _path(self, step: int) -> Path:
        return self.ckpt_dir / f"step_{step:06d}.ckpt"

    def existing(self) -> List[Path]:
        return sorted(self.ckpt_dir.glob("step_*.ckpt"))

    def join(self) -> Optional[BaseException]:
        """Wait for the write in flight, if any; return (and forget) its
        failure instead of raising it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._worker_exc = self._worker_exc, None
        return exc

    def flush(self) -> None:
        """Join the write in flight (if any); re-raise its failure."""
        exc = self.join()
        if exc is not None:
            raise exc

    def _write(self, path: Path, state: Dict[str, Any]) -> None:
        _write_atomic(path, state)
        # rolling retention, only once the new file is in place
        ckpts = self.existing()
        while len(ckpts) > self.max_keep:
            ckpts.pop(0).unlink()

    def save(self, step: int, params: Dict[str, Any],
             opt_state: Optional[Dict[str, Any]] = None, full: bool = True,
             async_write: bool = False,
             is_main_process: bool = True) -> Path:
        """Save `params` (and `opt_state` when `full`) as step `step`. The
        tensors are copied to the host before this returns; with
        `async_write` the file is written on a background thread (a new
        save or `flush()` joins it, and `flush()` re-raises its failure).
        Call `flush()` before reading checkpoints and at the end of a
        run. Not the main process: nothing is written."""
        if not is_main_process:
            return self._path(step)
        self.flush()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        for stale in self.ckpt_dir.glob("*.tmp"):     # a crashed write's
            stale.unlink(missing_ok=True)
        path = self._path(step)
        state: Dict[str, Any] = {"train_step": step,
                                 "params": snapshot(params)}
        if full and opt_state is not None:
            state["opt_state"] = snapshot(opt_state)
        if not async_write:
            self._write(path, state)
            return path

        def work():
            try:
                self._write(path, state)
            except BaseException as e:     # re-raised at the next flush
                self._worker_exc = e

        self._thread = threading.Thread(target=work, name="ckpt-writer")
        self._thread.start()
        return path

    def save_debug(self, name: str, step: int, params: Dict[str, Any],
                   is_main_process: bool = True
                   ) -> Tuple[Path, Optional[BaseException]]:
        """Save `params` as `<name>.ckpt`, outside the `step_*` glob: never
        evicted by retention, never taken by a latest-checkpoint resume
        (the NaN post-mortem). Joins the write in flight without raising
        and returns (path, that write's failure or None); the failure is
        logged, for the caller to chain to its own error. Not the main
        process: nothing is written."""
        if not is_main_process:
            return self.ckpt_dir / f"{name}.ckpt", None
        failed = self.join()
        if failed is not None:
            logger.error(f"an earlier checkpoint write failed: {failed!r}")
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = self.ckpt_dir / f"{name}.ckpt"
        _write_atomic(path, {"train_step": step, "params": snapshot(params)})
        return path, failed

    def load(self, path: Optional[Path] = None,
             optimizer: Optional[torch.optim.Optimizer] = None
             ) -> Tuple[Optional[Dict[str, Any]], Optional[Dict[str, Any]],
                        int]:
        """(params, opt_state, next_step) of the newest checkpoint, or of
        `path`; (None, None, 0) when there is none. The optimizer state is
        None where the file has none or, given `optimizer`, where it does
        not fit it (best effort, as the reference)."""
        self.flush()
        if path is None:
            ckpts = self.existing()
            if not ckpts:
                return None, None, 0
            path = ckpts[-1]
        state = torch.load(path, map_location="cpu", weights_only=True)
        opt_state = state.get("opt_state")
        if (opt_state is not None and optimizer is not None
                and not optimizer_state_fits(opt_state, optimizer)):
            opt_state = None
        return state["params"], opt_state, int(state.get("train_step", 0)) + 1
