"""Start the ranks of a process group on this host, as torchrun does: one
process a rank with `RANK`, `WORLD_SIZE` and `LOCAL_RANK` set, each
rendezvousing through the `file://` address it is given (no TCP port to
choose), all joined under one time limit that fails the run instead of
hanging it."""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def rendezvous_file(directory: Path) -> str:
    """A fresh `file://` init method under `directory`."""
    fd, path = tempfile.mkstemp(prefix="rendezvous_", dir=directory)
    os.close(fd)
    os.unlink(path)           # the store creates it
    return f"file://{path}"


def run_ranks(argv: Sequence[str], world: int, timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[Path] = None,
              log_dir: Optional[Path] = None) -> List[str]:
    """Run `argv` once a rank (world ranks), each with its rank in the
    environment; wait at most `timeout` seconds for all of them. Returns
    each rank's standard output. Raises RuntimeError, with the tails of the
    failed ranks' outputs, where a rank exits non-zero, and TimeoutError,
    after killing every rank, where the time runs out."""
    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="ranks_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for r in range(world):
        e = dict(os.environ if env is None else env, RANK=str(r),
                 WORLD_SIZE=str(world), LOCAL_RANK=str(r))
        out = open(log_dir / f"rank{r}.out", "w+")
        err = open(log_dir / f"rank{r}.err", "w+")
        files.append((out, err))
        procs.append(subprocess.Popen(list(argv), env=e, cwd=cwd,
                                      stdout=out, stderr=err))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise TimeoutError(f"{world} ranks of {argv} ran past {timeout} s: "
                           + _tails(files)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for out, _ in files:
        out.seek(0)
        outs.append(out.read())
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    text = _tails(files) if failed else ""
    for out, err in files:
        out.close()
        err.close()
    if failed:
        raise RuntimeError(f"ranks {failed} of {argv} failed: {text}")
    return outs


def _tails(files, n: int = 3000) -> str:
    parts = []
    for r, (out, err) in enumerate(files):
        err.seek(0)
        out.seek(0)
        parts.append(f"\n--- rank {r} stderr ---\n{err.read()[-n:]}"
                     f"\n--- rank {r} stdout ---\n{out.read()[-n:]}")
    return "".join(parts)
