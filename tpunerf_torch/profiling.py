"""Profiling and tracing hooks.

A `torch.profiler` trace of host operations and, where a card is
visible, its kernels, written as a Chrome trace (`trace`, or
`start_trace`/`stop_trace` for a window that opens and closes in different
places, as the trainer's `log.trace_steps` does); named ranges that show
in the trace (`annotate`); and a phase timer that synchronises the device
before it reads the clock (`PhaseTimer`). The JAX package's live profiling
server has no counterpart here.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator

import torch

TRACE_FILE = "trace.json"
# seconds between the device's last kernel and the end of a trace window:
# the profiler keeps a kernel only where its end, moved from the card's
# clock onto the host's, falls inside the window, and that move can put the
# last kernels a millisecond after the synchronisation that waited for them
# (an H100 lost the last 49 device records of a window that closed at once;
# `scripts/trace_edges.py`)
TRACE_TAIL_S = 0.1


def start_trace() -> torch.profiler.profile:
    """A running profiler of host operations and, where a card is visible,
    its kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: Path) -> Path:
    """Stop `prof` (after the device's queued work has finished and
    `TRACE_TAIL_S` more) and write its Chrome trace into `log_dir`; the
    file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(TRACE_TAIL_S)
    prof.stop()
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / TRACE_FILE
    prof.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir: Path) -> Iterator[torch.profiler.profile]:
    """Profile the block into `log_dir/trace.json` (chrome://tracing or
    Perfetto opens it)."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


def annotate(name: str) -> torch.profiler.record_function:
    """A named range visible in profiler timelines."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Wall-clock seconds per phase, the device synchronised at both ends
    (kernels run after their launch returns, so a clock read without a
    synchronisation times the launch)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True) -> Iterator[None]:
        if sync:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per phase."""
        return {k: self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}
