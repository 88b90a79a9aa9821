"""Times on the card: a piece of work captured alone in a CUDA graph and
replayed between CUDA events.

The capture follows PyTorch's recipe (warm-up calls on a side stream, then
the capture); the replays are timed on the device's clock, so a time here
is the device's and not the host's.
"""
from __future__ import annotations

import statistics
from typing import Callable, List


def capture(fn: Callable, warmup: int = 2):
    """(the graph, the captured call's output) of one call of `fn`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def graph_ms(fn: Callable, reps: int = 10) -> float:
    """The median ms of `reps` replays of one call of `fn` in a CUDA graph,
    each between two CUDA events, after one untimed replay."""
    import torch
    graph, _ = capture(fn)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times: List[float] = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)
