"""Share (%) of the card's peak that a whole training step reaches: each
part's operations at the peak of its precision (`arith/step.py`), summed,
over the window's time a step (taken before the profiler opens)."""
from portbench.arith import step


def read(ctx):
    if not ctx["step_ms"] or ctx["step_ms"] != ctx["step_ms"]:
        return None
    return 100.0 * step.seconds_at_peak(ctx["cfg"], ctx["traffic"]) * 1e3 \
        / ctx["step_ms"]
