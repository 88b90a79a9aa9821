"""Share (%) of the traced window of replays in which no device operation
ran: 1 − (the union of their intervals) / (the window's length)."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
