"""ms of the cell's mesh render piece alone (`drivers/parts.py`), one call
captured in a CUDA graph, the median of its replays on the device's clock;
nothing where the cell has no such piece."""


def read(ctx):
    return ctx["parts_ms"].get("mesh_render")
