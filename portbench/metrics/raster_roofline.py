"""Share (%) of its roofline that the port's rasterizer entries
(`kernels.rasterize.rasterize`: face selection and interpolation, and
`soft_silhouette`) reach on the step's body-camera face rows: the least
time, the larger of the operations of its inside pairs at the float32
peak and its bytes at the memory rate (`arith/raster.py`), over the
entries' time in a CUDA graph."""
from portbench.arith import peaks, raster


def read(ctx):
    ms = ctx["parts_ms"].get("raster")
    counts = ctx.get("raster_counts")
    if not ms or counts is None:
        return None
    least = max(raster.flops(counts["pairs"]) / peaks.FLOPS["f32"],
                raster.nbytes(counts["B"], counts["F"], counts["C"],
                              counts["P"]) / peaks.BYTES_PER_S)
    return 100.0 * least * 1e3 / ms
