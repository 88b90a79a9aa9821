"""Share (%) of its roofline that the port's attention entry
(`kernels.attention.attention`) reaches at the UNet's long self-attention
of the cell: the least time, the larger of its operations at the bf16
peak and its bytes at the memory rate (`arith/attention.py`), over the
entry's time in a CUDA graph."""
from portbench.arith import attention, peaks
from portbench.drivers.parts import attention_shape


def read(ctx):
    ms = ctx["parts_ms"].get("attention")
    if not ms:
        return None
    shape = attention_shape(ctx["cfg"], ctx["traffic"]["batch_size"])
    least = max(attention.flops(shape) / peaks.FLOPS["bf16"],
                attention.nbytes(shape, 2) / peaks.BYTES_PER_S)
    return 100.0 * least * 1e3 / ms
