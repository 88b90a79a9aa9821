"""Share (%) of its roofline that the port's hash-grid entry
(`kernels.hashgrid.hash_encode_auto`, the encode and the table's gradient)
reaches at the step's points (every ray's K compacted samples): the least
time, the larger of its operations at the float32 peak and its bytes at
the memory rate (`arith/hashgrid.py`), over the entry's time in a CUDA
graph."""
from portbench.arith import hashgrid, peaks


def read(ctx):
    ms = ctx["parts_ms"].get("hashgrid")
    if not ms:
        return None
    cfg, work = ctx["cfg"], ctx["traffic"]
    g = cfg["field"]["grid"]
    n = (work["batch_size"] * cfg["scene"]["train_grid_size"] ** 2
         * cfg["scene"]["num_compacted"])
    L, T, F = g["n_levels"], 1 << g["log2_hashmap_size"], \
        g["n_features_per_level"]
    least = max(hashgrid.flops(n, L, F) / peaks.FLOPS["f32"],
                hashgrid.nbytes(n, L, T, F) / peaks.BYTES_PER_S)
    return 100.0 * least * 1e3 / ms
