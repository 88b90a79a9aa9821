"""The tile arithmetic of the wgmma attention backward (#12, #13), on the CPU.

`csrc/attention_bwd.cu` streams tiles of T rows of DP bf16 through shared
memory in wgmma's swizzled layout (`csrc/wgmma.cuh`); its producer warp
copies, in every tile, the same chunks of 16 bytes, chunk t + 32k for thread
t. These twins of `swz` and of that chunk order hold the layout to what the
products read: every (row, 16-byte column chunk) of a tile copied exactly
once, to its own 16 bytes inside the tile. The kept mma.sync wrappers refuse
what they do not take.
"""
import pytest
import torch

from tpunerf_torch.kernels import attention as at

PRODUCERS = 32   # kWgProducers
TILES = {True: 48, False: 64}   # WgCfg<DP, DKV>::T: #12, #13


def _atom(dp: int):
    """(W, CW): the swizzle atom's row in bytes and its 16-byte chunks."""
    w = 128 if dp % 64 == 0 else 32
    return w, w // 16


def _swz(i: int, dp: int) -> int:
    """swz<DP>(i): the byte offset of chunk i in atom-major order."""
    _, cw = _atom(dp)
    o = 16 * i
    return o ^ (((o >> 7) & (cw - 1)) << 4)


def _chunk(i: int, rows: int, dp: int):
    """(row, first column) of chunk i, as load_rows and the producer
    compute them."""
    _, cw = _atom(dp)
    return (i // cw) % rows, ((i // (cw * rows)) * cw + i % cw) * 8


@pytest.mark.parametrize("dp", [48, 64])
@pytest.mark.parametrize("dkv", [True, False])
def test_producer_copies_each_chunk_of_a_tile_once(dp, dkv):
    rows = TILES[dkv]
    n = rows * dp // 8
    assert n % PRODUCERS == 0, "kChunks = T·(DP/8)/32 is whole"
    seen, offsets = set(), set()
    for t in range(PRODUCERS):
        for k in range(n // PRODUCERS):
            i = t + PRODUCERS * k
            seen.add(_chunk(i, rows, dp))
            offsets.add(_swz(i, dp))
    assert seen == {(r, c) for r in range(rows) for c in range(0, dp, 8)}
    assert offsets == set(range(0, 2 * rows * dp, 16))
    # a tile starts on whole swizzle atoms of 8 rows
    w, _ = _atom(dp)
    assert (rows * dp * 2) % (8 * w) == 0


@pytest.mark.parametrize("dp", [48, 64])
def test_swizzle_keeps_a_chunk_in_its_atom_row(dp):
    """The XOR moves a chunk only within its W-byte row of an atom, so a
    K-major k-step (32 bytes of every row) and an MN-major one (16 rows)
    read whole rows of the atom."""
    w, _ = _atom(dp)
    rows = 64
    for i in range(rows * dp // 8):
        assert _swz(i, dp) // w == 16 * i // w


def test_mma_design_wrappers_take_cuda_bf16_only():
    q, k, v, do = (torch.zeros((1, 1, 64, 40)) for _ in range(4))
    lse, delta = torch.zeros((1, 1, 64)), torch.zeros((1, 1, 64))
    with pytest.raises(TypeError, match="bf16 only"):
        at.attention_bwd_dkv_mma_cuda(q, k, v, do, lse, delta, 0.1)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    with pytest.raises(ValueError, match="CUDA device"):
        at.attention_bwd_dq_mma_cuda(*bf, lse, delta, 0.1)
