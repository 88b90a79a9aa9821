"""Hash-grid encode: CUDA kernels (csrc/hashgrid.cu) and their plain
PyTorch versions.

`hash_encode_auto` is what the field calls. On CUDA tensors it runs
`HashEncode`, whose forward and backward are the hand-written kernels #1
and #2; on CPU tensors the same autograd function runs the plain versions.
The backward returns the table gradient only: ray positions are not
trained, so dx ≡ 0, as in the JAX package's custom VJP.

Both kernels hold a part of the table in shared memory (`table_parts`).
#2 accumulates in fixed point; `hash_bwd_fixed_point_plain` repeats its
arithmetic in PyTorch. `hash_encode_level_cuda` runs the level-per-block
forward, kept only to be timed beside #1.

`hash_bwd_split` takes today's #2 apart on its own grid (full, gmax,
addr, accum, reduce: kernel #11 since its redesign); `hash_bwd_variant`
runs the first design of #11, the cost-split variants of the first #2
(full, global, addr, accum). Only the experiment
`python -m tpunerf_torch.scripts.exp_hash_bwd`, `chip_smoke.py` and the
tests call them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpunerf_torch.fields.encoding import (HashGridConfig,
                                           corner_indices_and_weights,
                                           hash_encode)
from tpunerf_torch.kernels import _build

FWD = "hashgrid_fwd"
BWD = "hashgrid_bwd"
FWD_LEVEL = "hashgrid_fwd_level"   # level-per-block forward, timed only
# the table gradient's cost split experiment (tpunerf_torch/scripts/
# exp_hash_bwd.py): kernel modes in the order of their codes
VARIANT = "hashgrid_bwd_variant"
VARIANT_MODES = ("full", "global", "addr", "accum")
# today's #2 taken apart (kernel #11): modes in the order of their codes,
# and the grids they run, as multiples of #2's resident blocks
SPLIT = "hashgrid_bwd_split"
SPLIT_MODES = ("full", "gmax", "addr", "accum", "reduce")
SPLIT_FACTORS = (0.5, 1, 2, 4)
STAND_IN_EXPONENT = 28        # accum's fixed point: G = 2 at every level
THREADS = 256                 # threads per block of the variants
# shared memory a block can use on Hopper, and what #1 and #2 keep beside
# their part of the table (an mbarrier; the per-level maxima)
SMEM_BYTES = 227 * 1024
SMEM_RESERVED = 1024
FWD_VALUE_BYTES = 4           # #1 stages the f32 table
BWD_VALUE_BYTES = 8           # #2 sums each value in 64-bit fixed point
FIXED_POINT_BITS = 30         # #2: every update |v| < 2^30
FWD_MIN_POINTS = 256          # #1: points a block at least
BWD_MIN_POINTS = 512          # #2: points a block at least (its fill, flush)
BWD_MAX_POINTS = 8192         # #2: points a block at most (the sums' bound)

Part = Tuple[int, int, int, int]     # (l0, nl, j0, nj)


def table_parts(cfg: HashGridConfig, value_bytes: int) -> List[Part]:
    """Cut the (L, T, F) table into the parts that one block of kernel #1
    (value_bytes 4) or #2 (8) holds in shared memory: levels [l0, l0 + nl),
    slots [j0, j0 + nj) of each, every (level, slot) in exactly one part,
    each part within SMEM_BYTES - SMEM_RESERVED bytes. Whole levels where
    one fits, in as few groups as fit and of sizes that differ by at most
    one; otherwise each level cut into equal power-of-two slot ranges."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    budget = SMEM_BYTES - SMEM_RESERVED
    level_bytes = T * F * value_bytes
    if level_bytes <= budget:
        groups = -(-L // (budget // level_bytes))
        parts, l0 = [], 0
        for k in range(groups):
            nl = L // groups + (k < L % groups)
            parts.append((l0, nl, 0, T))
            l0 += nl
        return parts
    cuts = 1
    while (T // cuts) * F * value_bytes > budget:
        cuts *= 2
    nj = T // cuts
    return [(l, 1, k * nj, nj) for l in range(L) for k in range(cuts)]


def hash_encode_plain(x: torch.Tensor, table: torch.Tensor,
                      cfg: HashGridConfig) -> torch.Tensor:
    """Plain forward: fields/encoding.py:hash_encode without autograd."""
    with torch.no_grad():
        return hash_encode(x, table, cfg)


def hash_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                   cfg: HashGridConfig) -> torch.Tensor:
    """Plain table gradient: dtable[l, idx, f] += w·g by `index_add_`."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = x.shape[0]
    idx8, w8 = corner_indices_and_weights(x, cfg)               # (L, N, 8)
    g_lnf = g.reshape(N, L, F).permute(1, 0, 2)                 # (L, N, F)
    wg = (w8[..., None] * g_lnf[:, :, None, :]).reshape(L, N * 8, F)
    flat = (idx8 + torch.arange(L, device=x.device)[:, None, None] * T
            ).reshape(-1)
    dtable = torch.zeros(L * T, F, dtype=torch.float32, device=x.device)
    dtable.index_add_(0, flat, wg.reshape(-1, F).float())
    return dtable.reshape(L, T, F)


def _check_inputs(x: torch.Tensor, other: torch.Tensor, cfg: HashGridConfig,
                  other_shape) -> None:
    if x.dtype != torch.float32 or other.dtype != torch.float32:
        raise TypeError("hash-grid kernels take float32 tensors")
    if x.dim() != 2 or x.shape[1] != 3 or tuple(other.shape) != other_shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, "
                         f"other {tuple(other.shape)} != {other_shape}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError("hash-grid kernels take contiguous tensors")
    _build.check_cuda(x, other)
    if cfg.table_size * cfg.n_features_per_level * 4 > SMEM_BYTES:
        raise ValueError("one level of the table must fit shared memory")


@functools.lru_cache(maxsize=None)
def _level_arrays(cfg: HashGridConfig):
    """Per-level resolution and dense flag as C int arrays."""
    res = cfg.level_resolutions().astype(np.int32).tolist()
    dense = cfg.dense_levels().astype(np.int32).tolist()
    return (ctypes.c_int * len(res))(*res), (ctypes.c_int * len(dense))(*dense)


@functools.lru_cache(maxsize=None)
def _part_arrays(cfg: HashGridConfig, value_bytes: int):
    """(n_parts, [l0, nl, j0, nj] as C int arrays, the most (level, slot)
    pairs a part holds) of `table_parts(cfg, value_bytes)`."""
    parts = table_parts(cfg, value_bytes)
    cols = [(ctypes.c_int * len(parts))(*col) for col in zip(*parts)]
    return len(parts), cols, max(nl * nj for _, nl, _, nj in parts)


def grid_blocks(n: int, n_parts: int, resident: int, min_points: int,
                max_points: int = 0) -> int:
    """Blocks per part along x for n points: about one a resident block
    slot (`resident` for the card, shared by the parts), none with under
    `min_points` points and, where max_points > 0, none with over it; 0
    only for n = 0."""
    blocks = min(max(1, resident // n_parts), -(-n // min_points))
    if max_points:
        blocks = max(blocks, -(-n // max_points))
    return blocks


_P, _I, _L = _build.VOIDP, _build.INT, _build.LONG
# argument types of the C entry points; every pointer, also the stream, a
# void*
_SIGNATURES = {
    FWD: ([_P] * 3 + [_L] + [_I] * 3 + [_P] * 2 + [_I] + [_P] * 4 + [_L, _P],
          _I),
    FWD_LEVEL: ([_P] * 3 + [_L] + [_I] * 3 + [_P] * 3, _I),
    BWD: ([_P] * 4 + [_L] + [_I] * 3 + [_P] * 2 + [_I] + [_P] * 4 + [_L, _P],
          _I),
    "hashgrid_resident_blocks": ([_I] * 3 + [_P], _I),
    VARIANT: ([_P] * 4 + [_L] + [_I] * 3 + [_P] * 2 + [_I] * 2 + [_P], _I),
    SPLIT: ([_P] * 8 + [_L] + [_I] * 3 + [_P] * 2 + [_I] + [_P] * 4
            + [_L, _I, _P], _I),
}


_symbols: Dict[str, object] = {}


def _symbol(name: str):
    """The C entry point `name` of csrc/hashgrid.cu, typed."""
    fn = _symbols.get(name)
    if fn is None:
        fn = _symbols[name] = getattr(_build.load("hashgrid"), name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


@functools.lru_cache(maxsize=None)
def _resident(kernel: str, cfg: HashGridConfig, device: int) -> int:
    """Blocks of kernel #1 (FWD) or #2 (BWD) at `cfg` that card `device`
    holds at once, asked once; the query also opens the kernel's shared
    memory on that card, which its launches need."""
    value_bytes = FWD_VALUE_BYTES if kernel == FWD else BWD_VALUE_BYTES
    _, _, most = _part_arrays(cfg, value_bytes)
    blocks = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        err = _symbol("hashgrid_resident_blocks")(
            int(kernel == BWD), cfg.n_features_per_level, most,
            ctypes.addressof(blocks))
    _build.check(err, "hashgrid_resident_blocks")
    return blocks.value


def bwd_blocks(n: int, cfg: HashGridConfig, device: torch.device) -> int:
    """The blocks per part that kernel #2 runs for n points on the card
    `device` (a tensor's device, which has its index): the chunks of
    `hash_bwd_fixed_point_plain`."""
    return grid_blocks(n, _part_arrays(cfg, BWD_VALUE_BYTES)[0],
                       _resident(BWD, cfg, device.index), BWD_MIN_POINTS,
                       BWD_MAX_POINTS)


def hash_encode_cuda(x: torch.Tensor, table: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """Kernel #1: x (N, 3) f32 in [0, 1], table (L, T, F) f32 →
    (N, L·F) f32."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, table, cfg, (L, T, F))
    out = torch.empty((x.shape[0], L * F), dtype=torch.float32,
                      device=x.device)
    res_c, dense_c = _level_arrays(cfg)
    n_parts, cols, _ = _part_arrays(cfg, FWD_VALUE_BYTES)
    blocks = grid_blocks(x.shape[0], n_parts,
                         _resident(FWD, cfg, x.device.index), FWD_MIN_POINTS)
    err = _symbol(FWD)(x.data_ptr(), table.data_ptr(), out.data_ptr(),
                       x.shape[0], L, T, F, res_c, dense_c, n_parts, *cols,
                       blocks, _build.stream_ptr(x.device))
    _build.check(err, FWD)
    _build.count_launch(FWD)
    return out


def hash_encode_level_cuda(x: torch.Tensor, table: torch.Tensor,
                           cfg: HashGridConfig) -> torch.Tensor:
    """The level-per-block forward (the first #1), with #1's contract; only
    `chip_smoke.py` calls it, to time it beside #1."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, table, cfg, (L, T, F))
    out = torch.empty((x.shape[0], L * F), dtype=torch.float32,
                      device=x.device)
    res_c, dense_c = _level_arrays(cfg)
    err = _symbol(FWD_LEVEL)(x.data_ptr(), table.data_ptr(), out.data_ptr(),
                             x.shape[0], L, T, F, res_c, dense_c,
                             _build.stream_ptr(x.device))
    _build.check(err, FWD_LEVEL)
    _build.count_launch(FWD_LEVEL)
    return out


def hash_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """Kernel #2: x (N, 3), g (N, L·F) → (L, T, F) f32, equal to
    `hash_bwd_fixed_point_plain(x, g, cfg, bwd_blocks(N, cfg, x.device))`."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, g, cfg, (x.shape[0], L * F))
    n_parts, cols, most = _part_arrays(cfg, BWD_VALUE_BYTES)
    blocks = bwd_blocks(x.shape[0], cfg, x.device)
    partial = torch.empty((n_parts * blocks * most * F,),
                          dtype=torch.float32, device=x.device)
    dtable = torch.empty((L, T, F), dtype=torch.float32, device=x.device)
    res_c, dense_c = _level_arrays(cfg)
    err = _symbol(BWD)(x.data_ptr(), g.data_ptr(), dtable.data_ptr(),
                       partial.data_ptr(), x.shape[0], L, T, F, res_c,
                       dense_c, n_parts, *cols, blocks,
                       _build.stream_ptr(x.device))
    _build.check(err, BWD)
    _build.count_launch(BWD)
    return dtable


def fixed_point_exponent(gmax: torch.Tensor) -> torch.Tensor:
    """#2's exponent s per G = max |g| ≥ 0 (f32, finite): the largest
    s ≤ 126 with 2^s · G < 2^30, read off G's exponent bits; 0 for G = 0."""
    bits = gmax.float().contiguous().view(torch.int32).long()
    e = (bits >> 23) - 127                      # G < 2^(e + 1)
    s = torch.clamp(FIXED_POINT_BITS - 1 - e, max=126)
    return torch.where(bits == 0, torch.zeros_like(s), s)


def _pow2(s: torch.Tensor) -> torch.Tensor:
    """2^s as f32, exactly, for -126 ≤ s ≤ 127."""
    return ((s + 127) << 23).to(torch.int32).view(torch.float32)


def _chunks(n: int, blocks: int):
    """#2's chunks of points: [b·c, min(n, (b + 1)·c)) with c = ⌈n/blocks⌉."""
    c = -(-n // blocks) if blocks else 0
    return [(b * c, min(n, (b + 1) * c)) for b in range(blocks)]


def hash_bwd_fixed_point_plain(x: torch.Tensor, g: torch.Tensor,
                               cfg: HashGridConfig,
                               blocks: int) -> torch.Tensor:
    """Kernel #2's arithmetic in PyTorch: the N points cut into `blocks`
    chunks of ⌈N / blocks⌉; per chunk and level, s from G = max |g| over
    the finite g (`fixed_point_exponent`), every update v = rint(w·g_f ·
    2^s) of a finite g summed exactly in int64, the sums converted back
    (one f32 rounding, then · 2^-s), the updates w·g_f of a non-finite g
    added to them in f32, and the chunks' tables added in chunk order.
    (L, T, F) f32."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = x.shape[0]
    dev = x.device
    dtable = torch.zeros((L * T, F), dtype=torch.float32, device=dev)
    if N == 0:
        return dtable.reshape(L, T, F)
    idx8, w8 = corner_indices_and_weights(x, cfg)               # (L, N, 8)
    flat = idx8 + torch.arange(L, device=dev)[:, None, None] * T
    g_lnf = g.reshape(N, L, F).permute(1, 0, 2)                 # (L, N, F)
    for lo, hi in _chunks(N, blocks):
        if lo >= hi:
            continue
        gb = g_lnf[:, lo:hi]
        finite = torch.isfinite(gb)
        g_fin = torch.where(finite, gb, torch.zeros_like(gb))
        s = fixed_point_exponent(g_fin.abs().amax(dim=(1, 2)))  # (L,)
        v = w8[:, lo:hi, :, None] * g_fin[:, :, None, :]        # f32 w·g_f
        q = torch.round(v * _pow2(s)[:, None, None, None]).long()
        slots = flat[:, lo:hi].reshape(-1)
        sums = torch.zeros((L * T, F), dtype=torch.int64, device=dev)
        sums.index_add_(0, slots, q.reshape(-1, F))
        back = (sums.reshape(L, T, F).float() * _pow2(-s)[:, None, None]
                ).reshape(L * T, F)
        if not finite.all():
            odd = torch.where(finite, torch.zeros_like(gb), gb)
            back.index_add_(0, slots, (w8[:, lo:hi, :, None]
                                       * odd[:, :, None, :]).reshape(-1, F)
                            .float())
        dtable = dtable + back
    return dtable.reshape(L, T, F)


def _variant_mode(mode: str, points_per_block: int) -> int:
    """The kernel's code for `mode`; raises on an unknown mode or on a
    `points_per_block` that is not a positive multiple of 256."""
    if mode not in VARIANT_MODES:
        raise ValueError(f"unknown mode {mode!r}, not one of {VARIANT_MODES}")
    if (not isinstance(points_per_block, int) or points_per_block <= 0
            or points_per_block % THREADS):
        raise ValueError(f"points_per_block {points_per_block!r} is not a "
                         f"positive multiple of {THREADS}")
    return VARIANT_MODES.index(mode)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2³² for 0 ≤ h, c < 2³² in int64, without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _corner_hashes(n: int, device) -> torch.Tensor:
    """h = fmix32(p·8 + c), MurmurHash3's 32-bit finaliser
    (csrc/hashgrid.cu), for every (point, corner): (N·8,) int64 in
    [0, 2³²)."""
    h = torch.arange(n * 8, dtype=torch.int64, device=device)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def accum_stand_ins(n: int, table_size: int, device):
    """`accum`'s stand-in slots (N, 8) int64 and payloads (N, 8) f32, from
    h = `_corner_hashes`: the slot h & (T − 1) and the f32 with bits
    0x3F800000 | (h >> 9), in [1, 2)."""
    h = _corner_hashes(n, device)
    payload = ((h >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (h & (table_size - 1)).reshape(n, 8), payload.reshape(n, 8)


def _wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """An int64 sum ≥ 0 modulo 2³², as the int32 with the uint32's bits."""
    return (torch.remainder(s + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def hash_bwd_variant_plain(x: torch.Tensor, g: torch.Tensor,
                           cfg: HashGridConfig, mode: str = "full",
                           points_per_block: int = 8192):
    """Plain versions of the cost-split variants (`points_per_block` only
    cuts the kernel's work into blocks):
      full, global: the table gradient, `hash_bwd_plain`;
      addr: (Σ idx per level, int32 with the uint32 sum's bits, (L,);
             Σ w·g_f per level, (L, F) f32) over every (point, corner);
      accum: `index_add_` of the `accum_stand_ins` payloads into their
             slots, every level and feature alike, (L, T, F) f32."""
    _variant_mode(mode, points_per_block)
    if mode in ("full", "global"):
        return hash_bwd_plain(x, g, cfg)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = x.shape[0]
    if mode == "accum":
        slots, payload = accum_stand_ins(N, T, x.device)
        dtable = torch.zeros(T, F, dtype=torch.float32, device=x.device)
        dtable.index_add_(0, slots.reshape(-1),
                          payload.reshape(-1, 1).expand(-1, F))
        return dtable.expand(L, T, F).contiguous()
    g_lnf = g.reshape(N, L, F).permute(1, 0, 2)                 # (L, N, F)
    idx8, w8 = corner_indices_and_weights(x, cfg)               # (L, N, 8)
    wg = (w8[..., None] * g_lnf[:, :, None, :]).sum(dim=(1, 2))
    return _wrap_int32(idx8.sum(dim=(1, 2))), wg


def hash_bwd_variant_cuda(x: torch.Tensor, g: torch.Tensor,
                          cfg: HashGridConfig, mode: str = "full",
                          points_per_block: int = 8192):
    """Kernel variant `mode` of the table gradient (csrc/hashgrid.cu
    `hashgrid_bwd_variant`): x (N, 3), g (N, L·F) f32 → what
    `hash_bwd_variant_plain` returns. The outputs are zero-filled here, so
    a call costs a fill and the launch."""
    code = _variant_mode(mode, points_per_block)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, g, cfg, (x.shape[0], L * F))
    dtable = sums = None
    if mode == "addr":
        sums = torch.zeros((L, 1 + F), dtype=torch.int32, device=x.device)
    else:
        dtable = torch.zeros((L, T, F), dtype=torch.float32, device=x.device)
    res_c, dense_c = _level_arrays(cfg)
    err = _symbol(VARIANT)(x.data_ptr(), g.data_ptr(),
             None if dtable is None else dtable.data_ptr(),
             None if sums is None else sums.data_ptr(), x.shape[0], L, T, F,
             res_c, dense_c, code,
             points_per_block, _build.stream_ptr(x.device))
    _build.check(err, VARIANT)
    _build.count_launch(VARIANT)
    if sums is not None:
        return sums[:, 0], sums[:, 1:].view(torch.float32)
    return dtable


def split_blocks(n: int, cfg: HashGridConfig, factor: float,
                 resident: int) -> int:
    """Blocks a part of #2's grid at `factor` times the `resident` blocks
    of #2 (the card's, `_resident(BWD, ...)`): factor 1 gives #2's own
    grid, `bwd_blocks`."""
    return grid_blocks(n, _part_arrays(cfg, BWD_VALUE_BYTES)[0],
                       max(1, round(factor * resident)), BWD_MIN_POINTS,
                       BWD_MAX_POINTS)


def _split_mode(mode: str, n: int, blocks: int) -> int:
    """The kernel's code for `mode`; raises on an unknown mode or on a grid
    that is not #2's: `blocks` a part an int, 0 only for n = 0, with no
    block over BWD_MAX_POINTS points."""
    if mode not in SPLIT_MODES:
        raise ValueError(f"unknown mode {mode!r}, not one of {SPLIT_MODES}")
    if (not isinstance(blocks, int) or isinstance(blocks, bool)
            or blocks < 0 or blocks > 1 << 30 or (blocks == 0) != (n == 0)
            or (blocks and -(-n // blocks) > BWD_MAX_POINTS)):
        raise ValueError(f"blocks {blocks!r} a part is no grid of #2 for "
                         f"{n} points (at most {BWD_MAX_POINTS} a block)")
    return SPLIT_MODES.index(mode)


def _split_gmax_plain(g: torch.Tensor, cfg: HashGridConfig,
                      blocks: int) -> torch.Tensor:
    """Pass 1: (blocks, L) f32, each chunk's max |g| per level over its
    finite g, 0 where there is none."""
    L, F = cfg.n_levels, cfg.n_features_per_level
    gl = g.reshape(-1, L, F).abs()
    gl = torch.where(torch.isfinite(gl), gl, torch.zeros_like(gl))
    out = torch.zeros((blocks, L), dtype=torch.float32, device=g.device)
    for b, (lo, hi) in enumerate(_chunks(g.shape[0], blocks)):
        if lo < hi:
            out[b] = gl[lo:hi].amax(dim=(0, 2))
    return out


def _split_addr_plain(x: torch.Tensor, g: torch.Tensor, cfg: HashGridConfig,
                      blocks: int, gmax: torch.Tensor):
    """Pass 2 without the adds: per chunk and level, over the updates
    (point, corner, feature) the sum of the slot idx (int32, the uint32
    sum's bits) and of v = rint(w·g_f·2^s), s from `gmax` (int64); a
    non-finite g gives v = 0."""
    L, F = cfg.n_levels, cfg.n_features_per_level
    idx8, w8 = corner_indices_and_weights(x, cfg)               # (L, N, 8)
    g_lnf = g.reshape(-1, L, F).permute(1, 0, 2)                # (L, N, F)
    g_lnf = torch.where(torch.isfinite(g_lnf), g_lnf,
                        torch.zeros_like(g_lnf))
    scale = _pow2(fixed_point_exponent(gmax))                   # (blocks, L)
    isum = torch.zeros((blocks, L), dtype=torch.int64, device=x.device)
    vsum = torch.zeros((blocks, L), dtype=torch.int64, device=x.device)
    for b, (lo, hi) in enumerate(_chunks(x.shape[0], blocks)):
        if lo >= hi:
            continue
        v = w8[:, lo:hi, :, None] * g_lnf[:, lo:hi, None, :]    # f32 w·g_f
        q = torch.round(v * scale[b][:, None, None, None]).long()
        isum[b] = idx8[:, lo:hi].sum(dim=(1, 2)) * F
        vsum[b] = q.sum(dim=(1, 2, 3))
    return _wrap_int32(isum), vsum


def split_stand_ins(n: int, table_size: int, device):
    """The split's `accum` stand-ins from h = `_corner_hashes`: slots
    h & (T − 1) (N, 8) int64, as `accum_stand_ins`, and updates
    v = (int32)h >> 3 (N, 8) int64, of either sign and below 2^28."""
    h = _corner_hashes(n, device)
    signed = torch.where(h >= 2 ** 31, h - 2 ** 32, h)
    return ((h & (table_size - 1)).reshape(n, 8),
            (signed >> 3).reshape(n, 8))


def _split_accum_plain(n: int, cfg: HashGridConfig, blocks: int, device
                       ) -> torch.Tensor:
    """The shared adds and the conversion alone: the slices (n_parts,
    blocks, most·F) f32, (F, nl, nj) each, of every chunk's exact int64
    sums of the stand-in updates into their slots (every level and feature
    alike), converted once to f32 and · 2^-28; 0 past a part's words."""
    T, F = cfg.table_size, cfg.n_features_per_level
    parts = table_parts(cfg, BWD_VALUE_BYTES)
    most = max(nl * nj for _, nl, _, nj in parts)
    slots, v = split_stand_ins(n, T, device)
    out = torch.zeros((len(parts), blocks, most * F), dtype=torch.float32,
                      device=device)
    for b, (lo, hi) in enumerate(_chunks(n, blocks)):
        sums = torch.zeros((T,), dtype=torch.int64, device=device)
        if lo < hi:
            sums.index_add_(0, slots[lo:hi].reshape(-1), v[lo:hi].reshape(-1))
        back = sums.float() * 2.0 ** -STAND_IN_EXPONENT
        for k, (_, nl, j0, nj) in enumerate(parts):
            out[k, b, :nl * nj * F] = back[j0:j0 + nj].repeat(F * nl)
    return out


def _split_reduce_plain(partial: torch.Tensor, cfg: HashGridConfig
                        ) -> torch.Tensor:
    """The slices (n_parts, blocks, stride) added in block order from 0,
    each part's (F, nl, nj) values put back at their (level, slot,
    feature): (L, T, F) f32."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    dtable = torch.zeros((L, T, F), dtype=torch.float32,
                         device=partial.device)
    for k, (l0, nl, j0, nj) in enumerate(table_parts(cfg, BWD_VALUE_BYTES)):
        acc = torch.zeros((nl * nj * F,), dtype=torch.float32,
                          device=partial.device)
        for b in range(partial.shape[1]):
            acc = acc + partial[k, b, :nl * nj * F]
        dtable[l0:l0 + nl, j0:j0 + nj] = acc.reshape(F, nl, nj).permute(
            1, 2, 0)
    return dtable


def _split_partial_shape(cfg: HashGridConfig, blocks: int):
    n_parts, _, most = _part_arrays(cfg, BWD_VALUE_BYTES)
    return (n_parts, blocks, most * cfg.n_features_per_level)


def hash_bwd_split_plain(x: torch.Tensor, g: torch.Tensor,
                         cfg: HashGridConfig, mode: str, blocks: int,
                         gmax: torch.Tensor = None,
                         partial: torch.Tensor = None):
    """Plain versions of #2's parts on #2's grid of `blocks` a part:
      full: the table gradient, `hash_bwd_fixed_point_plain`;
      gmax: each chunk's max |g| per level, (blocks, L) f32;
      addr: (Σ idx (blocks, L) int32, Σ v (blocks, L) int64) over each
            chunk's updates, v with the exponents of `gmax` (default: this
            function's gmax);
      accum: the slices of the stand-in updates, (n_parts, blocks, most·F);
      reduce: `partial` (that shape) added in block order → (L, T, F)."""
    _split_mode(mode, x.shape[0], blocks)
    if mode == "full":
        return hash_bwd_fixed_point_plain(x, g, cfg, blocks)
    if mode == "gmax":
        return _split_gmax_plain(g, cfg, blocks)
    if mode == "addr":
        if gmax is None:
            gmax = _split_gmax_plain(g, cfg, blocks)
        return _split_addr_plain(x, g, cfg, blocks, gmax)
    if mode == "accum":
        return _split_accum_plain(x.shape[0], cfg, blocks, x.device)
    _check_partial(partial, cfg, blocks)
    return _split_reduce_plain(partial, cfg)


def _check_partial(partial: torch.Tensor, cfg: HashGridConfig,
                   blocks: int) -> None:
    shape = _split_partial_shape(cfg, blocks)
    if (partial is None or tuple(partial.shape) != shape
            or partial.dtype != torch.float32
            or not partial.is_contiguous()):
        raise ValueError(f"reduce takes contiguous f32 slices {shape}")


def hash_bwd_split_cuda(x: torch.Tensor, g: torch.Tensor,
                        cfg: HashGridConfig, mode: str, blocks: int,
                        gmax: torch.Tensor = None,
                        partial: torch.Tensor = None):
    """Kernel #11, `hashgrid_bwd_split`: part `mode` of #2 on #2's grid of
    `blocks` a part, x (N, 3), g (N, L·F) f32 → what `hash_bwd_split_plain`
    returns, bit for bit (full at `bwd_blocks` is #2, launch for launch).
    addr without `gmax` first runs gmax (counted apart); reduce needs
    `partial`."""
    code = _split_mode(mode, x.shape[0], blocks)
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, g, cfg, (x.shape[0], L * F))
    dev = x.device
    n_parts, cols, most = _part_arrays(cfg, BWD_VALUE_BYTES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dtable = gmax_out = idx = vs = None
    if mode in ("full", "reduce"):
        dtable = torch.empty((L, T, F), dtype=torch.float32, device=dev)
    if mode == "full" or mode == "accum":
        partial = torch.empty(_split_partial_shape(cfg, blocks),
                              dtype=torch.float32, device=dev)
    elif mode == "reduce":
        _check_partial(partial, cfg, blocks)
        _build.check_cuda(x, partial)
    if mode == "gmax":
        gmax_out = torch.empty((blocks, L), dtype=torch.float32, device=dev)
    if mode == "addr":
        if gmax is None:
            gmax = hash_bwd_split_cuda(x, g, cfg, "gmax", blocks)
        if tuple(gmax.shape) != (blocks, L) or not gmax.is_contiguous():
            raise ValueError(f"addr takes gmax ({blocks}, {L}) f32")
        _build.check_cuda(x, gmax)
        idx = torch.zeros((blocks, L), dtype=torch.int32, device=dev)
        vs = torch.zeros((blocks, L), dtype=torch.int64, device=dev)
    res_c, dense_c = _level_arrays(cfg)
    err = _symbol(SPLIT)(
        x.data_ptr(), g.data_ptr(), ptr(dtable), ptr(partial),
        ptr(gmax if mode == "addr" else None), ptr(gmax_out), ptr(idx),
        ptr(vs), x.shape[0], L, T, F, res_c, dense_c, n_parts, *cols,
        blocks, code, _build.stream_ptr(dev))
    _build.check(err, SPLIT)
    _build.count_launch(SPLIT)
    return {"full": dtable, "reduce": dtable, "gmax": gmax_out,
            "addr": (idx, vs), "accum": partial}[mode]


def hash_bwd_split(x, g, cfg, mode, blocks, gmax=None, partial=None):
    if x.is_cuda:
        return hash_bwd_split_cuda(x, g, cfg, mode, blocks, gmax, partial)
    return hash_bwd_split_plain(x, g, cfg, mode, blocks, gmax, partial)


def hash_bwd_variant(x, g, cfg, mode="full", points_per_block=8192):
    if x.is_cuda:
        return hash_bwd_variant_cuda(x, g, cfg, mode, points_per_block)
    return hash_bwd_variant_plain(x, g, cfg, mode, points_per_block)


def hash_encode_fwd(x, table, cfg):
    if x.is_cuda:
        return hash_encode_cuda(x, table, cfg)
    return hash_encode_plain(x, table, cfg)


def hash_encode_bwd(x, g, cfg):
    if x.is_cuda:
        return hash_bwd_cuda(x, g, cfg)
    return hash_bwd_plain(x, g, cfg)


class HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, cfg):
        x = x.detach().contiguous()
        ctx.save_for_backward(x)
        ctx.cfg = cfg
        ctx.table_dtype = table.dtype
        return hash_encode_fwd(x, table.detach().float().contiguous(), cfg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dtable = hash_encode_bwd(x, g.float().contiguous(), ctx.cfg)
        return None, dtable.to(ctx.table_dtype), None


def hash_encode_auto(x: torch.Tensor, table: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """x (N, 3) in [0,1]³, table (L, T, F) → (N, L·F); gradient w.r.t. the
    table only."""
    return HashEncode.apply(x, table, cfg)
