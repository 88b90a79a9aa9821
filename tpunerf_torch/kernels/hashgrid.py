"""Hash-grid encode: CUDA kernels (csrc/hashgrid.cu) and their plain
PyTorch versions.

`hash_encode_auto` is what the field calls. On CUDA tensors it runs
`HashEncode`, whose forward and backward are the hand-written kernels; on
CPU tensors the same autograd function runs the plain versions. The
backward returns the table gradient only: ray positions are not trained,
so dx ≡ 0, as in the JAX package's custom VJP.

`hash_bwd_variant` runs the table gradient's cost-split variants of the
same kernel file (full, global, addr, accum); only the experiment
`python -m tpunerf_torch.scripts.exp_hash_bwd` calls it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpunerf_torch.fields.encoding import (HashGridConfig,
                                           corner_indices_and_weights,
                                           hash_encode)
from tpunerf_torch.kernels import _build

FWD = "hashgrid_fwd"
BWD = "hashgrid_bwd"
# the table gradient's cost-split experiment (tpunerf_torch/scripts/
# exp_hash_bwd.py): kernel modes in the order of their codes
VARIANT = "hashgrid_bwd_variant"
VARIANT_MODES = ("full", "global", "addr", "accum")
THREADS = 256                 # threads per block of the kernels


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
    if cfg.table_size * cfg.n_features_per_level * 4 > 227 * 1024:
        raise ValueError("one level of the table must fit shared memory")


def _level_arrays(cfg: HashGridConfig):
    """Per-level resolution and dense flag as C int arrays."""
    res = cfg.level_resolutions().astype(np.int32).tolist()
    dense = cfg.dense_levels().astype(np.int32).tolist()
    return (ctypes.c_int * len(res))(*res), (ctypes.c_int * len(dense))(*dense)


def _launch(symbol: str, x: torch.Tensor, other: torch.Tensor,
            out: torch.Tensor, cfg: HashGridConfig) -> None:
    """Launch `hashgrid_fwd` (other = table) or `hashgrid_bwd` (other = g)
    of csrc/hashgrid.cu; both take (x, other, out, n, L, T, F, res, dense,
    stream)."""
    fn = getattr(_build.load("hashgrid"), symbol)
    fn.argtypes = [_build.VOIDP] * 3 + [_build.LONG] + [_build.INT] * 3 \
        + [_build.VOIDP] * 3
    fn.restype = _build.INT
    res_c, dense_c = _level_arrays(cfg)
    err = fn(x.data_ptr(), other.data_ptr(), out.data_ptr(), x.shape[0],
             cfg.n_levels, cfg.table_size, cfg.n_features_per_level,
             ctypes.addressof(res_c), ctypes.addressof(dense_c),
             _build.stream_ptr(x.device))
    _build.check(err, symbol)
    _build.count_launch(symbol)


def hash_encode_cuda(x: torch.Tensor, table: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """Kernel forward: x (N, 3) f32 in [0, 1], table (L, T, F) f32 →
    (N, L·F) f32."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, table, cfg, (L, T, F))
    out = torch.empty((x.shape[0], L * F), dtype=torch.float32,
                      device=x.device)
    _launch(FWD, x, table, out, cfg)
    return out


def hash_bwd_cuda(x: torch.Tensor, g: torch.Tensor,
                  cfg: HashGridConfig) -> torch.Tensor:
    """Kernel table gradient: x (N, 3), g (N, L·F) → (L, T, F) f32."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    _check_inputs(x, g, cfg, (x.shape[0], L * F))
    dtable = torch.zeros((L, T, F), dtype=torch.float32, device=x.device)
    _launch(BWD, x, g, dtable, cfg)
    return dtable


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


def accum_stand_ins(n: int, table_size: int, device):
    """`accum`'s stand-in slots (N, 8) int64 and payloads (N, 8) f32, from
    h = fmix32(p·8 + c), MurmurHash3's 32-bit finaliser (csrc/hashgrid.cu):
    the slot h & (T − 1) and the f32 with bits 0x3F800000 | (h >> 9), in
    [1, 2)."""
    h = torch.arange(n * 8, dtype=torch.int64, device=device)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
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
    fn = _build.load("hashgrid").hashgrid_bwd_variant
    fn.argtypes = [_build.VOIDP] * 4 + [_build.LONG] + [_build.INT] * 3 \
        + [_build.VOIDP] * 2 + [_build.INT] * 2 + [_build.VOIDP]
    fn.restype = _build.INT
    res_c, dense_c = _level_arrays(cfg)
    err = fn(x.data_ptr(), g.data_ptr(),
             None if dtable is None else dtable.data_ptr(),
             None if sums is None else sums.data_ptr(), x.shape[0], L, T, F,
             ctypes.addressof(res_c), ctypes.addressof(dense_c), code,
             points_per_block, _build.stream_ptr(x.device))
    _build.check(err, VARIANT)
    _build.count_launch(VARIANT)
    if sums is not None:
        return sums[:, 0], sums[:, 1:].view(torch.float32)
    return dtable


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
