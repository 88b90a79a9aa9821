"""Bit-packed occupancy lookup: the CUDA kernel (csrc/occgrid.cu) and its
plain PyTorch version.

The thresholded (G³,) grid is packed z-minor into G³/32 32-bit words
(stored as int32): bit i of word w is cell w·32 + i. The packed field is
rebuilt only when the grid is refreshed.

The kernel takes four samples a thread with 16-byte loads where xyz starts
on 16 bytes, else one (`_lookup_plan`), and multiplies by 1/bound and 0.5
in place of the two quotients where bound is a power of two
(`_pow2_bound`): the same bits, since each product is the correctly
rounded value of the quotient's real number. `_kernel_cell_index` is that
arithmetic in PyTorch, for the tests.
"""
from __future__ import annotations

import math
import struct
from typing import Tuple

import torch

from tpunerf_torch.kernels import _build

LOOKUP = "occgrid_lookup"
LOOKUP_SCALAR = "occgrid_lookup_scalar"   # the first design, timed only


def pack_bits(occ: torch.Tensor) -> torch.Tensor:
    """(G³,) bool, z-minor → (G³/32,) int32 words (uint32 bit patterns)."""
    n = occ.shape[0]
    if n % 32:
        raise ValueError(f"cell count {n} is not a multiple of 32")
    bits = occ.reshape(n // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=occ.device)
    words = torch.sum(bits << shifts, dim=-1)                 # < 2³²
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def cell_index(x: torch.Tensor, grid_res: int, bound: float) -> torch.Tensor:
    """World xyz (..., 3) → flat z-minor cell index (...,), int64 — the
    index of fields/occupancy.py:lookup. The divisor is a tensor so that
    the card, too, divides (it multiplies by the reciprocal of a Python
    scalar)."""
    return _flat_index((x / x.new_full((), bound) + 1.0) / 2.0, grid_res)


def _flat_index(u: torch.Tensor, G: int) -> torch.Tensor:
    """Unit coordinates (..., 3) → truncate u·G, clamp, flat z-minor."""
    idx = torch.clamp((u * G).to(torch.int32), 0, G - 1).to(torch.int64)
    return (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2]


def _f32(v: float) -> float:
    return struct.unpack("f", struct.pack("f", v))[0]


def _pow2_bound(bound: float) -> bool:
    """True where the f32 bound is ±2^k and its reciprocal a finite f32:
    then x·(1/bound) equals x/bound bit for bit."""
    b = _f32(bound)
    if b == 0 or not math.isfinite(b) or abs(math.frexp(b)[0]) != 0.5:
        return False
    inv = 1.0 / b                       # exact: a power of two
    return math.isfinite(_f32(inv)) and _f32(inv) == inv


def _lookup_plan(ptr: int, bound: float) -> Tuple[bool, bool]:
    """(vec, pow2) of the kernel: four samples a thread where xyz starts on
    16 bytes (the ragged tail one a thread), else one; products where the
    bound is a power of two, else quotients."""
    return ptr % 16 == 0, _pow2_bound(bound)


def _kernel_cell_index(x: torch.Tensor, grid_res: int, bound: float
                       ) -> torch.Tensor:
    """`cell_index` in the kernel's arithmetic: x·(1/bound), +1, ·0.5 where
    `_pow2_bound`, else the quotients."""
    if not _pow2_bound(bound):
        return cell_index(x, grid_res, bound)
    return _flat_index((x * (1.0 / _f32(bound)) + 1.0) * 0.5, grid_res)


def occupancy_lookup_plain(x: torch.Tensor, packed: torch.Tensor,
                           grid_res: int, bound: float) -> torch.Tensor:
    """x (..., 3) world coords, packed (G³/32,) int32 → bool (...,)."""
    flat = cell_index(x, grid_res, bound)
    words = packed.to(torch.int64)[flat >> 5]
    return ((words >> (flat & 31)) & 1).to(torch.bool)


def _lookup_operands(x: torch.Tensor, packed: torch.Tensor, grid_res: int
                     ) -> torch.Tensor:
    """Check the operands; → x as (n, 3), a view where x is contiguous."""
    if x.dtype != torch.float32 or packed.dtype != torch.int32:
        raise TypeError("occupancy lookup takes float32 xyz and int32 words")
    if x.shape[-1] != 3 or packed.shape != (grid_res ** 3 // 32,):
        raise ValueError(f"bad shapes x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("packed words must be contiguous")
    return x.reshape(-1, 3).contiguous()


def _lookup_call(name: str, x: torch.Tensor, packed: torch.Tensor,
                 grid_res: int, bound: float) -> torch.Tensor:
    xf = _lookup_operands(x, packed, grid_res)
    _build.check_cuda(x, packed)
    n = xf.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=x.device)
    fn = getattr(_build.load("occgrid"), name)
    args = [xf.data_ptr(), packed.data_ptr(), out.data_ptr(), n, grid_res,
            float(bound)]
    types = [_build.VOIDP] * 3 + [_build.LONG, _build.INT, _build.FLOAT]
    if name == LOOKUP:
        args += [int(flag) for flag in _lookup_plan(xf.data_ptr(), bound)]
        types += [_build.INT, _build.INT]
    fn.argtypes = types + [_build.VOIDP]
    fn.restype = _build.INT
    _build.check(fn(*args, _build.stream_ptr(x.device)), name)
    _build.count_launch(name)
    return out.view(torch.bool).reshape(x.shape[:-1])


def occupancy_lookup_cuda(x: torch.Tensor, packed: torch.Tensor,
                          grid_res: int, bound: float) -> torch.Tensor:
    """Kernel #3."""
    return _lookup_call(LOOKUP, x, packed, grid_res, bound)


def occupancy_lookup_scalar_cuda(x: torch.Tensor, packed: torch.Tensor,
                                 grid_res: int, bound: float) -> torch.Tensor:
    """The first design of #3 (a sample a thread, six quotients), with #3's
    contract; only `chip_smoke.py` and the card tests call it."""
    return _lookup_call(LOOKUP_SCALAR, x, packed, grid_res, bound)


def occupancy_lookup(x: torch.Tensor, packed: torch.Tensor, grid_res: int,
                     bound: float) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if x.is_cuda:
        return occupancy_lookup_cuda(x, packed, grid_res, bound)
    return occupancy_lookup_plain(x, packed, grid_res, bound)
