"""Triangle rasterization: the visible-face selection kernels and the DIB-R
soft-silhouette kernels (csrc/rasterize.cu) with their plain PyTorch
versions, and the differentiable interpolation around them.

The rasterizer is split into

1. a selection pass (no gradient): per pixel the id of the visible face —
   highest interpolated z among the faces that cover the pixel centre
   (edges inclusive), lowest id on exact ties, −1 for background. Faces are
   pre-reduced to rows of 12 affine coefficients (`_face_rows`); at renders
   of ≥ 128² pixels with many faces the sweep runs per 1024-pixel band over
   that band's own bin of K faces (`_bin_faces`), and falls back to the
   dense sweep when a bin overflows. Both kernels skip, per warp tile of 32
   pixels, the faces with an edge form < 0 at the tile box's worst corner,
   which can hit none of its pixels; `_sel_tile_boxes` and `_sel_kept` are
   that rule in PyTorch;
2. a differentiable pass (`_interp_selected`): gather the winning face and
   recompute barycentrics with autograd.

Conventions: image coords are NDC in [−1, 1], +y up; pixel (i, j) has
centre ((j+.5)/W·2−1, 1−(i+.5)/H·2). Camera-space z is negative in front of
the camera and the largest interpolated z wins. Attributes are interpolated
in image space.

The soft silhouette (`soft_silhouette`, `dibr_rasterization`) is
1 − ∏_f (1 − p_f) per pixel, with p_f = 1 inside face f and exp(−d²/σ) of
the squared distance to its nearest edge outside. Faces are pre-reduced to
rows of 16 floats (`_soft_rows`); forward and backward are kernels (dense
and band-binned, as the selection) behind one `autograd.Function`, whose
backward is the closed-form vertex gradient. The forward kernels skip,
per warp tile of 32 pixels, the faces whose vertex box widened by
√(27.7·σ) the tile lies outside, where every factor is exactly 1.0f, but
never a sliver, whose rounded inside test can hold far from the face;
`_soft_cull_boxes`, `_soft_tile_pixels`, `_soft_tile_boxes` and
`_soft_kept` are that rule in PyTorch, for the tests and the pair counts
of `chip_smoke.py`. Both backward kernels skip by the same rule against
the box of a tile's live pixels (g·prod ≠ 0), where each skipped share is
below |g·prod|·2e^−27.7·m/σ, skip tiles with no live pixel whole, and sum
to faces in a fixed order (`_soft_bwd_kept` and `_slots_to_faces_ordered`
are the binned one's twins, `_soft_bwd_dense_kept` the dense one's).
"""
from __future__ import annotations

import functools
import struct
from typing import Optional, Tuple

import torch

from tpunerf_torch.fields.volume_render import pixel_grid_ndc as _pixel_grid
from tpunerf_torch.kernels import _build

DENSE = "select_faces_dense"
BINNED = "select_faces_binned"
# the all-pairs designs of the selection kernels, timed only
DENSE_SWEEP = "select_faces_dense_sweep"
BINNED_SWEEP = "select_faces_binned_sweep"
SOFT_FWD_DENSE = "soft_fwd_dense"
SOFT_FWD_BINNED = "soft_fwd_binned"
SOFT_BWD_DENSE = "soft_bwd_dense"
SOFT_BWD_BINNED = "soft_bwd_binned"
# the all-pairs designs of the soft kernels, timed only
SOFT_FWD_DENSE_SWEEP = "soft_fwd_dense_sweep"
SOFT_FWD_BINNED_SWEEP = "soft_fwd_binned_sweep"
SOFT_BWD_DENSE_SWEEP = "soft_bwd_dense_sweep"
SOFT_BWD_BINNED_SWEEP = "soft_bwd_binned_sweep"

_EPS = 1e-10
_BAND = 1024                 # pixels per band (row-major)
_BIN_K = 256                 # faces per band bin
# the soft silhouette's bins are wider: its y-range test grows by the tail
# margin √(27.7·σ), which adds faces to every band
_SOFT_BIN_K = 768
# exp(−d²/σ) < 1e-12 beyond d = √(27.7·σ): a face farther than that from a
# band adds nothing to its probabilities or gradients above f32 rounding
_SOFT_TAIL = 27.7
# a face with |2·area| < 2^−10 · (longest edge)², i.e. sin(smallest angle)
# under ~1e-3, is a sliver: its two long edge forms round to ≥ 0 at pixels
# well beyond its tip, so the cull keeps it everywhere (see _soft_cull_boxes)
_SOFT_SLIVER = 2.0 ** -10
_BIN_MIN_PIXELS = 128 * 128  # binning engages at ≥128² renders
# elements of one (faces, pixels) block of the plain sweeps
_PLAIN_BLOCK = 1 << 22



@functools.lru_cache(maxsize=16)
def pixel_grid_ndc(height: int, width: int, device: torch.device
                   ) -> torch.Tensor:
    """(H·W, 2) pixel-centre NDC coordinates, row-major, +y up. Cached per
    size and device, so a render finds its grid on the device."""
    return _pixel_grid(height, width, torch.device(device))


# --------------------------------------------------------------------------
# face rows
# --------------------------------------------------------------------------

def _face_rows(fv_img: torch.Tensor, fv_z: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 2), (..., F, 3), (..., F) → (..., F, 12) affine coeffs
    [e0x,e0y,e0c, e1…, e2…, zx,zy,zc], sign-normalised so that inside ⇔ all
    edge functions ≥ 0; invalid/degenerate faces get edge0 ≡ −1 so they can
    never win a pixel."""
    v0, v1, v2 = fv_img[..., 0, :], fv_img[..., 1, :], fv_img[..., 2, :]

    def edge(a, b):
        ex = -(b[..., 1] - a[..., 1])
        ey = b[..., 0] - a[..., 0]
        ec = ((b[..., 1] - a[..., 1]) * a[..., 0]
              - (b[..., 0] - a[..., 0]) * a[..., 1])
        return torch.stack([ex, ey, ec], dim=-1)

    e0, e1, e2 = edge(v1, v2), edge(v2, v0), edge(v0, v1)
    denom = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
             - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    s = torch.sign(denom)[..., None]
    ok = valid & (denom.abs() > _EPS)
    e0, e1, e2 = e0 * s, e1 * s, e2 * s
    ad = torch.where(ok, denom.abs(), torch.ones_like(denom))[..., None]
    z = (e0 * fv_z[..., 0:1] + e1 * fv_z[..., 1:2]
         + e2 * fv_z[..., 2:3]) / ad
    okk = ok[..., None]
    zero = torch.zeros_like(e0)
    e0 = torch.where(okk, e0, _filler_row(e0.device)[:3])
    e1 = torch.where(okk, e1, zero)
    e2 = torch.where(okk, e2, zero)
    z = torch.where(okk, z, zero)
    return torch.cat([e0, e1, e2, z], dim=-1)


@functools.lru_cache(maxsize=8)
def _filler_row(device: torch.device) -> torch.Tensor:
    """The never-wins row: edge0 ≡ −1."""
    row = torch.zeros(12, dtype=torch.float32, device=device)
    row[2] = -1.0
    return row


# --------------------------------------------------------------------------
# the sweep: plain versions
# --------------------------------------------------------------------------

def _sweep_plain(tab: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 best_z: torch.Tensor, best_i: torch.Tensor, id0: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of rows against the pixels. tab (..., Fc, 12); px, py
    (..., 1, Pn); best_z/best_i (..., Pn). The rows carry ids id0, id0+1, …
    Each affine form is (a·px + b·py) + c in separate f32 operations — the
    order the kernel keeps with round-to-nearest intrinsics."""
    t = tab.unsqueeze(-1)                                   # (..., Fc, 12, 1)

    def affine(i):
        return t[..., i, :] * px + t[..., i + 1, :] * py + t[..., i + 2, :]

    hit = (affine(0) >= 0.0) & (affine(3) >= 0.0) & (affine(6) >= 0.0)
    z = affine(9)
    # a NaN z never wins (it fails the kernel's `z > best`)
    z = torch.where(hit & (z == z), z, z.new_full((), -torch.inf))
    zbest = z.max(dim=-2).values                            # (..., Pn)
    ids = torch.arange(id0, id0 + tab.shape[-2], dtype=torch.int32,
                       device=tab.device)[:, None]
    big = torch.iinfo(torch.int32).max
    first = torch.where(z == zbest.unsqueeze(-2), ids,
                        ids.new_full((), big)).min(dim=-2).values
    take = zbest > best_z          # strict: earlier (lower) ids keep ties
    return torch.where(take, zbest, best_z), torch.where(take, first, best_i)


def select_faces_dense_plain(rows: torch.Tensor, pix: torch.Tensor
                             ) -> torch.Tensor:
    """rows (B, F, 12), pix (P, 2) → winning face id (B, P) int32, −1 =
    background. Chunked over faces to bound memory."""
    B, F, _ = rows.shape
    P = pix.shape[0]
    px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
    best_z = rows.new_full((B, P), -torch.inf)
    best_i = torch.full((B, P), -1, dtype=torch.int32, device=rows.device)
    chunk = max(1, _PLAIN_BLOCK // max(B * P, 1))
    for f0 in range(0, F, chunk):
        best_z, best_i = _sweep_plain(rows[:, f0:f0 + chunk], px, py, best_z,
                                      best_i, f0)
    return best_i


def _band_pixels(pix: torch.Tensor, nb: int, pad_value: float = 2.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pix (P, 2) → px, py (nb, 1024); pixels past the image sit outside
    NDC (at `pad_value`) so they hit nothing."""
    pad = nb * _BAND - pix.shape[0]
    pixp = torch.nn.functional.pad(pix, (0, 0, 0, pad), value=pad_value)
    return pixp[:, 0].reshape(nb, _BAND), pixp[:, 1].reshape(nb, _BAND)


def select_faces_binned_plain(rows: torch.Tensor, ids: torch.Tensor,
                              pix: torch.Tensor) -> torch.Tensor:
    """rows (B, F+1, 12) with the filler last, ids (B, nb, K) row index per
    bin slot, pix (P, 2) → winning *slot* (B, nb, 1024) int32, −1 =
    background. Chunked over slots to bound memory."""
    B, nb, K = ids.shape
    px, py = (a[None, :, None, :] for a in _band_pixels(pix, nb))
    best_z = rows.new_full((B, nb, _BAND), -torch.inf)
    best_i = torch.full((B, nb, _BAND), -1, dtype=torch.int32,
                        device=rows.device)
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    chunk = max(1, _PLAIN_BLOCK // (B * nb * _BAND))
    for k0 in range(0, K, chunk):
        tab = rows[bidx, ids[:, :, k0:k0 + chunk].long()]   # (B, nb, Kc, 12)
        best_z, best_i = _sweep_plain(tab, px, py, best_z, best_i, k0)
    return best_i


# --------------------------------------------------------------------------
# the sweep: kernels
# --------------------------------------------------------------------------

def _check_rows(rows: torch.Tensor, pix: torch.Tensor) -> None:
    if rows.dtype != torch.float32 or pix.dtype != torch.float32:
        raise TypeError("face selection takes float32 rows and pixels, got "
                        f"{rows.dtype}, {pix.dtype}")
    if rows.dim() != 3 or rows.shape[-1] != 12 or pix.dim() != 2 \
            or pix.shape[-1] != 2:
        raise ValueError(f"face selection takes rows (B, F, 12) and pix "
                         f"(P, 2), got {tuple(rows.shape)}, "
                         f"{tuple(pix.shape)}")
    if not (rows.is_contiguous() and pix.is_contiguous()
            and rows.data_ptr() % 16 == 0):
        raise ValueError("face rows and pixels must be contiguous and the "
                         "rows 16-byte aligned")


def _check_ids(rows: torch.Tensor, ids: torch.Tensor, pix: torch.Tensor
               ) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 3 \
            or ids.shape[0] != rows.shape[0] or not ids.is_contiguous():
        raise ValueError("bin ids must be contiguous int32 (B, nb, K), got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if ids.shape[1] * _BAND < pix.shape[0]:
        raise ValueError(f"{ids.shape[1]} bands do not cover {pix.shape[0]} "
                         "pixels")


def _entry(name: str, ptrs: int, ints: int, floats: int = 0):
    """The C entry `name` of csrc/rasterize.cu taking `ptrs` pointers,
    `ints` ints, `floats` floats and the stream."""
    fn = getattr(_build.load("rasterize"), name)
    fn.argtypes = ([_build.VOIDP] * ptrs + [_build.INT] * ints
                   + [_build.FLOAT] * floats + [_build.VOIDP])
    fn.restype = _build.INT
    return fn


def select_faces_dense_cuda(rows: torch.Tensor, pix: torch.Tensor,
                            width: int = 0) -> torch.Tensor:
    """Kernel #5, culled by warp tiles of 8 × 4 pixels where `width` (the
    image's) allows, else 32 in a row."""
    _check_rows(rows, pix)
    _build.check_cuda(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    out = torch.empty((B, P), dtype=torch.int32, device=rows.device)
    err = _entry(DENSE, 3, 4)(
        rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
        _soft_tile_width(P, width, False), _build.stream_ptr(rows.device))
    _build.check(err, DENSE)
    _build.count_launch(DENSE)
    return out


def select_faces_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                             pix: torch.Tensor, width: int = 0
                             ) -> torch.Tensor:
    """Kernel #6, culled by warp tiles of 16 × 2 pixels at a width of 512
    (see `_soft_tile_width`)."""
    _check_rows(rows, pix)
    _check_ids(rows, ids, pix)
    _build.check_cuda(rows, ids, pix)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    P = pix.shape[0]
    out = torch.empty((B, nb, _BAND), dtype=torch.int32, device=rows.device)
    err = _entry(BINNED, 4, 6)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
        B, Fr, nb, K, P, _soft_tile_width(P, width, True),
        _build.stream_ptr(rows.device))
    _build.check(err, BINNED)
    _build.count_launch(BINNED)
    return out


def select_faces_dense_sweep_cuda(rows: torch.Tensor, pix: torch.Tensor
                                  ) -> torch.Tensor:
    """The all-pairs #5 (every pair evaluated), with #5's contract; only
    `chip_smoke.py` and the card tests call it, to time and check it beside
    #5."""
    _check_rows(rows, pix)
    _build.check_cuda(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    out = torch.empty((B, P), dtype=torch.int32, device=rows.device)
    err = _entry(DENSE_SWEEP, 3, 3)(
        rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
        _build.stream_ptr(rows.device))
    _build.check(err, DENSE_SWEEP)
    _build.count_launch(DENSE_SWEEP)
    return out


def select_faces_binned_sweep_cuda(rows: torch.Tensor, ids: torch.Tensor,
                                   pix: torch.Tensor) -> torch.Tensor:
    """The all-pairs #6 (every slot at every band pixel), with #6's
    contract; timed and checked beside #6 only."""
    _check_rows(rows, pix)
    _check_ids(rows, ids, pix)
    _build.check_cuda(rows, ids, pix)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    out = torch.empty((B, nb, _BAND), dtype=torch.int32, device=rows.device)
    err = _entry(BINNED_SWEEP, 4, 5)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
        B, Fr, nb, K, pix.shape[0], _build.stream_ptr(rows.device))
    _build.check(err, BINNED_SWEEP)
    _build.count_launch(BINNED_SWEEP)
    return out


def select_faces_dense(rows: torch.Tensor, pix: torch.Tensor,
                       width: int = 0) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `width`, the
    image's, only shapes the kernel's tiles."""
    if rows.is_cuda:
        return select_faces_dense_cuda(rows, pix, width)
    return select_faces_dense_plain(rows, pix)


def select_faces_binned(rows: torch.Tensor, ids: torch.Tensor,
                        pix: torch.Tensor, width: int = 0) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors. `width`, the
    image's, only shapes the kernel's tiles."""
    if rows.is_cuda:
        return select_faces_binned_cuda(rows, ids, pix, width)
    return select_faces_binned_plain(rows, ids, pix)


# --------------------------------------------------------------------------
# the selection kernels' cull, in PyTorch
# --------------------------------------------------------------------------

def _sel_tile_boxes(pix: torch.Tensor, width: int, banded: bool = False
                    ) -> torch.Tensor:
    """(T, 4) [xmin, xmax, ymin, ymax] of the selection kernels' warp
    tiles, tile-major as they number them: dense, the box of each tile's
    live pixels; banded, of all 32 pixels of each band tile, those past the
    image at (2, 2) (the kernel sweeps them, as the plain version does)."""
    P = pix.shape[0]
    if not banded:
        return _soft_tile_boxes(pix, _soft_tile_pixels(P, width, False,
                                                       pix.device))
    nb = -(-P // _BAND)
    px, py = _band_pixels(pix, nb)
    padded = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1)
    tiles = _soft_tile_pixels(nb * _BAND, _soft_tile_width(P, width, True),
                              True, pix.device)
    return _soft_tile_boxes(padded, tiles)


def _sel_kept(rows: torch.Tensor, tile_boxes: torch.Tensor) -> torch.Tensor:
    """(..., F, 12) face rows against (..., T, 4) tile boxes → (..., T, F)
    True where the kernels evaluate the pair: none of the three edge forms
    (a, b, c) is < 0 at the box's worst corner x = (a ≥ 0 ? xmax : xmin),
    y = (b ≥ 0 ? ymax : ymin), in the sweep's f32 order (a NaN there keeps
    the pair). The twin of csrc/rasterize.cu:face_out."""
    e = rows[..., None, :, :9].unflatten(-1, (3, 3))        # (..., 1, F, 3, 3)
    t = tile_boxes[..., :, None, None, :]                    # (..., T, 1, 1, 4)
    a, b, c = e[..., 0], e[..., 1], e[..., 2]
    x = torch.where(a >= 0, t[..., 1], t[..., 0])
    y = torch.where(b >= 0, t[..., 3], t[..., 2])
    return ~((a * x + b * y + c) < 0).any(dim=-1)


# --------------------------------------------------------------------------
# band bins
# --------------------------------------------------------------------------

def _band_ranges(height: int, width: int, nb: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-band pixel-centre y-ranges (ylo, yhi) for nb bands of 1024
    row-major pixels. The boundary rows come from the same f32 operations
    as `pixel_grid_ndc`, so a face whose bbox-y extreme lies exactly on a
    boundary pixel centre is not dropped by a rounding difference."""
    b = torch.arange(nb, device=device)
    r0 = (b * _BAND) // width
    r1 = torch.clamp(((b + 1) * _BAND - 1) // width, max=height - 1)
    ys = 1.0 - (torch.arange(height, dtype=torch.float32, device=device)
                + 0.5) / height * 2.0
    return ys[r1], ys[r0]


def _bin_faces(fv_img: torch.Tensor, valid: torch.Tensor, ylo: torch.Tensor,
               yhi: torch.Tensor, K: int, margin: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-band first-K face ids, ascending. fv_img (B, F, 3, 2), valid
    (B, F), ylo/yhi (nb,) → ids (B, nb, K) int32, slot-padded with the
    filler id F, and the largest per-band count (0-dim tensor). A stable
    compaction: rank by a running count, scatter the first K. `margin`
    widens each face's y-range on both sides (the soft silhouette's
    tail)."""
    B, F = valid.shape
    nb = ylo.shape[0]
    fy = fv_img[..., 1]
    fymin, fymax = fy.min(dim=-1).values, fy.max(dim=-1).values  # (B, F)
    if margin:
        fymin, fymax = fymin - margin, fymax + margin
    mask = ((fymax[:, None, :] >= ylo[None, :, None])
            & (fymin[:, None, :] <= yhi[None, :, None])
            & valid[:, None, :])                                  # (B, nb, F)
    rank = torch.cumsum(mask, dim=-1) - 1
    slot = torch.where(mask & (rank < K), rank, rank.new_full((), K))
    ids = torch.full((B, nb, K + 1), F, dtype=torch.int32,
                     device=fv_img.device)
    face = torch.arange(F, dtype=torch.int32,
                        device=fv_img.device).expand(B, nb, F)
    ids.scatter_(2, slot, face)          # slot K collects what is dropped
    return ids[..., :K].contiguous(), mask.sum(dim=-1).max()


def uses_bins(height: int, width: int, n_faces: int, K: int = _BIN_K) -> bool:
    """The static gate of the band-binned sweeps, hard and soft: renders of
    ≥ 128² with a bin meaningfully smaller than the face count."""
    return height * width >= _BIN_MIN_PIXELS and n_faces > 2 * K


def _select_faces_batched(pix: torch.Tensor, fv_img: torch.Tensor,
                          fv_z: torch.Tensor, valid: torch.Tensor,
                          height: int, width: int, K: int = _BIN_K
                          ) -> torch.Tensor:
    """Batched per-pixel winning face ids (B, P) int32, with band binning
    and the dense sweep when a bin overflows (a bin that dropped a face
    would give a wrong image). The overflow count is read on the host."""
    B, F = valid.shape
    P = pix.shape[0]
    rows = _face_rows(fv_img, fv_z, valid)                    # (B, F, 12)
    if not uses_bins(height, width, F, K):
        return select_faces_dense(rows, pix, width)
    nb = -(-P // _BAND)
    ylo, yhi = _band_ranges(height, width, nb, pix.device)
    ids, maxc = _bin_faces(fv_img, valid, ylo, yhi, K)
    if int(maxc) > K:
        return select_faces_dense(rows, pix, width)
    rows = torch.cat([rows, _filler_row(rows.device).expand(B, 1, 12)], dim=1)
    slots = select_faces_binned(rows, ids, pix, width)        # (B, nb, 1024)
    fid = torch.gather(ids, 2, slots.clamp(min=0).long())
    fid = torch.where((slots >= 0) & (fid < F), fid, fid.new_full((), -1))
    return fid.reshape(B, nb * _BAND)[:, :P]


# --------------------------------------------------------------------------
# the differentiable pass
# --------------------------------------------------------------------------

def _interp_selected(pix: torch.Tensor, face_idx: torch.Tensor,
                     fv_img: torch.Tensor, face_features: torch.Tensor
                     ) -> torch.Tensor:
    """Barycentric interpolation of the selected faces, with autograd to
    `fv_img` and `face_features`. pix (P, 2), face_idx (B, P), fv_img
    (B, F, 3, 2), face_features (B, F, 3, C) → (B, P, C)."""
    B = face_idx.shape[0]
    safe = face_idx.clamp(min=0).long()
    bidx = torch.arange(B, device=face_idx.device)[:, None]
    tri = fv_img[bidx, safe]                                # (B, P, 3, 2)
    feat = face_features[bidx, safe]                        # (B, P, 3, C)
    v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]

    def cross2(a, b):
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]

    w0 = cross2(v2 - v1, pix - v1)
    w1 = cross2(v0 - v2, pix - v2)
    w2 = cross2(v1 - v0, pix - v0)
    denom = w0 + w1 + w2
    denom = torch.where(denom.abs() > _EPS, denom, torch.ones_like(denom))
    bary = torch.stack([w0, w1, w2], dim=-1) / denom[..., None]
    out = torch.einsum("bpk,bpkc->bpc", bary, feat)
    return torch.where((face_idx >= 0)[..., None], out,
                       torch.zeros_like(out))


def rasterize(height: int, width: int, face_vertices_z: torch.Tensor,
              face_vertices_image: torch.Tensor, face_features: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard z-buffer rasterization.

    face_vertices_z (B, F, 3) camera-space z per face vertex;
    face_vertices_image (B, F, 3, 2) NDC xy; face_features (B, F, 3, C).
    Returns image_features (B, H, W, C) and face_idx (B, H, W) int32 (−1
    background). The selection carries no gradient; the features carry it
    to `face_vertices_image` and `face_features`."""
    B, F = face_vertices_z.shape[:2]
    pix = pixel_grid_ndc(height, width, face_vertices_image.device)
    valid = torch.ones((B, F), dtype=torch.bool,
                       device=face_vertices_image.device)
    with torch.no_grad():
        face_idx = _select_faces_batched(pix, face_vertices_image.detach(),
                                         face_vertices_z.detach(), valid,
                                         height, width)
    feats = _interp_selected(pix, face_idx, face_vertices_image,
                             face_features)
    C = face_features.shape[-1]
    return (feats.reshape(B, height, width, C),
            face_idx.reshape(B, height, width))


# --------------------------------------------------------------------------
# the soft silhouette: rows and plain versions
# --------------------------------------------------------------------------

def _soft_rows(fv_img: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 2) → (..., F, 16): [edge forms·sign (9), v0 v1 v2 xy (6),
    valid (1)]. Degenerate faces keep their boundary distance but never
    test inside (edge0 ≡ −1)."""
    v0, v1, v2 = fv_img[..., 0, :], fv_img[..., 1, :], fv_img[..., 2, :]

    def edge(a, b):
        ex = -(b[..., 1] - a[..., 1])
        ey = b[..., 0] - a[..., 0]
        ec = ((b[..., 1] - a[..., 1]) * a[..., 0]
              - (b[..., 0] - a[..., 0]) * a[..., 1])
        return torch.stack([ex, ey, ec], dim=-1)

    e0, e1, e2 = edge(v1, v2), edge(v2, v0), edge(v0, v1)
    denom = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
             - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    s = torch.sign(denom)[..., None]
    e0, e1, e2 = e0 * s, e1 * s, e2 * s
    zero_in = (denom.abs() <= _EPS)[..., None]
    zero = torch.zeros_like(e0)
    e0 = torch.where(zero_in, _filler_row(e0.device)[:3], e0)
    e1 = torch.where(zero_in, zero, e1)
    e2 = torch.where(zero_in, zero, e2)
    okf = torch.ones_like(denom)[..., None]
    return torch.cat([e0, e1, e2, v0, v1, v2, okf], dim=-1)


def _soft_stage(rows: torch.Tensor) -> torch.Tensor:
    """(..., F, 16) → (..., F, 19): the rows with 1/max(|edge|², 1e-10) of
    the three edges v0v1, v1v2, v2v0 appended. The quotient depends only on
    the face, so it is taken once per face here, as the kernels take it
    when they stage a row."""
    vx, vy = rows[..., 9:15:2], rows[..., 10:15:2]          # (..., F, 3)
    wx = vx.roll(-1, dims=-1) - vx
    wy = vy.roll(-1, dims=-1) - vy
    inv = 1.0 / (wx * wx + wy * wy).clamp(min=_EPS)
    return torch.cat([rows, inv], dim=-1)


def _seg_d2(px, py, ax, ay, bx, by, inv):
    """Squared distance of the pixels to the segment a→b, with the clamped
    foot parameter s and the residual r = (p − a) − s·(b − a)."""
    wx, wy = bx - ax, by - ay
    ux, uy = px - ax, py - ay
    s = ((ux * wx + uy * wy) * inv).clamp(0.0, 1.0)
    rx, ry = ux - s * wx, uy - s * wy
    return rx * rx + ry * ry, s, rx, ry


def _soft_face_prob(tab: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                    sigma: float):
    """Staged rows tab (..., Fc, 19) against pixels px, py (..., 1, Pn) →
    the coverage probability p (..., Fc, Pn), the least squared edge
    distance, the inside test and the three segments' (d², s, rx, ry)."""
    t = tab.unsqueeze(-1)                                   # (..., Fc, 19, 1)

    def affine(i):
        return t[..., i, :] * px + t[..., i + 1, :] * py + t[..., i + 2, :]

    inside = (affine(0) >= 0.0) & (affine(3) >= 0.0) & (affine(6) >= 0.0)
    segs = []
    for k in range(3):
        a, b = 9 + 2 * k, 9 + 2 * ((k + 1) % 3)
        segs.append(_seg_d2(px, py, t[..., a, :], t[..., a + 1, :],
                            t[..., b, :], t[..., b + 1, :],
                            t[..., 16 + k, :]))
    d = torch.minimum(segs[0][0], torch.minimum(segs[1][0], segs[2][0]))
    p = torch.where(inside, torch.ones_like(d),
                    torch.exp(-d / sigma)) * t[..., 15, :]
    return p, d, inside, segs


def soft_prod_dense_plain(rows: torch.Tensor, pix: torch.Tensor,
                          sigma: float) -> torch.Tensor:
    """rows (B, F, 16), pix (P, 2) → ∏_f (1 − p_f) per pixel (B, P).
    Chunked over faces to bound memory."""
    B, F, _ = rows.shape
    P = pix.shape[0]
    tab = _soft_stage(rows)
    px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
    prod = rows.new_ones((B, P))
    chunk = max(1, _PLAIN_BLOCK // max(B * P, 1))
    for f0 in range(0, F, chunk):
        p = _soft_face_prob(tab[:, f0:f0 + chunk], px, py, sigma)[0]
        prod = prod * torch.prod(1.0 - p, dim=-2)
    return prod


def _band_operands(pix: torch.Tensor, nb: int, *flat: torch.Tensor):
    """Pixels and per-pixel (B, nb·1024) maps as (…, nb, 1, 1024) operands
    of the banded plain sweeps; pixels past the image sit far outside NDC,
    where exp(−d²/σ) underflows to 0."""
    px, py = (a[None, :, None, :] for a in _band_pixels(pix, nb, 5.0))
    return (px, py) + tuple(a.reshape(a.shape[0], nb, 1, _BAND)
                            for a in flat)


def soft_prod_binned_plain(rows: torch.Tensor, ids: torch.Tensor,
                           pix: torch.Tensor, sigma: float) -> torch.Tensor:
    """rows (B, F+1, 16) with the all-zero filler last, ids (B, nb, K), pix
    (P, 2) → ∏ over each band's bin (B, nb, 1024). Chunked over slots."""
    B, nb, K = ids.shape
    tab = _soft_stage(rows)
    px, py = _band_operands(pix, nb)
    prod = rows.new_ones((B, nb, _BAND))
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    chunk = max(1, _PLAIN_BLOCK // (B * nb * _BAND))
    for k0 in range(0, K, chunk):
        t = tab[bidx, ids[:, :, k0:k0 + chunk].long()]      # (B, nb, Kc, 19)
        prod = prod * torch.prod(
            1.0 - _soft_face_prob(t, px, py, sigma)[0], dim=-2)
    return prod


def _soft_grad_rows_plain(tab, px, py, sigma: float, g, prod) -> torch.Tensor:
    """Closed-form ∂L/∂(vertex xy) of the staged faces tab (..., Fc, 19)
    summed over the pixels px, py, g, prod (..., 1, Pn) → (..., Fc, 6) as
    [v0x v0y v1x v1y v2x v2y]. dL/dp = g·prod / max(1 − p, 1e-12); outside,
    dL/dd² = −p/σ · dL/dp, given whole to the first minimal edge, with
    ∂d²/∂a = −2(1 − s)·r and ∂d²/∂b = −2s·r; inside, 0."""
    p, d, inside, segs = _soft_face_prob(tab, px, py, sigma)
    valid = tab[..., 15][..., None]
    dLdp = g * prod / (1.0 - p).clamp(min=1e-12)
    dLdd = torch.where(inside, torch.zeros_like(p),
                       dLdp * (-p / sigma)) * valid
    vg = [0.0] * 6
    first = torch.ones_like(inside)
    zero = torch.zeros_like(p)
    for k, (dk, s, rx, ry) in enumerate(segs):
        is_min = (dk == d) & first
        first = first & ~is_min
        coef = torch.where(is_min, dLdd, zero)
        ia, ib = k, (k + 1) % 3
        vg[2 * ia] = vg[2 * ia] + coef * (-2.0 * (1.0 - s) * rx)
        vg[2 * ia + 1] = vg[2 * ia + 1] + coef * (-2.0 * (1.0 - s) * ry)
        vg[2 * ib] = vg[2 * ib] + coef * (-2.0 * s * rx)
        vg[2 * ib + 1] = vg[2 * ib + 1] + coef * (-2.0 * s * ry)
    return torch.stack([v.sum(dim=-1) for v in vg], dim=-1)


def soft_grad_dense_plain(rows: torch.Tensor, pix: torch.Tensor,
                          g: torch.Tensor, prod: torch.Tensor, sigma: float
                          ) -> torch.Tensor:
    """rows (B, F, 16), pix (P, 2), the mask's cotangent g and the
    forward's prod (B, P) → vertex gradients (B, F, 6)."""
    B, F, _ = rows.shape
    P = pix.shape[0]
    tab = _soft_stage(rows)
    px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
    g, prod = g[:, None, :], prod[:, None, :]
    chunk = max(1, _PLAIN_BLOCK // max(B * P, 1))
    return torch.cat([
        _soft_grad_rows_plain(tab[:, f0:f0 + chunk], px, py, sigma, g, prod)
        for f0 in range(0, F, chunk)], dim=1)


def soft_grad_binned_plain(rows: torch.Tensor, ids: torch.Tensor,
                           pix: torch.Tensor, g: torch.Tensor,
                           prod: torch.Tensor, sigma: float) -> torch.Tensor:
    """rows (B, F+1, 16), ids (B, nb, K), g and prod (B, nb, 1024) → the
    gradient rows of each (band, slot), (B, nb, K, 6)."""
    B, nb, K = ids.shape
    tab = _soft_stage(rows)
    px, py, g, prod = _band_operands(pix, nb, g, prod)
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    chunk = max(1, _PLAIN_BLOCK // (B * nb * _BAND))
    return torch.cat([
        _soft_grad_rows_plain(tab[bidx, ids[:, :, k0:k0 + chunk].long()],
                              px, py, sigma, g, prod)
        for k0 in range(0, K, chunk)], dim=2)


def _slots_to_faces(slot_rows: torch.Tensor, ids: torch.Tensor, F: int
                    ) -> torch.Tensor:
    """Sum the per-(band, slot) rows (B, nb, K, 6) back to their faces by
    id; the filler id F is dropped. → (B, F, 6). On the card `index_add_`
    adds in an order that varies from run to run."""
    B = ids.shape[0]
    out = slot_rows.new_zeros((B * (F + 1), 6))
    flat = (ids.long() + torch.arange(B, device=ids.device)[:, None, None]
            * (F + 1)).reshape(-1)
    out.index_add_(0, flat, slot_rows.reshape(-1, 6))
    return out.reshape(B, F + 1, 6)[:, :F]


def _slots_to_faces_ordered(slot_rows: torch.Tensor, ids: torch.Tensor,
                            F: int) -> torch.Tensor:
    """`_slots_to_faces` in the order of kernel #10's face sum: each face's
    rows added band by band in band order, from 0, the filler id F dropped
    (a band holds a face at most once). The twin of
    csrc/rasterize.cu:soft_bwd_faces_kernel, bit for bit where the rows of
    the bands without a live pixel are zero."""
    B, nb, K = ids.shape
    out = slot_rows.new_zeros((B, F + 1, 6))
    bidx = torch.arange(B, device=ids.device)[:, None].expand(B, K)
    for j in range(nb):
        out.index_put_((bidx, ids[:, j].long()), slot_rows[:, j],
                       accumulate=True)
    return out[:, :F]


# --------------------------------------------------------------------------
# the soft silhouette: the forward kernels' cull, in PyTorch
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _soft_margin(sigma: float) -> float:
    """The cull's margin √(27.7·σ), rounded to f32 as the kernels get it:
    beyond it exp(−d²/σ) < 1e-12 and a factor 1 − p is exactly 1.0f."""
    m = (_SOFT_TAIL * sigma) ** 0.5
    return struct.unpack("f", struct.pack("f", m))[0]


def _soft_cull_boxes(rows: torch.Tensor, sigma: float) -> torch.Tensor:
    """(..., F, 16) → (..., F, 4) [xmin, xmax, ymin, ymax] of each face's
    three vertices, widened by the margin in f32; (−inf, inf, −inf, inf)
    for a face the cull never skips: one with a non-finite vertex
    coordinate, and a sliver. The twin of csrc/rasterize.cu:face_box.

    A pixel outside the widened box is farther than m from the face, so one
    of its edge forms is below −|edge|·m·sin(A/2) for the smallest angle A,
    and the inside test fails there, if that exceeds the forms' rounding
    (a few ulps of |edge|·(|p| + |v|)). For a sliver (sin A ≲ 1e-5 at
    σ = 1e-4) it does not, a far pixel can test inside (p = 1, factor 0)
    in the plain version, and skipping the pair would give 1. So a face is
    kept everywhere unless |n0 × n1| ≥ 2^−10 · max_k |n_k|², the n_k being
    its rows' edge normals (2·area and the edges' squared lengths), each
    product and sum rounded to f32 as the kernels round them: enough for
    σ ≥ 1e-6 in NDC. A degenerate face (normals 0, edge0 ≡ −1) never tests
    inside and keeps its box."""
    vx, vy = rows[..., 9:15:2], rows[..., 10:15:2]           # (..., F, 3)
    m = torch.tensor(_soft_margin(sigma), dtype=torch.float32,
                     device=rows.device)
    box = torch.stack([vx.amin(-1) - m, vx.amax(-1) + m,
                       vy.amin(-1) - m, vy.amax(-1) + m], dim=-1)
    nx, ny = rows[..., 0:9:3], rows[..., 1:9:3]              # (..., F, 3)
    cross = nx[..., 0] * ny[..., 1] - ny[..., 0] * nx[..., 1]
    l2 = (nx * nx + ny * ny).amax(-1)
    # written so that a NaN keeps the face
    sliver = ~(cross.abs() >= _SOFT_SLIVER * l2)
    keep = ~torch.isfinite(rows[..., 9:15]).all(-1) | sliver
    inf = float("inf")
    return torch.where(keep[..., None],
                       box.new_tensor([-inf, inf, -inf, inf]), box)


def _soft_tile_width(P: int, width: int, banded: bool) -> int:
    """The width the forward kernels tile by, 0 for 32 pixels in a row:
    dense, 8 × 4 tiles where the width is a multiple of 8 that divides P;
    banded, (32/R) × R tiles of a band's R = 1024/width rows where width
    divides 1024 and P and is at least 32."""
    if width <= 0 or P % width:
        return 0
    if banded:
        return width if _BAND % width == 0 and width >= 32 else 0
    return width if width % 8 == 0 else 0


def _soft_tile_pixels(P: int, width: int, banded: bool = False,
                      device: torch.device = None) -> torch.Tensor:
    """(T, 32) int64 pixel of each lane of each warp tile, −1 past the
    image, tile-major as the kernels number them (banded: 32 tiles a band,
    band by band). The twin of dense_tile_pixel / band_tile_pixel."""
    w = _soft_tile_width(P, width, banded)
    lane = torch.arange(32, device=device)
    if banded:
        nb = -(-P // _BAND)
        t = torch.arange(nb * 32, device=device)[:, None]
        band, t = t // 32, t % 32
        if w:
            tw = 32 // (_BAND // w)
            local = (lane // tw) * w + t * tw + lane % tw
        else:
            local = t * 32 + lane
        p = band * _BAND + local
    elif w:
        per_row = w // 8
        rows = -(-(P // w) // 4)
        t = torch.arange(rows * per_row, device=device)[:, None]
        p = ((t // per_row) * 4 + lane // 8) * w + (t % per_row) * 8 + lane % 8
    else:
        t = torch.arange(-(-P // 32), device=device)[:, None]
        p = t * 32 + lane
    return torch.where(p < P, p, torch.full_like(p, -1))


def _soft_tile_boxes(pix: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """(T, 4) box of each tile's live pixels: empty (inf, −inf, inf, −inf)
    where none is live, the whole plane where one is NaN. The twin of
    csrc/rasterize.cu:tile_box."""
    live = tiles >= 0
    xy = pix[tiles.clamp(min=0)]                              # (T, 32, 2)
    inf = float("inf")
    lo = torch.where(live[..., None], xy, torch.full_like(xy, inf))
    hi = torch.where(live[..., None], xy, torch.full_like(xy, -inf))
    box = torch.stack([lo[..., 0].amin(-1), hi[..., 0].amax(-1),
                       lo[..., 1].amin(-1), hi[..., 1].amax(-1)], dim=-1)
    nan = (live & torch.isnan(xy).any(-1)).any(-1, keepdim=True)
    return torch.where(nan, box.new_tensor([-inf, inf, -inf, inf]), box)


def _soft_kept(face_boxes: torch.Tensor, tile_boxes: torch.Tensor
               ) -> torch.Tensor:
    """(..., F, 4) face boxes against (..., T, 4) tile boxes → (..., T, F)
    True where the kernels evaluate the pair: the tile does not lie wholly
    outside the face's box (a NaN compare never skips)."""
    f, t = face_boxes[..., None, :, :], tile_boxes[..., :, None, :]
    skip = ((t[..., 1] < f[..., 0]) | (t[..., 0] > f[..., 1])
            | (t[..., 3] < f[..., 2]) | (t[..., 2] > f[..., 3]))
    return ~skip


def _soft_live_tile_boxes(pix: torch.Tensor, gp: torch.Tensor,
                          tiles: torch.Tensor) -> torch.Tensor:
    """(B, T, 4) box of each warp tile's live pixels (g·prod ≠ 0, in the
    image) for the per-view maps gp (B, ·) indexed by `tiles` (T, 32):
    empty where none is live, as `_soft_tile_boxes`."""
    live = (tiles >= 0) & (gp[:, tiles.clamp(min=0)] != 0)   # (B, T, 32)
    return _soft_tile_boxes(pix, torch.where(live, tiles, -1))


def _soft_bwd_kept(rows: torch.Tensor, ids: torch.Tensor, pix: torch.Tensor,
                   g: torch.Tensor, prod: torch.Tensor, sigma: float,
                   width: int = 0) -> torch.Tensor:
    """(B, nb, 32, K) True where kernel #10 evaluates the pair of a band's
    warp tile and bin slot: the slot holds a face (the kernel stops at the
    first filler), and the face's widened vertex box does not lie wholly
    outside the box of the tile's live pixels (g·prod ≠ 0, in the image).
    A tile with no live pixel has an empty box, outside every finite one; a
    face with a non-finite vertex, whose box is the plane, is kept at every
    tile (the kernel gives its sum NaN instead). rows (B, F+1, 16) with the
    filler last, ids (B, nb, K), g and prod (B, nb, 1024)."""
    B, nb, K = ids.shape
    tiles = _soft_tile_pixels(pix.shape[0], width, True, pix.device)
    boxes = _soft_live_tile_boxes(pix, (g * prod).reshape(B, nb * _BAND),
                                  tiles)
    bidx = torch.arange(B, device=ids.device)[:, None, None]
    face = _soft_cull_boxes(rows, sigma)[bidx, ids.long()]     # (B, nb, K, 4)
    real = (ids >= 0) & (ids < rows.shape[1] - 1)
    return _soft_kept(face, boxes.reshape(B, nb, 32, 4)) & real[:, :, None, :]


def _soft_bwd_dense_kept(rows: torch.Tensor, pix: torch.Tensor,
                         g: torch.Tensor, prod: torch.Tensor, sigma: float,
                         width: int = 0) -> torch.Tensor:
    """(B, T, F) True where kernel #9's cull keeps the pair of a dense warp
    tile (`_soft_tile_pixels`) and a face: the face's widened vertex box
    does not lie wholly outside the box of the tile's live pixels (g·prod
    ≠ 0). A tile with no live pixel has an empty box, outside every finite
    one (the kernel skips it whole); a face with a non-finite vertex, whose
    box is the plane, is kept at every tile (the kernel gives its sum NaN).
    rows (B, F, 16), g and prod (B, P)."""
    tiles = _soft_tile_pixels(pix.shape[0], width, False, pix.device)
    boxes = _soft_live_tile_boxes(pix, g * prod, tiles)
    return _soft_kept(_soft_cull_boxes(rows, sigma), boxes)


# --------------------------------------------------------------------------
# the soft silhouette: kernels
# --------------------------------------------------------------------------

def _check_soft(rows: torch.Tensor, pix: torch.Tensor, *maps: torch.Tensor,
                ids: torch.Tensor = None) -> None:
    if any(t.dtype != torch.float32 for t in (rows, pix) + maps):
        raise TypeError("the soft silhouette takes float32 tensors, got "
                        f"{[t.dtype for t in (rows, pix) + maps]}")
    if rows.dim() != 3 or rows.shape[-1] != 16 or pix.dim() != 2 \
            or pix.shape[-1] != 2:
        raise ValueError(f"the soft silhouette takes rows (B, F, 16) and pix "
                         f"(P, 2), got {tuple(rows.shape)}, "
                         f"{tuple(pix.shape)}")
    if not (all(t.is_contiguous() for t in (rows, pix) + maps)
            and rows.data_ptr() % 16 == 0):
        raise ValueError("soft rows, pixels and maps must be contiguous and "
                         "the rows 16-byte aligned")
    if ids is not None:
        _check_ids(rows, ids, pix)
        for m in maps:
            if tuple(m.shape) != (ids.shape[0], ids.shape[1], _BAND):
                raise ValueError("banded maps must be (B, nb, 1024), got "
                                 f"{tuple(m.shape)}")
    else:
        for m in maps:
            if tuple(m.shape) != (rows.shape[0], pix.shape[0]):
                raise ValueError(f"maps must be (B, P), got {tuple(m.shape)}")
    _build.check_cuda(rows, pix, *maps, *(() if ids is None else (ids,)))


def _soft_fwd_call(name: str, ptrs: int, ints: int):
    """The soft forward entry `name`: its floats are sigma and, for the
    culling kernels, the margin."""
    return _entry(name, ptrs, ints, 1 if name.endswith("_sweep") else 2)


def soft_prod_dense_cuda(rows: torch.Tensor, pix: torch.Tensor, sigma: float,
                         width: int = 0) -> torch.Tensor:
    """Kernel #7: ∏ (1 − p_f) per pixel, culled by warp tiles of 8 × 4
    pixels where `width` (the image's) allows, else 32 in a row."""
    _check_soft(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    out = torch.empty((B, P), dtype=torch.float32, device=rows.device)
    err = _soft_fwd_call(SOFT_FWD_DENSE, 3, 4)(
        rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
        _soft_tile_width(P, width, False), float(sigma), _soft_margin(sigma),
        _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_DENSE)
    _build.count_launch(SOFT_FWD_DENSE)
    return out


def soft_prod_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                          pix: torch.Tensor, sigma: float, width: int = 0
                          ) -> torch.Tensor:
    """Kernel #8. `ids` holds each band's face ids first and the filler id
    (the last row) from there to the end, as `_bin_faces` makes them: the
    kernel stops a band's sweep at its first filler. Warp tiles of 16 × 2
    pixels at a width of 512 (see `_soft_tile_width`)."""
    _check_soft(rows, pix, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    P = pix.shape[0]
    out = torch.empty((B, nb, _BAND), dtype=torch.float32, device=rows.device)
    err = _soft_fwd_call(SOFT_FWD_BINNED, 4, 6)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
        B, Fr, nb, K, P, _soft_tile_width(P, width, True), float(sigma),
        _soft_margin(sigma), _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_BINNED)
    _build.count_launch(SOFT_FWD_BINNED)
    return out


def soft_prod_dense_sweep_cuda(rows: torch.Tensor, pix: torch.Tensor,
                               sigma: float) -> torch.Tensor:
    """The all-pairs #7 (every pair), with #7's contract; only `chip_smoke.py`
    and the card tests call it, to time and check it beside #7."""
    _check_soft(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    out = torch.empty((B, P), dtype=torch.float32, device=rows.device)
    err = _soft_fwd_call(SOFT_FWD_DENSE_SWEEP, 3, 3)(
        rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
        float(sigma), _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_DENSE_SWEEP)
    _build.count_launch(SOFT_FWD_DENSE_SWEEP)
    return out


def soft_prod_binned_sweep_cuda(rows: torch.Tensor, ids: torch.Tensor,
                                pix: torch.Tensor, sigma: float
                                ) -> torch.Tensor:
    """The all-pairs #8 (every filled slot at every band pixel), with #8's
    contract; timed and checked beside #8 only."""
    _check_soft(rows, pix, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    out = torch.empty((B, nb, _BAND), dtype=torch.float32, device=rows.device)
    err = _soft_fwd_call(SOFT_FWD_BINNED_SWEEP, 4, 5)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
        B, Fr, nb, K, pix.shape[0], float(sigma),
        _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_BINNED_SWEEP)
    _build.count_launch(SOFT_FWD_BINNED_SWEEP)
    return out


@functools.lru_cache(maxsize=None)
def _soft_bwd_dense_entries():
    """The typed C entries of kernel #9: its scratch size and its launch."""
    lib = _build.load("rasterize")
    size = lib.soft_bwd_dense_scratch
    size.argtypes = [_build.INT] * 3
    size.restype = _build.LONG
    fn = lib.soft_bwd_dense
    fn.argtypes = ([_build.VOIDP] * 6 + [_build.LONG] + [_build.INT] * 4
                   + [_build.FLOAT] * 2 + [_build.VOIDP])
    fn.restype = _build.INT
    return size, fn


def soft_grad_dense_cuda(rows: torch.Tensor, pix: torch.Tensor,
                         g: torch.Tensor, prod: torch.Tensor, sigma: float,
                         width: int = 0) -> torch.Tensor:
    """Kernel #9 (with its first pass over the tiles): the vertex
    gradients (B, F, 6), culled by warp tiles of 8 × 4 pixels where
    `width` (the image's) allows, else 32 in a row; deterministic."""
    _check_soft(rows, pix, g, prod)
    B, F, _ = rows.shape
    P = pix.shape[0]
    w = _soft_tile_width(P, width, False)
    size, fn = _soft_bwd_dense_entries()
    words = size(B, P, w)
    scratch = torch.empty((max(words, 4),), dtype=torch.int32,
                          device=rows.device)
    out = torch.empty((B, F, 6), dtype=torch.float32, device=rows.device)
    err = fn(rows.data_ptr(), pix.data_ptr(), g.data_ptr(), prod.data_ptr(),
             out.data_ptr(), scratch.data_ptr(), scratch.numel(), B, F, P, w,
             float(sigma), _soft_margin(sigma),
             _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_DENSE)
    _build.count_launch(SOFT_BWD_DENSE)
    return out


def soft_grad_dense_sweep_cuda(rows: torch.Tensor, pix: torch.Tensor,
                               g: torch.Tensor, prod: torch.Tensor,
                               sigma: float) -> torch.Tensor:
    """The first design of #9 (8 faces a block at every live pixel), with
    #9's contract; only `chip_smoke.py` and the card tests call it, to time
    and check it beside #9."""
    _check_soft(rows, pix, g, prod)
    B, F, _ = rows.shape
    out = torch.empty((B, F, 6), dtype=torch.float32, device=rows.device)
    err = _entry(SOFT_BWD_DENSE_SWEEP, 5, 3, 1)(
        rows.data_ptr(), pix.data_ptr(), g.data_ptr(), prod.data_ptr(),
        out.data_ptr(), B, F, pix.shape[0], float(sigma),
        _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_DENSE_SWEEP)
    _build.count_launch(SOFT_BWD_DENSE_SWEEP)
    return out


def _soft_bwd_binned_rows(rows: torch.Tensor, ids: torch.Tensor,
                          pix: torch.Tensor, g: torch.Tensor,
                          prod: torch.Tensor, sigma: float, width: int = 0):
    """The first of #10's two kernels → (slot rows (B, nb, 2, K, 6) of
    each half band, written only at the filled slots of the halves with a
    live pixel; slot_of (B, F, nb), each face's slot in each band that
    holds it; span (2, B, F), each face's first and last band; band_live
    (B, nb, 2), each half's)."""
    _check_soft(rows, pix, g, prod, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    P = pix.shape[0]
    dev = rows.device
    slot_rows = torch.empty((B, nb, 2, K, 6), dtype=torch.float32,
                            device=dev)
    slot_of = torch.empty((B, Fr - 1, nb), dtype=torch.int32, device=dev)
    span = torch.empty((2, B, Fr - 1), dtype=torch.int32, device=dev)
    live = torch.empty((B, nb, 2), dtype=torch.int32, device=dev)
    err = _entry(SOFT_BWD_BINNED, 9, 6, 2)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), g.data_ptr(),
        prod.data_ptr(), slot_rows.data_ptr(), slot_of.data_ptr(),
        span.data_ptr(), live.data_ptr(), B, Fr, nb, K, P,
        _soft_tile_width(P, width, True), float(sigma), _soft_margin(sigma),
        _build.stream_ptr(dev))
    _build.check(err, SOFT_BWD_BINNED)
    return slot_rows, slot_of, span, live


def _soft_bwd_faces(rows: torch.Tensor, ids: torch.Tensor,
                    slot_rows: torch.Tensor, slot_of: torch.Tensor,
                    span: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """The second: each face's slot rows summed in band order → (B, F, 6)."""
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    out = torch.empty((B, Fr - 1, 6), dtype=torch.float32, device=rows.device)
    err = _entry("soft_bwd_faces", 7, 4)(
        rows.data_ptr(), ids.data_ptr(), slot_rows.data_ptr(),
        slot_of.data_ptr(), span.data_ptr(), live.data_ptr(), out.data_ptr(),
        B, Fr, nb, K, _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_BINNED)
    return out


def soft_grad_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                          pix: torch.Tensor, g: torch.Tensor,
                          prod: torch.Tensor, sigma: float, width: int = 0
                          ) -> torch.Tensor:
    """Kernel #10 and its face sum → the vertex gradients (B, F, 6). `ids`
    holds each band's face ids ascending, then the filler id (the last
    row), as `_bin_faces` makes them; tiles as `soft_prod_binned_cuda`'s.
    Deterministic."""
    parts = _soft_bwd_binned_rows(rows, ids, pix, g, prod, sigma, width)
    out = _soft_bwd_faces(rows, ids, *parts)
    _build.count_launch(SOFT_BWD_BINNED)
    return out


def soft_grad_binned_sweep_cuda(rows: torch.Tensor, ids: torch.Tensor,
                                pix: torch.Tensor, g: torch.Tensor,
                                prod: torch.Tensor, sigma: float
                                ) -> torch.Tensor:
    """The first design of #10 (8 slots a block, every live pixel) and its
    `index_add_` to faces, with #10's contract; timed and checked beside
    #10 only."""
    _check_soft(rows, pix, g, prod, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    slot_rows = torch.empty((B, nb, K, 6), dtype=torch.float32,
                            device=rows.device)
    err = _entry(SOFT_BWD_BINNED_SWEEP, 6, 5, 1)(
        rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), g.data_ptr(),
        prod.data_ptr(), slot_rows.data_ptr(), B, Fr, nb, K, pix.shape[0],
        float(sigma), _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_BINNED_SWEEP)
    _build.count_launch(SOFT_BWD_BINNED_SWEEP)
    return _slots_to_faces(slot_rows, ids, Fr - 1)


def soft_prod_dense(rows, pix, sigma, width: int = 0):
    """Kernel on CUDA tensors, plain version on CPU tensors. `width`, the
    image's, only shapes the kernel's tiles."""
    if rows.is_cuda:
        return soft_prod_dense_cuda(rows, pix, sigma, width)
    return soft_prod_dense_plain(rows, pix, sigma)


def soft_prod_binned(rows, ids, pix, sigma, width: int = 0):
    """Kernel on CUDA tensors, plain version on CPU tensors. `width`, the
    image's, only shapes the kernel's tiles."""
    if rows.is_cuda:
        return soft_prod_binned_cuda(rows, ids, pix, sigma, width)
    return soft_prod_binned_plain(rows, ids, pix, sigma)


def soft_grad_dense(rows, pix, g, prod, sigma, width: int = 0):
    """Kernel on CUDA tensors, plain version on CPU tensors. `width`, the
    image's, only shapes the kernel's tiles."""
    if rows.is_cuda:
        return soft_grad_dense_cuda(rows, pix, g, prod, sigma, width)
    return soft_grad_dense_plain(rows, pix, g, prod, sigma)


def soft_grad_binned(rows, ids, pix, g, prod, sigma, width: int = 0):
    """The vertex gradients (B, F, 6): kernel and its face sum on CUDA
    tensors, the plain rows and `_slots_to_faces` on CPU tensors."""
    if rows.is_cuda:
        return soft_grad_binned_cuda(rows, ids, pix, g, prod, sigma, width)
    return _slots_to_faces(soft_grad_binned_plain(rows, ids, pix, g, prod,
                                                  sigma),
                           ids, rows.shape[1] - 1)


# --------------------------------------------------------------------------
# the soft silhouette: bins, autograd, entry points
# --------------------------------------------------------------------------

def _soft_bins(fv_img: torch.Tensor, height: int, width: int, sigma: float,
               K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band bins of the soft silhouette: ids (B, nb, K) and the largest
    per-band count, the y-ranges widened by the tail margin √(27.7·σ)."""
    B, F = fv_img.shape[:2]
    nb = -(-height * width // _BAND)
    ylo, yhi = _band_ranges(height, width, nb, fv_img.device)
    valid = torch.ones((B, F), dtype=torch.bool, device=fv_img.device)
    return _bin_faces(fv_img, valid, ylo, yhi, K,
                      margin=float((_SOFT_TAIL * sigma) ** 0.5))


def _with_filler(rows: torch.Tensor) -> torch.Tensor:
    """rows (B, F, 16) → (B, F+1, 16) with the all-zero filler row (valid
    = 0: probability 0, gradient 0) last."""
    return torch.cat([rows, rows.new_zeros((rows.shape[0], 1, 16))], dim=1)


def _band_maps(a: torch.Tensor, nb: int) -> torch.Tensor:
    """(B, P) → (B, nb, 1024), zero-padded."""
    pad = nb * _BAND - a.shape[1]
    return torch.nn.functional.pad(a, (0, pad)).reshape(a.shape[0], nb, _BAND)


class _SoftSilhouette(torch.autograd.Function):
    """mask = 1 − ∏(1 − p_f), (B, H, W), with the closed-form gradient to
    the vertex positions. Forward decides between the binned and the dense
    sweep (the bin counts are read on the host); backward takes the branch
    forward took, with forward's bins and forward's prod."""

    @staticmethod
    def forward(ctx, fv_img, height: int, width: int, sigma: float, K: int):
        fv = fv_img.detach().contiguous()
        B, F = fv.shape[:2]
        pix = pixel_grid_ndc(height, width, fv.device)
        P = pix.shape[0]
        rows = _soft_rows(fv)
        ids = None
        if uses_bins(height, width, F, K):
            ids, maxc = _soft_bins(fv, height, width, sigma, K)
            if int(maxc) > K:      # a bin that dropped a face: dense sweep
                ids = None
        if ids is None:
            prod = soft_prod_dense(rows, pix, sigma, width)
        else:
            prod = soft_prod_binned(_with_filler(rows), ids, pix, sigma,
                                    width)
            prod = prod.reshape(B, -1)[:, :P].contiguous()
        ctx.save_for_backward(rows, prod, *(() if ids is None else (ids,)))
        ctx.dims = (height, width, sigma)
        return (1.0 - prod).reshape(B, height, width)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        rows, prod, *ids = ctx.saved_tensors
        height, width, sigma = ctx.dims
        B, F = rows.shape[:2]
        pix = pixel_grid_ndc(height, width, rows.device)
        g = g.reshape(B, -1).contiguous()
        if not ids:
            grad = soft_grad_dense(rows, pix, g, prod, sigma, width)
        else:
            nb = ids[0].shape[1]
            grad = soft_grad_binned(
                _with_filler(rows), ids[0], pix, _band_maps(g, nb),
                _band_maps(prod, nb), sigma, width)
        return grad.reshape(B, F, 3, 2), None, None, None, None


def soft_silhouette(height: int, width: int,
                    face_vertices_image: torch.Tensor, sigma: float = 1e-4,
                    bin_k: int = _SOFT_BIN_K) -> torch.Tensor:
    """DIB-R soft silhouette (B, H, W) of faces (B, F, 3, 2), differentiable
    to the vertex positions."""
    return _SoftSilhouette.apply(face_vertices_image, height, width,
                                 float(sigma), bin_k)


def dibr_rasterization(height: int, width: int,
                       face_vertices_z: torch.Tensor,
                       face_vertices_image: torch.Tensor,
                       face_features: torch.Tensor,
                       face_normals_z: Optional[torch.Tensor] = None,
                       sigma: float = 1e-4
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DIB-R: hard interior attributes + soft silhouette. Returns
    (image_features, soft_mask, face_idx). `face_normals_z` is accepted and
    does not cull (faces are double-sided)."""
    feats, face_idx = rasterize(height, width, face_vertices_z,
                                face_vertices_image, face_features)
    soft = soft_silhouette(height, width, face_vertices_image, sigma=sigma)
    return feats, soft, face_idx
