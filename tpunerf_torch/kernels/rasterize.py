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
   dense sweep when a bin overflows;
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
backward is the closed-form vertex gradient.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from tpunerf_torch.fields.volume_render import pixel_grid_ndc as _pixel_grid
from tpunerf_torch.kernels import _build

DENSE = "select_faces_dense"
BINNED = "select_faces_binned"
SOFT_FWD_DENSE = "soft_fwd_dense"
SOFT_FWD_BINNED = "soft_fwd_binned"
SOFT_BWD_DENSE = "soft_bwd_dense"
SOFT_BWD_BINNED = "soft_bwd_binned"

_EPS = 1e-10
_BAND = 1024                 # pixels per band (row-major)
_BIN_K = 256                 # faces per band bin
# the soft silhouette's bins are wider: its y-range test grows by the tail
# margin √(27.7·σ), which adds faces to every band
_SOFT_BIN_K = 768
# exp(−d²/σ) < 1e-12 beyond d = √(27.7·σ): a face farther than that from a
# band adds nothing to its probabilities or gradients above f32 rounding
_SOFT_TAIL = 27.7
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


def select_faces_dense_cuda(rows: torch.Tensor, pix: torch.Tensor
                            ) -> torch.Tensor:
    _check_rows(rows, pix)
    _build.check_cuda(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    fn = _build.load("rasterize").select_faces_dense
    fn.argtypes = [_build.VOIDP] * 3 + [_build.INT] * 3 + [_build.VOIDP]
    fn.restype = _build.INT
    out = torch.empty((B, P), dtype=torch.int32, device=rows.device)
    err = fn(rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
             _build.stream_ptr(rows.device))
    _build.check(err, DENSE)
    _build.count_launch(DENSE)
    return out


def select_faces_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                             pix: torch.Tensor) -> torch.Tensor:
    _check_rows(rows, pix)
    if ids.dtype != torch.int32 or ids.dim() != 3 \
            or ids.shape[0] != rows.shape[0] or not ids.is_contiguous():
        raise ValueError("bin ids must be contiguous int32 (B, nb, K), got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    _build.check_cuda(rows, ids, pix)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    P = pix.shape[0]
    if nb * _BAND < P:
        raise ValueError(f"{nb} bands do not cover {P} pixels")
    fn = _build.load("rasterize").select_faces_binned
    fn.argtypes = [_build.VOIDP] * 4 + [_build.INT] * 5 + [_build.VOIDP]
    fn.restype = _build.INT
    out = torch.empty((B, nb, _BAND), dtype=torch.int32, device=rows.device)
    err = fn(rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
             B, Fr, nb, K, P, _build.stream_ptr(rows.device))
    _build.check(err, BINNED)
    _build.count_launch(BINNED)
    return out


def select_faces_dense(rows: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return select_faces_dense_cuda(rows, pix)
    return select_faces_dense_plain(rows, pix)


def select_faces_binned(rows: torch.Tensor, ids: torch.Tensor,
                        pix: torch.Tensor) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return select_faces_binned_cuda(rows, ids, pix)
    return select_faces_binned_plain(rows, ids, pix)


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
        return select_faces_dense(rows, pix)
    nb = -(-P // _BAND)
    ylo, yhi = _band_ranges(height, width, nb, pix.device)
    ids, maxc = _bin_faces(fv_img, valid, ylo, yhi, K)
    if int(maxc) > K:
        return select_faces_dense(rows, pix)
    rows = torch.cat([rows, _filler_row(rows.device).expand(B, 1, 12)], dim=1)
    slots = select_faces_binned(rows, ids, pix)               # (B, nb, 1024)
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
        if ids.dtype != torch.int32 or ids.dim() != 3 \
                or ids.shape[0] != rows.shape[0] or not ids.is_contiguous():
            raise ValueError("bin ids must be contiguous int32 (B, nb, K), "
                             f"got {ids.dtype} {tuple(ids.shape)}")
        if ids.shape[1] * _BAND < pix.shape[0]:
            raise ValueError(f"{ids.shape[1]} bands do not cover "
                             f"{pix.shape[0]} pixels")
        for m in maps:
            if tuple(m.shape) != (ids.shape[0], ids.shape[1], _BAND):
                raise ValueError("banded maps must be (B, nb, 1024), got "
                                 f"{tuple(m.shape)}")
    else:
        for m in maps:
            if tuple(m.shape) != (rows.shape[0], pix.shape[0]):
                raise ValueError(f"maps must be (B, P), got {tuple(m.shape)}")
    _build.check_cuda(rows, pix, *maps, *(() if ids is None else (ids,)))


def soft_prod_dense_cuda(rows: torch.Tensor, pix: torch.Tensor, sigma: float
                         ) -> torch.Tensor:
    _check_soft(rows, pix)
    B, F, _ = rows.shape
    P = pix.shape[0]
    fn = _build.load("rasterize").soft_fwd_dense
    fn.argtypes = ([_build.VOIDP] * 3 + [_build.INT] * 3 + [_build.FLOAT]
                   + [_build.VOIDP])
    fn.restype = _build.INT
    out = torch.empty((B, P), dtype=torch.float32, device=rows.device)
    err = fn(rows.data_ptr(), pix.data_ptr(), out.data_ptr(), B, F, P,
             float(sigma), _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_DENSE)
    _build.count_launch(SOFT_FWD_DENSE)
    return out


def soft_prod_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                          pix: torch.Tensor, sigma: float) -> torch.Tensor:
    """`ids` holds each band's face ids first and the filler id (the last row) from
    there to the end, as `_bin_faces` makes them: the kernel stops a band's
    sweep at its first filler."""
    _check_soft(rows, pix, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    fn = _build.load("rasterize").soft_fwd_binned
    fn.argtypes = ([_build.VOIDP] * 4 + [_build.INT] * 5 + [_build.FLOAT]
                   + [_build.VOIDP])
    fn.restype = _build.INT
    out = torch.empty((B, nb, _BAND), dtype=torch.float32, device=rows.device)
    err = fn(rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), out.data_ptr(),
             B, Fr, nb, K, pix.shape[0], float(sigma),
             _build.stream_ptr(rows.device))
    _build.check(err, SOFT_FWD_BINNED)
    _build.count_launch(SOFT_FWD_BINNED)
    return out


def soft_grad_dense_cuda(rows: torch.Tensor, pix: torch.Tensor,
                         g: torch.Tensor, prod: torch.Tensor, sigma: float
                         ) -> torch.Tensor:
    _check_soft(rows, pix, g, prod)
    B, F, _ = rows.shape
    P = pix.shape[0]
    fn = _build.load("rasterize").soft_bwd_dense
    fn.argtypes = ([_build.VOIDP] * 5 + [_build.INT] * 3 + [_build.FLOAT]
                   + [_build.VOIDP])
    fn.restype = _build.INT
    out = torch.empty((B, F, 6), dtype=torch.float32, device=rows.device)
    err = fn(rows.data_ptr(), pix.data_ptr(), g.data_ptr(), prod.data_ptr(),
             out.data_ptr(), B, F, P, float(sigma),
             _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_DENSE)
    _build.count_launch(SOFT_BWD_DENSE)
    return out


def soft_grad_binned_cuda(rows: torch.Tensor, ids: torch.Tensor,
                          pix: torch.Tensor, g: torch.Tensor,
                          prod: torch.Tensor, sigma: float) -> torch.Tensor:
    _check_soft(rows, pix, g, prod, ids=ids)
    B, Fr, _ = rows.shape
    _, nb, K = ids.shape
    fn = _build.load("rasterize").soft_bwd_binned
    fn.argtypes = ([_build.VOIDP] * 6 + [_build.INT] * 5 + [_build.FLOAT]
                   + [_build.VOIDP])
    fn.restype = _build.INT
    out = torch.empty((B, nb, K, 6), dtype=torch.float32, device=rows.device)
    err = fn(rows.data_ptr(), ids.data_ptr(), pix.data_ptr(), g.data_ptr(),
             prod.data_ptr(), out.data_ptr(), B, Fr, nb, K, pix.shape[0],
             float(sigma), _build.stream_ptr(rows.device))
    _build.check(err, SOFT_BWD_BINNED)
    _build.count_launch(SOFT_BWD_BINNED)
    return out


def soft_prod_dense(rows, pix, sigma):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return soft_prod_dense_cuda(rows, pix, sigma)
    return soft_prod_dense_plain(rows, pix, sigma)


def soft_prod_binned(rows, ids, pix, sigma):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return soft_prod_binned_cuda(rows, ids, pix, sigma)
    return soft_prod_binned_plain(rows, ids, pix, sigma)


def soft_grad_dense(rows, pix, g, prod, sigma):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return soft_grad_dense_cuda(rows, pix, g, prod, sigma)
    return soft_grad_dense_plain(rows, pix, g, prod, sigma)


def soft_grad_binned(rows, ids, pix, g, prod, sigma):
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if rows.is_cuda:
        return soft_grad_binned_cuda(rows, ids, pix, g, prod, sigma)
    return soft_grad_binned_plain(rows, ids, pix, g, prod, sigma)


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
            prod = soft_prod_dense(rows, pix, sigma)
        else:
            prod = soft_prod_binned(_with_filler(rows), ids, pix, sigma)
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
            grad = soft_grad_dense(rows, pix, g, prod, sigma)
        else:
            nb = ids[0].shape[1]
            slot_rows = soft_grad_binned(
                _with_filler(rows), ids[0], pix, _band_maps(g, nb),
                _band_maps(prod, nb), sigma)
            grad = _slots_to_faces(slot_rows, ids[0], F)
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
