"""Hard z-buffer triangle rasterization: the visible-face selection kernels
(csrc/rasterize.cu) with their plain PyTorch versions, and the
differentiable interpolation around them.

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

The soft silhouette (`soft_silhouette`, `dibr_rasterization`) belongs to the
latent-paint-mesh slice of the port and is refused here.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from tpunerf_torch.fields.volume_render import pixel_grid_ndc as _pixel_grid
from tpunerf_torch.kernels import _build

DENSE = "select_faces_dense"
BINNED = "select_faces_binned"

_EPS = 1e-10
_BAND = 1024                 # pixels per band (row-major)
_BIN_K = 256                 # faces per band bin
_BIN_MIN_PIXELS = 128 * 128  # binning engages at ≥128² renders
# elements of one (faces, pixels) block of the plain sweeps
_PLAIN_BLOCK = 1 << 22

MESH_SLICE = ("comes with the latent-paint-mesh slice of the port (see "
              "ROADMAP.md)")


@functools.lru_cache(maxsize=16)
def pixel_grid_ndc(height: int, width: int,
                   device: torch.device = torch.device("cpu")
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


def _band_pixels(pix: torch.Tensor, nb: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """pix (P, 2) → px, py (nb, 1024); pixels past the image sit outside
    NDC (at 2.0) so they hit nothing."""
    pad = nb * _BAND - pix.shape[0]
    pixp = torch.nn.functional.pad(pix, (0, 0, 0, pad), value=2.0)
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
               yhi: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-band first-K face ids, ascending. fv_img (B, F, 3, 2), valid
    (B, F), ylo/yhi (nb,) → ids (B, nb, K) int32, slot-padded with the
    filler id F, and the largest per-band count (0-dim tensor). A stable
    compaction: rank by a running count, scatter the first K."""
    B, F = valid.shape
    nb = ylo.shape[0]
    fy = fv_img[..., 1]
    fymin, fymax = fy.min(dim=-1).values, fy.max(dim=-1).values  # (B, F)
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
    """The static gate of the band-binned sweep."""
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


def soft_silhouette(*args, **kwargs):
    raise NotImplementedError(f"soft_silhouette {MESH_SLICE}")


def dibr_rasterization(*args, **kwargs):
    raise NotImplementedError(f"dibr_rasterization {MESH_SLICE}")
