"""The gated kernels of the band bins' overflow choice (#5/#6, #7/#8,
#9/#10) on the projected sphere, for their checks on a card.

`gated_cases` gives, for each kernel, a call of its wrapper with a gate and
an output to write into, its plain version's result on the same inputs and
the tolerance it is held to. `check_gate` holds one kernel to them: with its
gate open it equals its plain version and the ungated call, with its gate
shut it leaves the output it was given as it was. `chip_smoke.py` and the
card tests use both; the trainer does not.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from tpunerf_torch.core.views import ViewSamplerConfig, circle_poses
from tpunerf_torch.kernels import rasterize as rz
from tpunerf_torch.meshrep import render as mrender
from tpunerf_torch.meshrep import shapes

SIGMA = 1e-4
# against the plain version: the selection bit for bit; the soft products
# of up to ~400 factors in another order; the gradients summed in another
# order, of the largest value
TOLS = {rz.DENSE: 0.0, rz.BINNED: 0.0, rz.SOFT_FWD_DENSE: 5e-6,
        rz.SOFT_FWD_BINNED: 5e-6, rz.SOFT_BWD_DENSE: 2e-5,
        rz.SOFT_BWD_BINNED: 2e-5}
NUMBERS = {rz.DENSE: "#5", rz.BINNED: "#6", rz.SOFT_FWD_DENSE: "#7",
           rz.SOFT_FWD_BINNED: "#8", rz.SOFT_BWD_DENSE: "#9",
           rz.SOFT_BWD_BINNED: "#10"}

Case = Tuple[Callable[[Optional[torch.Tensor], Optional[torch.Tensor]],
                      torch.Tensor], torch.Tensor, float]


def gated_cases(device: torch.device, n_views: int = 5, size: int = 512,
                seed: int = 0) -> Dict[str, Case]:
    """{kernel name: (fn(skip, out), plain result, tolerance)} on the sphere
    of the paint apps under `n_views` views of the eval orbit at `size`²
    (the eval chunk's shapes), each binned kernel on bins that hold (K
    widened where the sphere overflows the default), the backwards on a
    cotangent g ~ N(0, 1) from `seed` and the plain forward's prod."""
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(device)
    views = circle_poses(n_views, ViewSamplerConfig(), device)
    fv_cam, fv_img, _ = mrender._project(
        mesh.vertices, mesh.faces, views.theta, views.phi, views.radius,
        mrender.CameraSpec(look_at_height=0.25))
    B, F = fv_img.shape[:2]
    valid = torch.ones((B, F), dtype=torch.bool, device=device)
    pix = rz.pixel_grid_ndc(size, size, device)
    nb = -(-size * size // 1024)
    gen = torch.Generator(device=device).manual_seed(seed)
    cases: Dict[str, Case] = {}

    rows = rz._face_rows(fv_img, fv_cam[..., 2], valid)
    cases[rz.DENSE] = (
        lambda skip, out: rz.select_faces_dense_cuda(rows, pix, size, skip,
                                                     out),
        rz.select_faces_dense_plain(rows, pix), TOLS[rz.DENSE])
    ylo, yhi = rz._band_ranges(size, size, nb, device)
    K = rz._BIN_K
    ids, maxc = rz._bin_faces(fv_img, valid, ylo, yhi, K)
    if int(maxc) > K:
        K = -(-int(maxc) // 64) * 64
        ids, _ = rz._bin_faces(fv_img, valid, ylo, yhi, K)
    rows_f = torch.cat([rows, rz._filler_row(device).expand(B, 1, 12)], 1)
    cases[rz.BINNED] = (
        lambda skip, out: rz.select_faces_binned_cuda(rows_f, ids, pix, size,
                                                      skip, out),
        rz.select_faces_binned_plain(rows_f, ids, pix), TOLS[rz.BINNED])

    soft = rz._soft_rows(fv_img).contiguous()
    prod = rz.soft_prod_dense_plain(soft, pix, SIGMA)
    g = torch.randn(prod.shape, generator=gen, device=device)
    cases[rz.SOFT_FWD_DENSE] = (
        lambda skip, out: rz.soft_prod_dense_cuda(soft, pix, SIGMA, size,
                                                  skip, out),
        prod, TOLS[rz.SOFT_FWD_DENSE])
    cases[rz.SOFT_BWD_DENSE] = (
        lambda skip, out: rz.soft_grad_dense_cuda(soft, pix, g, prod, SIGMA,
                                                  size, skip, out),
        rz.soft_grad_dense_plain(soft, pix, g, prod, SIGMA),
        TOLS[rz.SOFT_BWD_DENSE])
    K = rz._SOFT_BIN_K
    sids, maxc = rz._soft_bins(fv_img, size, size, SIGMA, K)
    if int(maxc) > K:
        K = -(-int(maxc) // 128) * 128
        sids, _ = rz._soft_bins(fv_img, size, size, SIGMA, K)
    soft_f = rz._with_filler(soft).contiguous()
    bprod = rz.soft_prod_binned_plain(soft_f, sids, pix, SIGMA)
    bg = rz._band_maps(g, nb)
    cases[rz.SOFT_FWD_BINNED] = (
        lambda skip, out: rz.soft_prod_binned_cuda(soft_f, sids, pix, SIGMA,
                                                   size, skip, out),
        bprod, TOLS[rz.SOFT_FWD_BINNED])
    cases[rz.SOFT_BWD_BINNED] = (
        lambda skip, out: rz.soft_grad_binned_cuda(soft_f, sids, pix, bg,
                                                   bprod, SIGMA, size, skip,
                                                   out),
        rz._slots_to_faces(rz.soft_grad_binned_plain(soft_f, sids, pix, bg,
                                                     bprod, SIGMA), sids, F),
        TOLS[rz.SOFT_BWD_BINNED])
    return cases


def gate_flags(device: torch.device) -> Dict[bool, torch.Tensor]:
    """{shut: the gate}: a device int32 1 shuts a kernel, 0 opens it."""
    return {s: torch.full((1,), int(s), dtype=torch.int32, device=device)
            for s in (False, True)}


def check_gate(case: Case, flags: Dict[bool, torch.Tensor]
               ) -> Dict[str, float]:
    """One kernel against its case: {"shut_changed": elements of the given
    output that the shut kernel changed, "open_vs_ungated": elements where
    the open and the ungated calls differ, "err": the open call's largest
    |difference| to plain, "scale": plain's largest |value|, "ok"}: ok where
    nothing changed shut, the open call equals the ungated one bit for bit
    and plain within the tolerance (of the largest value)."""
    fn, plain, tol = case
    sentinel = torch.full_like(plain, -7)
    shut = fn(flags[True], sentinel.clone())
    opened = fn(flags[False], sentinel.clone())
    ungated = fn(None, None)
    changed = int((shut != sentinel).sum().item())
    differ = int((opened != ungated).sum().item())
    err = (opened.double() - plain.double()).abs().max().item()
    scale = plain.double().abs().max().item()
    ok = changed == 0 and differ == 0 and (
        torch.equal(opened, plain) if tol == 0.0 else err <= tol * scale)
    return {"shut_changed": changed, "open_vs_ungated": differ, "err": err,
            "scale": scale, "ok": ok}
