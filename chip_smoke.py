#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpunerf_torch) on one NVIDIA card.

1. Builds the CUDA kernels of tpunerf_torch/csrc/ with nvcc (sm_90a).
2. Holds each of the ten kernels against its plain PyTorch version on the
   card at the shapes of the full-width latent-NeRF, latent-paint and
   latent-paint-mesh paths, and times kernel, plain version and (for
   attention) PyTorch's SDPA with CUDA events.
3. Checks a tiny step of each app, and the soft silhouette's gradient to
   the displacement, on the card against the same on the CPU.
4. Trains the port's latent-NeRF app at full width (hash grid L=12, T=2^11;
   128^3 occupancy grid; S=128, K=64 at 64x64; the 859M-parameter SD-v1
   UNet, the CLIP ViT-L/14 text tower and the SD-v1 VAE, random-initialised
   from the seed) through `Trainer.train()` for 17+ steps, so that the
   occupancy refreshes at steps 1 and 16 run.
5. Trains the port's latent-paint app at full width with the same guidance
   (procedural sphere of 3968 faces, 960-face background dome, 128^2 latent
   texture, 64x64 train grid) through `Trainer.train()`, which ends with the
   eval orbit (5 frames at 512^2: VAE decode of the texture to 1024^2,
   band-binned face selection, texture sampling) and the mesh export.
6. Trains the port's latent-paint-mesh app at full width with the same
   guidance (sphere, body and head cameras at body_prob 0.7, displacement,
   normals, soft silhouette): mode 0 for 24 steps through `Trainer.train()`
   with the eval orbit (5 frames at 512^2, soft mask by the binned kernel)
   and the export of the displaced mesh, then 4 steps each of mode 1 (TADA,
   512^2 renders, two VAE encodes) and mode 2 (SDEdit).
7. Drives the soft silhouette's backward kernels through the scene: the
   gradient of sum(mask^2) to the displacement through
   `render_train(...)["soft_mask"]` at 64^2 and `render_test(...)["mask"]`
   at 512^2 (no loss of the app reads the soft mask, so no training step
   launches them).
For each path the launch counters are reset just before and read just after.

Prints the device line, one line per check, a `{"kernels": [...]}` line and,
last, `{"ok": true, "device": {...}}`. Exits non-zero, printing no result,
when there is no CUDA device, when the package is missing, or when any
phase fails.

    python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 24      # > 16, so that the refreshes at steps 1 and 16 both run
DEVICE = "cuda"  # where the latent-paint-mesh phases build and run

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W).
MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(seed: int):
    """Each kernel vs its plain version at full-width shapes. Returns
    {name: row} without launch counts."""
    import torch
    from tpunerf_torch.fields.encoding import HashGridConfig
    from tpunerf_torch.fields.occupancy import OccupancyGridConfig
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}

    # --- #1/#2 hash grid: N = 1·64²·K points, default config -------------
    cfg = HashGridConfig()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = 64 * 64 * 64
    x = torch.rand((N, 3), generator=gen, device=dev)
    table = torch.rand((L, T, F), generator=gen, device=dev) * 2 - 1
    out = hg.hash_encode_cuda(x, table, cfg)
    ref = hg.hash_encode_plain(x, table, cfg)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-5 * ref.abs().max().item()   # same f32 math, other sum order
    print(f"hashgrid_fwd N={N}: max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail("hash-grid forward kernel disagrees with its plain version")
    nbytes = x.numel() * 4 + table.numel() * 4 + out.numel() * 4
    flops = N * L * 8 * (2 + 2 * F)
    b_ms, b_by = bound(nbytes, flops, "f32")
    rows[hg.FWD] = dict(
        name=hg.FWD, route="cuda", source="tpunerf_torch/csrc/hashgrid.cu",
        replaces="tpunerf/kernels/hashgrid.py:252",
        max_abs_err=err, ms=cuda_ms(lambda: hg.hash_encode_cuda(x, table, cfg),
                                    50),
        plain_ms=cuda_ms(lambda: hg.hash_encode_plain(x, table, cfg), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    g = torch.randn((N, L * F), generator=gen, device=dev)
    dt = hg.hash_bwd_cuda(x, g, cfg)
    dref = hg.hash_bwd_plain(x, g, cfg)
    torch.cuda.synchronize()
    err = (dt - dref).abs().max().item()
    tol = 1e-5 * dref.abs().max().item()  # atomics: summation order varies
    print(f"hashgrid_bwd N={N}: max_abs_err {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail("hash-grid backward kernel disagrees with its plain version")
    nbytes = x.numel() * 4 + g.numel() * 4 + dt.numel() * 4
    flops = N * L * 8 * (2 + 2 * F)
    b_ms, b_by = bound(nbytes, flops, "f32")
    rows[hg.BWD] = dict(
        name=hg.BWD, route="cuda", source="tpunerf_torch/csrc/hashgrid.cu",
        replaces="tpunerf/kernels/hashgrid.py:408",
        max_abs_err=err, ms=cuda_ms(lambda: hg.hash_bwd_cuda(x, g, cfg), 50),
        plain_ms=cuda_ms(lambda: hg.hash_bwd_plain(x, g, cfg), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # --- #3 occupancy lookup: (1, 4096, 128) samples, G = 128 ------------
    ocfg = OccupancyGridConfig()
    G = ocfg.resolution
    grid = torch.rand((G ** 3,), generator=gen, device=dev) * 0.025
    packed = og.pack_bits(grid > ocfg.density_threshold)
    xs = torch.rand((1, 4096, 128, 3), generator=gen, device=dev) * 2 - 1
    # a slice of samples exactly on cell walls, where rounding decides
    walls = (torch.randint(0, G + 1, (4096, 3), generator=gen, device=dev)
             .float() * (2.0 / G) - 1.0)
    xs[0, :, 0, :] = walls
    occ = og.occupancy_lookup_cuda(xs, packed, G, ocfg.bound)
    oref = og.occupancy_lookup_plain(xs, packed, G, ocfg.bound)
    torch.cuda.synchronize()
    mism = int((occ != oref).sum().item())
    print(f"occgrid_lookup n={xs.shape[:-1].numel()}: mismatches {mism} "
          f"(tol 0, exact)")
    if mism:
        fail("occupancy lookup kernel disagrees with its plain version")
    nbytes = xs.numel() * 4 + packed.numel() * 4 + occ.numel()
    b_ms, b_by = bound(nbytes, xs.shape[:-1].numel() * 12, "f32")
    rows[og.LOOKUP] = dict(
        name=og.LOOKUP, route="cuda", source="tpunerf_torch/csrc/occgrid.cu",
        replaces="tpunerf/kernels/occgrid.py:139", max_abs_err=float(mism),
        ms=cuda_ms(lambda: og.occupancy_lookup_cuda(xs, packed, G,
                                                    ocfg.bound), 50),
        plain_ms=cuda_ms(lambda: og.occupancy_lookup_plain(xs, packed, G,
                                                           ocfg.bound), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # --- #4 attention: (2, 8, 4096, 40), the UNet's 64² self-attention ----
    B, H, S, D = 2, 8, 4096, 40
    scale = D ** -0.5
    errs = {}
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        # bf16: the plain path rounds the probabilities to bf16 before P·V
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=dev)
                   .to(dtype).permute(0, 2, 1, 3) for _ in range(3))
        o = at.attention_cuda(q, k, v, scale)
        r = at.attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs().max().item()
        tol = rel * r.float().abs().max().item()
        print(f"attention_fwd {dtype} {(B, H, S, D)}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e})")
        if not err <= tol:
            fail(f"attention kernel disagrees with its plain version "
                 f"({dtype})")
        errs[dtype] = err
    # the main path's dtype: bf16 under unet_dtype "auto"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms_f32 = cuda_ms(lambda: at.attention_cuda(*(t.float() for t in (q, k, v)),
                                               scale), 3)
    print(f"attention_fwd f32 {(B, H, S, D)}: {ms_f32:.4f} ms")
    flops = 4 * B * H * S * S * D
    nbytes = 4 * B * H * S * D * 2
    b_ms, b_by = bound(nbytes, flops, "bf16")
    rows[at.ATTN] = dict(
        name=at.ATTN, route="cuda", source="tpunerf_torch/csrc/attention.cu",
        replaces="tpunerf/guidance/unet.py:167",
        max_abs_err=errs[torch.bfloat16],
        ms=cuda_ms(lambda: at.attention_cuda(q, k, v, scale), 10),
        plain_ms=cuda_ms(lambda: at.attention_plain(q, k, v, scale), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: sdpa(q, k, v, scale=scale), 20))
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}")
    return rows


SEL_FLOPS = 25   # per face-pixel pair: 4 affine forms, 3 compares, a select


def check_raster_kernels(seed: int):
    """The two face-selection kernels vs their plain versions on the
    projected sphere and dome at the latent-paint shapes: mismatches must
    be 0. Returns {name: row} without launch counts."""
    import dataclasses
    import torch
    from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                          rand_poses)
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    vcfg = ViewSamplerConfig()
    spec = mrender.CameraSpec(look_at_height=0.25)
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    dome = shapes.env_sphere().to(dev)
    rows = {}

    def project(m, views):
        fv_cam, fv_img, _ = mrender._project(m.vertices, m.faces, views.theta,
                                             views.phi, views.radius, spec)
        valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
        return fv_img, fv_cam[..., 2], valid

    # --- #5 dense: 64² train grid, B = 1, a few sampled poses -------------
    pix = rz.pixel_grid_ndc(64, 64, dev)
    P = pix.shape[0]
    poses = rand_poses(4, vcfg, dev, generator=gen)
    timed = {}
    for label, m in (("mesh", mesh), ("dome", dome)):
        fv_img, fv_z, valid = project(m, poses)
        face_rows = rz._face_rows(fv_img, fv_z, valid)
        F = face_rows.shape[1]
        mism = hits = 0
        for b in range(face_rows.shape[0]):
            r = face_rows[b:b + 1].contiguous()
            got = rz.select_faces_dense_cuda(r, pix)
            ref = rz.select_faces_dense_plain(r, pix)
            torch.cuda.synchronize()
            mism += int((got != ref).sum().item())
            hits += int((ref >= 0).sum().item())
        print(f"select_faces_dense {label} F={F} P={P}, 4 poses: mismatches "
              f"{mism} (tol 0, exact); covered pixels {hits}")
        if mism or not hits:
            fail(f"dense selection kernel disagrees with its plain version "
                 f"({label})")
        r = face_rows[:1].contiguous()
        timed[label] = dict(
            F=F, mism=mism,
            ms=cuda_ms(lambda: rz.select_faces_dense_cuda(r, pix), 50),
            plain_ms=cuda_ms(lambda: rz.select_faces_dense_plain(r, pix), 5),
            bound=bound(r.numel() * 4 + pix.numel() * 4 + P * 4,
                        F * P * SEL_FLOPS, "f32"))
    # pixels exactly on edges, exact z ties, coplanar overlapping copies:
    # vertices on pixel centres of the grid, depths from a set of 3 values
    n = 600
    cells = torch.randint(0, 64, (n, 3, 2), generator=gen, device=dev)
    fv_img = (cells.float() + 0.5) / 64 * 2.0 - 1.0
    fv_img[..., 1] = -fv_img[..., 1]
    fv_z = -2.0 - 0.5 * torch.randint(0, 3, (n, 1), generator=gen,
                                      device=dev).float().expand(n, 3)
    fv_img = torch.cat([fv_img, fv_img[:200]])          # overlapping copies
    fv_z = torch.cat([fv_z, fv_z[:200]])
    r = rz._face_rows(fv_img[None], fv_z[None],
                      torch.ones((1, n + 200), dtype=torch.bool, device=dev))
    got = rz.select_faces_dense_cuda(r, pix)
    ref = rz.select_faces_dense_plain(r, pix)
    torch.cuda.synchronize()
    on_edge = int(((r[0, :, None, 0:9:3] * pix[None, :, 0:1]
                    + r[0, :, None, 1:9:3] * pix[None, :, 1:2]
                    + r[0, :, None, 2:9:3]) == 0).any(-1).any(0).sum().item())
    mism = int((got != ref).sum().item())
    print(f"select_faces_dense edge/tie set F={n + 200}: mismatches {mism} "
          f"(tol 0, exact); pixels on an edge of some face {on_edge}; "
          f"copies that won {int((ref >= n).sum().item())} (must be 0)")
    if mism or not on_edge or int((ref >= n).sum().item()):
        fail("dense selection kernel breaks the edge or tie rule")
    t = timed["mesh"]
    rows[rz.DENSE] = dict(
        name=rz.DENSE, route="cuda", source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:234",
        max_abs_err=float(t["mism"] + timed["dome"]["mism"] + mism),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
        bound_by=t["bound"][1], library_ms=None)
    d = timed["dome"]
    print(f"  {rz.DENSE} dome F={d['F']}: kernel {d['ms']:.4f} ms, plain "
          f"{d['plain_ms']:.4f} ms, bound {d['bound'][0]:.4f} ms "
          f"({d['bound'][1]})")

    # --- #6 binned: the eval chunk, B = 5 views of the orbit at 512² ------
    H = W = 512
    K = rz._BIN_K
    pix = rz.pixel_grid_ndc(H, W, dev)
    fv_img, fv_z, valid = project(mesh, circle_poses(5, vcfg, dev))
    B, F = valid.shape
    if not rz.uses_bins(H, W, F, K):
        fail("the eval render does not engage the band bins")
    nb = H * W // 1024
    ylo, yhi = rz._band_ranges(H, W, nb, dev)
    ids, maxc = rz._bin_faces(fv_img, valid, ylo, yhi, K)
    if int(maxc) > K:
        fail(f"a band bin overflows on the eval orbit ({int(maxc)} > {K})")
    face_rows = torch.cat(
        [rz._face_rows(fv_img, fv_z, valid),
         rz._filler_row(dev).expand(B, 1, 12)], dim=1).contiguous()
    got = rz.select_faces_binned_cuda(face_rows, ids, pix)
    ref = rz.select_faces_binned_plain(face_rows, ids, pix)
    dense = rz.select_faces_dense_cuda(face_rows[:, :F].contiguous(), pix)
    torch.cuda.synchronize()
    mism = int((got != ref).sum().item())
    fid = torch.gather(ids, 2, got.clamp(min=0).long())
    fid = torch.where(got >= 0, fid, -1).reshape(B, -1)
    vs_dense = int((fid != dense).sum().item())
    swept = int((ids < F).sum().item())       # slots that hold a face
    print(f"select_faces_binned B={B} {H}x{W} K={K} (largest bin "
          f"{int(maxc)}): mismatches {mism} (tol 0, exact); vs the dense "
          f"kernel {vs_dense}; covered pixels {int((got >= 0).sum().item())}")
    if mism or vs_dense or not int((got >= 0).sum().item()):
        fail("binned selection kernel disagrees with its plain version")
    b_ms, b_by = bound(face_rows.numel() * 4 + ids.numel() * 4
                       + pix.numel() * 4 + got.numel() * 4,
                       swept * 1024 * SEL_FLOPS, "f32")
    rows[rz.BINNED] = dict(
        name=rz.BINNED, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:326", max_abs_err=float(mism),
        ms=cuda_ms(lambda: rz.select_faces_binned_cuda(face_rows, ids, pix),
                   20),
        plain_ms=cuda_ms(lambda: rz.select_faces_binned_plain(face_rows, ids,
                                                              pix), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    fr = face_rows[:, :F].contiguous()
    print(f"  dense kernel on the same 5 views at 512²: "
          f"{cuda_ms(lambda: rz.select_faces_dense_cuda(fr, pix), 5):.4f} ms;"
          f" binning (ranges, mask, rank, scatter): "
          f"{cuda_ms(lambda: rz._bin_faces(fv_img, valid, ylo, yhi, K), 10):.4f}"
          f" ms")
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}")
    return rows


SOFT_FWD_FLOPS = 80    # per face-pixel pair: 3 affine forms, 3 segment
#                        distances (~15 each), a min, a quotient, an exp
SOFT_GRAD_FLOPS = 30   # on top, only where the backward goes on to the
#                        routed closed-form gradient (see _soft_grad_pairs)


def _max_rel(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def _soft_grad_pairs(rz, rows, pix, g, prod, sigma: float, ids=None) -> int:
    """The (face, pixel) pairs at which the soft backward must form the
    routed gradient: the pixel outside the face and dL/dd² != 0. Every
    other pair ends after the probability (inside, or exp(−d²/σ) = 0 a few
    pixels from the face, or g·prod = 0). Counted with the plain version's
    arithmetic; rows, g, prod dense (B, F, 16), (B, P) or, with ids
    (B, nb, K), banded (B, F+1, 16), (B, nb, 1024)."""
    import torch
    tab = rz._soft_stage(rows)
    B = rows.shape[0]
    if ids is None:
        n, per = rows.shape[1], B * pix.shape[0]
        px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
        g, prod = g[:, None, :], prod[:, None, :]
        take = lambda a, b: tab[:, a:b]  # noqa: E731
    else:
        nb, n = ids.shape[1:]
        per = B * nb * 1024
        px, py, g, prod = rz._band_operands(pix, nb, g, prod)
        bidx = torch.arange(B, device=rows.device)[:, None, None]
        take = lambda a, b: tab[bidx, ids[:, :, a:b].long()]  # noqa: E731
    chunk = max(1, rz._PLAIN_BLOCK // per)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for a in range(0, n, chunk):
        t = take(a, a + chunk)
        p, _, inside, _ = rz._soft_face_prob(t, px, py, sigma)
        dLdd = (g * prod / (1.0 - p).clamp(min=1e-12) * (-p / sigma)
                * t[..., 15][..., None])
        total += (~inside & (dLdd != 0)).sum()
    return int(total.item())


def check_soft_kernels(seed: int):
    """The four soft-silhouette kernels vs their plain versions on the
    projected sphere under the body and the head camera at the
    latent-paint-mesh shapes: forward to 5e-6 absolute, forward+backward
    pairs (each backward with its own forward's prod) to 2e-5 of the largest
    gradient. Returns {name: row} without launch counts."""
    import torch
    from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                          rand_poses)
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    vcfg = ViewSamplerConfig()
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    # the two cameras of body_prob < 1, whose narrow fields the sphere mostly
    # fills at training radii, and the one wide camera of body_prob = 1,
    # which sees the whole rim
    cameras = {"body": mrender.BODY_CAMERA, "head": mrender.HEAD_CAMERA,
               "wide": mrender.CameraSpec(look_at_height=0.25)}
    sigma = 1e-4
    FWD_TOL = 5e-6    # a product of ~100s of factors in another order
    # sums over pixels in another order; prod / (1 - p) near an edge
    BWD_TOL = 2e-5
    rows_out = {}

    def project(views, spec):
        return mrender._project(mesh.vertices, mesh.faces, views.theta,
                                views.phi, views.radius, spec)[1].contiguous()

    def pair_dense(face_rows, pix, g):
        prod_k = rz.soft_prod_dense_cuda(face_rows, pix, sigma)
        prod_p = rz.soft_prod_dense_plain(face_rows, pix, sigma)
        grad_k = rz.soft_grad_dense_cuda(face_rows, pix, g, prod_k, sigma)
        grad_p = rz.soft_grad_dense_plain(face_rows, pix, g, prod_p, sigma)
        torch.cuda.synchronize()
        return prod_k, prod_p, grad_k, grad_p

    # --- #7/#9 dense: the 64² train grid, B = 1, sampled poses -----------
    pix = rz.pixel_grid_ndc(64, 64, dev)
    P = pix.shape[0]
    poses = rand_poses(4, vcfg, dev, generator=gen)
    fwd_err = bwd_err = bwd_abs = 0.0
    rim = 0
    for label, spec in cameras.items():
        fv_img = project(poses, spec)
        for b in range(fv_img.shape[0]):
            face_rows = rz._soft_rows(fv_img[b:b + 1]).contiguous()
            g = torch.randn((1, P), generator=gen, device=dev)
            prod_k, prod_p, grad_k, grad_p = pair_dense(face_rows, pix, g)
            fwd_err = max(fwd_err, (prod_k - prod_p).abs().max().item())
            bwd_err = max(bwd_err, _max_rel(grad_k, grad_p))
            bwd_abs = max(bwd_abs, (grad_k - grad_p).abs().max().item())
            rim += int(((prod_p > 0.01) & (prod_p < 0.99)).sum().item())
            if not torch.isfinite(grad_k).all():
                fail(f"dense soft backward is not finite ({label})")
    F = face_rows.shape[1]
    print(f"soft_fwd_dense F={F} P={P}, 4 poses x body/head/wide camera: "
          f"max_abs_err {fwd_err:.3e} (tol {FWD_TOL:.0e}); rim pixels {rim}")
    print(f"soft_bwd_dense same poses, kernel pair vs plain pair: max err / "
          f"max|grad| {bwd_err:.3e} (tol {BWD_TOL:.0e})")
    if not (fwd_err <= FWD_TOL and bwd_err <= BWD_TOL and rim):
        fail("dense soft-silhouette kernels disagree with their plain "
             "versions")
    # degenerate faces, faces wholly outside the view, vertices on pixel
    # centres, padded rows (valid = 0)
    n = 400
    tri = torch.rand((n, 3, 2), generator=gen, device=dev) * 1.6 - 0.8
    tri[:, 1:] = tri[:, :1] + 0.15 * (torch.rand((n, 2, 2), generator=gen,
                                                 device=dev) - 0.5)
    tri[:100, 2] = tri[:100, 1]                          # zero area
    tri[100:200] += 3.0                                  # outside the view
    cells = torch.randint(0, 64, (100, 3, 2), generator=gen, device=dev)
    tri[200:300] = (cells.float() + 0.5) / 64 * 2.0 - 1.0
    face_rows = rz._soft_rows(tri[None]).contiguous()
    face_rows[0, 300:320, 15] = 0.0                      # padded rows
    g = torch.randn((1, P), generator=gen, device=dev)
    prod_k, prod_p, grad_k, grad_p = pair_dense(face_rows, pix, g)
    e_f = (prod_k - prod_p).abs().max().item()
    e_b = _max_rel(grad_k, grad_p)
    covered = int((prod_p == 0).sum().item())
    print(f"soft dense degenerate/outside/padded set F={n}: fwd "
          f"max_abs_err {e_f:.3e}, bwd rel {e_b:.3e}; covered pixels "
          f"{covered}; gradient of outside and padded faces "
          f"{grad_k[0, 100:200].abs().max().item():.1e} / "
          f"{grad_k[0, 300:320].abs().max().item():.1e} (must be 0)")
    if not (e_f <= FWD_TOL and e_b <= BWD_TOL and covered
            and torch.isfinite(grad_k).all()
            and grad_k[0, 100:200].abs().max().item() == 0
            and grad_k[0, 300:320].abs().max().item() == 0):
        fail("dense soft-silhouette kernels mishandle degenerate, outside "
             "or padded faces")
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    bwd_abs = max(bwd_abs, (grad_k - grad_p).abs().max().item())

    # times at the training shape: the wide camera's first pose, which has
    # a rim for the backward to work on
    face_rows = rz._soft_rows(project(poses, cameras["wide"])[:1]).contiguous()
    g = torch.randn((1, P), generator=gen, device=dev)
    prod = rz.soft_prod_dense_cuda(face_rows, pix, sigma)
    live = int((g * prod != 0).sum().item())
    io = face_rows.numel() * 4 + pix.numel() * 4
    b_ms, b_by = bound(io + P * 4, F * P * SOFT_FWD_FLOPS, "f32")
    rows_out[rz.SOFT_FWD_DENSE] = dict(
        name=rz.SOFT_FWD_DENSE, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:675", max_abs_err=fwd_err,
        ms=cuda_ms(lambda: rz.soft_prod_dense_cuda(face_rows, pix, sigma), 50),
        plain_ms=cuda_ms(lambda: rz.soft_prod_dense_plain(face_rows, pix,
                                                          sigma), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the backward skips pixels with g·prod = 0 (count the live ones) and
    # forms the gradient at few of the live pairs (count those too)
    routed = _soft_grad_pairs(rz, face_rows, pix, g, prod, sigma)
    b_ms, b_by = bound(io + 2 * P * 4 + F * 6 * 4,
                       F * live * SOFT_FWD_FLOPS + routed * SOFT_GRAD_FLOPS,
                       "f32")
    rows_out[rz.SOFT_BWD_DENSE] = dict(
        name=rz.SOFT_BWD_DENSE, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:725", max_abs_err=bwd_abs,
        max_rel_err=bwd_err,
        ms=cuda_ms(lambda: rz.soft_grad_dense_cuda(face_rows, pix, g, prod,
                                                   sigma), 50),
        plain_ms=cuda_ms(lambda: rz.soft_grad_dense_plain(face_rows, pix, g,
                                                          prod, sigma), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"  dense backward: {live} of {P} pixels live (g*prod != 0); "
          f"{routed} of {F * live} live (face, pixel) pairs reach the "
          f"routed gradient; max abs err {bwd_abs:.3e}")

    # --- #8/#10 binned: the eval chunk, B = 5 views of the orbit at 512² --
    H = W = 512
    pix = rz.pixel_grid_ndc(H, W, dev)
    P = pix.shape[0]
    nb = P // 1024
    orbit = circle_poses(5, vcfg, dev)
    fwd_err = bwd_err = bwd_abs = 0.0
    timed = None
    for label, spec in cameras.items():
        fv_img = project(orbit, spec)
        B = fv_img.shape[0]
        K = rz._SOFT_BIN_K
        ids, maxc = rz._soft_bins(fv_img, H, W, sigma, K)
        print(f"soft bins, {label} camera, 5 orbit views at {H}²: largest "
              f"bin {int(maxc)} of K = {K}"
              + (" -- OVERFLOW: the scene takes the dense sweep here; the "
                 "kernels are checked at a K that holds" if int(maxc) > K
                 else ""))
        if int(maxc) > K:
            K = -(-int(maxc) // 128) * 128
            ids, maxc = rz._soft_bins(fv_img, H, W, sigma, K)
        face_rows = rz._with_filler(rz._soft_rows(fv_img)).contiguous()
        g = torch.randn((B, nb, 1024), generator=gen, device=dev)
        prod_k = rz.soft_prod_binned_cuda(face_rows, ids, pix, sigma)
        prod_p = rz.soft_prod_binned_plain(face_rows, ids, pix, sigma)
        slot_k = rz.soft_grad_binned_cuda(face_rows, ids, pix, g, prod_k,
                                          sigma)
        slot_p = rz.soft_grad_binned_plain(face_rows, ids, pix, g, prod_p,
                                           sigma)
        dense_rows = face_rows[:, :F].contiguous()
        prod_d = rz.soft_prod_dense_cuda(dense_rows, pix, sigma)
        grad_d = rz.soft_grad_dense_cuda(dense_rows, pix,
                                         g.reshape(B, P).contiguous(), prod_d,
                                         sigma)
        grad_k = rz._slots_to_faces(slot_k, ids, F)
        torch.cuda.synchronize()
        e_f = (prod_k - prod_p).abs().max().item()
        e_b = _max_rel(slot_k, slot_p)
        e_fd = (prod_k.reshape(B, P) - prod_d).abs().max().item()
        e_bd = _max_rel(grad_k, grad_d)
        filled = int((ids < F).sum().item())
        print(f"soft_fwd_binned {label} B={B} {H}x{W} K={K}: max_abs_err "
              f"{e_f:.3e} (tol {FWD_TOL:.0e}); vs the dense kernel {e_fd:.3e} "
              f"(tol 1e-5: the bins drop tails below 1e-12)")
        print(f"soft_bwd_binned {label}: per-slot rows, kernel pair vs plain "
              f"pair: max err / max {e_b:.3e} (tol {BWD_TOL:.0e}); summed to "
              f"faces (index_add_, order varies) vs the dense kernel "
              f"{e_bd:.3e} (tol 1e-4); filled slots {filled} of "
              f"{ids.numel()}")
        if not (e_f <= FWD_TOL and e_b <= BWD_TOL and e_fd <= 1e-5
                and e_bd <= 1e-4 and torch.isfinite(slot_k).all()):
            fail(f"binned soft-silhouette kernels disagree ({label})")
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
        bwd_abs = max(bwd_abs, (slot_k - slot_p).abs().max().item())
        if timed is None:
            timed = (face_rows, ids, g, prod_k, dense_rows, filled, K)
    face_rows, ids, g, prod, dense_rows, filled, K = timed
    # each band's filled slots against its own live pixels
    is_live = g * prod != 0
    live = int(is_live.sum().item())
    live_pairs = int(((ids < F).sum(-1) * is_live.sum(-1)).sum().item())
    routed = _soft_grad_pairs(rz, face_rows, pix, g, prod, sigma, ids)
    io = face_rows.numel() * 4 + ids.numel() * 4 + pix.numel() * 4
    b_ms, b_by = bound(io + prod.numel() * 4,
                       filled * 1024 * SOFT_FWD_FLOPS, "f32")
    rows_out[rz.SOFT_FWD_BINNED] = dict(
        name=rz.SOFT_FWD_BINNED, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:694", max_abs_err=fwd_err,
        ms=cuda_ms(lambda: rz.soft_prod_binned_cuda(face_rows, ids, pix,
                                                    sigma), 20),
        plain_ms=cuda_ms(lambda: rz.soft_prod_binned_plain(face_rows, ids,
                                                           pix, sigma), 2,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    b_ms, b_by = bound(io + 2 * prod.numel() * 4 + ids.numel() * 6 * 4,
                       live_pairs * SOFT_FWD_FLOPS
                       + routed * SOFT_GRAD_FLOPS, "f32")
    rows_out[rz.SOFT_BWD_BINNED] = dict(
        name=rz.SOFT_BWD_BINNED, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:748", max_abs_err=bwd_abs,
        max_rel_err=bwd_err,
        ms=cuda_ms(lambda: rz.soft_grad_binned_cuda(face_rows, ids, pix, g,
                                                    prod, sigma), 20),
        plain_ms=cuda_ms(lambda: rz.soft_grad_binned_plain(
            face_rows, ids, pix, g, prod, sigma), 2, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    slot = rz.soft_grad_binned_cuda(face_rows, ids, pix, g, prod, sigma)
    gd = g.reshape(5, P).contiguous()
    pd = prod.reshape(5, P).contiguous()
    fv_body = project(orbit, cameras["body"])
    sum_ms = cuda_ms(lambda: rz._slots_to_faces(slot, ids, F), 10)
    bins_ms = cuda_ms(lambda: rz._soft_bins(fv_body, H, W, sigma, K), 5)
    dense_f = cuda_ms(lambda: rz.soft_prod_dense_cuda(dense_rows, pix, sigma),
                      3)
    dense_b = cuda_ms(lambda: rz.soft_grad_dense_cuda(dense_rows, pix, gd, pd,
                                                      sigma), 3)
    print(f"  binned backward: {live} of {prod.numel()} pixels live; "
          f"{routed} of {live_pairs} live (slot, pixel) pairs reach the "
          f"routed gradient; max abs err {bwd_abs:.3e}; "
          f"slots -> faces (index_add_) {sum_ms:.4f} ms; soft bins (ranges, "
          f"mask, rank, scatter) {bins_ms:.4f} ms; dense kernels on the same "
          f"5 views: fwd {dense_f:.4f} ms, bwd {dense_b:.4f} ms")
    for r in rows_out.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}")
    return rows_out


def _rel_grad_err(got, ref) -> float:
    """max over the gradients of max|got − ref| / max|ref| (a gradient that
    is all zero on both sides counts 0)."""
    return max(((got[k] - g).abs().max()
                / g.abs().max().clamp(min=1e-30)).item()
               for k, g in ref.items())


def check_small_steps(seed: int, device: str = "cuda") -> None:
    """One tiny-config loss and gradient of each app on the card (kernels)
    against the same step on the CPU (plain versions): same weights, same
    draws, f32."""
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import rand_poses
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer

    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.unet_dtype", "float32",
        "--render.mlp_dtype", "float32", "--render.train_grid_size", "16",
        "--render.num_samples_per_ray", "32"])
    cpu, gpu = torch.device("cpu"), torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    guides = {d: StableDiffusionGuidance.create(tiny=True,
                                                unet_dtype="float32",
                                                device=d)
              for d in (cpu, gpu)}
    for name in ("unet", "text_encoder", "vae"):
        getattr(guides[gpu], name).load_state_dict(
            getattr(guides[cpu], name).state_dict())
    apps = {d: LatentNeRFApp.create(cfg, guidance=guides[d], device=d)
            for d in (cpu, gpu)}
    apps[cpu].scene.init_params(gen)
    apps[gpu].scene.load_state_dict(apps[cpu].scene.state_dict())
    views = rand_poses(1, Trainer.view_config(cfg), cpu, generator=gen)
    u = torch.rand((1, 256, 32), generator=gen)
    noise = torch.randn((1, 16, 16, 4), generator=gen)
    out = {}
    for d, app in apps.items():
        loss, _ = app.loss_fn(views.to(d), u=u.to(d),
                              t=torch.tensor(500, device=d),
                              noise=noise.to(d))
        loss.backward()
        out[d] = (loss.item(), {k: p.grad.cpu() for k, p in
                                app.scene.field.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out[cpu], out[gpu]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    g_err = _rel_grad_err(g_gpu, g_cpu)
    print(f"tiny latent-NeRF step, card vs CPU: loss {l_gpu:+.6e} vs "
          f"{l_cpu:+.6e} (rel {rel:.2e}, tol 1e-4); max grad err / "
          f"max|grad| {g_err:.2e} (tol 1e-4)")
    # f32 on both; the UNet's convolutions and the atomics sum in other
    # orders (TF32 is off)
    if not (rel <= 1e-4 and g_err <= 1e-4):
        fail("the tiny step on the card disagrees with the CPU step")

    # --- latent-paint: sphere, 24² grid, 32² texture ----------------------
    pcfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.unet_dtype", "float32",
        "--guide.shape_path", "sphere", "--guide.texture_resolution", "32",
        "--render.train_grid_size", "24"])
    papps = {d: LatentPaintApp.create(pcfg, guidance=guides[d], device=d)
             for d in (cpu, gpu)}
    papps[cpu].scene.init_params(gen)
    papps[gpu].scene.load_state_dict(papps[cpu].scene.state_dict())
    noise = torch.randn((1, 16, 16, 4), generator=gen)
    out = {}
    for d, app in papps.items():
        loss, aux = app.loss_fn(views.to(d), t=torch.tensor(500, device=d),
                                noise=noise.to(d))
        loss.backward()
        out[d] = (loss.item(), {k: getattr(app.scene, k).grad.cpu()
                                for k in app.scene.trainable_keys()},
                  aux["image"].cpu())
    (l_cpu, g_cpu, i_cpu), (l_gpu, g_gpu, i_gpu) = out[cpu], out[gpu]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    g_err = _rel_grad_err(g_gpu, g_cpu)
    i_err = ((i_gpu - i_cpu).abs().max() / i_cpu.abs().max()).item()
    print(f"tiny latent-paint step, card vs CPU: loss {l_gpu:+.6e} vs "
          f"{l_cpu:+.6e} (rel {rel:.2e}, tol 1e-4); max grad err / "
          f"max|grad| {g_err:.2e} (tol 1e-4); render err / max {i_err:.2e} "
          f"(tol 1e-4)")
    # the card's sin/cos differ from the host's in the last bit; that moves
    # the uv coordinates by ~1e-6, which the noisy 32² texture's slope
    # (~16 per unit uv) turns into ~2e-5 of the render
    if not (rel <= 1e-4 and g_err <= 1e-4 and i_err <= 1e-4):
        fail("the tiny latent-paint step on the card disagrees with the CPU "
             "step")

    # --- latent-paint-mesh: sphere, 24² grid, 32² texture, two cameras ----
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.core.views import ViewBatch
    from tpunerf_torch.guidance import sds as sds_lib
    mviews = ViewBatch(theta=torch.tensor([1.2, 0.9]),
                       phi=torch.tensor([0.4, 2.5]),
                       radius=torch.tensor([1.4, 1.3]),
                       dirs=torch.tensor([0, 2]),
                       is_body=torch.tensor([True, False]))
    for mode, body_prob, views_m in ((0, 0.5, mviews), (1, 1.0, mviews[:1])):
        mcfg = parse(TrainConfig, [
            "--guide.tiny_diffusion", "true", "--guide.unet_dtype", "float32",
            "--guide.shape_path", "sphere", "--guide.texture_resolution",
            "32", "--render.train_grid_size", "24", "--optim.mode", str(mode),
            "--render.body_prob", str(body_prob)])
        mapps = {d: LatentPaintMeshApp.create(
            mcfg, guidance=papps[d].guidance, device=d) for d in (cpu, gpu)}
        scene = mapps[cpu].scene
        scene.init_params(gen)
        with torch.no_grad():
            scene.displacement.copy_(0.01 * torch.randn(
                scene.displacement.shape, generator=gen))
            scene.texture_img_rgb_finetune.copy_(torch.rand(
                scene.texture_img_rgb_finetune.shape, generator=gen))
        mapps[gpu].scene.load_state_dict(scene.state_dict())
        n = views_m.batch_size
        draws = {"t": torch.tensor(500), "t_img": torch.tensor(500),
                 "t_nrm": torch.tensor(300),
                 "noise": torch.randn((n, 16, 16, 4), generator=gen)}
        for k in ("vae_noise_img", "vae_noise_nrm", "noise_img", "noise_nrm"):
            draws[k] = torch.randn((n, 16, 16, 4), generator=gen)
        # the SDS loss is a signed sum Σ latents·w(ε̂ − ε) that can cancel to
        # a value far below its terms, so the loss error is read on the scale
        # of what was summed: Σ|latents·w(ε̂ − ε)| of the CPU step (mode 1:
        # its two terms, the second at its weight of 0.5), recorded from
        # `score_gradient` as `sds_loss` calls it
        summed = []
        plain_score = sds_lib.score_gradient

        def recording_score(unet_apply, sched, latents, *args, **kwargs):
            grad, t = plain_score(unet_apply, sched, latents, *args, **kwargs)
            if latents.device == cpu:
                summed.append((latents.detach() * grad).abs().sum().item())
            return grad, t

        out = {}
        sds_lib.score_gradient = recording_score
        try:
            for d, app in mapps.items():
                loss, _ = app.loss_fn(views_m.to(d), draws={
                    k: v.to(d) for k, v in draws.items()})
                loss.backward()
                out[d] = (loss.item(), {k: p.grad.cpu() for k, p in
                                        app.scene.named_parameters()
                                        if p.grad is not None})
        finally:
            sds_lib.score_gradient = plain_score
        if len(summed) != (2 if mode else 1):
            fail(f"mode {mode} summed {len(summed)} SDS terms on the CPU")
        scale = sum(w * v for w, v in zip((1.0, 0.5), summed))
        (l_cpu, g_cpu), (l_gpu, g_gpu) = out[cpu], out[gpu]
        rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        rel_summed = abs(l_gpu - l_cpu) / scale
        g_err = _rel_grad_err(g_gpu, g_cpu)
        print(f"tiny latent-paint-mesh step, mode {mode}, card vs CPU: loss "
              f"{l_gpu:+.6e} vs {l_cpu:+.6e}, |diff| / sum|terms| "
              f"{rel_summed:.2e} (tol 1e-4; sum|terms| {scale:.4e}; |diff| / "
              f"|loss| {rel:.2e}); max grad err / max|grad| {g_err:.2e} (tol "
              f"2e-4) over {sorted(g_cpu)}")
        want = {"background_sphere_colors", "displacement",
                "texture_img" if mode == 0 else "texture_img_rgb_finetune"}
        want |= {"lights"} if mode else set()
        # gradients as latent-paint's, with the normals' scatter-add and the
        # barycentrics' gradient to the vertices on top
        if set(g_cpu) != want or not (rel_summed <= 1e-4 and g_err <= 2e-4):
            fail(f"the tiny latent-paint-mesh step (mode {mode}) on the card "
                 f"disagrees with the CPU step")
        # the soft silhouette's backward through the scene: d sum(mask²) /
        # d displacement, train render (24²) and eval render (32²), under
        # the one wide camera (at these two poses the sphere fills the body
        # and head cameras' fields: no rim, no gradient)
        if body_prob == 1.0:
            grads = {}
            for d, app in mapps.items():
                sc = app.scene
                v = views_m.to(d)
                got = []
                for mask in (sc.render_train(v)["soft_mask"],
                             sc.render_test(
                                 v, decode_fn=app.guidance.decode_latents,
                                 dims=(32, 32))["mask"]):
                    sc.zero_grad()
                    mask.square().sum().backward()
                    got.append(sc.displacement.grad.cpu().clone())
                grads[d] = got
            errs = [((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(grads[gpu], grads[cpu])]
            print(f"tiny soft-silhouette gradient to the displacement, card "
                  f"vs CPU: max err / max|grad| train {errs[0]:.2e}, eval "
                  f"{errs[1]:.2e} (tol 1e-3)")
            # the card's sin/cos move a vertex by ~1e-7, d² by 2·d·1e-7 and
            # each term's p = exp(−d²/σ) by ~2e-5 at σ = 1e-4; terms of both
            # signs cancel in a vertex's sum
            if not all(e <= 1e-3 for e in errs) or not all(
                    g.abs().max() > 0 for g in grads[cpu]):
                fail("the soft silhouette's gradient on the card disagrees "
                     "with the CPU")


def build_guidance(seed: int):
    """The full-width guidance stack, built once for both apps: SD-v1 UNet
    (bf16), CLIP ViT-L/14 and the SD-v1 VAE (f32), random from the seed."""
    import torch
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.utils import make_generator
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    guidance = StableDiffusionGuidance.create(
        unet_dtype="auto", device=dev, generator=make_generator(seed, dev))
    torch.cuda.synchronize()
    print(f"setup (UNet + CLIP + VAE build): {time.perf_counter() - t0:.2f} s")
    for name in ("unet", "text_encoder", "vae"):
        m = getattr(guidance, name)
        print(f"{name} parameters: {sum(p.numel() for p in m.parameters())} "
              f"({next(m.parameters()).dtype})")
    return guidance


def timed_train(trainer, steps: int):
    """`trainer.train()` with a synchronised stamp after every step.
    Returns (losses, step times, seconds from the last step to the end of
    train(), launch counts of the run)."""
    import torch
    from tpunerf_torch.kernels import _build
    stamps, losses = [], []

    def on_step(step, loss):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer.train(on_step=on_step)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    times = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    print("losses: " + " ".join(f"{v:+.4e}" for v in losses))
    print("step ms: " + " ".join(f"{1e3 * v:.2f}" for v in times))
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail("training produced a non-finite loss or missed steps")
    return losses, times, t_end - stamps[-1], launches


def train_full_width(steps: int, seed: int, guidance):
    """Full-width latent-NeRF training through the port's Trainer."""
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer

    exp_root = ROOT / "experiments" / "chip_smoke"
    cfg = parse(TrainConfig, [
        "--optim.iters", str(steps), "--optim.seed", str(seed),
        "--log.exp_root", str(exp_root), "--log.eval_size", "0",
        "--log.full_eval_size", "0", "--log.save_mesh", "false",
        "--log.log_images", "false", "--log.save_interval", str(steps + 1)],
        config_path=ROOT / "demo_configs" / "latent_nerf" /
        "sand_castle.yaml")
    t0 = time.perf_counter()
    app = LatentNeRFApp.create(cfg, guidance=guidance, device="cuda")
    trainer = Trainer(cfg, app, device="cuda")
    torch.cuda.synchronize()
    print(f"latent-NeRF setup (text embeddings, field): "
          f"{time.perf_counter() - t0:.2f} s")
    _, times, _, launches = timed_train(trainer, steps)
    # steady steps: past the first, excluding refresh steps (1, 16, 32, …)
    steady = sorted(t for i, t in enumerate(times, start=1)
                    if i > 1 and i % 16 != 0)
    med = steady[len(steady) // 2]
    rays = cfg.render.batch_size * cfg.render.train_grid_size ** 2
    print(f"latent-NeRF steady step: median {1e3 * med:.3f} ms over "
          f"{len(steady)} steps "
          f"({rays / med:.1f} rays/s); refresh step 16: "
          f"{1e3 * times[15]:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    occ_frac = app.metric_scalars().get("occ_frac")
    print(f"occ_frac after training: {occ_frac}")
    return launches, app, trainer


def train_paint_full_width(steps: int, seed: int, guidance):
    """Full-width latent-paint through the port's Trainer: `steps` SDS steps
    on the sphere, then the eval orbit (5 frames at 512², one chunk) and the
    mesh export, all inside `Trainer.train()`; the eval chunk is then timed
    again split into VAE decode and render."""
    import tempfile
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import circle_poses
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer

    n_eval = 5
    with tempfile.TemporaryDirectory(prefix="chip_smoke_paint_") as tmp:
        cfg = parse(TrainConfig, [
            "--guide.text", "a goldfish", "--guide.shape_path", "sphere",
            "--optim.iters", str(steps), "--optim.seed", str(seed),
            "--log.exp_root", tmp, "--log.exp_name", "paint",
            "--log.eval_size", "0", "--log.full_eval_size", str(n_eval),
            "--log.eval_batch", str(n_eval), "--log.save_mesh", "true",
            "--log.log_images", "false",
            "--log.save_interval", str(steps + 1)])
        t0 = time.perf_counter()
        app = LatentPaintApp.create(cfg, guidance=guidance, device="cuda")
        trainer = Trainer(cfg, app, device="cuda")
        torch.cuda.synchronize()
        scene = app.scene
        print(f"latent-paint setup (text embeddings, mesh, texture): "
              f"{time.perf_counter() - t0:.2f} s; mesh faces "
              f"{scene.mesh.num_faces}, dome faces "
              f"{scene.env_sphere.num_faces}, texture "
              f"{tuple(scene.texture_img.shape)}, train grid "
              f"{scene.render_grid_size}, text_z {tuple(app.text_z.shape)}, "
              f"guidance scale {cfg.guide.guidance_scale}")
        tex0 = scene.texture_img.detach().clone()
        _, times, tail_s, launches = timed_train(trainer, steps)
        steady = sorted(times[1:])
        med = steady[len(steady) // 2]
        print(f"latent-paint steady step: median {1e3 * med:.3f} ms over "
              f"{len(steady)} steps; first step {1e3 * times[0]:.1f} ms; "
              f"full eval ({n_eval} frames at {cfg.render.eval_grid_size}², "
              f"video/PNG encode, mesh export) {tail_s:.3f} s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        if torch.equal(tex0, scene.texture_img.detach()):
            fail("latent-paint training left the texture unchanged")
        if scene.texture_img_rgb_finetune.abs().max().item() != 0:
            fail("the frozen RGB texture was updated")
        # the path's kernels, and the binned sweep rather than its fallback:
        # two dense launches per step and none from the eval render
        want = {at.ATTN: 5 * steps, rz.DENSE: 2 * steps, rz.BINNED: 1}
        print("latent-paint launches: " + json.dumps(launches))
        for name, n in want.items():
            if launches.get(name, 0) != n:
                fail(f"latent-paint launched {name} "
                     f"{launches.get(name, 0)} times, expected {n}")
        exp = Path(tmp) / "paint"
        results = sorted(p.name for p in (exp / "results").iterdir())
        mesh_files = sorted(p.name for p in (exp / "mesh").iterdir())
        print(f"results: {results}; mesh: {mesh_files}")
        if mesh_files != ["albedo.png", "mesh.mtl", "mesh.obj"]:
            fail("mesh export is incomplete")

        # the eval chunk once more, by hand: frames checked and times split
        frames = trainer.evaluate(steps, size=n_eval)
        written = sorted((exp / "vis" / "eval").glob("*_rgb.png"))
        size = cfg.render.eval_grid_size
        if (len(frames) != n_eval or len(written) != n_eval
                or any(f.shape != (size, size, 3) for f in frames)):
            fail("the eval orbit did not write its frames")
        import numpy as np
        stack = np.stack(frames)
        if not ((stack == 255).all(-1).any() and (stack != 255).any()):
            fail("eval frames lack the white background or the mesh")
        views = circle_poses(n_eval, trainer.view_cfg, trainer.device)
        dims = (size, size)
        chunk_ms = cuda_ms(lambda: app.eval_render(views, dims), 3, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        decode_ms = cuda_ms(
            lambda: guidance.decode_latents(scene.texture_img), 3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rgb = guidance.decode_latents(scene.texture_img)
        with torch.no_grad():
            render_ms = cuda_ms(
                lambda: scene._render_views(views, rgb, dims, True), 5)
        print(f"eval chunk ({n_eval} views at {size}²): {chunk_ms:.3f} ms; "
              f"alone: VAE decode of {tuple(scene.texture_img.shape)} to "
              f"{tuple(rgb.shape)} {decode_ms:.3f} ms, render "
              f"{render_ms:.3f} ms; decode peak memory {peak:.3f} GiB")
    return launches, app, trainer


def _mesh_cfg(tmp: str, name: str, seed: int, mode: int, steps: int,
              n_eval: int, extra=()):
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    return parse(TrainConfig, [
        "--guide.text", "a goldfish", "--guide.shape_path", "sphere",
        "--optim.mode", str(mode), "--render.body_prob", "0.7",
        "--optim.iters", str(steps), "--optim.seed", str(seed),
        "--log.exp_root", tmp, "--log.exp_name", name,
        "--log.eval_size", "0", "--log.full_eval_size", str(n_eval),
        "--log.eval_batch", str(max(n_eval, 1)),
        "--log.save_mesh", "true" if n_eval else "false",
        "--log.log_images", "false", "--log.save_interval", str(steps + 1),
        *extra])


def train_mesh_full_width(steps: int, seed: int, guidance):
    """Full-width latent-paint-mesh through the port's Trainer: mode 0 for
    `steps` SDS steps on the sphere with the body and head cameras, the eval
    orbit (5 frames at 512², soft mask) and the export of the displaced
    mesh; then 4 steps each of modes 1 and 2. Returns the mode-0 run's
    launch counts with the largest mode-1 counts of the binned forward, the
    mode-0 app and trainer, and the mode-1 trainer."""
    import tempfile
    import numpy as np
    import torch
    from tpunerf_torch.core.obj_io import load_obj
    from tpunerf_torch.core.views import circle_poses, rand_poses
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer

    n_eval = 5
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        cfg = _mesh_cfg(tmp, "mesh", seed, 0, steps, n_eval)
        t0 = time.perf_counter()
        app = LatentPaintMeshApp.create(cfg, guidance=guidance, device=DEVICE)
        trainer = Trainer(cfg, app, device=DEVICE)
        torch.cuda.synchronize()
        scene = app.scene
        print(f"latent-paint-mesh setup (two prompt banks, mesh, Laplacian, "
              f"texture): {time.perf_counter() - t0:.2f} s; mesh faces "
              f"{scene.mesh.num_faces}, vertices {scene.mesh.num_vertices}, "
              f"Laplacian edges {scene.laplacian.src.numel()}, cameras "
              f"{scene.camera} / {scene.head_camera}, sigma "
              f"{scene.soft_mask_sigma}, lr {cfg.optim.lr} / disp_lr "
              f"{cfg.optim.disp_lr}")
        # which eval renders overflow their soft bins and take the dense sweep
        ev = circle_poses(n_eval, trainer.view_cfg, trainer.device)
        size = cfg.render.eval_grid_size
        n_over = 0
        with torch.no_grad():
            for label, spec in (("body", scene.camera),
                                ("head", scene.head_camera)):
                fv_img = mrender._project(
                    scene.mesh.vertices, scene.mesh.faces, ev.theta, ev.phi,
                    ev.radius, spec)[1]
                maxc = int(rz._soft_bins(fv_img, size, size,
                                         scene.soft_mask_sigma,
                                         rz._SOFT_BIN_K)[1])
                n_over += maxc > rz._SOFT_BIN_K
                print(f"eval soft bins, {label} camera: largest "
                      f"{maxc} of K = {rz._SOFT_BIN_K}"
                      + (" (overflow: dense sweep)"
                         if maxc > rz._SOFT_BIN_K else ""))
            # how much rim (0.01 < mask < 0.99) a training render gives the
            # soft forward to work on: poses sampled as the trainer samples
            n_pose, grid = 8, scene.render_grid_size
            tv = rand_poses(n_pose, trainer.view_cfg, trainer.device,
                            generator=torch.Generator(
                                device=trainer.device).manual_seed(seed))
            for label, spec in (("body", scene.camera),
                                ("head", scene.head_camera)):
                soft = rz.soft_silhouette(grid, grid, mrender._project(
                    scene.mesh.vertices, scene.mesh.faces, tv.theta, tv.phi,
                    tv.radius, spec)[1], scene.soft_mask_sigma)
                print(f"training renders, {label} camera, {n_pose} sampled "
                      f"poses at {grid}²: rim pixels "
                      f"{int(((soft > 0.01) & (soft < 0.99)).sum())}, "
                      f"uncovered pixels {int((soft <= 0.01).sum())} of "
                      f"{soft.numel()}")
        before = {k: v.detach().clone()
                  for k, v in scene.named_parameters()}
        _, times, tail_s, launches = timed_train(trainer, steps)
        steady = sorted(times[1:])
        med = steady[len(steady) // 2]
        print(f"latent-paint-mesh mode 0 steady step: median "
              f"{1e3 * med:.3f} ms over {len(steady)} steps; first step "
              f"{1e3 * times[0]:.1f} ms; full eval ({n_eval} frames at "
              f"{size}², video/PNG encode, mesh export) {tail_s:.3f} s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        for k in ("texture_img", "background_sphere_colors", "displacement"):
            if torch.equal(before[k], getattr(scene, k).detach()):
                fail(f"latent-paint-mesh training left {k} unchanged")
        if scene.texture_img_rgb_finetune.abs().max().item() != 0:
            fail("the frozen RGB texture was updated")
        # per step: both cameras render (2 soft forwards, 2 mesh selections)
        # and the dome (1 selection); the eval chunk: both cameras at 512²
        # (binned unless a camera's bins overflow, which the lines above
        # foretell for the soft ones); no loss reads the soft mask, so no
        # backward kernel runs
        n = lambda name: launches.get(name, 0)  # noqa: E731
        print("latent-paint-mesh launches: " + json.dumps(launches))
        if not (n(at.ATTN) == 5 * steps
                and n(rz.DENSE) + n(rz.BINNED) == 3 * steps + 2
                and n(rz.DENSE) >= 3 * steps
                and n(rz.SOFT_FWD_DENSE) == 2 * steps + n_over
                and n(rz.SOFT_FWD_BINNED) == 2 - n_over
                and n(rz.SOFT_BWD_DENSE) == n(rz.SOFT_BWD_BINNED) == 0):
            fail("latent-paint-mesh launched its kernels an unexpected "
                 "number of times")
        exp = Path(tmp) / "mesh"
        results = sorted(p.name for p in (exp / "results").iterdir())
        mesh_files = sorted(p.name for p in (exp / "mesh").iterdir())
        print(f"results: {results}; mesh: {mesh_files}")
        if mesh_files != ["albedo.png", "mesh.mtl", "mesh.obj"]:
            fail("mesh export is incomplete")
        moved = np.abs(load_obj(exp / "mesh" / "mesh.obj").vertices
                       - scene.mesh.vertices.cpu().numpy()).max()
        print(f"exported vertices moved by up to {moved:.3e} "
              f"({steps} steps at disp_lr {cfg.optim.disp_lr})")
        if not 0 < moved <= steps * cfg.optim.disp_lr * 1.05:
            fail("the exported mesh does not carry the displacement")
        frames = trainer.evaluate(steps, size=n_eval)
        if (len(frames) != n_eval
                or any(f.shape != (size, size, 3) for f in frames)
                or not (np.stack(frames) == 255).all(-1).any()):
            fail("the latent-paint-mesh eval orbit did not give its frames")
        chunk_ms = cuda_ms(lambda: app.eval_render(ev, (size, size)), 3,
                           warmup=1)
        rgb = guidance.decode_latents(scene.texture_img)
        with torch.no_grad():
            render_ms = cuda_ms(lambda: scene._render_views(
                ev, rgb, (size, size), True,
                displacement=scene.displacement), 5)
        print(f"latent-paint-mesh eval chunk ({n_eval} views at {size}², "
              f"both cameras): {chunk_ms:.3f} ms, of which render "
              f"{render_ms:.3f} ms")

        # --- modes 1 and 2, 4 steps each, on the same guidance ------------
        extra_steps = 4
        mode1 = None
        for mode, extra in ((1, ("--render.train_grid_size", "512")), (2, ())):
            mcfg = _mesh_cfg(tmp, f"mode{mode}", seed, mode, extra_steps, 0,
                             extra)
            mapp = LatentPaintMeshApp.create(mcfg, guidance=guidance,
                                             device=DEVICE)
            mtrainer = Trainer(mcfg, mapp, device=DEVICE)
            rgb0 = mapp.scene.texture_img_rgb_finetune.detach().clone()
            _, mtimes, _, mlaunch = timed_train(mtrainer, extra_steps)
            msteady = sorted(mtimes[1:])
            print(f"latent-paint-mesh mode {mode} "
                  f"(train grid {mcfg.render.train_grid_size}): step median "
                  f"{1e3 * msteady[len(msteady) // 2]:.3f} ms over "
                  f"{len(msteady)} steps; first {1e3 * mtimes[0]:.1f} ms; "
                  f"peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
                  f"launches {json.dumps(mlaunch)}")
            if torch.equal(rgb0, mapp.scene.texture_img_rgb_finetune.detach()):
                fail(f"mode {mode} left the RGB texture unchanged")
            if mapp.scene.lights.grad is None:
                fail(f"mode {mode} gave the lights no gradient")
            soft = (mlaunch.get(rz.SOFT_FWD_DENSE, 0)
                    + mlaunch.get(rz.SOFT_FWD_BINNED, 0))
            # mode 1: two UNet passes a step (image and blended latents)
            if soft != 2 * extra_steps or mlaunch.get(at.ATTN, 0) != \
                    5 * extra_steps * (2 if mode == 1 else 1):
                fail(f"mode {mode} launched its kernels an unexpected "
                     f"number of times")
            if mode == 1:
                mode1 = (mapp, mtrainer, mlaunch)
            else:
                del mapp, mtrainer
    return launches, app, trainer, mode1


def silhouette_phase(app, trainer, guidance):
    """The path that launches the soft silhouette's backward kernels at
    full width: d sum(mask²) / d displacement through
    `render_train(...)["soft_mask"]` at 64² (dense, #9) and through
    `render_test(...)["mask"]` at 512² with autograd on (binned, #10), at
    the orbit's radius, where the body camera sees the sphere's rim.
    Returns the launch counts."""
    import torch
    from tpunerf_torch.core.views import circle_poses
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import rasterize as rz

    scene = app.scene
    size = trainer.cfg.render.eval_grid_size
    views = circle_poses(5, trainer.view_cfg, trainer.device)
    _build.reset_launches()
    out = {}
    for label, render in (
            (f"render_train soft_mask {scene.render_grid_size}²",
             lambda: scene.render_train(views[:1])["soft_mask"]),
            (f"render_test mask {size}²",
             lambda: scene.render_test(
                 views, decode_fn=guidance.decode_latents,
                 dims=(size, size))["mask"])):
        scene.zero_grad()
        t0 = time.perf_counter()
        mask = render()
        mask.square().sum().backward()
        torch.cuda.synchronize()
        grad = scene.displacement.grad
        rim = int(((mask > 0.01) & (mask < 0.99)).sum().item())
        print(f"silhouette phase, {label}: d sum(mask²)/d displacement max "
              f"{grad.abs().max().item():.4e}, finite "
              f"{bool(torch.isfinite(grad).all())}, rim pixels {rim}, "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms (first call)")
        if not torch.isfinite(grad).all() or not grad.abs().max() > 0:
            fail(f"{label}: no finite non-zero gradient reached the "
                 f"displacement")
        out[label] = grad.abs().max().item()
    scene.zero_grad()
    launches = dict(_build.LAUNCHES)
    print("silhouette phase launches: " + json.dumps(launches))
    if launches.get(rz.SOFT_BWD_DENSE, 0) <= 0:
        fail("the silhouette phase never launched the dense backward")
    return launches


def mesh_breakdown(app, trainer, mode1) -> None:
    """The latent-paint-mesh step's layers, each alone, by CUDA events."""
    import torch
    from tpunerf_torch.core.views import rand_poses
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender

    dev, gen, scene = trainer.device, trainer.generator, app.scene
    guidance = app.guidance
    views = rand_poses(1, trainer.view_cfg, dev, generator=gen)

    def render_fwd_bwd():
        out = scene.render_train(views)
        (out["image"].square().mean() + out["laplacian_loss"]
         + out["displacement_norm"]).backward()

    def soft_only():
        with torch.no_grad():
            for spec in (scene.camera, scene.head_camera):
                fv_img = mrender._project(
                    scene.mesh.vertices, scene.mesh.faces, views.theta,
                    views.phi, views.radius, spec)[1]
                rz.soft_silhouette(scene.render_grid_size,
                                   scene.render_grid_size, fv_img,
                                   scene.soft_mask_sigma)

    parts = {
        "mesh render fwd+bwd (both cameras: 2 projections, normals, 2 "
        "selections #5, 2 soft silhouettes #7, interpolation, sampling; dome; "
        "composite; Laplacian)": render_fwd_bwd,
        "  of which soft silhouette (2 x projection, rows, kernel #7)":
            soft_only,
        "Adam step (texture, dome, displacement, lights)":
            trainer.optimizer.step,
    }
    for name, fn in parts.items():
        print(f"layer {name}: {cuda_ms(fn, 10):.4f} ms")
    # mode 1's two encodes: 512² RGB -> latents, forward and backward
    img = torch.rand((1, guidance.image_size, guidance.image_size, 3),
                     device=dev, generator=gen, requires_grad=True)

    def encodes():
        lat = guidance.encode_imgs(img, generator=gen) + guidance.encode_imgs(
            1.0 - img, generator=gen)
        lat.square().sum().backward()

    torch.cuda.reset_peak_memory_stats()
    print(f"layer mode 1's two VAE encodes ({guidance.image_size}², f32, "
          f"fwd+bwd to the image): {cuda_ms(encodes, 3, warmup=1):.4f} ms; "
          f"peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if mode1 is not None:
        mapp, mtrainer, _ = mode1
        mviews = rand_poses(1, mtrainer.view_cfg, dev, generator=gen)

        def render512():
            out = mapp.scene.render_train(mviews, with_lighting=True)
            (out["image"] * out["lighting"]).square().mean().backward()

        print(f"layer mode 1 mesh render at "
              f"{mapp.scene.render_grid_size}² fwd+bwd (both cameras, "
              f"lighting, binned kernels #6 and #8): "
              f"{cuda_ms(render512, 5):.4f} ms")


def paint_breakdown(app, trainer) -> None:
    """The latent-paint step's layers, each alone, by CUDA events."""
    import torch
    from tpunerf_torch.core.views import circle_poses, rand_poses
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.kernels import texture as texk
    from tpunerf_torch.meshrep import render as mrender

    dev, gen, scene = trainer.device, trainer.generator, app.scene
    views = rand_poses(1, trainer.view_cfg, dev, generator=gen)

    def render_fwd_bwd():
        out = scene.render_train(views)
        out["image"].square().mean().backward()

    parts = {
        "mesh render fwd+bwd (2 projections, 2 selections #5, interpolation,"
        " texture sampling, composite)": render_fwd_bwd,
        "Adam step (texture + dome colours)": trainer.optimizer.step,
    }
    for name, fn in parts.items():
        print(f"layer {name}: {cuda_ms(fn, 10):.4f} ms")
    # the 512² eval render of 5 views, without the decode
    ev = circle_poses(5, trainer.view_cfg, dev)
    tex = torch.rand((1, 1024, 1024, 3), device=dev, generator=gen)
    with torch.no_grad():
        ms = cuda_ms(lambda: scene._render_views(ev, tex, (512, 512), True),
                     5)
        print(f"layer eval render (5 views at 512², selection #6 with "
              f"binning, interpolation, texture sampling): {ms:.4f} ms")
        spec = mrender.CameraSpec(look_at_height=scene.dy)
        fv_cam, fv_img, _ = mrender._project(
            scene.mesh.vertices, scene.mesh.faces, ev.theta, ev.phi,
            ev.radius, spec)
        pix = rz.pixel_grid_ndc(512, 512, dev)
        valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
        fz = fv_cam[..., 2]
        ms = cuda_ms(lambda: rz._select_faces_batched(pix, fv_img, fz, valid,
                                                      512, 512), 5)
        print(f"  of which selection (rows, bins, overflow read, kernel, "
              f"slot→id): {ms:.4f} ms")
        uv = torch.rand((5, 512, 512, 2), device=dev, generator=gen)
        texb = tex.expand(5, -1, -1, -1)
        ms = cuda_ms(lambda: texk.texture_mapping(uv, texb, "bilinear"), 5)
        print(f"  of which texture sampling (bilinear): {ms:.4f} ms")


def breakdown(app, trainer, steps: int = 5) -> None:
    """Where a steady full-width latent-NeRF step's time goes: each layer
    alone, timed with CUDA events, then the profiler's view of `steps`
    train steps."""
    import torch
    from tpunerf_torch.core.views import rand_poses
    from tpunerf_torch.training.latent_nerf_app import select_text_embeddings

    dev, gen = trainer.device, trainer.generator
    scene, guidance = app.scene, app.guidance
    views = rand_poses(1, trainer.view_cfg, dev, generator=gen)
    text_z = select_text_embeddings(app.text_z, views.dirs)
    lat = torch.randn((1, 64, 64, 4), device=dev, generator=gen)
    t = torch.tensor(500, device=dev)

    def render_fwd_bwd():
        out = scene.render_train(views, generator=gen)
        (out["image"].square().mean() + out["sparsity_loss"]).backward()

    def unet_cfg_pass():
        with torch.no_grad():
            guidance.unet_apply(torch.cat([lat, lat]), t, text_z)

    parts = {
        "render fwd+bwd (rays, occupancy, compaction, field, composite)":
            render_fwd_bwd,
        "UNet CFG pass (batch 2, 64x64, no grad)": unet_cfg_pass,
        "Adam step (field)": trainer.optimizer.step,
        "occupancy refresh (128^3 jittered density)":
            lambda: scene.update_occupancy(generator=gen),
    }
    for name, fn in parts.items():
        print(f"layer {name}: {cuda_ms(fn, 10):.4f} ms")
    profile_steps(trainer, "latent-NeRF", steps)


def profile_steps(trainer, label: str, steps: int = 5) -> None:
    """The profiler's device time by kernel over `steps` train steps and
    the device's idle share of their wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    # the kernels themselves (device-side events), not the host ops that
    # launched them, so that no time counts twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    print(f"profiled {label} steady step (profiler on): wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    # the 15 largest, and the port's own kernels wherever they rank
    ranked = sorted(events, key=dev_us, reverse=True)
    own = ("select_", "soft_", "hashgrid_", "occgrid_", "attention_")
    for e in ranked[:15] + [e for e in ranked[15:]
                            if any(tag in e.key for tag in own)]:
        print(f"  kernel {dev_us(e) / 1e3 / steps:8.4f} ms/step "
              f"x{e.count / steps:6.1f}  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "tpunerf_torch" / "csrc").is_dir():
        fail(f"no tpunerf_torch package beside {Path(__file__).name}")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")

    from tpunerf_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"nvcc build of {len(logs)} sources: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    rows = check_kernels(args.seed)
    paint_rows = check_raster_kernels(args.seed)
    soft_rows = check_soft_kernels(args.seed)
    check_small_steps(args.seed)
    guidance = build_guidance(args.seed)
    launches, app, trainer = train_full_width(STEPS, args.seed, guidance)
    missing = [n for n in rows if launches.get(n, 0) <= 0]
    if missing:
        fail(f"latent-NeRF path never launched {missing}")
    breakdown(app, trainer)
    del app, trainer
    paint_launches, papp, ptrainer = train_paint_full_width(
        STEPS, args.seed, guidance)
    paint_breakdown(papp, ptrainer)
    profile_steps(ptrainer, "latent-paint")
    del papp, ptrainer
    mesh_launches, mapp, mtrainer, mode1 = train_mesh_full_width(
        STEPS, args.seed, guidance)
    sil_launches = silhouette_phase(mapp, mtrainer, guidance)
    mesh_breakdown(mapp, mtrainer, mode1)
    profile_steps(mtrainer, "latent-paint-mesh mode 0")
    if mode1 is not None:
        profile_steps(mode1[1], "latent-paint-mesh mode 1", steps=2)
    # each kernel's count comes from the run of the path that was checked
    # for it: the latent-NeRF run for the first four (the attention kernel
    # is on both paths; train_paint_full_width holds its count there too),
    # the latent-paint run for the two selection kernels, the
    # latent-paint-mesh run for the soft forwards (the binned one from its
    # eval chunk or, where those bins overflow, from mode 1's 512² steps),
    # the silhouette phase for the soft backwards
    from tpunerf_torch.kernels import rasterize as rz
    kernels = [dict(row, launches=launches.get(name, 0))
               for name, row in rows.items()]
    kernels += [dict(row, launches=paint_launches.get(name, 0))
                for name, row in paint_rows.items()]
    soft_counts = {
        rz.SOFT_FWD_DENSE: mesh_launches.get(rz.SOFT_FWD_DENSE, 0),
        rz.SOFT_FWD_BINNED: mesh_launches.get(rz.SOFT_FWD_BINNED, 0)
        or (mode1[2].get(rz.SOFT_FWD_BINNED, 0) if mode1 else 0),
        rz.SOFT_BWD_DENSE: sil_launches.get(rz.SOFT_BWD_DENSE, 0),
        rz.SOFT_BWD_BINNED: sil_launches.get(rz.SOFT_BWD_BINNED, 0)}
    kernels += [dict(row, launches=soft_counts[name])
                for name, row in soft_rows.items()]
    if any(k["launches"] <= 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    # the card once more, where the end of a long output still shows it
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
