#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpunerf_torch) on one NVIDIA card.

1. Builds the CUDA kernels of tpunerf_torch/csrc/ with nvcc (sm_90a).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the full-width latent-NeRF and latent-paint paths, and times
   kernel, plain version and (for attention) PyTorch's SDPA with CUDA
   events.
3. Checks a tiny step of each app on the card against the same step on the
   CPU.
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


def _rel_grad_err(got, ref) -> float:
    return max(((got[k] - g).abs().max() / g.abs().max()).item()
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
    own = ("select_", "hashgrid_", "occgrid_", "attention_")
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
    # each kernel's count comes from the run of the path that was checked
    # for it: the latent-NeRF run for the first four (the attention kernel
    # is on both paths; train_paint_full_width holds its count there too),
    # the latent-paint run for the two selection kernels
    kernels = [dict(row, launches=launches.get(name, 0))
               for name, row in rows.items()]
    kernels += [dict(row, launches=paint_launches.get(name, 0))
                for name, row in paint_rows.items()]
    if any(k["launches"] <= 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
