#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpunerf_torch) on one NVIDIA card.

1. Builds the CUDA kernels of tpunerf_torch/csrc/ with nvcc (sm_90a).
2. Holds each of the first ten kernels against its plain PyTorch version
   on the card at the shapes of the full-width latent-NeRF, latent-paint and
   latent-paint-mesh paths, and times kernel, plain version and (for
   attention) PyTorch's SDPA with CUDA events; attention also in a CUDA
   graph, against f32 attention, beside its bound by bytes, tensor-core
   operations and exponentials, with the tensor-core opcodes of its SASS.
   The hash-grid kernels #1 and #2 also in a CUDA graph, beside the
   level-per-block designs of both (timed in the same call), at uniform x with N(0,1) and
   with heavy-tailed g; #2 bit for bit against its fixed-point emulation,
   and its SASS free of compare-and-swap loops. The soft-silhouette
   forwards #7 and #8, which cull per warp tile, at their inputs (#7: 64²
   wide and head camera, 512² dense; #8: the 5-view eval chunk and one
   mode-1 view at 512²) eager and in a CUDA graph beside the all-pairs
   designs, bit for bit against them, with the bound of the live pairs
   (factor 1 - p != 1.0f), the all-pairs bound and the cull's candidate
   pairs; and on faces with NaN or inf vertices against the plain version.
   The face-selection kernels #5 and #6, which cull per warp tile by an
   exact edge test, the same way at their inputs (#5: mesh and dome at
   64², the eval chunk's 5 views dense at 512²; #6: the eval chunk and one
   mode-1 view at 512²) beside the all-pairs designs, bit for bit against
   them and the plain versions, there and on edge/tie and NaN/inf sets.
   The occupancy lookup #3 (four samples a thread, products for a
   power-of-two bound) beside its first design, at uniform x with a slice
   on cell walls, at 4x the samples and at 4 samples (a graph node's
   floor), checked exactly there, at a bound of 0.7 and on an offset view.
   The binned soft backward #10 (culled per warp tile, live tiles only, a
   fixed-order sum to faces) beside its first design with `index_add_`, at
   the eval chunk and one mode-1 view with random g, within 2e-5 of plain
   and that design, 1e-4 of the dense #9, bit-identical over two calls,
   with the pairs within the margin, candidate, live and all pairs and
   both bounds. The dense soft backward #9 (the same cull after a first
   pass that lists each view's live tiles, 32 faces a block, a fixed-order
   sum to faces) beside its first design, eager and in a CUDA graph, at
   (a) the wide camera and (b) the head camera at 64² with random g and
   (c) the eval chunk's 5 views dense at 512² (the overflow fallback),
   within 2e-5 of plain and that design, 1e-4 of #10, bit-identical over
   two calls, with its live pixels and tiles, kept, within-margin,
   candidate and live pairs and both bounds; on the degenerate, outside,
   padded and NaN/inf sets; its -Xptxas -v free of spills. The four soft
   kernels #7-#10 on a sliver set (256 needles of 1e-6 to 1e-5 rad beside
   the sphere, pixels on their axes where plain's rounded inside test
   holds far from the face) against plain: the culls keep slivers.
3. Runs the hash-grid table gradient's cost-split experiment (kernel #11;
   `python -m tpunerf_torch.scripts.exp_hash_bwd`) at full width
   (N = 262,144, L=12, T=2^11, F=2): the first design
   (`hashgrid_bwd_variant`, four modes at five points-per-block settings,
   `full` at 8192 against kernel #2) and the split of today's #2
   (`hashgrid_bwd_split`: full, gmax, addr, accum, reduce at 0.5x ... 4x
   the resident blocks, `full` at 1x equal to #2), each timed in a CUDA
   graph and held against its plain version (the split's bit for bit).
4. Checks a tiny step of each app (and of latent-NeRF with config #3's
   sketch-shape loss, of config #5's depth-guided latent-paint-mesh at B =
   2, and of Paint-by-Example latent-paint-mesh with `use_clip` in both
   branches), the soft silhouette's gradient to the displacement and a
   tiny latent-NeRF eval chunk on the card against the same on the CPU.
   The card's depth and Paint-by-Example stacks are read by their
   `create(model_dir=...)` from tiny diffusers-layout directories the CPU
   stacks are written into (depth with `use_inpaint=True,
   inpaint_model_dir=...`), equal to them bit for bit.
5. Trains the port's latent-NeRF app at full width (hash grid L=12, T=2^11;
   128^3 occupancy grid; S=128, K=64 at 64x64; the 859M-parameter SD-v1
   UNet, the CLIP ViT-L/14 text tower and the SD-v1 VAE, random-initialised
   from the seed) through `Trainer.train()` at sand_castle.yaml's defaults,
   cut to 24 steps (so that the occupancy refreshes at steps 1 and 16 run)
   and a checkpoint every 12: the 10-frame eval orbit at 512^2 before step
   1 and after each checkpoint, train images at 5 %, asynchronous
   checkpoints, the 100-frame final orbit and the mesh export (the 64^3
   iso-surface at 10 as OBJ/MTL/albedo under mesh/). It copies the x,
   table and g that reach #1 and
   #2 and the samples that reach #3 on step 10, and what reaches #1 and #3
   in the first eval chunk, and then times those kernels, and their first
   designs, on those ray-ordered inputs. It times the eval chunk (render,
   VAE decode) and a save (to its return, to the end of the write), then
   resumes a second Trainer from the checkpoint (state equal bit for bit,
   two more finite steps) and runs the CLI with log.eval_only.
6. (after 9 (c)) Eval config #3 end to end with the same guidance:
   `lego_man.yaml --guide.shape_path sphere` (`shapes/teddy.obj` is not in
   the repo): the sphere's 48^3 SDF grid built by the C++ library
   (`tpunerf_torch/native`, g++ at first use); then the stage-1 runs of 5
   and (b), (e) on lego_man.yaml: 24 eager steps through the Trainer with
   the shape loss of each step (checkpoints at 12 and 24, the 10-frame
   evals, a 10-frame final orbit, the mesh export), 24 steps with
   `--optim.train_chunk 8` (every launch accounted for, the trace, the
   steady step graphed beside eager); its step 1 is held graphed against
   eager in (a). Then the NeRF->mesh bridge on its step-24 checkpoint:
   `train_latent_nerf_mesh.extract_mesh_from_checkpoint` at 128^3 and iso
   10 twice (density grid on the card through #1, 32 chunks of 65,536
   points; marching tetrahedra on the host; equal bit for bit), the paint
   stage as the CLI builds it with the built stack (the UV build timed, 4
   latent-paint steps, a 5-frame eval chunk at 512^2: #4, #5, #6 or its
   dense fallback, the export), #5 on the extracted mesh's rows and pixels
   as the training render and the eval chunk give them (bit for bit
   against the plain version and the all-pairs design, timed, with their
   bounds), and #1 against its plain version on the density grid's first
   chunk.
   Then trains the port's latent-paint app at full width with the same guidance
   (procedural sphere of 3968 faces, 960-face background dome, 128^2 latent
   texture, 64x64 train grid) through `Trainer.train()`, which ends with the
   eval orbit (5 frames at 512^2: VAE decode of the texture to 1024^2,
   band-binned face selection, texture sampling) and the mesh export.
7. Trains the port's latent-paint-mesh app at full width with the same
   guidance (sphere, body and head cameras at body_prob 0.7, displacement,
   normals, soft silhouette): mode 0 for 24 steps through `Trainer.train()`
   with the eval orbit (5 frames at 512^2, soft mask by the binned kernel)
   and the export of the displaced mesh, then 4 steps each of mode 1 (TADA,
   512^2 renders, two VAE encodes) and mode 2 (SDEdit).
8. Drives the soft silhouette's backward kernels through the scene: the
   gradient of sum(mask^2) to the displacement through
   `render_train(...)["soft_mask"]` at 64^2 and `render_test(...)["mask"]`
   at 512^2 (no loss of the app reads the soft mask, so no training step
   launches them), then times #10 and #9 ((d) at 64²) on that phase's own
   g = 2 mask and prod beside their first designs.
9. Config #4 end to end, the latent→RGB refine stage and the chunked
   trainer (`optim.train_chunk`: one step captured in a CUDA graph and
   replayed k times a chunk):
   (a) before 5, a full-width step of stage 1, of the refine stage, of
       config #3 and of latent-paint, captured and replayed against the same step run
       eagerly twice from the same state (parameters, buffers, Adam's
       moments, the generator): bit for bit where the eager runs agree,
       else each tensor within its own stated bound, with the operations
       that have no deterministic form named (the refine step, which names
       none, bit for bit under deterministic algorithms);
   (b) after 5, stage 1 again with `--optim.train_chunk 8`: chunks of 8
       and 4, the refreshes of steps 1 and 16 between replays, checkpoints
       and evals on the eager run's steps (final orbit cut to 10 frames);
       the steady step graphed beside eager in turns, the profiler's idle
       share of graphed steps and the launches a replay; the run's launches
       exactly 25 steps' worth (24 replays and the capture's warm-up step)
       and the eager launches of its evals and refreshes;
   (e) in the same run `--log.trace_steps 5,9`, whose trace holds the
       kernels of #1-#4, each as many times as the window's replays times
       what the capture recorded, plus the refresh between them;
   (c) the refine stage from (b)'s step-24 checkpoint: the migration (3
       channel heads, the rest the checkpoint's), the refine step's split
       (render; resize + VAE encode fwd+bwd; UNet CFG pass), graphed beside
       eager, one RGB eval chunk (one pose at 512²) with its peak memory
       and #1, #3 on its inputs; then the CLI, `--render.nerf_type rgb
       --optim.ckpt <ckpt> --optim.train_chunk 8`, 16 steps with the
       10-frame RGB evals and a 10-frame final orbit;
   (d) after 6, latent-paint trains again with `--optim.train_chunk 4`
       (its launches exactly 25 steps' worth and the eval's, graphed beside
       eager after it) and its latent checkpoint is refined in RGB mode
       (the texture decoded into the finetune texture), 8 steps.
10. Eval config #5 end to end, after 8 (the SD-v1 stack's phases): its own
    depth-conditioned stack (5-channel UNet with a 1024-wide context in
    bf16, the 1024-wide 23-layer text tower and the VAE in f32, the
    9-channel inpainting UNet), `nascar_depth.yaml` on the sphere through
    the Trainer (mode 0, B = 2, 24 eager steps, the 5-frame eval orbit at
    512² before step 1 and after the checkpoint at 24, the final orbit and
    the export), its setup time, steady step median, p90 and max, peak
    memory and launches of #4-#8; the profiler's device busy time and idle
    share of its eager step; the depth UNet's CFG pass (batch 4), the
    eval chunk and its VAE decode; one masked img2img walk through the
    inpaint window and one txt2img, timed and checked finite; then #4 at
    its (4, 8, 4096, 40) against plain, beside SDPA. The stack is freed
    after the phase.
11. The Paint-by-Example cell, after 10 (`train_pbe_full_width`): a 512²
    exemplar written by `write_png` from the seed and read back by
    `read_png`, then `--guide.use_sd false --guide.image <it>
    --optim.use_clip true --guide.shape_path sphere --render.body_prob
    0.7` through the Trainer with its own stack (the 9-channel UNet in
    bf16, the VAE and two ViT-L/14 towers in f32): 24 eager steps in both
    branches (SDS, and the CLIP branch at t <= 400, differentiated through
    the DDIM step, the f32 VAE decode and the tower), the 5-frame eval
    orbit before step 1 and after the checkpoint at 24, the final orbit and
    the export; the steady step by branch, a profiled step of each, the
    layers (UNet CFG pass, `encode_exemplar`, the decode's and the tower's
    forward and backward), the eval chunk, peak memory and the launches of
    #4-#8. The stack is freed after the phase.
12. The attention backward, #12 (dK, dV) and #13 (dQ), after 2: at (2, 8,
    4096, 40) bf16 (a UNet pass), (4, 8, 4096, 40) (config #5's batch),
    D = 64 and 128 in bf16 and (1, 1, 4096, 32) f32, each against
    `attention_bwd_plain` on the forward kernel's own output and
    log-sum-exp (the LSE against plain too), in bf16 also against f32
    autograd and, in bf16, against the earlier mma.sync design (kept for
    timing), two calls bit for bit, eager and, in turns with that design and
    SDPA's backward (a yardstick only), in a CUDA graph beside the plain
    backward, with bounds; the wgmma instances' HGMMA counts in their SASS.
    Then, after 8, with the SD-v1 stack: text-token optimisation at its
    defaults (4 DDIM steps through the UNet, the f32 VAE decode and a
    ViT-L/14 image tower; Adam at 1e-3) cut to 4 of 100 steps, with its
    losses, step ms, peak and launches (20 forwards and 19 of each backward
    kernel a step), and one step's gradient through the kernels against
    the same step through `attention_bwd_plain` (beside that step with a
    fault planted in one layer's backward) and each of its 19 backward
    calls against `attention_bwd_plain` on the call's own inputs, and two
    profiled steps with #12 + #13's share of the device's busy time;
    null-text inversion at its defaults but 5 inner steps (`invert` over
    50 DDIM steps, `null_optimization` 50 x 5, cut from 50 x 10) with its
    seconds, peak and launches, the fitted embeddings' retrace
    and a profiled 2 x 5 run (#12 + #13's share of its busy time); `prompt_to_img` (50 steps) and one DDS step, timed.
13. Pretrained weights, after the SD-v1 stack is built (`weights_phase`):
    the stack written as a diffusers-layout directory (the bf16 UNet as
    BF16 safetensors, the VAE as F32 safetensors in the older attention
    naming, the text tower as `text_encoder/pytorch_model.bin` with the
    `text_model.` prefix and a stray `position_ids`), read back on the card
    by `create(model_dir=...)` (every parameter and one CFG pass through #4
    equal to the source's bit for bit), the latent-NeRF CLI from
    `--guide.model_dir` for 4 steps (sand_castle.yaml; evals, images and
    the export cut) and the port's `convert_sd_weights --dtype bfloat16`
    on the directory; the bytes and seconds of the write, the read and the
    CLI's first step, beside the card's name and power limit. At most 90 s;
    the directory is removed after it.
14. The bin-overflow choice on the device (`check_gates`, after 2): each of
    #5-#10 at the eval chunk's shapes with its gate open (equal to plain
    and to the ungated call) and shut (its output untouched), and the ms a
    launch costs in a CUDA graph shut and open. Then latent-paint-mesh with
    `--optim.train_chunk 8` (`chunked_mesh_phase`, after 9; and at the
    ends of 10 and 11 on their own stacks): mode 0, mode 1 at 512² (bins
    hold) and 256² (its judged step on a view whose selection bins
    overflow), mode 2, config #5 and Paint-by-Example with `use_clip` (a
    draw graph and a step graph a branch, judged once on each branch):
    each graphed step against two eager runs (`judge_graphed`), 16 steps
    in chunks of 8 with every launch accounted for by the replays' recorded
    launches, the step in turns (eager, graph, graph, eager), profiled
    replays with the idle share, the launches a replay (by branch) and the
    peak memory.
For each path the launch counters are reset just before and read just after;
a replay counts the launches its capture recorded.

The profiles of the paint, mode-0 and mode-1 steps end with the selection
kernels' device ms a step.
Prints the device line, one line per check, a `{"kernels": [...]}` line (the
eleven kernels, then the kept first designs with "main_path": false and the
launches of their checks, then #12 and #13 with the text-token run's
launches and their kept mma.sync design with its check's) and, last, `{"ok": true, "device": {...}}`.
Exits non-zero, printing no result, when there is no CUDA device, when the
package is missing, or when any phase fails.

    python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 24      # > 16, so that the refreshes at steps 1 and 16 both run
DEVICE = "cuda"  # where the latent-paint-mesh phases build and run


START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def mark(phase: str) -> None:
    """The script's seconds so far, as a phase starts."""
    print(f"[{time.perf_counter() - START:.1f} s] {phase}", flush=True)


sys.path.insert(0, str(ROOT))
try:
    # the card's peaks, bounds and CUDA-event timing, shared with the
    # experiments
    from tpunerf_torch.scripts.card import (bound, bound_terms, cuda_ms,
                                           max_sm_mhz, nvidia_smi)
except ImportError as exc:
    fail(f"no tpunerf_torch package beside {Path(__file__).name} ({exc})")


def hash_grid_rows(x, table, g, cfg, label: str):
    """Kernels #1 and #2 on (x, table) and (x, g): each against its plain
    version (1e-5 of the largest value; #2 also bit for bit against its
    fixed-point emulation); eager and CUDA-graph times beside the
    level-per-block designs (#1: `hashgrid_fwd_level`; #2: #11's `full` at
    8192 points per block), the plain version, the bound and the share of the bound.
    Returns the two kernels' rows (#2's None where g is None: #1 alone)."""
    import torch
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = x.shape[0]
    flops = N * L * 8 * (2 + 2 * F)
    if g is None:
        print(f"hash grid, {label}: N={N} (#1 alone)")
    else:
        zero_g = (g == 0).all(dim=1).float().mean().item()
        print(f"hash grid, {label}: N={N}, rows of g all zero {zero_g:.4f}")
    calls = {
        hg.FWD: (lambda: hg.hash_encode_cuda(x, table, cfg),
                 lambda: hg.hash_encode_level_cuda(x, table, cfg),
                 lambda: hg.hash_encode_plain(x, table, cfg),
                 x.numel() + table.numel() + N * L * F,
                 "tpunerf/kernels/hashgrid.py:252")}
    if g is not None:
        calls[hg.BWD] = (
            lambda: hg.hash_bwd_cuda(x, g, cfg),
            lambda: hg.hash_bwd_variant_cuda(x, g, cfg, "full", 8192),
            lambda: hg.hash_bwd_plain(x, g, cfg),
            x.numel() + g.numel() + L * T * F,
            "tpunerf/kernels/hashgrid.py:408")
    rows = {}
    for name, (new, old, plain, words, site) in calls.items():
        out, ref, before = new(), plain(), old()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()   # f32, other summation order
        old_err = (before - ref).abs().max().item()
        print(f"{name} {label}: max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"level-per-block design {old_err:.3e}")
        if not (err <= tol and old_err <= tol):
            fail(f"{name} disagrees with its plain version ({label})")
        if name == hg.BWD:
            blocks = hg.bwd_blocks(N, cfg, x.device)
            emu = hg.hash_bwd_fixed_point_plain(x, g, cfg, blocks)
            if not torch.equal(out, emu):
                fail(f"{name} differs from its fixed-point emulation "
                     f"({label})")
        b_ms, b_by = bound(4 * words, flops, "f32")
        ms, old_ms = cuda_ms(new, 50), cuda_ms(old, 50)
        graph, _ = ex.graph_ms(new, 50)
        old_graph, _ = ex.graph_ms(old, 50)
        ms2 = cuda_ms(new, 50)     # new, old, old, new in one call
        rows[name] = dict(
            name=name, route="cuda", source="tpunerf_torch/csrc/hashgrid.cu",
            replaces=site, max_abs_err=err, ms=ms, graph_ms=graph,
            eager_ms_again=ms2, level_per_block_ms=old_ms,
            level_per_block_graph_ms=old_graph,
            plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / graph, library_ms=None)
        print(f"  {name} {label}: eager {ms:.4f} / {ms2:.4f} ms, graph "
              f"{graph:.4f} ms; level-per-block design eager {old_ms:.4f}, graph "
              f"{old_graph:.4f}; plain {rows[name]['plain_ms']:.4f}; bound "
              f"{b_ms:.4f} ms ({b_by}), share {b_ms / graph:.3f} (graph)")
    return rows[hg.FWD], rows.get(hg.BWD)


def occgrid_case(x, packed, G: int, bnd: float, label: str,
                 iters: int = 50):
    """Kernel #3 and its first design on x: each against the plain version
    (0 mismatches); CUDA-graph and eager times of both in the order new,
    old, old, new; the bound (bytes: xyz, words, flags) and its share."""
    import torch
    from tpunerf_torch.kernels import occgrid as og
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    new = lambda: og.occupancy_lookup_cuda(x, packed, G, bnd)  # noqa: E731
    old = lambda: og.occupancy_lookup_scalar_cuda(  # noqa: E731
        x, packed, G, bnd)
    out, before = new(), old()
    ref = og.occupancy_lookup_plain(x, packed, G, bnd)
    torch.cuda.synchronize()
    mism = int((out != ref).sum().item())
    mism_old = int((before != ref).sum().item())
    n = x.shape[:-1].numel()
    b_ms, b_by = bound(x.numel() * 4 + packed.numel() * 4 + n, n * 12, "f32")
    graph, _ = ex.graph_ms(new, iters)
    old_graph, _ = ex.graph_ms(old, iters)
    old_graph2, _ = ex.graph_ms(old, iters)
    graph2, _ = ex.graph_ms(new, iters)
    ms, old_ms = cuda_ms(new, iters), cuda_ms(old, iters)
    case = dict(n=n, mismatches=mism, graph_ms=graph, graph_ms_again=graph2,
                ms=ms, scalar_graph_ms=old_graph,
                scalar_graph_ms_again=old_graph2, scalar_ms=old_ms,
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / graph)
    print(f"  #3 {label}, n={n}: mismatches {mism}, first design {mism_old} "
          f"(tol 0); graph {graph:.4f} / {graph2:.4f} ms, eager {ms:.4f}; "
          f"first design graph {old_graph:.4f} / {old_graph2:.4f}, eager "
          f"{old_ms:.4f}; bound {b_ms:.5f} ms ({b_by}), share "
          f"{b_ms / graph:.3f} (graph)")
    if mism or mism_old:
        fail(f"occupancy lookup disagrees with its plain version ({label})")
    return case


def check_kernels(seed: int):
    """Each kernel vs its plain version at full-width shapes. Returns
    {name: row} without launch counts (the kept first designs' rows carry
    the launches of their timing here)."""
    import torch
    from tpunerf_torch.fields.encoding import HashGridConfig
    from tpunerf_torch.fields.occupancy import OccupancyGridConfig
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = {}
    _build.reset_launches()

    # --- #1/#2 hash grid: N = 1·64²·K points, default config -------------
    cfg = HashGridConfig()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    N = 64 * 64 * 64
    x = torch.rand((N, 3), generator=gen, device=dev)
    table = torch.rand((L, T, F), generator=gen, device=dev) * 2 - 1
    g = torch.randn((N, L * F), generator=gen, device=dev)
    fwd, bwd = hash_grid_rows(x, table, g, cfg, "uniform x, N(0,1) g")
    # (b) heavy-tailed g: 1 % of the entries scaled by 1e4
    heavy = torch.rand(g.shape, generator=gen, device=dev) < 0.01
    _, bwd_heavy = hash_grid_rows(x, table, torch.where(heavy, g * 1e4, g),
                                  cfg, "uniform x, heavy-tailed g")
    bwd["heavy_tailed_g"] = {k: bwd_heavy[k] for k in (
        "max_abs_err", "ms", "graph_ms", "level_per_block_ms",
        "level_per_block_graph_ms")}
    rows[hg.FWD], rows[hg.BWD] = fwd, bwd
    rows[hg.FWD_LEVEL] = dict(
        fwd, name=hg.FWD_LEVEL, ms=fwd["level_per_block_ms"],
        graph_ms=fwd["level_per_block_graph_ms"], main_path=False,
        launches=_build.LAUNCHES.get(hg.FWD_LEVEL, 0))
    sass = dict(ex.sass_atomics().get("hashgrid_bwd_kernel", {}))
    print(f"hashgrid_bwd SASS atomics: {sass}")
    if "ATOMS.ADD" not in sass or any("CAS" in op for op in sass):
        fail("kernel #2's shared adds are not native ATOMS.ADD")

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
    print("occgrid_lookup (#3) against its first design (one sample a "
          "thread, six quotients):")
    cases = {"a": occgrid_case(xs, packed, G, ocfg.bound,
                               "(a) uniform x and cell walls")}
    # 4x the samples, and 4 samples (a graph node's floor)
    x4 = torch.rand((4, 4096, 128, 3), generator=gen, device=dev) * 2 - 1
    cases["4x"] = occgrid_case(x4, packed, G, ocfg.bound, "4x the samples")
    cases["floor"] = occgrid_case(xs.reshape(-1, 3)[:4], packed, G,
                                  ocfg.bound, "4 samples, the launch floor")
    # where the rounding of another bound decides: quotients, and an offset
    # view on the one-sample path (checked, not timed)
    for label, x, bnd in (("bound 0.7", xs * 0.7, 0.7),
                          ("offset view", xs.reshape(-1, 3)[1:], 1.0)):
        got = og.occupancy_lookup_cuda(x, packed, G, bnd)
        mism = int((got != og.occupancy_lookup_plain(x, packed, G,
                                                     bnd)).sum().item())
        print(f"  {label}: mismatches {mism} (tol 0)")
        if mism:
            fail(f"occupancy lookup disagrees with its plain version "
                 f"({label})")
    a = cases["a"]
    rows[og.LOOKUP] = dict(
        name=og.LOOKUP, route="cuda", source="tpunerf_torch/csrc/occgrid.cu",
        replaces="tpunerf/kernels/occgrid.py:139",
        max_abs_err=float(a["mismatches"]), ms=a["ms"],
        graph_ms=a["graph_ms"],
        plain_ms=cuda_ms(lambda: og.occupancy_lookup_plain(xs, packed, G,
                                                           ocfg.bound), 5),
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
        inputs=cases)
    rows[og.LOOKUP_SCALAR] = dict(
        rows[og.LOOKUP], name=og.LOOKUP_SCALAR, ms=a["scalar_ms"],
        graph_ms=a["scalar_graph_ms"], main_path=False,
        launches=_build.LAUNCHES.get(og.LOOKUP_SCALAR, 0),
        inputs={k: {"ms": c["scalar_ms"], "graph_ms": c["scalar_graph_ms"]}
                for k, c in cases.items()})

    # --- #4 attention: (2, 8, 4096, 40), the UNet's 64² self-attention ----
    rows[at.ATTN] = check_attention(gen)
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}")
    return rows


def attention_sass(source: str = "attention"):
    """{kernel: Counter of tensor-core opcodes} in `cuobjdump -sass` of the
    built attention library (or `source`'s), one entry per template
    instance; `WARPGROUP.DEPBAR` counts the waits on wgmma."""
    import re
    from collections import Counter
    from tpunerf_torch.scripts.card import sass_functions
    found = {}
    for head, chunk in sass_functions(source).items():
        m = re.search(r"(?<=\d)(attention_\w*?_kernel)ILi(\d+)E(?:Lb(\d)E)?",
                      head)
        if m:
            which = {None: "", "1": ", dkv", "0": ", dq"}[m.group(3)]
            found[f"{m.group(1)}<{m.group(2)}{which}>"] = Counter(
                re.findall(r"\b(HGMMA|HMMA|WARPGROUP\.DEPBAR)\b", chunk))
    return found


def check_attention(gen):
    """#4 at the UNet's shape: f32 and bf16 against the plain version, bf16
    also against f32 attention; kernel and SDPA eager and in a CUDA graph;
    the bound by bytes, tensor-core operations and ex2; the tensor-core
    opcodes of the built kernels. Returns the kernel's row."""
    import torch
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    B, H, S, D = 2, 8, 4096, 40
    scale = D ** -0.5
    errs = {}
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        # bf16: the plain path rounds the probabilities to bf16 before P·V
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
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
    # bf16 against attention in f32 on the same (bf16) inputs: the kernel
    # may err at most twice as much as the plain bf16 path
    ref = at.attention_plain(q.float(), k.float(), v.float(), scale)
    e_kernel = (o.float() - ref).abs().max().item()
    e_plain = (r.float() - ref).abs().max().item()
    print(f"attention_fwd bf16 vs f32 attention: kernel {e_kernel:.3e}, "
          f"plain bf16 {e_plain:.3e} (tol {2 * e_plain + 1e-6:.3e})")
    if not e_kernel <= 2 * e_plain + 1e-6:
        fail("bf16 attention kernel is further from f32 than the plain path")

    # the main path's dtype: bf16 under unet_dtype "auto"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms_f32 = cuda_ms(lambda: at.attention_cuda(*(t.float() for t in (q, k, v)),
                                               scale), 3)
    print(f"attention_fwd f32 {(B, H, S, D)}: {ms_f32:.4f} ms")

    def kernel():
        return at.attention_cuda(q, k, v, scale)

    def library():
        return sdpa(q, k, v, scale=scale)

    ms = cuda_ms(kernel, 20)
    lib_ms = cuda_ms(library, 20)
    iters = 20
    before = _build.LAUNCHES.get(at.ATTN, 0)
    graph_ms, out = ex.graph_ms(kernel, iters)
    ran = _build.LAUNCHES.get(at.ATTN, 0) - before
    lib_graph_ms, _ = ex.graph_ms(library, iters)
    torch.cuda.synchronize()
    if ran != ex.WARMUP + 2 * iters or not torch.equal(out, o):
        fail(f"attention graph: {ran} launches ran, not "
             f"{ex.WARMUP + 2 * iters}, or its output differs from eager")
    mhz = max_sm_mhz()
    nbytes = 4 * B * H * S * D * 2
    flops = 4 * B * H * S * S * D
    ex2 = B * H * S * S   # one exponential per score
    terms = bound_terms(nbytes, flops, "bf16", ex2, mhz)
    b_ms, b_by = bound(nbytes, flops, "bf16", ex2, mhz)
    print(f"attention_fwd bf16 {(B, H, S, D)}: kernel {ms:.4f} ms eager, "
          f"{graph_ms:.4f} ms graph ({ran} launches ran); SDPA {lib_ms:.4f} "
          f"ms eager, {lib_graph_ms:.4f} ms graph; f32 kernel {ms_f32:.4f} ms")
    print(f"attention_fwd bound: bytes {terms['bytes']:.4f} ms, bf16 tensor "
          f"cores {terms['bf16']:.4f} ms, ex2 {terms['ex2']:.4f} ms ({ex2} at "
          f"16 a clock per SM, {mhz} MHz max SM clock) -> {b_ms:.4f} ms; "
          f"share of the bound: eager {b_ms / ms:.3f}, graph "
          f"{b_ms / graph_ms:.3f}")
    sass = attention_sass()
    for name, ops in sass.items():
        print(f"attention SASS {name}: {dict(ops) or 'no tensor-core op'}")
    if not any(ops for name, ops in sass.items() if "bf16" in name):
        fail("no HGMMA/HMMA in the bf16 attention kernel's SASS")
    return dict(
        name=at.ATTN, route="cuda", source="tpunerf_torch/csrc/attention.cu",
        replaces="tpunerf/guidance/unet.py:167",
        max_abs_err=errs[torch.bfloat16], ms=ms, graph_ms=graph_ms,
        plain_ms=cuda_ms(lambda: at.attention_plain(q, k, v, scale), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library_graph_ms=lib_graph_ms, f32_ms=ms_f32)


def check_hash_bwd_experiment(seed: int):
    """Kernel #11, the hash-grid table gradient's cost split, through the
    experiment's `run` (`python -m tpunerf_torch.scripts.exp_hash_bwd`) at
    full width: every mode and points per block against its plain version,
    `full` at 8192 against kernel #2. Returns the kernel's row with this
    run's launches."""
    import torch
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    cfg = ex.CFG
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    n = ex.FULL_N
    iters = 20   # calls a graph (the experiment's default is 50): ~0.4 s
    _build.reset_launches()
    rows = ex.run("cuda", n=n, seed=seed, iters=iters)
    launches = _build.LAUNCHES.get(hg.VARIANT, 0)
    # the kernels that ran: each variant's warm-ups and two graph replays
    if launches != len(rows) * (ex.WARMUP + 2 * iters):
        fail(f"the experiment counted {launches} launches of {hg.VARIANT}, "
             f"not {len(rows) * (ex.WARMUP + 2 * iters)}")
    for r in rows:
        print(ex.format_row(r))
    if not all(r["ok"] for r in rows):
        fail("a hash-grid backward variant disagrees with its plain version")
    for line in ex.split_lines(rows):
        print(line)

    x, g = ex.make_inputs(n, seed, "cuda")
    full = hg.hash_bwd_variant_cuda(x, g, cfg, "full", 8192)
    base = hg.hash_bwd_cuda(x, g, cfg)
    torch.cuda.synchronize()
    err = (full - base).abs().max().item()
    tol = ex.REL_TOL * base.abs().max().item()   # atomics: order varies
    print(f"hashgrid_bwd_variant full ppb=8192 vs hashgrid_bwd: max_abs_err "
          f"{err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail("the variant full at 8192 disagrees with kernel #2")
    flat, wg = ex.index_add_operands(x, g)
    b_ms, b_by = ex.bound_ms(n)
    mhz = max_sm_mhz()
    at8192 = next(r for r in rows
                  if r["mode"] == "full" and r["points_per_block"] == 8192)
    row = dict(
        name=hg.VARIANT, route="cuda", source="tpunerf_torch/csrc/hashgrid.cu",
        replaces="scripts/exp_hash_bwd.py:146", launches=launches,
        max_abs_err=at8192["max_abs_err"], ms=at8192["ms"],
        plain_ms=cuda_ms(lambda: hg.hash_bwd_variant_plain(
            x, g, cfg, "full", 8192), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.zeros(
            (L * T, F), device="cuda").index_add_(0, flat, wg), 5),
        atomics_bound_ms=None if mhz is None else ex.atomics_bound_ms(
            n, mhz),
        variants={f"{r['mode']}@{r['points_per_block']}": r["ms"]
                  for r in rows})
    print(f"  {row['name']}: full@8192 {row['ms']:.4f} ms (CUDA graph), "
          f"plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"shared atomics {row['atomics_bound_ms']} ms at {mhz} MHz, "
          f"index_add_ {row['library_ms']:.4f} ms, launches {launches}")
    row["main_path"] = False   # the first design of #11, beside the split

    # #11 since its redesign: today's #2 taken apart on its own grid, every
    # mode at 0.5x ... 4x the resident blocks, bit for bit against plain
    base_ms, _ = ex.graph_ms(lambda: hg.hash_bwd_cuda(x, g, cfg), iters)
    _build.reset_launches()
    srows = ex.run_split("cuda", n=n, seed=seed, iters=iters)
    split_launches = _build.LAUNCHES.get(hg.SPLIT, 0)
    if split_launches != len(srows) * (ex.WARMUP + 2 * iters):
        fail(f"the split counted {split_launches} launches of {hg.SPLIT}, "
             f"not {len(srows) * (ex.WARMUP + 2 * iters)}")
    print(f"kernel #2 (hashgrid_bwd) in a CUDA graph: {base_ms:.4f} ms")
    for r in srows:
        print(ex.format_split_row(r, base_ms, b_ms))
    if not all(r["ok"] for r in srows):
        fail("a part of the split of #2 disagrees with its plain version, "
             "or full at 1x with #2")
    for line in ex.split_sum_lines(srows):
        print(line)
    at1 = {r["mode"]: r for r in srows if r["factor"] == 1}
    blocks = at1["full"]["blocks"]
    split_row = dict(
        name=hg.SPLIT, route="cuda", source="tpunerf_torch/csrc/hashgrid.cu",
        replaces="scripts/exp_hash_bwd.py:146", launches=split_launches,
        max_abs_err=0.0, ms=at1["full"]["ms"], graph_ms=at1["full"]["ms"],
        plain_ms=cuda_ms(lambda: hg.hash_bwd_split_plain(
            x, g, cfg, "full", blocks), 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=row["library_ms"],
        kernel_2_graph_ms=base_ms,
        modes={f"{r['mode']}@{r['factor']}x": r["ms"] for r in srows})
    print(f"  {hg.SPLIT}: full@1x {split_row['ms']:.4f} ms (CUDA graph; #2 "
          f"{base_ms:.4f}), plain {split_row['plain_ms']:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), share {b_ms / split_row['ms']:.3f}, "
          f"launches {split_launches}")
    return split_row, row


SEL_FLOPS = 25   # per face-pixel pair: 4 affine forms, 3 compares, a select


def _sel_live_pairs(rz, rows, pix, ids=None) -> int:
    """The (face, pixel) pairs whose pixel passes all three edges of the
    face, under the plain sweep's arithmetic: dense rows (B, F, 12) against
    every pixel or, with ids (B, nb, K), each band's bin slots against the
    band's pixels (the filler passes none)."""
    import torch
    B = rows.shape[0]
    if ids is None:
        n, per = rows.shape[1], B * pix.shape[0]
        px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
        take = lambda a, b: rows[:, a:b]  # noqa: E731
    else:
        nb, n = ids.shape[1:]
        per = B * nb * 1024
        px, py = (a[None, :, None, :] for a in rz._band_pixels(pix, nb))
        bidx = torch.arange(B, device=rows.device)[:, None, None]
        take = lambda a, b: rows[bidx, ids[:, :, a:b].long()]  # noqa: E731
    chunk = max(1, (1 << 26) // per)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for a in range(0, n, chunk):
        t = take(a, a + chunk).unsqueeze(-1)
        hit = torch.ones((), dtype=torch.bool, device=rows.device)
        for i in (0, 3, 6):
            hit = hit & ((t[..., i, :] * px + t[..., i + 1, :] * py
                          + t[..., i + 2, :]) >= 0.0)
        total += hit.sum()
    return int(total.item())


def _sel_candidate_pairs(rz, rows, pix, width: int, ids=None) -> int:
    """The (face, pixel) pairs that kernels #5 and #6 evaluate: the (tile,
    face) pairs their tiles' corner test keeps (`_sel_kept`, the kernels'
    twin) times the 32 lanes of a tile; #6 over every slot of a bin (the
    filler is skipped), #5 before its block's coarser test."""
    import torch
    banded = ids is not None
    boxes = rz._sel_tile_boxes(pix, width, banded)
    total = 0
    if not banded:
        for a in range(0, rows.shape[1], 256):
            total += int(rz._sel_kept(rows[:, a:a + 256], boxes).sum().item())
        return 32 * total
    B, nb, K = ids.shape
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    boxes = boxes.reshape(nb, 32, 4)
    for a in range(0, K, 64):
        tab = rows[bidx, ids[:, :, a:a + 64].long()]
        total += int(rz._sel_kept(tab, boxes).sum().item())
    return 32 * total


def _sel_case(rz, label: str, new, sweep, plain, rows, pix, width: int,
              iters: int, ids=None):
    """One input of kernel #5 or #6: the culled kernel bit for bit against
    the all-pairs design (`sweep`) and the plain version; eager and
    CUDA-graph times of both in the order new, old, old, new; the live-pair
    bound (what the inputs need), the all-pairs bound (what the all-pairs design
    evaluates: every face, or every filled slot, at every pixel), the
    candidate pairs of the cull."""
    import torch
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    out, before, ref = new(), sweep(), plain()
    torch.cuda.synchronize()
    mism = int((out != ref).sum().item())
    same = torch.equal(out, before)
    B, n = rows.shape[:2]
    if ids is None:
        all_pairs = B * n * pix.shape[0]
    else:
        all_pairs = int((ids < n - 1).sum().item()) * 1024
    live = _sel_live_pairs(rz, rows, pix, ids)
    cand = _sel_candidate_pairs(rz, rows, pix, width, ids)
    nbytes = 4 * (rows.numel() + pix.numel() + out.numel()
                  + (0 if ids is None else ids.numel()))
    b_ms, b_by = bound(nbytes, live * SEL_FLOPS, "f32")
    all_ms, all_by = bound(nbytes, all_pairs * SEL_FLOPS, "f32")
    ms, old_ms = cuda_ms(new, iters), cuda_ms(sweep, iters)
    old_graph, _ = ex.graph_ms(sweep, iters)
    graph, _ = ex.graph_ms(new, iters)
    ms2 = cuda_ms(new, iters)
    case = dict(mismatches=mism, equals_sweep=same, ms=ms, graph_ms=graph,
                eager_ms_again=ms2, sweep_ms=old_ms,
                sweep_graph_ms=old_graph, live_pairs=live,
                candidate_pairs=cand, all_pairs=all_pairs,
                live_per_candidate=live / max(cand, 1), bound_ms=b_ms,
                bound_by=b_by, all_pairs_bound_ms=all_ms,
                all_pairs_bound_by=all_by, share_of_bound=b_ms / graph,
                sweep_share_of_all_pairs_bound=all_ms / old_graph,
                covered=int((ref >= 0).sum().item()))
    print(f"  {label}: mismatches vs plain {mism} (tol 0), equals the "
          f"all-pairs design bit for bit: {same}; eager {ms:.4f} / {ms2:.4f} ms, graph "
          f"{graph:.4f} ms; the all-pairs design eager {old_ms:.4f}, graph "
          f"{old_graph:.4f}; pairs live {live}, candidate {cand} "
          f"(live/candidate {live / max(cand, 1):.4f}), all {all_pairs}; "
          f"bound {b_ms:.5f} ms ({b_by}; all pairs {all_ms:.4f}); share "
          f"{b_ms / graph:.4f} (graph), the all-pairs design {all_ms / old_graph:.4f}"
          f" of the all-pairs bound; covered pixels {case['covered']}")
    if mism or not same or not case["covered"]:
        fail(f"{label}: the culled selection disagrees with its plain "
             f"version or with the all-pairs design")
    return case


def _sel_hard_rows(dev, gen, n: int = 400):
    """Face rows that stress the cull: vertices on pixel centres of the 64²
    grid with coplanar copies (edges, exact z ties), zero-area faces,
    coordinates up to 1e20 (inf and NaN coefficients), and hand-set
    coefficients ±0, ±inf, NaN."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz
    fv = (torch.rand((n, 1, 2), generator=gen, device=dev) * 2.2 - 1.1
          + torch.rand((n, 3, 2), generator=gen, device=dev) * 0.4 - 0.2)
    cells = torch.randint(0, 64, (40, 3, 2), generator=gen, device=dev)
    fv[:40] = (cells.float() + 0.5) / 32 - 1.0
    fv[40:60] = fv[:20]
    fv[60:70, 2] = fv[60:70, 1]
    fv[70:100] *= 10.0 ** torch.randint(0, 21, (30, 1, 1), generator=gen,
                                        device=dev).float()
    z = torch.rand((n, 3), generator=gen, device=dev) * 2 - 3
    z[40:60] = z[:20]
    rows = rz._face_rows(fv[None], z[None],
                         torch.ones((1, n), dtype=torch.bool, device=dev))
    vals = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                         float("nan")], device=dev)
    pick = torch.randint(0, 5, (80, 12), generator=gen, device=dev)
    hit = torch.rand((80, 12), generator=gen, device=dev) < 0.2
    rows[0, 100:180] = torch.where(hit, vals[pick], rows[0, 100:180])
    return rows.contiguous()


def check_raster_kernels(seed: int):
    """The two face-selection kernels, which cull per warp tile, bit for bit
    against the all-pairs designs and their plain versions: on the
    projected sphere and dome at the latent-paint shapes (#5 (a) mesh and
    (b) dome at 64², (c) the eval chunk's 5 views dense at 512², the
    overflow fallback; #6 (a) the eval chunk, B = 5 at 512², (b) one
    mode-1 view, B = 1), each eager and in a CUDA graph beside the
    all-pairs design with its live-pair, candidate and all-pairs counts, and on the
    edge/tie and NaN/inf sets. Returns {name: row} without launch counts
    (the all-pairs designs' rows carry the launches of their timing here)."""
    import torch
    from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                          rand_poses)
    from tpunerf_torch.kernels import _build
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
    _build.reset_launches()

    def project(m, views, camera=spec):
        fv_cam, fv_img, _ = mrender._project(m.vertices, m.faces, views.theta,
                                             views.phi, views.radius, camera)
        valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
        return fv_img, fv_cam[..., 2], valid

    def dense_calls(r, pix, width):
        return (lambda: rz.select_faces_dense_cuda(r, pix, width),
                lambda: rz.select_faces_dense_sweep_cuda(r, pix),
                lambda: rz.select_faces_dense_plain(r, pix))

    def binned_calls(r, ids, pix, width):
        return (lambda: rz.select_faces_binned_cuda(r, ids, pix, width),
                lambda: rz.select_faces_binned_sweep_cuda(r, ids, pix),
                lambda: rz.select_faces_binned_plain(r, ids, pix))

    # --- #5 dense: 64² train grid, B = 1, a few sampled poses -------------
    pix = rz.pixel_grid_ndc(64, 64, dev)
    P = pix.shape[0]
    poses = rand_poses(4, vcfg, dev, generator=gen)
    first = {}
    for label, m in (("mesh", mesh), ("dome", dome)):
        face_rows = rz._face_rows(*project(m, poses))
        mism = hits = 0
        for b in range(face_rows.shape[0]):
            r = face_rows[b:b + 1].contiguous()
            got = rz.select_faces_dense_cuda(r, pix, 64)
            old = rz.select_faces_dense_sweep_cuda(r, pix)
            ref = rz.select_faces_dense_plain(r, pix)
            torch.cuda.synchronize()
            mism += int((got != ref).sum().item() + (got != old).sum().item())
            hits += int((ref >= 0).sum().item())
        print(f"select_faces_dense {label} F={face_rows.shape[1]} P={P}, 4 "
              f"poses: mismatches vs plain and the all-pairs design {mism} (tol 0, "
              f"exact); covered pixels {hits}")
        if mism or not hits:
            fail(f"dense selection kernel disagrees with its plain version "
                 f"({label})")
        first[label] = face_rows[:1].contiguous()
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
    got = rz.select_faces_dense_cuda(r, pix, 64)
    old = rz.select_faces_dense_sweep_cuda(r, pix)
    ref = rz.select_faces_dense_plain(r, pix)
    torch.cuda.synchronize()
    on_edge = int(((r[0, :, None, 0:9:3] * pix[None, :, 0:1]
                    + r[0, :, None, 1:9:3] * pix[None, :, 1:2]
                    + r[0, :, None, 2:9:3]) == 0).any(-1).any(0).sum().item())
    mism = int((got != ref).sum().item() + (got != old).sum().item())
    print(f"select_faces_dense edge/tie set F={n + 200}: mismatches vs plain "
          f"and the all-pairs design {mism} (tol 0, exact); pixels on an edge of "
          f"some face {on_edge}; copies that won "
          f"{int((ref >= n).sum().item())} (must be 0)")
    if mism or not on_edge or int((ref >= n).sum().item()):
        fail("dense selection kernel breaks the edge or tie rule")
    # NaN, inf, ±0 coefficients and huge coordinates, dense and banded (every
    # face in each of the 4 bands' bins, the filler after them)
    hard = _sel_hard_rows(dev, gen)
    F = hard.shape[1]
    hard_f = torch.cat([hard, rz._filler_row(dev).expand(1, 1, 12)],
                       dim=1).contiguous()
    ids_all = torch.arange(512, dtype=torch.int32, device=dev).clamp(
        max=F).expand(1, 4, -1).contiguous()
    outs = [rz.select_faces_dense_cuda(hard, pix, 64),
            rz.select_faces_dense_cuda(hard, pix, 0),
            rz.select_faces_dense_sweep_cuda(hard, pix)]
    bouts = [rz.select_faces_binned_cuda(hard_f, ids_all, pix, 64),
             rz.select_faces_binned_cuda(hard_f, ids_all, pix, 0),
             rz.select_faces_binned_sweep_cuda(hard_f, ids_all, pix)]
    ref = rz.select_faces_dense_plain(hard, pix)
    bref = rz.select_faces_binned_plain(hard_f, ids_all, pix)
    torch.cuda.synchronize()
    mism = (sum(int((o != ref).sum().item()) for o in outs)
            + sum(int((o != bref).sum().item()) for o in bouts))
    print(f"selection NaN/inf/degenerate set F={F}: non-finite coefficients "
          f"{int((~torch.isfinite(hard)).sum().item())}; mismatches of both "
          f"kernels (both tilings) and the all-pairs designs vs plain {mism} (tol "
          f"0, exact); covered pixels {int((ref >= 0).sum().item())}")
    if mism:
        fail("the culled selection mishandles NaN, inf or degenerate rows")

    # --- the §5 inputs ----------------------------------------------------
    print("select_faces_dense (#5) and select_faces_binned (#6) against PR "
          "2's designs (8 x 4 tiles dense, 16 x 2 in a 512-wide band):")
    cases5 = {}
    for key, label in (("a", "mesh, 64² wide camera"), ("b", "dome, 64²")):
        r = first["mesh" if key == "a" else "dome"]
        cases5[key] = _sel_case(rz, f"#5 ({key}) {label} F={r.shape[1]}",
                                *dense_calls(r, pix, 64), r, pix, 64, 50)
    H = W = 512
    pix512 = rz.pixel_grid_ndc(H, W, dev)
    K = rz._BIN_K
    nb = H * W // 1024
    ylo, yhi = rz._band_ranges(H, W, nb, dev)
    fv_img, fv_z, valid = project(mesh, circle_poses(5, vcfg, dev))
    B, F = valid.shape
    if not rz.uses_bins(H, W, F, K):
        fail("the eval render does not engage the band bins")
    ids, maxc = rz._bin_faces(fv_img, valid, ylo, yhi, K)
    if int(maxc) > K:
        fail(f"a band bin overflows on the eval orbit ({int(maxc)} > {K})")
    dense5 = rz._face_rows(fv_img, fv_z, valid).contiguous()
    face_rows = torch.cat([dense5, rz._filler_row(dev).expand(B, 1, 12)],
                          dim=1).contiguous()
    cases5["c"] = _sel_case(rz, "#5 (c) eval chunk's 5 views dense at 512², "
                            "the overflow fallback", *dense_calls(
                                dense5, pix512, W), dense5, pix512, W, 10)
    cases6 = {"a": _sel_case(
        rz, f"#6 (a) eval chunk, B={B} 512² K={K} (largest bin {int(maxc)})",
        *binned_calls(face_rows, ids, pix512, W), face_rows, pix512, W, 20,
        ids)}
    # the binned result mapped to face ids equals the dense kernel's
    got = rz.select_faces_binned_cuda(face_rows, ids, pix512, W)
    fid = torch.gather(ids, 2, got.clamp(min=0).long())
    fid = torch.where(got >= 0, fid, -1).reshape(B, -1)
    vs_dense = int((fid != rz.select_faces_dense_cuda(dense5, pix512,
                                                      W)).sum().item())
    print(f"  #6 (a) slots as face ids vs the dense kernel: mismatches "
          f"{vs_dense}; binning (ranges, mask, rank, scatter) "
          f"{cuda_ms(lambda: rz._bin_faces(fv_img, valid, ylo, yhi, K), 10):.4f}"
          f" ms")
    if vs_dense:
        fail("binned selection disagrees with the dense kernel")
    fv1, fz1, v1 = project(mesh, rand_poses(1, vcfg, dev, generator=gen),
                           mrender.BODY_CAMERA)
    ids1, maxc1 = rz._bin_faces(fv1, v1, ylo, yhi, K)
    if int(maxc1) > K:
        fail(f"a band bin overflows on the mode-1 view ({int(maxc1)} > {K})")
    rows1 = torch.cat([rz._face_rows(fv1, fz1, v1),
                       rz._filler_row(dev).expand(1, 1, 12)],
                      dim=1).contiguous()
    cases6["b"] = _sel_case(rz, f"#6 (b) one mode-1 view, body camera, B=1 "
                            f"512² (largest bin {int(maxc1)})",
                            *binned_calls(rows1, ids1, pix512, W), rows1,
                            pix512, W, 20, ids1)

    src = "tpunerf_torch/csrc/rasterize.cu"
    r5 = first["mesh"]
    rows[rz.DENSE] = dict(
        name=rz.DENSE, route="cuda", source=src,
        replaces="tpunerf/kernels/rasterize.py:234", max_abs_err=0.0,
        ms=cases5["a"]["ms"], graph_ms=cases5["a"]["graph_ms"],
        plain_ms=cuda_ms(lambda: rz.select_faces_dense_plain(r5, pix), 5),
        bound_ms=cases5["a"]["bound_ms"], bound_by=cases5["a"]["bound_by"],
        library_ms=None, inputs=cases5)
    rows[rz.BINNED] = dict(
        name=rz.BINNED, route="cuda", source=src,
        replaces="tpunerf/kernels/rasterize.py:326", max_abs_err=0.0,
        ms=cases6["a"]["ms"], graph_ms=cases6["a"]["graph_ms"],
        plain_ms=cuda_ms(lambda: rz.select_faces_binned_plain(
            face_rows, ids, pix512), 3),
        bound_ms=cases6["a"]["bound_ms"], bound_by=cases6["a"]["bound_by"],
        library_ms=None, inputs=cases6)
    # the all-pairs designs, launched here only (no path calls them): their rows
    # carry the launches of this check
    for name, new, case in ((rz.DENSE_SWEEP, rz.DENSE, cases5["a"]),
                            (rz.BINNED_SWEEP, rz.BINNED, cases6["a"])):
        rows[name] = dict(
            rows[new], name=name, ms=case["sweep_ms"],
            graph_ms=case["sweep_graph_ms"],
            bound_ms=case["all_pairs_bound_ms"],
            bound_by=case["all_pairs_bound_by"],
            main_path=False, launches=_build.LAUNCHES.get(name, 0),
            inputs={k: {"ms": c["sweep_ms"], "graph_ms": c["sweep_graph_ms"],
                        "all_pairs_bound_ms": c["all_pairs_bound_ms"]}
                    for k, c in (cases5 if name == rz.DENSE_SWEEP
                                 else cases6).items()})
    for r in rows.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms eager, "
              f"{r['graph_ms']:.4f} graph, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), library "
              f"{r['library_ms']}")
    return rows


SOFT_FWD_FLOPS = 80    # per face-pixel pair: 3 affine forms, 3 segment
#                        distances (~15 each), a min, a quotient, an exp
SOFT_GRAD_FLOPS = 30   # on top, only where the backward goes on to the
#                        routed closed-form gradient (see _soft_grad_pairs)
# the soft backwards against plain: sums over pixels in another order;
# prod / (1 - p) near an edge
BWD_TOL = 2e-5


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


def _soft_live_pairs(rz, rows, pix, sigma: float, ids=None) -> int:
    """The (face, pixel) pairs that the soft forward must evaluate: those
    whose factor 1 − p is not exactly 1.0f under the plain arithmetic
    (`_soft_face_prob`). Dense rows (B, F, 16) or, with ids (B, nb, K),
    banded rows (B, F+1, 16) with the filler (p = 0) last."""
    import torch
    tab = rz._soft_stage(rows)
    B = rows.shape[0]
    if ids is None:
        n, per = rows.shape[1], B * pix.shape[0]
        px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
        take = lambda a, b: tab[:, a:b]  # noqa: E731
    else:
        nb, n = ids.shape[1:]
        per = B * nb * 1024
        px, py = rz._band_operands(pix, nb)
        bidx = torch.arange(B, device=rows.device)[:, None, None]
        take = lambda a, b: tab[bidx, ids[:, :, a:b].long()]  # noqa: E731
    chunk = max(1, rz._PLAIN_BLOCK // per)
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for a in range(0, n, chunk):
        p = rz._soft_face_prob(take(a, a + chunk), px, py, sigma)[0]
        total += ((1.0 - p) != 1.0).sum()
    return int(total.item())


def _soft_candidate_pairs(rz, rows, pix, sigma: float, width: int,
                          ids=None) -> int:
    """The (face, pixel) pairs that kernels #7 and #8 evaluate: the
    (face, warp tile) pairs their cull keeps (`_soft_kept`, the kernels'
    twin), times the 32 lanes of a tile; for #8 only the slots before a
    bin's first filler."""
    import torch
    P = pix.shape[0]
    boxes = rz._soft_cull_boxes(rows, sigma)
    tiles = rz._soft_tile_pixels(P, width, ids is not None, pix.device)
    tb = rz._soft_tile_boxes(pix, tiles)
    if ids is None:
        return 32 * int(rz._soft_kept(boxes, tb).sum().item())
    B, nb, _ = ids.shape
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    real = ids < rows.shape[1] - 1                           # (B, nb, K)
    kept = rz._soft_kept(boxes[bidx, ids.long()], tb.reshape(nb, 32, 4))
    return 32 * int((kept & real[:, :, None, :]).sum().item())


def _soft_fwd_case(rz, label: str, new, sweep, plain, rows, pix,
                   sigma: float, width: int, iters: int, ids=None,
                   tol: float = 5e-6):
    """One input of kernel #7 or #8: the kernel against its plain version
    (`tol`, absolute) and bit for bit against the all-pairs design (`sweep`);
    eager and CUDA-graph times of both, in the order new, old, old, new;
    the live-pair bound (what the inputs need), the all-pairs bound (what
    the all-pairs design evaluates), the candidate pairs of the cull."""
    import torch
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    out, before, ref = new(), sweep(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    same = torch.equal(out, before)
    B, n = rows.shape[:2]
    if ids is None:
        all_pairs = B * n * pix.shape[0]
    else:
        all_pairs = int((ids < n - 1).sum().item()) * 1024
    live = _soft_live_pairs(rz, rows, pix, sigma, ids)
    cand = _soft_candidate_pairs(rz, rows, pix, sigma, width, ids)
    nbytes = 4 * (rows.numel() + pix.numel() + out.numel()
                  + (0 if ids is None else ids.numel()))
    b_ms, b_by = bound(nbytes, live * SOFT_FWD_FLOPS, "f32")
    all_ms, all_by = bound(nbytes, all_pairs * SOFT_FWD_FLOPS, "f32")
    ms, old_ms = cuda_ms(new, iters), cuda_ms(sweep, iters)
    old_graph, _ = ex.graph_ms(sweep, iters)
    graph, _ = ex.graph_ms(new, iters)
    ms2 = cuda_ms(new, iters)
    case = dict(max_abs_err=err, equals_sweep=same, ms=ms, graph_ms=graph,
                eager_ms_again=ms2, sweep_ms=old_ms,
                sweep_graph_ms=old_graph, live_pairs=live,
                candidate_pairs=cand, all_pairs=all_pairs,
                live_per_candidate=live / max(cand, 1), bound_ms=b_ms,
                bound_by=b_by, all_pairs_bound_ms=all_ms,
                all_pairs_bound_by=all_by,
                share_of_bound=b_ms / graph,
                sweep_share_of_bound=b_ms / old_graph,
                sweep_share_of_all_pairs_bound=all_ms / old_graph)
    print(f"  {label}: max_abs_err {err:.3e} (tol {tol:.0e}), equals the "
          f"all-pairs design bit for bit: {same}; eager {ms:.4f} / {ms2:.4f} ms, "
          f"graph {graph:.4f} ms; all-pairs design eager {old_ms:.4f}, graph "
          f"{old_graph:.4f}; pairs live {live}, candidate {cand} "
          f"(live/candidate {live / max(cand, 1):.4f}), all {all_pairs}; "
          f"bound {b_ms:.5f} ms ({b_by}; all pairs {all_ms:.4f}); share "
          f"{b_ms / graph:.4f} (graph), the all-pairs design's {b_ms / old_graph:.5f} of "
          f"the live bound, {all_ms / old_graph:.4f} of the all-pairs bound")
    if not (err <= tol and same):
        fail(f"{label}: the culled soft forward disagrees with its plain "
             f"version or with the all-pairs design")
    return case


def _soft_margin_pairs(rz, rows, ids, pix, g, prod, sigma: float) -> int:
    """The (slot, pixel) pairs that the binned soft backward needs: the slot
    holds a face, the pixel is live (g·prod != 0) and lies inside the
    face's vertex box widened by the margin (`_soft_cull_boxes`, the
    kernels' twin); beyond it every share is below |g·prod|·2e^-27.7·m/σ."""
    import torch
    B, nb, K = ids.shape
    px, py = (a[None, :, None, :] for a in rz._band_pixels(pix, nb, 5.0))
    live = ((g * prod) != 0)[:, :, None, :]                 # (B, nb, 1, 1024)
    boxes = rz._soft_cull_boxes(rows, sigma)
    bidx = torch.arange(B, device=rows.device)[:, None, None]
    total = torch.zeros((), dtype=torch.int64, device=rows.device)
    for a in range(0, K, 64):
        idk = ids[:, :, a:a + 64].long()
        fb = boxes[bidx, idk][..., None, :]                 # (B, nb, k, 1, 4)
        inside = ((px >= fb[..., 0]) & (px <= fb[..., 1])
                  & (py >= fb[..., 2]) & (py <= fb[..., 3]))
        real = (idk < rows.shape[1] - 1)[..., None]
        total += (inside & live & real).sum()
    return int(total.item())


def soft_bwd_case(label: str, rows, ids, pix, g, prod, sigma: float,
                  width: int, iters: int = 20, dense: bool = False):
    """One input of kernel #10 (with its face sum): against the plain
    version (the plain slot rows summed by `_slots_to_faces`) and the first
    binned design to BWD_TOL of the largest gradient, with `dense` against
    the dense kernel to 1e-4; two calls bit for bit; eager and CUDA-graph
    times of both designs in the order new, old, old, new, the face sum
    alone and the first design's `index_add_`; the bound of the pairs
    within the margin (110 operations each) beside the earlier one (live
    pairs × 80 + routed × 30), and the candidate, live and all pairs."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    B, Fr = rows.shape[:2]
    F, P = Fr - 1, pix.shape[0]
    new = lambda: rz.soft_grad_binned_cuda(  # noqa: E731
        rows, ids, pix, g, prod, sigma, width)
    old = lambda: rz.soft_grad_binned_sweep_cuda(  # noqa: E731
        rows, ids, pix, g, prod, sigma)
    out, again, before = new(), new(), old()
    plain = rz._slots_to_faces(rz.soft_grad_binned_plain(
        rows, ids, pix, g, prod, sigma), ids, F)
    torch.cuda.synchronize()
    err, err_old = _max_rel(out, plain), _max_rel(out, before)
    same = torch.equal(out, again)
    err_dense = None
    if dense:
        gd, pd = (a.reshape(B, -1)[:, :P].contiguous() for a in (g, prod))
        err_dense = _max_rel(out, rz.soft_grad_dense_cuda(
            rows[:, :F].contiguous(), pix, gd, pd, sigma))
    is_live = g * prod != 0
    filled = (ids < F).sum(-1)
    live_pairs = int((filled * is_live.sum(-1)).sum().item())
    all_pairs = int(filled.sum().item()) * 1024
    routed = _soft_grad_pairs(rz, rows, pix, g, prod, sigma, ids)
    margin = _soft_margin_pairs(rz, rows, ids, pix, g, prod, sigma)
    kept = rz._soft_bwd_kept(rows, ids, pix, g, prod, sigma, width)
    tiles = rz._soft_tile_pixels(P, width, True, pix.device)
    gp = (g * prod).reshape(B, -1)
    lanes = ((gp[:, tiles.clamp(min=0)] != 0) & (tiles >= 0)).sum(-1)
    cand = int((kept.sum(-1) * lanes.reshape(kept.shape[:3])).sum().item())
    kept_pairs = int(kept.sum().item())
    nbytes = 4 * (rows.numel() + ids.numel() + pix.numel() + g.numel()
                  + prod.numel() + out.numel())
    b_ms, b_by = bound(nbytes, margin * (SOFT_FWD_FLOPS + SOFT_GRAD_FLOPS),
                       "f32")
    old_b_ms, old_b_by = bound(nbytes + 4 * (ids.numel() * 6 - out.numel()),
                               live_pairs * SOFT_FWD_FLOPS
                               + routed * SOFT_GRAD_FLOPS, "f32")
    graph, _ = ex.graph_ms(new, iters)
    old_graph, _ = ex.graph_ms(old, iters)
    old_graph2, _ = ex.graph_ms(old, iters)
    graph2, _ = ex.graph_ms(new, iters)
    ms, old_ms = cuda_ms(new, iters), cuda_ms(old, iters)
    parts = rz._soft_bwd_binned_rows(rows, ids, pix, g, prod, sigma, width)
    sum_ms, _ = ex.graph_ms(lambda: rz._soft_bwd_faces(rows, ids, *parts),
                            iters)
    slots_old = torch.randn(tuple(ids.shape) + (6,), device=rows.device)
    add_ms, _ = ex.graph_ms(lambda: rz._slots_to_faces(slots_old, ids, F),
                            iters)
    case = dict(max_rel_err=err, sweep_rel_err=err_old,
                dense_rel_err=err_dense, bit_identical=same, ms=ms,
                graph_ms=graph, graph_ms_again=graph2, sweep_ms=old_ms,
                sweep_graph_ms=old_graph, sweep_graph_ms_again=old_graph2,
                face_sum_graph_ms=sum_ms, index_add_graph_ms=add_ms,
                live_pixels=int(is_live.sum().item()),
                margin_pairs=margin, candidate_pairs=cand,
                kept_tile_slot_pairs=kept_pairs,
                live_pairs=live_pairs, routed_pairs=routed,
                all_pairs=all_pairs, bound_ms=b_ms, bound_by=b_by,
                old_bound_ms=old_b_ms, old_bound_by=old_b_by,
                share_of_bound=b_ms / graph,
                sweep_share_of_old_bound=old_b_ms / old_graph)
    print(f"  #10 {label}: max err / max |grad| vs plain {err:.3e}, vs the "
          f"first design {err_old:.3e} (tol {BWD_TOL:.0e}), vs dense "
          f"{err_dense} (tol 1e-4); two calls bit-identical {same}; graph "
          f"{graph:.4f} / {graph2:.4f} ms, eager {ms:.4f}; the first design "
          f"graph {old_graph:.4f} / {old_graph2:.4f}, eager {old_ms:.4f}; "
          f"face sum alone {sum_ms:.4f}, the first design's index_add_ "
          f"{add_ms:.4f} (graph); pixels live {case['live_pixels']}; pairs "
          f"within the margin {margin}, candidate {cand} (kept tile-slot "
          f"pairs {kept_pairs}), live {live_pairs}, "
          f"routed {routed}, all {all_pairs}; bound {b_ms:.5f} ms ({b_by}), "
          f"share {b_ms / graph:.4f} (graph); the earlier bound "
          f"{old_b_ms:.5f} ({old_b_by})")
    if not (err <= BWD_TOL and err_old <= BWD_TOL and same
            and (err_dense is None or err_dense <= 1e-4)
            and torch.isfinite(out).all()):
        fail(f"#10 {label}: the culled binned backward disagrees with its "
             f"plain version, the first design or the dense kernel, or is "
             f"not deterministic")
    return case


def _all_faces_bins(rows, P: int):
    """Bins that hold every face in every band, faces ascending and then
    the filler (K a multiple of 128): #10 on them computes #9's function
    with no band dropping a tail. rows (B, F, 16) → (rows with the filler,
    ids (B, nb, K))."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz
    B, F = rows.shape[:2]
    K = -(-(F + 1) // 128) * 128
    nb = -(-P // 1024)
    ids = torch.cat([torch.arange(F, dtype=torch.int32, device=rows.device),
                     torch.full((K - F,), F, dtype=torch.int32,
                                device=rows.device)])
    return (rz._with_filler(rows).contiguous(),
            ids.expand(B, nb, K).contiguous())


def soft_bwd_dense_case(label: str, rows, pix, g, prod, sigma: float,
                        width: int, iters: int = 20, binned=None):
    """One input of kernel #9: against the plain version and its first
    design (`soft_grad_dense_sweep_cuda`) to BWD_TOL of the largest
    gradient, and against #10 to 1e-4 (`binned`: (rows with the filler,
    ids), else bins of every face); two calls bit for bit; CUDA-graph and
    eager times of both designs in the order new, old, old, new; the live
    pixels and tiles, the kept (tile, face) pairs, the pairs within the
    margin, candidate and live pairs; the new bound (bytes once; pairs
    within the margin × 110) beside the earlier one (live pairs × 80 +
    routed × 30) and the shares."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    B, F = rows.shape[:2]
    P = pix.shape[0]
    new = lambda: rz.soft_grad_dense_cuda(  # noqa: E731
        rows, pix, g, prod, sigma, width)
    old = lambda: rz.soft_grad_dense_sweep_cuda(  # noqa: E731
        rows, pix, g, prod, sigma)
    out, again, before = new(), new(), old()
    plain = rz.soft_grad_dense_plain(rows, pix, g, prod, sigma)
    rows_f, ids = binned if binned is not None else _all_faces_bins(rows, P)
    nb = ids.shape[1]
    via10 = rz.soft_grad_binned_cuda(rows_f, ids, pix, rz._band_maps(g, nb),
                                     rz._band_maps(prod, nb), sigma, width)
    torch.cuda.synchronize()
    err, err_old = _max_rel(out, plain), _max_rel(out, before)
    err_10 = _max_rel(out, via10)
    same = torch.equal(out, again)
    gp = g * prod
    is_live = gp != 0
    tiles = rz._soft_tile_pixels(P, width, False, pix.device)
    lanes = ((gp[:, tiles.clamp(min=0)] != 0) & (tiles >= 0)).sum(-1)
    kept = rz._soft_bwd_dense_kept(rows, pix, g, prod, sigma, width)
    kept = kept & (lanes > 0)[..., None]       # dead tiles are skipped whole
    kept_pairs = int(kept.sum().item())
    cand = int((kept.sum(-1) * lanes).sum().item())
    live_pixels = int(is_live.sum().item())
    live_pairs = F * live_pixels
    routed = _soft_grad_pairs(rz, rows, pix, g, prod, sigma)
    boxes = rz._soft_cull_boxes(rows, sigma)              # (B, F, 4)
    px, py = pix[:, 0], pix[:, 1]
    margin = 0
    for f0 in range(0, F, 64):
        fb = boxes[:, f0:f0 + 64, None, :]
        inside = ((px >= fb[..., 0]) & (px <= fb[..., 1])
                  & (py >= fb[..., 2]) & (py <= fb[..., 3]))
        margin += int((inside & is_live[:, None, :]).sum().item())
    nbytes = 4 * (rows.numel() + pix.numel() + g.numel() + prod.numel()
                  + out.numel())
    b_ms, b_by = bound(nbytes, margin * (SOFT_FWD_FLOPS + SOFT_GRAD_FLOPS),
                       "f32")
    old_b_ms, old_b_by = bound(nbytes, live_pairs * SOFT_FWD_FLOPS
                               + routed * SOFT_GRAD_FLOPS, "f32")
    graph, _ = ex.graph_ms(new, iters)
    old_graph, _ = ex.graph_ms(old, iters)
    old_graph2, _ = ex.graph_ms(old, iters)
    graph2, _ = ex.graph_ms(new, iters)
    ms, old_ms = cuda_ms(new, iters), cuda_ms(old, iters)
    case = dict(max_rel_err=err, sweep_rel_err=err_old, binned_rel_err=err_10,
                bit_identical=same, ms=ms, graph_ms=graph,
                graph_ms_again=graph2, sweep_ms=old_ms,
                sweep_graph_ms=old_graph, sweep_graph_ms_again=old_graph2,
                live_pixels=live_pixels,
                live_tiles=int((lanes > 0).sum().item()),
                kept_tile_face_pairs=kept_pairs, margin_pairs=margin,
                candidate_pairs=cand, live_pairs=live_pairs,
                routed_pairs=routed, bound_ms=b_ms, bound_by=b_by,
                old_bound_ms=old_b_ms, old_bound_by=old_b_by,
                share_of_bound=b_ms / graph,
                sweep_share_of_old_bound=old_b_ms / old_graph)
    print(f"  #9 {label}: max err / max |grad| vs plain {err:.3e}, vs the "
          f"first design {err_old:.3e} (tol {BWD_TOL:.0e}), vs #10 "
          f"{err_10:.3e} (tol 1e-4); two calls bit-identical {same}; graph "
          f"{graph:.4f} / {graph2:.4f} ms, eager {ms:.4f}; the first design "
          f"graph {old_graph:.4f} / {old_graph2:.4f}, eager {old_ms:.4f}; "
          f"pixels live {live_pixels}, live tiles {case['live_tiles']} of "
          f"{B * tiles.shape[0]}; kept tile-face pairs {kept_pairs}; pairs "
          f"within the margin {margin}, candidate {cand}, live {live_pairs},"
          f" routed {routed}; bound {b_ms:.5f} ms ({b_by}), share "
          f"{b_ms / graph:.4f} (graph); the earlier bound {old_b_ms:.5f} "
          f"({old_b_by}), the first design's share of it "
          f"{old_b_ms / old_graph:.4f}")
    if not (err <= BWD_TOL and err_old <= BWD_TOL and err_10 <= 1e-4
            and same and torch.isfinite(out).all()):
        fail(f"#9 {label}: the culled dense backward disagrees with its "
             f"plain version, its first design or #10, or is not "
             f"deterministic")
    return case


def check_soft_kernels(seed: int):
    """The four soft-silhouette kernels vs their plain versions on the
    projected sphere under the body and the head camera at the
    latent-paint-mesh shapes: forward to 5e-6 absolute, forward+backward
    pairs (each backward with its own forward's prod) to 2e-5 of the largest
    gradient. Returns {name: row} without launch counts."""
    import torch
    from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                          rand_poses)
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    from tpunerf_torch.scripts import exp_hash_bwd as ex

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
    rows_out = {}

    def project(views, spec):
        return mrender._project(mesh.vertices, mesh.faces, views.theta,
                                views.phi, views.radius, spec)[1].contiguous()

    def pair_dense(face_rows, pix, g):
        prod_k = rz.soft_prod_dense_cuda(face_rows, pix, sigma, 64)
        prod_p = rz.soft_prod_dense_plain(face_rows, pix, sigma)
        grad_k = rz.soft_grad_dense_cuda(face_rows, pix, g, prod_k, sigma, 64)
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
    grad_s = rz.soft_grad_dense_sweep_cuda(face_rows, pix, g, prod_k, sigma)
    e_f = (prod_k - prod_p).abs().max().item()
    e_b = _max_rel(grad_k, grad_p)
    e_s = _max_rel(grad_k, grad_s)
    covered = int((prod_p == 0).sum().item())
    print(f"soft dense degenerate/outside/padded set F={n}: fwd "
          f"max_abs_err {e_f:.3e}, bwd rel {e_b:.3e}, vs the first dense "
          f"backward {e_s:.3e}; covered pixels "
          f"{covered}; gradient of outside and padded faces "
          f"{grad_k[0, 100:200].abs().max().item():.1e} / "
          f"{grad_k[0, 300:320].abs().max().item():.1e} (must be 0)")
    if not (e_f <= FWD_TOL and e_b <= BWD_TOL and e_s <= BWD_TOL and covered
            and torch.isfinite(grad_k).all()
            and grad_k[0, 100:200].abs().max().item() == 0
            and grad_k[0, 300:320].abs().max().item() == 0):
        fail("dense soft-silhouette kernels mishandle degenerate, outside "
             "or padded faces")
    fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    bwd_abs = max(bwd_abs, (grad_k - grad_p).abs().max().item())

    # faces with a NaN or an infinite vertex coordinate in the first of two
    # views: the plain version's product is NaN at every pixel of that view
    # (the face's distances are NaN); the kernels' must be too, and the
    # clean second view equal to the all-pairs design's bit for bit
    bad = rz._soft_rows(torch.tensor(
        [[[[0.3, 0.3], [0.35, 0.3], [float("nan"), 0.32]],
          [[-0.5, 0.5], [float("inf"), 0.5], [-0.45, 0.55]],
          [[0.9, -0.9], [0.92, -0.9], [0.9, -float("inf")]]]], device=dev))
    base = rz._soft_rows(project(poses, cameras["wide"])[:2])
    mid = torch.cat([bad, base[1:, 200:203]], dim=0)
    nf_rows = torch.cat([base[:, :200], mid, base[:, 200:]], 1).contiguous()
    nf = rz.soft_prod_dense_cuda(nf_rows, pix, sigma, 64)
    nf_old = rz.soft_prod_dense_sweep_cuda(nf_rows, pix, sigma)
    nf_ref = rz.soft_prod_dense_plain(nf_rows, pix, sigma)
    ids_all = torch.arange(nf_rows.shape[1], dtype=torch.int32,
                           device=dev).expand(2, 4, -1).contiguous()
    nf_rows_f = rz._with_filler(nf_rows).contiguous()
    nf_b = rz.soft_prod_binned_cuda(nf_rows_f, ids_all, pix, sigma,
                                    64).reshape(2, P)
    nf_b_old = rz.soft_prod_binned_sweep_cuda(nf_rows_f, ids_all, pix,
                                              sigma).reshape(2, P)
    torch.cuda.synchronize()
    nan_ref = torch.isnan(nf_ref)
    e_nf = (nf[1] - nf_ref[1]).abs().max().item()
    e_nfb = (nf_b[1] - nf_ref[1]).abs().max().item()
    nan_same = (torch.equal(torch.isnan(nf), nan_ref)
                and torch.equal(torch.isnan(nf_b), nan_ref))
    clean_same = (torch.equal(nf[1], nf_old[1])
                  and torch.equal(nf_b[1], nf_b_old[1]))
    print(f"soft forward, NaN/inf vertex set F={nf_rows.shape[1]}, B=2: NaN "
          f"pixels plain {int(nan_ref.sum())} (view 0 all, view 1 "
          f"{int(nan_ref[1].sum())}), kernel #7 {int(torch.isnan(nf).sum())},"
          f" #8 {int(torch.isnan(nf_b).sum())}, all-pairs designs "
          f"{int(torch.isnan(nf_old).sum())} / "
          f"{int(torch.isnan(nf_b_old).sum())} (their fminf drops the NaN "
          f"distances); kernels' NaN pixels equal plain's: {nan_same}; clean"
          f" view 1 equal to the all-pairs designs bit for bit: {clean_same}, "
          f"max_abs_err #7 {e_nf:.3e}, #8 {e_nfb:.3e} (tol {FWD_TOL:.0e})")
    if not (nan_ref[0].all() and not nan_ref[1].any() and nan_same
            and clean_same and e_nf <= FWD_TOL and e_nfb <= FWD_TOL):
        fail("the culled soft forward mishandles faces with a non-finite "
             "vertex")
    fwd_err = max(fwd_err, e_nf, e_nfb)
    # #9 on the same faces: with a finite prod (that of the clean faces),
    # plain gives the three bad faces NaN and every other face a finite
    # gradient; so must #9, within BWD_TOL elsewhere
    keep = torch.ones(nf_rows.shape[1], dtype=torch.bool, device=dev)
    keep[200:203] = False
    clean_prod = rz.soft_prod_dense_plain(nf_rows[:, keep].contiguous(), pix,
                                          sigma)
    g_nf = torch.randn((2, P), generator=gen, device=dev)
    nf_g = rz.soft_grad_dense_cuda(nf_rows, pix, g_nf, clean_prod, sigma, 64)
    nf_g_ref = rz.soft_grad_dense_plain(nf_rows, pix, g_nf, clean_prod, sigma)
    torch.cuda.synchronize()
    fin = torch.isfinite(nf_g_ref)
    nan_bwd = torch.equal(torch.isnan(nf_g), torch.isnan(nf_g_ref))
    e_nfg = _max_rel(nf_g[fin], nf_g_ref[fin])
    print(f"soft_bwd_dense (#9), NaN/inf vertex set: NaN entries plain "
          f"{int(torch.isnan(nf_g_ref).sum())} (faces 200-202 of view 0: 18),"
          f" #9 {int(torch.isnan(nf_g).sum())}, equal: {nan_bwd}; elsewhere "
          f"max err / max {e_nfg:.3e} (tol {BWD_TOL:.0e})")
    if not (nan_bwd and torch.isnan(nf_g_ref[0, 200:203]).all()
            and int(torch.isnan(nf_g_ref).sum()) == 18 and e_nfg <= BWD_TOL):
        fail("#9 mishandles faces with a non-finite vertex")

    # inputs (a) the wide camera's first pose, which has a rim for the
    # backward to work on; (b) a head-camera pose, which the sphere fills,
    # as in most mode-0 steps; (c) 512² dense, the binned path's overflow
    # fallback (below)
    face_rows = rz._soft_rows(project(poses, cameras["wide"])[:1]).contiguous()
    head_rows = rz._soft_rows(project(poses, cameras["head"])[:1]).contiguous()
    dense_cases = {}
    print("soft_fwd_dense (#7) against the all-pairs design, 64² (8 x 4 tiles):")
    for key, fr in (("a", face_rows), ("b", head_rows)):
        dense_cases[key] = _soft_fwd_case(
            rz, f"#7 ({key}) {'wide' if key == 'a' else 'head'} camera 64²",
            lambda fr=fr: rz.soft_prod_dense_cuda(fr, pix, sigma, 64),
            lambda fr=fr: rz.soft_prod_dense_sweep_cuda(fr, pix, sigma),
            lambda fr=fr: rz.soft_prod_dense_plain(fr, pix, sigma),
            fr, pix, sigma, 64, 50)
        fwd_err = max(fwd_err, dense_cases[key]["max_abs_err"])
    g = torch.randn((1, P), generator=gen, device=dev)
    prod = rz.soft_prod_dense_cuda(face_rows, pix, sigma, 64)
    live = int((g * prod != 0).sum().item())
    rows_out[rz.SOFT_FWD_DENSE] = dict(
        name=rz.SOFT_FWD_DENSE, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:675", max_abs_err=fwd_err,
        ms=dense_cases["a"]["ms"], graph_ms=dense_cases["a"]["graph_ms"],
        plain_ms=cuda_ms(lambda: rz.soft_prod_dense_plain(face_rows, pix,
                                                          sigma), 5),
        bound_ms=dense_cases["a"]["bound_ms"],
        bound_by=dense_cases["a"]["bound_by"], library_ms=None,
        inputs=dense_cases)
    # #9 (a) the wide camera with random g; (b) the head camera, which the
    # sphere fills: hardly a live pixel, the floor; (c), the eval chunk's
    # 5 views dense at 512², the overflow fallback, and (d), the silhouette
    # phase's own 64² g and prod, follow below and in main()
    print("soft_bwd_dense (#9) against its first design (8 faces a block, "
          "every live pixel), 64² (8 x 4 tiles):")
    head_prod = rz.soft_prod_dense_cuda(head_rows, pix, sigma, 64)
    g_head = torch.randn((1, P), generator=gen, device=dev)
    dense_bwd_cases = {
        "a": soft_bwd_dense_case("(a) wide camera 64², B=1, random g",
                                 face_rows, pix, g, prod, sigma, 64),
        "b": soft_bwd_dense_case("(b) head camera 64², B=1, random g",
                                 head_rows, pix, g_head, head_prod, sigma,
                                 64)}
    a9 = dense_bwd_cases["a"]
    rows_out[rz.SOFT_BWD_DENSE] = dict(
        name=rz.SOFT_BWD_DENSE, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:725", max_abs_err=bwd_abs,
        max_rel_err=max(bwd_err, a9["max_rel_err"]), ms=a9["ms"],
        graph_ms=a9["graph_ms"],
        plain_ms=cuda_ms(lambda: rz.soft_grad_dense_plain(face_rows, pix, g,
                                                          prod, sigma), 3),
        bound_ms=a9["bound_ms"], bound_by=a9["bound_by"], library_ms=None,
        inputs=dense_bwd_cases)
    print(f"  dense backward: {live} of {P} pixels live (g*prod != 0); "
          f"{a9['routed_pairs']} of {F * live} live (face, pixel) pairs "
          f"reach the routed gradient; max abs err {bwd_abs:.3e}")

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
        prod_k = rz.soft_prod_binned_cuda(face_rows, ids, pix, sigma, W)
        prod_p = rz.soft_prod_binned_plain(face_rows, ids, pix, sigma)
        grad_k = rz.soft_grad_binned_cuda(face_rows, ids, pix, g, prod_k,
                                          sigma, W)
        grad_p = rz._slots_to_faces(rz.soft_grad_binned_plain(
            face_rows, ids, pix, g, prod_p, sigma), ids, F)
        dense_rows = face_rows[:, :F].contiguous()
        prod_d = rz.soft_prod_dense_cuda(dense_rows, pix, sigma, W)
        grad_d = rz.soft_grad_dense_cuda(dense_rows, pix,
                                         g.reshape(B, P).contiguous(), prod_d,
                                         sigma)
        torch.cuda.synchronize()
        e_f = (prod_k - prod_p).abs().max().item()
        e_b = _max_rel(grad_k, grad_p)
        e_fd = (prod_k.reshape(B, P) - prod_d).abs().max().item()
        e_bd = _max_rel(grad_k, grad_d)
        filled = int((ids < F).sum().item())
        print(f"soft_fwd_binned {label} B={B} {H}x{W} K={K}: max_abs_err "
              f"{e_f:.3e} (tol {FWD_TOL:.0e}); vs the dense kernel {e_fd:.3e} "
              f"(tol 1e-5: the bins drop tails below 1e-12)")
        print(f"soft_bwd_binned {label}: face gradients, kernel pair vs plain "
              f"pair: max err / max {e_b:.3e} (tol {BWD_TOL:.0e}); vs the "
              f"dense kernel {e_bd:.3e} (tol 1e-4); filled slots {filled} of "
              f"{ids.numel()}")
        if not (e_f <= FWD_TOL and e_b <= BWD_TOL and e_fd <= 1e-5
                and e_bd <= 1e-4 and torch.isfinite(grad_k).all()):
            fail(f"binned soft-silhouette kernels disagree ({label})")
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
        bwd_abs = max(bwd_abs, (grad_k - grad_p).abs().max().item())
        if timed is None:
            timed = (face_rows, ids, g, prod_k, dense_rows, filled, K)
    face_rows, ids, g, prod, dense_rows, filled, K = timed
    # #8 (a) the eval chunk above (body camera, B = 5, 512²); (b) the mode-1
    # step's shape, one body-camera pose at 512²; #7 (c) 512² dense, the
    # fallback where a bin overflows, on the eval chunk's first view
    print("soft_fwd_binned (#8) against the all-pairs design, 512² (16 x 2 tiles):")
    binned_cases = {"a": _soft_fwd_case(
        rz, f"#8 (a) eval chunk, body camera, B=5 {H}² K={K}",
        lambda: rz.soft_prod_binned_cuda(face_rows, ids, pix, sigma, W),
        lambda: rz.soft_prod_binned_sweep_cuda(face_rows, ids, pix, sigma),
        lambda: rz.soft_prod_binned_plain(face_rows, ids, pix, sigma),
        face_rows, pix, sigma, W, 20, ids)}
    fv1 = project(rand_poses(1, vcfg, dev, generator=gen), cameras["body"])
    K1 = rz._SOFT_BIN_K
    ids1, maxc1 = rz._soft_bins(fv1, H, W, sigma, K1)
    if int(maxc1) > K1:
        K1 = -(-int(maxc1) // 128) * 128
        ids1, _ = rz._soft_bins(fv1, H, W, sigma, K1)
    rows1 = rz._with_filler(rz._soft_rows(fv1)).contiguous()
    binned_cases["b"] = _soft_fwd_case(
        rz, f"#8 (b) mode-1 step, body camera, B=1 {H}² K={K1}",
        lambda: rz.soft_prod_binned_cuda(rows1, ids1, pix, sigma, W),
        lambda: rz.soft_prod_binned_sweep_cuda(rows1, ids1, pix, sigma),
        lambda: rz.soft_prod_binned_plain(rows1, ids1, pix, sigma),
        rows1, pix, sigma, W, 20, ids1)
    fwd_err = max(fwd_err, *(c["max_abs_err"] for c in binned_cases.values()))
    rows_c = dense_rows[:1].contiguous()
    print("soft_fwd_dense (#7) at 512², the overflow fallback (8 x 4 tiles):")
    case_c = _soft_fwd_case(
        rz, f"#7 (c) dense {H}², body camera, eval chunk's first view",
        lambda: rz.soft_prod_dense_cuda(rows_c, pix, sigma, W),
        lambda: rz.soft_prod_dense_sweep_cuda(rows_c, pix, sigma),
        lambda: rz.soft_prod_dense_plain(rows_c, pix, sigma),
        rows_c, pix, sigma, W, 10)
    dense_row = rows_out[rz.SOFT_FWD_DENSE]
    dense_row["inputs"]["c"] = case_c
    dense_row["max_abs_err"] = max(dense_row["max_abs_err"],
                                   case_c["max_abs_err"])
    rows_out[rz.SOFT_FWD_BINNED] = dict(
        name=rz.SOFT_FWD_BINNED, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:694", max_abs_err=fwd_err,
        ms=binned_cases["a"]["ms"], graph_ms=binned_cases["a"]["graph_ms"],
        plain_ms=cuda_ms(lambda: rz.soft_prod_binned_plain(face_rows, ids,
                                                           pix, sigma), 2,
                         warmup=1),
        bound_ms=binned_cases["a"]["bound_ms"],
        bound_by=binned_cases["a"]["bound_by"], library_ms=None,
        inputs=binned_cases)
    # #10 (a) the eval chunk above with its random g; (b) the mode-1 view;
    # (c), the silhouette phase's own g and prod, comes from that phase
    print("soft_bwd_binned (#10) against the first binned design (8 slots a "
          "block, index_add_ to faces), 512²:")
    g1 = torch.randn((1, nb, 1024), generator=gen, device=dev)
    prod1 = rz.soft_prod_binned_cuda(rows1, ids1, pix, sigma, W)
    bwd_cases = {
        "a": soft_bwd_case(f"(a) eval chunk, body camera, B=5, random g, "
                           f"K={K}", face_rows, ids, pix, g, prod, sigma, W,
                           dense=True),
        "b": soft_bwd_case(f"(b) mode-1 view, B=1, random g, K={K1}", rows1,
                           ids1, pix, g1, prod1, sigma, W, dense=True)}
    bwd_err = max(bwd_err, *(c["max_rel_err"] for c in bwd_cases.values()))
    a = bwd_cases["a"]
    rows_out[rz.SOFT_BWD_BINNED] = dict(
        name=rz.SOFT_BWD_BINNED, route="cuda",
        source="tpunerf_torch/csrc/rasterize.cu",
        replaces="tpunerf/kernels/rasterize.py:748", max_abs_err=bwd_abs,
        max_rel_err=bwd_err, ms=a["ms"], graph_ms=a["graph_ms"],
        plain_ms=cuda_ms(lambda: rz._slots_to_faces(rz.soft_grad_binned_plain(
            face_rows, ids, pix, g, prod, sigma), ids, F), 2, warmup=1),
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
        inputs=bwd_cases)
    rows_out[rz.SOFT_BWD_BINNED_SWEEP] = dict(
        rows_out[rz.SOFT_BWD_BINNED], name=rz.SOFT_BWD_BINNED_SWEEP,
        max_rel_err=a["sweep_rel_err"], ms=a["sweep_ms"],
        graph_ms=a["sweep_graph_ms"], bound_ms=a["old_bound_ms"],
        bound_by=a["old_bound_by"], main_path=False,
        inputs={k: {"ms": c["sweep_ms"], "graph_ms": c["sweep_graph_ms"],
                    "old_bound_ms": c["old_bound_ms"]}
                for k, c in bwd_cases.items()})
    # the all-pairs designs of the forwards, kept for timing
    for name, new, cases in (
            (rz.SOFT_FWD_DENSE_SWEEP, rz.SOFT_FWD_DENSE, dense_cases),
            (rz.SOFT_FWD_BINNED_SWEEP, rz.SOFT_FWD_BINNED, binned_cases)):
        rows_out[name] = dict(
            rows_out[new], name=name, ms=cases["a"]["sweep_ms"],
            graph_ms=cases["a"]["sweep_graph_ms"],
            bound_ms=cases["a"]["all_pairs_bound_ms"],
            bound_by=cases["a"]["all_pairs_bound_by"], main_path=False,
            inputs={k: {"ms": c["sweep_ms"], "graph_ms": c["sweep_graph_ms"],
                        "all_pairs_bound_ms": c["all_pairs_bound_ms"]}
                    for k, c in cases.items()})
    gd = g.reshape(5, P).contiguous()
    pd = prod.reshape(5, P).contiguous()
    fv_body = project(orbit, cameras["body"])
    bins_ms = cuda_ms(lambda: rz._soft_bins(fv_body, H, W, sigma, K), 5)
    dense_f = cuda_ms(lambda: rz.soft_prod_dense_cuda(dense_rows, pix, sigma,
                                                      W), 3)
    print(f"  max abs err of #10 at the three cameras {bwd_abs:.3e}; soft "
          f"bins (ranges, mask, rank, scatter) {bins_ms:.4f} ms; dense "
          f"forward on the same 5 views {dense_f:.4f} ms")
    print("soft_bwd_dense (#9) at 512², the overflow fallback (8 x 4 tiles):")
    rows_out[rz.SOFT_BWD_DENSE]["inputs"]["c"] = soft_bwd_dense_case(
        f"(c) dense {H}², the eval chunk's 5 views, body camera, random g",
        dense_rows, pix, gd, pd, sigma, W, 3, binned=(face_rows, ids))
    dense_row9 = rows_out[rz.SOFT_BWD_DENSE]
    rows_out[rz.SOFT_BWD_DENSE_SWEEP] = dict(
        dense_row9, name=rz.SOFT_BWD_DENSE_SWEEP,
        max_rel_err=dense_row9["inputs"]["a"]["sweep_rel_err"],
        ms=dense_row9["inputs"]["a"]["sweep_ms"],
        graph_ms=dense_row9["inputs"]["a"]["sweep_graph_ms"],
        bound_ms=dense_row9["inputs"]["a"]["old_bound_ms"],
        bound_by=dense_row9["inputs"]["a"]["old_bound_by"], main_path=False,
        inputs={k: {"ms": c["sweep_ms"], "graph_ms": c["sweep_graph_ms"],
                    "old_bound_ms": c["old_bound_ms"]}
                for k, c in dense_row9["inputs"].items()})
    for name in (rz.SOFT_BWD_BINNED_SWEEP, rz.SOFT_BWD_DENSE_SWEEP,
                 rz.SOFT_FWD_DENSE_SWEEP, rz.SOFT_FWD_BINNED_SWEEP):
        rows_out[name]["launches"] = _build.LAUNCHES.get(name, 0)
    for r in rows_out.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms eager, "
              f"{r.get('graph_ms', float('nan')):.4f} graph, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}")
    return rows_out


def _needles(seed: int, n: int, dev):
    """(n, 3, 2) needle faces: an angle of 1e-6 to 1e-5 rad at vertex 0,
    long edges of 0.05 to 0.6 and 0.5 to 1.5 times that, tips inside NDC;
    and (2·n·32, 2) pixels on each needle's axis 1 to 8 cull margins (σ =
    1e-4) behind its tip and past its short edge, where its nearly parallel
    long edge forms round to either sign. Drawn on the host, so that the
    set is the one whose spurious insides a CPU run counts (256 needles
    give some at every seed tried)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 6), generator=gen, dtype=torch.float64)
    tip = u[:, :2] * 1.6 - 0.8
    th = u[:, 2] * 2 * math.pi
    ang = 10.0 ** (u[:, 3] - 6.0)
    length = (u[:, 4] * 0.55 + 0.05)[:, None]
    stretch = (u[:, 5] + 0.5)[:, None]
    a = torch.stack([th.cos(), th.sin()], -1) * length
    b = torch.stack([(th + ang).cos(), (th + ang).sin()], -1) * length * stretch
    faces = torch.stack([tip, tip + a, tip + b], 1).float()
    # the axis of the f32 faces: the wedge of spurious insides behind a tip
    # is ~1e-7 wide
    f = faces.double()
    mid = (f[:, 1] + f[:, 2]) / 2
    axis = (mid - f[:, 0]) / (mid - f[:, 0]).norm(dim=-1, keepdim=True)
    m = (27.7 * 1e-4) ** 0.5
    dist = torch.linspace(1.0, 8.0, 32, dtype=torch.float64)[None, :, None] * m
    pix = torch.cat([f[:, 0, None] - dist * axis[:, None],
                     mid[:, None] + dist * axis[:, None]], 1)
    return faces.to(dev), pix.reshape(-1, 2).float().to(dev)


def check_slivers(seed: int, device: str = "cuda") -> None:
    """Fault C.3: the soft kernels #7-#10 on the wide camera's sphere (two
    poses, 64²) with 256 needles (slivers of 1e-6 to 1e-5 rad) added to
    both views, at the image's pixels and at 16384 pixels on the needles'
    axes beyond their tips. There the plain version's rounded inside test
    holds for some needle (p = 1, a factor of 0) though the pixel lies
    outside the needle's widened vertex box, where a box cull would skip
    the pair; the kernels keep every sliver and must agree with plain:
    forwards within 5e-6, backwards within 2e-5 of the largest gradient,
    the binned ones on bins that hold every face."""
    import torch
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sigma = 1e-4
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    poses = rand_poses(2, ViewSamplerConfig(), dev, generator=gen)
    fv = mrender._project(mesh.vertices, mesh.faces, poses.theta, poses.phi,
                          poses.radius,
                          mrender.CameraSpec(look_at_height=0.25))[1]
    needles, beyond = _needles(seed, 256, dev)
    fv = torch.cat([fv, needles.expand(2, -1, -1, -1)], 1)
    rows = rz._soft_rows(fv).contiguous()
    B, F = rows.shape[:2]
    pix = torch.cat([rz.pixel_grid_ndc(64, 64, dev), beyond]).contiguous()
    P = pix.shape[0]
    nb = P // 1024
    # the spurious insides a box cull would skip
    nrows = rows[:1, -256:]
    p_n = rz._soft_face_prob(rz._soft_stage(nrows[0]), pix[:, 0][None],
                             pix[:, 1][None], sigma)[0]          # (256, P)
    vx, vy = nrows[0, :, 9:15:2], nrows[0, :, 10:15:2]
    m = rz._soft_margin(sigma)
    outside = ((pix[None, :, 0] < vx.amin(-1, keepdim=True) - m)
               | (pix[None, :, 0] > vx.amax(-1, keepdim=True) + m)
               | (pix[None, :, 1] < vy.amin(-1, keepdim=True) - m)
               | (pix[None, :, 1] > vy.amax(-1, keepdim=True) + m))
    spurious = int(((p_n == 1.0) & outside).sum())
    kept = bool(torch.isinf(rz._soft_cull_boxes(nrows, sigma)).all())

    ref = rz.soft_prod_dense_plain(rows, pix, sigma)
    prod7 = rz.soft_prod_dense(rows, pix, sigma, 0)
    K = -(-(F + 1) // 128) * 128
    ids = torch.cat([torch.arange(F, dtype=torch.int32, device=dev),
                     torch.full((K - F,), F, dtype=torch.int32, device=dev)]
                    ).expand(B, nb, K).contiguous()
    frows = rz._with_filler(rows).contiguous()
    prod8 = rz.soft_prod_binned(frows, ids, pix, sigma, 0).reshape(B, P)
    g = torch.randn((B, P), generator=gen, device=dev)
    grad_ref = rz.soft_grad_dense_plain(rows, pix, g, ref, sigma)
    grad9 = rz.soft_grad_dense(rows, pix, g, ref, sigma, 0)
    grad10 = rz.soft_grad_binned(frows, ids, pix, rz._band_maps(g, nb),
                                 rz._band_maps(ref, nb), sigma, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    e7 = (prod7 - ref).abs().max().item()
    e8 = (prod8 - ref).abs().max().item()
    e9, e10 = _max_rel(grad9, grad_ref), _max_rel(grad10, grad_ref)
    zeros = int((ref == 0).sum())
    print(f"slivers (C.3): 256 needles of 1e-6..1e-5 rad beside the sphere, "
          f"B={B}, F={F}, P={P}: plain's spurious insides beyond a needle's "
          f"widened box {spurious} (pixels with a factor 0: {zeros}); every "
          f"needle kept by the cull: {kept}; #7 max_abs_err {e7:.3e}, #8 "
          f"{e8:.3e} (tol 5e-6); #9 max err / max {e9:.3e}, #10 {e10:.3e} "
          f"(tol {BWD_TOL:.0e})")
    if not (spurious > 0 and kept and e7 <= 5e-6 and e8 <= 5e-6
            and e9 <= BWD_TOL and e10 <= BWD_TOL):
        fail("the soft kernels disagree with plain on slivers (C.3)")


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
    # random weights from the seed (the card's are copied from the CPU's)
    guides = {d: StableDiffusionGuidance.create(
        tiny=True, unet_dtype="float32", device=d,
        generator=torch.Generator().manual_seed(seed) if d == cpu else None)
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

    # --- the same step with config #3's sketch shape (lambda_shape 1) ----
    # one SDF grid of the sphere, built on the host, on both devices; the
    # one-gather lookup's index may flip where a sample's xyz (from the
    # card's sin/cos) lies within an ulp of a cell's half
    from tpunerf_torch.fields.sketch_shape import SDFGrid
    from tpunerf_torch.meshrep import shapes
    mesh = shapes.load_shape("sphere").normalize(cfg.guide.shape_scale,
                                                 cfg.guide.dy)
    sdf = SDFGrid.from_mesh(mesh.vertices.numpy(), mesh.faces.numpy(),
                            resolution=24, bound=cfg.render.bound)
    lam = cfg.optim.lambda_shape
    cfg.optim.lambda_shape = 1.0          # the apps share cfg
    out = {}
    for d, app in apps.items():
        app.scene.sdf = SDFGrid(sdf.values.to(d), sdf.bound)
        app.scene.zero_grad(set_to_none=True)
        loss, aux = app.loss_fn(views.to(d), u=u.to(d),
                                t=torch.tensor(500, device=d),
                                noise=noise.to(d))
        loss.backward()
        out[d] = (loss.item(), aux["shape_loss"].item(),
                  {k: p.grad.cpu() for k, p in
                   app.scene.field.named_parameters()})
    cfg.optim.lambda_shape = lam
    for app in apps.values():
        app.scene.sdf = None
        app.scene.zero_grad(set_to_none=True)
    (l_cpu, s_cpu, g_cpu), (l_gpu, s_gpu, g_gpu) = out[cpu], out[gpu]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    s_rel = abs(s_gpu - s_cpu) / abs(s_cpu)
    g_err = _rel_grad_err(g_gpu, g_cpu)
    print(f"tiny config #3 step (sketch shape, 24³ SDF of the sphere, "
          f"lambda_shape 1), card vs CPU: loss {l_gpu:+.6e} vs "
          f"{l_cpu:+.6e} (rel {rel:.2e}, tol 1e-4); shape loss "
          f"{s_gpu:.6e} vs {s_cpu:.6e} (rel {s_rel:.2e}, tol 1e-4); max "
          f"grad err / max|grad| {g_err:.2e} (tol 1e-4)")
    if not (s_cpu > 0 and rel <= 1e-4 and s_rel <= 1e-4 and g_err <= 1e-4):
        fail("the tiny sketch-shape step on the card disagrees with the CPU "
             "step")

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

    check_small_depth_step(seed, gpu)
    check_small_pbe_step(seed, gpu)

    # the eval chunk: 5 poses at the 16² latent grid, the tiny VAE's 64²
    # frames resized to 96² as jax.image.resize resizes
    from tpunerf_torch.core.views import circle_poses
    ev = circle_poses(5, Trainer.view_config(cfg), cpu)
    frames = {d: app.eval_render(ev.to(d), (96, 96))["image"].cpu()
              for d, app in apps.items()}
    e_ev = ((frames[gpu] - frames[cpu]).abs().max()
            / frames[cpu].abs().max()).item()
    print(f"tiny latent-NeRF eval chunk (5 views, 16² latents decoded and "
          f"resized to 96²), card vs CPU: max err / max {e_ev:.2e} (tol "
          f"1e-4)")
    if not (frames[gpu].shape == (5, 96, 96, 3) and e_ev <= 1e-4):
        fail("the tiny eval chunk on the card disagrees with the CPU's")


def check_small_depth_step(seed: int, gpu) -> None:
    """Config #5's step at the tiny size, card against CPU
    (`scripts.depth_step`): depth-guided latent-paint-mesh, B = 2 views
    (body and head camera), mode 0, the same weights and draws, f32; the
    loss on the scale of its summed terms and every gradient within
    paint-mesh's tolerances. The card's stack is read from tiny directories
    the CPU stack is written into (`create(model_dir=..., use_inpaint=True,
    inpaint_model_dir=...)`, the inpainting UNet drawn from the seed)."""
    from tpunerf_torch.scripts import depth_step

    (l_cpu, g_cpu), (l_gpu, g_gpu), scale = depth_step.tiny_depth_steps(
        gpu, seed, load_stack=lambda cpu_stack, dev: stack_from_dirs(
            cpu_stack, dev, seed))
    want = {"background_sphere_colors", "displacement", "texture_img"}
    if set(g_cpu) != want or set(g_gpu) != want:
        fail(f"the tiny config #5 step has gradients of {sorted(g_cpu)} on "
             f"the CPU and {sorted(g_gpu)} on the card, not {sorted(want)}")
    rel_summed = abs(l_gpu - l_cpu) / scale
    g_err = _rel_grad_err(g_gpu, g_cpu)
    print(f"tiny config #5 step (depth SD, B = 2, mode 0), card vs CPU: loss "
          f"{l_gpu:+.6e} vs {l_cpu:+.6e}, |diff| / sum|terms| "
          f"{rel_summed:.2e} (tol {depth_step.LOSS_TOL:.0e}; sum|terms| "
          f"{scale:.4e}); max grad err / max|grad| {g_err:.2e} (tol "
          f"{depth_step.GRAD_TOL:.0e}) over {sorted(g_cpu)}")
    if not (rel_summed <= depth_step.LOSS_TOL
            and g_err <= depth_step.GRAD_TOL):
        fail("the tiny config #5 step on the card disagrees with the CPU step")


def check_small_pbe_step(seed: int, gpu) -> None:
    """The Paint-by-Example step at the tiny size, card against CPU
    (`scripts.pbe_step`): an exemplar PNG, `use_clip`, one body view, mode
    0, the same weights and draws, f32, at t = 250 (the CLIP branch: DDIM
    step, VAE decode and CLIP tower differentiated) and t = 500 (SDS): the
    loss on its scale and every gradient within paint-mesh's
    tolerances. The card's stack is read from a tiny directory the CPU
    stack is written into (`create(model_dir=...)`)."""
    from tpunerf_torch.scripts import pbe_step

    want = {"background_sphere_colors", "displacement", "texture_img"}
    for branch, ((l_cpu, g_cpu), (l_gpu, g_gpu), scale) in \
            pbe_step.tiny_pbe_steps(gpu, seed, load_stack=lambda cpu_stack,
                                    dev: stack_from_dirs(cpu_stack, dev,
                                                         seed)).items():
        if set(g_cpu) != want or set(g_gpu) != want:
            fail(f"the tiny Paint-by-Example {branch} step has gradients of "
                 f"{sorted(g_cpu)} on the CPU and {sorted(g_gpu)} on the "
                 f"card, not {sorted(want)}")
        rel = abs(l_gpu - l_cpu) / scale
        g_err = _rel_grad_err(g_gpu, g_cpu)
        print(f"tiny Paint-by-Example step ({branch} branch, t = "
              f"{pbe_step.BRANCH_T[branch]}), card vs CPU: loss "
              f"{l_gpu:+.6e} vs {l_cpu:+.6e}, |diff| / scale {rel:.2e} (tol "
              f"{pbe_step.LOSS_TOL:.0e}; scale {scale:.4e}); max grad err / "
              f"max|grad| {g_err:.2e} (tol {pbe_step.GRAD_TOL:.0e})")
        if not (rel <= pbe_step.LOSS_TOL and g_err <= pbe_step.GRAD_TOL):
            fail(f"the tiny Paint-by-Example {branch} step on the card "
                 "disagrees with the CPU step")


# --------------------------------------------------------------------------
# diffusers-layout directories written from the port's modules: the port
# reads such directories (guidance/weights.py) and, as the JAX package, has
# no writer of its own
# --------------------------------------------------------------------------

ST_DTYPES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16",
             "int64": "I64"}
VAE_OLD_NAMES = {"group_norm": "norm", "to_q": "query", "to_k": "key",
                 "to_v": "value", "to_out.0": "proj_attn"}
WEIGHTS_STEPS = 4       # latent-NeRF CLI steps from --guide.model_dir
WEIGHTS_PHASE_S = 90    # the pretrained-weights phase's budget


def write_safetensors(path: Path, tensors) -> int:
    """{name: tensor} (any device) as a .safetensors file in the tensors'
    own dtypes, the header padded to 8 bytes. Returns the bytes written."""
    import struct
    import torch
    header, host, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        size = t.numel() * t.element_size()
        header[name] = {"dtype": ST_DTYPES[str(t.dtype).split(".")[-1]],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        host.append(t)
        offset += size
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for t in host:
            f.write(t.reshape(-1).view(torch.uint8).numpy())
    return 8 + len(text) + offset


def write_part(base: Path, state, form: str) -> int:
    """One module's state dict at `base` (no suffix): "st" as safetensors in
    its dtypes, "bin" by torch.save. Returns the file's bytes."""
    import torch
    base.parent.mkdir(parents=True, exist_ok=True)
    if form == "st":
        return write_safetensors(base.with_suffix(".safetensors"), state)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               base.with_suffix(".bin"))
    return base.with_suffix(".bin").stat().st_size


def vae_old_names(state) -> dict:
    """A VAE state dict with its attention in diffusers' older naming
    (`norm`, `query`, `key`, `value`, `proj_attn`)."""
    pat = re.compile(r"^(.*\.mid_block\.attentions\.\d+)\."
                     r"(group_norm|to_q|to_k|to_v|to_out\.0)\.(\w+)$")
    out = {}
    for k, v in state.items():
        m = pat.match(k)
        out[f"{m.group(1)}.{VAE_OLD_NAMES[m.group(2)]}.{m.group(3)}"
            if m else k] = v
    return out


def equal_modules(pairs) -> tuple:
    """(tensors compared, whether each pair of modules has the same state
    dict, dtype and bits)."""
    import torch
    n, same = 0, True
    for a, b in pairs:
        sa, sb = a.state_dict(), b.state_dict()
        n += len(sa)
        same = same and sa.keys() == sb.keys() and all(
            sa[k].dtype == sb[k].dtype
            and torch.equal(sa[k], sb[k].to(sa[k].device)) for k in sa)
    return n, same


def stack_from_dirs(cpu_stack, device, seed: int):
    """A tiny depth or Paint-by-Example stack on `device` read by its
    `create(model_dir=...)` from directories `cpu_stack` is written into
    (UNet and text tower as F32 safetensors, the VAE as .bin in the older
    attention naming, the exemplar encoder as `image_encoder/model`; for
    depth also a 9-channel inpainting UNet drawn from `seed`, read by
    `use_inpaint=True, inpaint_model_dir=...`), held equal bit for bit to
    its sources."""
    import tempfile
    import torch
    from tpunerf_torch.guidance.depth import StableDiffusionDepthGuidance
    from tpunerf_torch.guidance.paint_by_example import \
        PaintByExampleGuidance
    from tpunerf_torch.guidance.stable_diffusion import _build
    from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
    depth = isinstance(cpu_stack, StableDiffusionDepthGuidance)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiny_") as tmp:
        root = Path(tmp)
        write_part(root / "unet" / "diffusion_pytorch_model",
                   cpu_stack.unet.state_dict(), "st")
        write_part(root / "vae" / "diffusion_pytorch_model",
                   vae_old_names(cpu_stack.vae.state_dict()), "bin")
        pairs = [(cpu_stack.unet, "unet"), (cpu_stack.vae, "vae")]
        if depth:
            write_part(root / "text_encoder" / "model",
                       cpu_stack.text_encoder.state_dict(), "st")
            inpaint = _build(UNet2DCondition, UNetConfig.tiny(in_channels=9),
                             torch.device("cpu"),
                             torch.Generator().manual_seed(seed))
            write_part(root / "inpaint" / "unet" / "diffusion_pytorch_model",
                       inpaint.state_dict(), "st")
            stack = StableDiffusionDepthGuidance.create(
                tiny=True, model_dir=root, use_inpaint=True,
                inpaint_model_dir=root / "inpaint", unet_dtype="float32",
                device=device)
            pairs += [(cpu_stack.text_encoder, "text_encoder"),
                      (inpaint, "inpaint_unet")]
        else:
            write_part(root / "image_encoder" / "model",
                       cpu_stack.image_encoder.state_dict(), "st")
            stack = PaintByExampleGuidance.create(
                tiny=True, model_dir=root, unet_dtype="float32",
                device=device)
            pairs += [(cpu_stack.image_encoder, "image_encoder")]
    n, same = equal_modules([(a, getattr(stack, name)) for a, name in pairs])
    label = "depth (+ inpainting UNet)" if depth else "Paint-by-Example"
    print(f"tiny {label} stack on the card from create(model_dir=...): "
          f"{n} tensors of {', '.join(name for _, name in pairs)} equal to "
          f"their sources bit for bit: {same}")
    if not same:
        fail(f"the tiny {label} stack read from its directories differs "
             f"from the stack written")
    return stack


def write_sd_dir(root: Path, guidance) -> int:
    """The SD-v1 stack in diffusers' layout, in mixed forms: the bf16 UNet
    as BF16 safetensors, the VAE as F32 safetensors in the older attention
    naming, the text tower as `text_encoder/pytorch_model.bin` with the
    `text_model.` prefix and a stray `position_ids`. Returns the bytes
    written."""
    import torch
    n = write_part(root / "unet" / "diffusion_pytorch_model",
                   guidance.unet.state_dict(), "st")
    n += write_part(root / "vae" / "diffusion_pytorch_model",
                    vae_old_names(guidance.vae.state_dict()), "st")
    text = {f"text_model.{k}": v
            for k, v in guidance.text_encoder.state_dict().items()}
    text["text_model.embeddings.position_ids"] = torch.arange(
        guidance.text_encoder.config.max_length)[None]
    n += write_part(root / "text_encoder" / "pytorch_model", text, "bin")
    return n


def weights_phase(seed: int, guidance) -> dict:
    """Pretrained weights at full width: the SD-v1 stack (the 859M UNet in
    bf16, the VAE and the ViT-L/14 text tower in f32) written as a
    diffusers-layout directory (`write_sd_dir`), read back on the card by
    `StableDiffusionGuidance.create(model_dir=...)` (every parameter equal
    to its source bit for bit, one CFG pass of the loaded UNet equal to the
    source's on the same inputs, with #4's launches), the latent-NeRF CLI
    from `--guide.model_dir` at sand_castle.yaml's settings for
    WEIGHTS_STEPS steps (evals, images and the export cut; finite losses,
    #1-#4 launched), and the port's `convert_sd_weights --dtype bfloat16`
    on the directory (its count in the JAX script's line). Prints bytes,
    seconds and GB/s beside the card. The directory goes after the phase;
    a temporary filesystem without room for it fails by name. Returns the
    CLI run's launches."""
    import contextlib as ctx
    import io
    import shutil
    import tempfile
    import torch
    from tpunerf_torch import train_latent_nerf
    from tpunerf_torch.guidance import sds as sds_lib
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og
    from tpunerf_torch.scripts import convert_sd_weights
    from tpunerf_torch.training import trainer as trainer_lib

    t_phase = time.perf_counter()
    parts = ("unet", "vae", "text_encoder")
    n_params = {n: sum(p.numel() for p in getattr(guidance, n).parameters())
                for n in parts}
    sizes = {n: sum(p.numel() * p.element_size()
                    for p in getattr(guidance, n).parameters())
             for n in parts}
    need = sum(sizes.values()) + 2 * sum(n_params.values())   # + bf16 .npz
    tmp = Path(tempfile.gettempdir())
    free = shutil.disk_usage(tmp).free
    print(f"pretrained weights: parameters {n_params}, the directory "
          f"{sum(sizes.values()) / 1e9:.3f} GB and the bf16 .npz "
          f"{2 * sum(n_params.values()) / 1e9:.3f} GB under {tmp} "
          f"({free / 1e9:.1f} GB free)")
    if free < 1.1 * need:
        fail(f"pretrained weights phase: {tmp} has {free / 1e9:.2f} GB "
             f"free, the phase writes {need / 1e9:.2f} GB")
    smi = nvidia_smi("name,power.limit")
    card = smi[0] if smi else "unavailable"
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_weights_", dir=tmp))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = write_sd_dir(root, guidance)
        write_s = time.perf_counter() - t0
        files = sorted(p for p in root.rglob("*") if p.is_file())
        on_disk = sum(p.stat().st_size for p in files)
        print(f"pretrained weights, written ({card}): {written} bytes in "
              f"{write_s:.3f} s ({written / write_s / 1e9:.3f} GB/s): "
              + ", ".join(f"{p.relative_to(root)} {p.stat().st_size}"
                          for p in files))

        # the stack resident on the card, read back
        t0 = time.perf_counter()
        loaded = StableDiffusionGuidance.create(
            model_dir=root, unet_dtype="auto", device=torch.device("cuda"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n, same = equal_modules([(getattr(guidance, p), getattr(loaded, p))
                                 for p in parts])
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lat = torch.randn((1, 64, 64, 4), generator=gen, device="cuda")
        emb = guidance.get_text_embeds(["a highly detailed sandcastle"])
        t = torch.tensor(500, device="cuda")
        with torch.no_grad():
            eps_src = sds_lib.cfg_eps(guidance.unet_apply, lat, t, emb, 100.0)
            torch.cuda.synchronize()
            _build.reset_launches()
            eps_new = sds_lib.cfg_eps(loaded.unet_apply, lat, t, emb, 100.0)
            torch.cuda.synchronize()
        cfg_attn = _build.LAUNCHES.get(at.ATTN, 0)
        same_eps = torch.equal(eps_src, eps_new) and bool(
            torch.isfinite(eps_new).all())
        print(f"pretrained weights, read ({card}): create(model_dir=...) to "
              f"the stack resident on the card {load_s:.3f} s, {on_disk} "
              f"bytes read ({on_disk / load_s / 1e9:.3f} GB/s; the files "
              f"just written, a warm read); {n} tensors equal to their "
              f"sources bit for bit (dtype too): {same}; UNet dtype "
              f"{loaded.unet.conv_in.weight.dtype}; one CFG pass (batch 2) "
              f"of the loaded UNet equal to the source's bit for bit: "
              f"{same_eps}, #4 launched {cfg_attn} times in it")
        if not (same and same_eps and cfg_attn > 0):
            fail("the SD-v1 stack read from its directory differs from its "
                 "source, or its CFG pass does, or it never launched #4")
        del loaded, eps_src, eps_new
        _free_card()

        # the latent-NeRF CLI from --guide.model_dir
        argv = ["--config_path", str(SAND_CASTLE), "--guide.model_dir",
                str(root), "--optim.iters", str(WEIGHTS_STEPS),
                "--optim.seed", str(seed), "--log.exp_root",
                str(ROOT / "experiments" / "chip_smoke"), "--log.exp_name",
                "weights_cli", "--log.eval_size", "0",
                "--log.full_eval_size", "0", "--log.save_mesh", "false",
                "--log.log_images", "false", "--log.save_interval", "100",
                "--device", "cuda"]
        real_step = trainer_lib.Trainer.train_step
        losses, stamps = [], []

        def step(self):
            out = real_step(self)
            losses.append(float(out[0]))       # synchronises
            stamps.append(time.perf_counter())
            return out

        trainer_lib.Trainer.train_step = step
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            train_latent_nerf.main(argv)
        finally:
            trainer_lib.Trainer.train_step = real_step
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = dict(_build.LAUNCHES)
        first = stamps[0] - t0 if stamps else float("nan")
        print(f"latent-NeRF CLI from --guide.model_dir ({card}): "
              f"{' '.join(argv[:-2])} (cut: iters {WEIGHTS_STEPS} of 5000, no "
              f"evals, images or export): {first:.3f} s to the end of its "
              f"first step (the stack read, the field, the text embeddings), "
              f"{cli_s:.3f} s in all; losses "
              + " ".join(f"{v:+.4e}" for v in losses)
              + f"; launches {cli_launches}")
        path_kernels = (hg.FWD, hg.BWD, og.LOOKUP, at.ATTN)
        if not (len(losses) == WEIGHTS_STEPS
                and all(math.isfinite(v) for v in losses)
                and all(cli_launches.get(k, 0) > 0 for k in path_kernels)):
            fail("the latent-NeRF CLI from --guide.model_dir missed steps, "
                 "gave a non-finite loss or never launched one of #1-#4")
        _free_card()

        # the converter, as a user runs it
        out = io.StringIO()
        t0 = time.perf_counter()
        with ctx.redirect_stdout(out):
            convert_sd_weights.main(["--model_dir", str(root), "--out",
                                     str(root / "sd_v1.npz"), "--dtype",
                                     "bfloat16"])
        conv_s = time.perf_counter() - t0
        line = out.getvalue().strip().splitlines()[-1]
        m = re.search(r": (\d+) tensors, ([\d.]+)M params, dtype=bfloat16$",
                      line)
        npz = (root / "sd_v1.npz").stat().st_size
        print(f"convert_sd_weights --dtype bfloat16: {conv_s:.3f} s, "
              f"{npz} bytes; its line: {line}")
        want = sum(n_params.values()) / 1e6
        if not (m and abs(float(m.group(2)) - want) < 0.1
                and 1060 < float(m.group(2)) < 1070):
            fail(f"convert_sd_weights printed {line!r}, not "
                 f"{want:.1f}M params")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"pretrained weights phase: {phase_s:.1f} s (budget "
          f"{WEIGHTS_PHASE_S} s); the directory removed: {not root.exists()}")
    if phase_s > WEIGHTS_PHASE_S:
        fail(f"the pretrained weights phase took {phase_s:.1f} s, over its "
             f"{WEIGHTS_PHASE_S} s")
    return cli_launches


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


def mesh_written(mesh_dir: Path) -> bool:
    """Whether an export wrote its OBJ, MTL and albedo into `mesh_dir`."""
    return mesh_dir.is_dir() and sorted(
        p.name for p in mesh_dir.iterdir()) == ["albedo.png", "mesh.mtl",
                                                "mesh.obj"]


def obj_summary(mesh_dir: Path) -> str:
    """The vertex and face counts of `mesh_dir/mesh.obj`."""
    obj = mesh_dir / "mesh.obj"
    if not obj.exists():
        return f"no {obj.name} under {mesh_dir.name}/"
    lines = obj.read_text().splitlines()
    n_v = sum(ln.startswith("v ") for ln in lines)
    n_f = sum(ln.startswith("f ") for ln in lines)
    return f"{mesh_dir.name}/{obj.name}: {n_v} vertices, {n_f} faces"


SAND_CASTLE = ROOT / "demo_configs" / "latent_nerf" / "sand_castle.yaml"
LEGO_MAN = ROOT / "demo_configs" / "latent_nerf" / "lego_man.yaml"
NASCAR_DEPTH = ROOT / "demo_configs" / "latent_paint_mesh" / \
    "nascar_depth.yaml"


def _nerf_argv(steps: int, seed: int, *extra: str):
    """A latent-NeRF config (sand_castle.yaml or lego_man.yaml) cut to
    `steps` steps with a checkpoint (and its eval) every STEPS/2; every
    other setting the yaml's or its default, unless `extra` sets it."""
    return ["--optim.iters", str(steps), "--optim.seed", str(seed),
            "--log.exp_root", str(ROOT / "experiments" / "chip_smoke"),
            "--log.save_interval", str(STEPS // 2), *extra]


# eval config #3 (lego_man.yaml) on the procedural sphere: its mesh,
# shapes/teddy.obj, is not in the repo; the final orbit cut to 10 frames
SKETCH = ("--guide.shape_path", "sphere", "--log.full_eval_size", "10")


def train_full_width(steps: int, seed: int, guidance,
                     config: Path = SAND_CASTLE, extra=(),
                     label: str = "latent-NeRF"):
    """Full-width latent-NeRF training through the port's Trainer at
    `config`'s settings (stage 1: sand_castle.yaml; config #3: lego_man.yaml
    with `SKETCH`), cut only to `steps` steps, a checkpoint every steps/2
    and what `extra` sets: the eval orbit's 10 frames at 512² before the
    first step and after each checkpoint, train images at 5 %,
    asynchronous checkpoints, the final orbit and the mesh export (the 64³
    iso-surface at 10, written as OBJ/MTL/albedo under `mesh/`); with a
    guide shape, the shape loss of every step. Prints the save's times, the
    artifacts, the exported mesh's size and the steady median without the
    steps that carry a checkpoint, an eval or an image. Returns the run's
    launches, the app, the trainer and what reached #1-#3 on step
    CAPTURE_STEP and the first eval chunk."""
    import shutil
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer

    cfg = parse(TrainConfig, _nerf_argv(steps, seed, *extra),
                config_path=config)
    log, guide = cfg.log, cfg.guide
    exp = Path(log.exp_dir)
    shutil.rmtree(exp, ignore_errors=True)      # an earlier call's
    full = parse(TrainConfig, [], config_path=config).optim.iters
    print(f"{label}, {config.name}, cuts: optim.iters {steps} (of {full}), "
          f"log.save_interval {log.save_interval} (of 100), "
          f"{' '.join(extra) or 'nothing else'}; settings: eval_size "
          f"{log.eval_size}, full_eval_size {log.full_eval_size}, eval_batch "
          f"{log.eval_batch}, log_images {log.log_images} at vis_train_prob "
          f"{log.vis_train_prob}, async_ckpt {log.async_ckpt}, "
          f"max_keep_ckpts {log.max_keep_ckpts}, save_mesh {log.save_mesh}, "
          f"eval_grid_size {cfg.render.eval_grid_size}, seed "
          f"{cfg.optim.seed}, text {guide.text!r}; guide shape "
          f"{guide.shape_path} (shape_scale {guide.shape_scale}, dy "
          f"{guide.dy}, proximal_surface {guide.proximal_surface}, "
          f"lambda_shape {cfg.optim.lambda_shape})")
    t0 = time.perf_counter()
    app = LatentNeRFApp.create(cfg, guidance=guidance, device="cuda")
    trainer = Trainer(cfg, app, device="cuda")
    torch.cuda.synchronize()
    print(f"{label} setup (text embeddings, field"
          f"{', SDF grid' if app.scene.sdf is not None else ''}): "
          f"{time.perf_counter() - t0:.2f} s")
    save_return, shape_losses = [], []
    real_save, real_loss = trainer.save_checkpoint, app.loss_fn

    def timed_save(full=True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(full)
        save_return.append(time.perf_counter() - t)

    def loss_fn(*args, **kwargs):
        loss, aux = real_loss(*args, **kwargs)
        shape_losses.append(aux.get("shape_loss"))
        return loss, aux

    trainer.save_checkpoint, app.loss_fn = timed_save, loss_fn
    try:
        with capture_hash_inputs(CAPTURE_STEP) as captured:
            _, times, tail_s, launches = timed_train(trainer, steps)
    finally:
        del trainer.save_checkpoint, app.loss_fn
    if app.scene.sdf is not None:
        shape = [float(v) for v in shape_losses]
        print(f"{label} shape loss: " + " ".join(f"{v:.5f}" for v in shape))
        if not (len(shape) == steps and all(math.isfinite(v) and v > 0
                                            for v in shape)):
            fail(f"{label}: the shape loss is missing or not finite")

    # what the run wrote
    ckpts = [p.name for p in trainer.ckpts.existing()]
    evals = sorted(p.name for p in (exp / "vis" / "eval").iterdir())
    results = sorted(p.name for p in (exp / "results").iterdir())
    images = sorted(p.name for p in (exp / "vis" / "train").iterdir())
    mesh_line = [ln for ln in (exp / "log.txt").read_text().splitlines()
                 if "mesh export" in ln]
    saves = list(range(log.save_interval, steps + 1, log.save_interval))
    print(f"checkpoints kept: {ckpts}; eval frames: {len(evals)} (steps "
          f"{sorted({int(e[5:11]) for e in evals})}); results: "
          f"{len(results)} files ({results[0]} ... {results[-1]}); train "
          f"images: {images}")
    print(f"log: {mesh_line[0] if mesh_line else 'no mesh export line'}; "
          f"{obj_summary(exp / 'mesh')}")
    if not (ckpts == [f"step_{s:06d}.ckpt" for s in saves[-2:]]
            and len(evals) == log.eval_size * (len(saves) + 1)
            and (len(results) == log.full_eval_size
                 or any(r.endswith((".mp4", ".gif")) for r in results))
            and all(r.startswith(f"step_{steps:06d}") for r in results)
            and mesh_written(exp / "mesh")):
        fail(f"the {label} run did not write its checkpoints, frames or "
             f"mesh")

    # steady steps: past the first (it carries the first eval), without the
    # refresh steps (16, 32, ...) and the steps after a checkpoint with its
    # eval, or after an image: their time lands in the next step's interval
    aside = {1} | {s + 1 for s in saves} | {
        int(name[5:11]) + 1 for name in images}
    steady = sorted(t for i, t in enumerate(times, start=1)
                    if i not in aside and i % 16 != 0)
    med = steady[len(steady) // 2]
    rays = cfg.render.batch_size * cfg.render.train_grid_size ** 2
    print(f"{label} steady step: median {1e3 * med:.3f} ms over "
          f"{len(steady)} steps (p90 "
          f"{1e3 * steady[int(0.9 * (len(steady) - 1))]:.3f}, max "
          f"{1e3 * steady[-1]:.3f}; {rays / med:.1f} rays/s; left out: steps "
          f"{sorted(aside)} and the refresh steps); refresh step 16: "
          f"{1e3 * times[15]:.3f} ms; step {saves[0] + 1} (after the step-"
          f"{saves[0]} checkpoint and eval): {1e3 * times[saves[0]]:.3f} ms;"
          f" full eval ({log.full_eval_size} frames, PNG writes, mesh "
          f"export, joins) {tail_s:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    print(f"{label} save_checkpoint in the run: returned in "
          + ", ".join(f"{1e3 * t:.2f}" for t in save_return) + " ms")
    occ_frac = app.metric_scalars().get("occ_frac")
    print(f"{label} occ_frac after training: {occ_frac}")
    return launches, app, trainer, captured


def save_and_eval_split(app, trainer) -> None:
    """Stage 1 after its run: one save by hand (to its return, to the end
    of the write; its size) and the eval chunk's time split into the 64²
    latent render and the VAE decode."""
    import torch
    from tpunerf_torch.core.views import circle_poses
    cfg = trainer.cfg
    log, steps = cfg.log, trainer.train_step_idx
    exp = Path(log.exp_dir)
    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.save_checkpoint(True)
    t_ret = time.perf_counter() - t
    trainer.ckpts.flush()
    t_end = time.perf_counter() - t
    size = (exp / "checkpoints" / f"step_{steps:06d}.ckpt").stat().st_size
    print(f"checkpoint of step {steps} (scene state_dict + Adam), async: "
          f"returned in {1e3 * t_ret:.2f} ms, written in {1e3 * t_end:.2f} "
          f"ms; {size} bytes ({size / 2 ** 20:.2f} MiB)")

    # the eval chunk split: render at the 64² latent grid, VAE decode
    views = circle_poses(log.eval_batch, trainer.view_cfg, trainer.device)
    dims = (cfg.render.eval_grid_size,) * 2
    chunk_ms = cuda_ms(lambda: app.eval_render(views, dims), 3, warmup=1)
    with torch.no_grad():
        def render():
            return app.scene.render_views(
                views, (app.scene.latent_size,) * 2, perturb=False,
                use_occupancy=True, white_background=True)
        latents = render()["image"]
        render_ms = cuda_ms(render, 5)
        decode_ms = cuda_ms(lambda: app.guidance.decode_latents(latents),
                            3, warmup=1)
    print(f"latent-NeRF eval chunk ({log.eval_batch} views, "
          f"{app.scene.latent_size}² latent render + VAE decode to "
          f"{dims[0]}²): {chunk_ms:.3f} ms; alone: render {render_ms:.3f} "
          f"ms, VAE decode of {tuple(latents.shape)} {decode_ms:.3f} ms")


def resume_and_eval_only(steps: int, seed: int, guidance, trainer) -> None:
    """A second Trainer over the same experiment with optim.resume and two
    more steps: it restores step `steps`, its scene and Adam state equal
    the first trainer's bit for bit, and its steps are finite. Then the
    CLI with log.eval_only writes the final orbit of the newest checkpoint
    and takes no step."""
    import shutil
    import torch
    from tpunerf_torch import train_latent_nerf
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training import trainer as trainer_lib
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp

    argv = _nerf_argv(steps + 2, seed, "--optim.resume", "true")
    cfg = parse(TrainConfig, argv, config_path=SAND_CASTLE)
    t0 = time.perf_counter()
    app = LatentNeRFApp.create(cfg, guidance=guidance, device="cuda")
    resumed = trainer_lib.Trainer(cfg, app, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    a, b = trainer.app.state_dict(), resumed.app.state_dict()
    same_scene = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                              for k in a)
    oa = trainer.optimizer.state_dict()["state"]
    ob = resumed.optimizer.state_dict()["state"]
    same_adam = oa.keys() == ob.keys() and all(
        oa[i].keys() == ob[i].keys()
        and all(torch.equal(oa[i][k], ob[i][k]) for k in oa[i]) for i in oa)
    print(f"resume: restored step {resumed.train_step_idx} in {load_s:.2f} "
          f"s (app and trainer construction included); scene state_dict "
          f"({len(a)} tensors) equal bit for bit: {same_scene}; Adam state "
          f"({len(oa)} parameters, step, exp_avg, exp_avg_sq) equal bit for "
          f"bit: {same_adam}")
    if not (resumed.train_step_idx == steps and same_scene and same_adam):
        fail("the resumed trainer does not restore the saved state")
    losses, _, _, _ = timed_train(resumed, 2)
    print(f"resume: steps {steps + 1}-{steps + 2} losses "
          + " ".join(f"{v:+.4e}" for v in losses))
    del resumed, app

    exp = Path(cfg.log.exp_dir)
    shutil.rmtree(exp / "results")
    real_step = trainer_lib.Trainer.train_step

    def no_step(self):
        fail("log.eval_only took a training step")

    trainer_lib.Trainer.train_step = no_step
    t0 = time.perf_counter()
    try:
        train_latent_nerf.main(
            ["--config_path", str(SAND_CASTLE)]
            + _nerf_argv(steps + 2, seed, "--log.eval_only", "true",
                         "--optim.resume", "true", "--device", "cuda"))
    finally:
        trainer_lib.Trainer.train_step = real_step
    torch.cuda.synchronize()
    results = sorted(p.name for p in (exp / "results").iterdir())
    print(f"eval only (CLI, guidance built anew): {time.perf_counter() - t0:.2f}"
          f" s; results: {len(results)} files ({results[0] if results else ''}"
          f" ...)")
    if not (results and all(r.startswith(f"step_{steps:06d}")
                            for r in results)):
        fail("log.eval_only wrote no results frames of the newest checkpoint")


CAPTURE_STEP = 10   # a steady latent-NeRF step: past step 1, no refresh


@contextlib.contextmanager
def capture_hash_inputs(step: int):
    """While open, copies what reaches kernels #1 and #2 on training step
    `step` (the step-th table gradient): {"x", "table", "g"}, and what
    reaches #3 on that step (its step-th lookup outside the eval render, one
    a step): "occ"; and what reaches #1 and #3 in the first eval chunk (the
    first calls inside `LatentNeRFScene.render_test`): "eval_x",
    "eval_table", "eval_occ". It wraps the module functions `HashEncode`
    and `occupied` call, and `render_test`, and calls through to them, so
    every launch still counts; the package is not changed."""
    from tpunerf_torch.fields.scene import LatentNeRFScene
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og
    fwd, bwd = hg.hash_encode_fwd, hg.hash_encode_bwd
    lookup = og.occupancy_lookup
    render_test = LatentNeRFScene.render_test
    last, captured, seen, in_eval = {}, {}, [0, 0], [False]

    def lookup_spy(x, packed, grid_res, bnd):
        if not in_eval[0]:
            seen[1] += 1
            if seen[1] == step:
                captured["occ"] = (x.clone(), packed.clone(), grid_res, bnd)
        elif "eval_occ" not in captured:
            captured["eval_occ"] = (x.clone(), packed.clone(), grid_res, bnd)
        return lookup(x, packed, grid_res, bnd)

    def fwd_spy(x, table, cfg):
        if not in_eval[0]:
            last.update(x=x, table=table)   # references only, no copy
        elif "eval_x" not in captured:
            captured.update(eval_x=x.clone(), eval_table=table.clone(),
                            eval_cfg=cfg)
        return fwd(x, table, cfg)

    def bwd_spy(x, g, cfg):
        seen[0] += 1
        if seen[0] == step:
            # before the optimizer step, so `table` is still this step's
            captured.update(x=x.clone(), g=g.clone(),
                            table=last["table"].clone(), cfg=cfg)
        return bwd(x, g, cfg)

    def render_test_spy(self, *args, **kwargs):
        in_eval[0] = True
        try:
            return render_test(self, *args, **kwargs)
        finally:
            in_eval[0] = False

    hg.hash_encode_fwd, hg.hash_encode_bwd = fwd_spy, bwd_spy
    og.occupancy_lookup = lookup_spy
    LatentNeRFScene.render_test = render_test_spy
    try:
        yield captured
    finally:
        hg.hash_encode_fwd, hg.hash_encode_bwd = fwd, bwd
        og.occupancy_lookup = lookup
        LatentNeRFScene.render_test = render_test


def check_hash_step_inputs(captured, rows) -> None:
    """(c) Kernels #1 and #2 on the x, table and g of one steady
    full-width latent-NeRF step (ray-ordered: 64 compacted samples a ray),
    beside the level-per-block designs; (b) kernel #3 on that step's
    samples beside its first design; the times go into the rows as
    `step_inputs`. Then #1 and #3 on the first eval chunk's inputs
    (`eval_inputs`)."""
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og
    if "g" not in captured or "occ" not in captured:
        fail(f"no table gradient or no lookup reached kernels #2, #3 on "
             f"step {CAPTURE_STEP}")
    rows[og.LOOKUP]["step_inputs"] = occgrid_case(
        *captured["occ"], f"(b) latent-NeRF step {CAPTURE_STEP}'s samples")
    fwd, bwd = hash_grid_rows(captured["x"], captured["table"],
                              captured["g"], captured["cfg"],
                              f"latent-NeRF step {CAPTURE_STEP}'s inputs")
    keys = ("max_abs_err", "ms", "graph_ms", "level_per_block_ms",
            "level_per_block_graph_ms", "bound_ms", "share_of_bound")
    for name, row in ((hg.FWD, fwd), (hg.BWD, bwd)):
        rows[name]["step_inputs"] = {k: row[k] for k in keys}
    # the eval orbit's first chunk: 5 poses at the 64² latent grid, S = 128,
    # K = 64, under no_grad (#1 and #3 only: nothing runs backward there)
    if "eval_x" not in captured or "eval_occ" not in captured:
        fail("no eval chunk reached kernels #1 and #3")
    rows[og.LOOKUP]["eval_inputs"] = occgrid_case(
        *captured["eval_occ"], "(c) the first eval chunk's samples")
    fwd, _ = hash_grid_rows(captured["eval_x"], captured["eval_table"], None,
                            captured["eval_cfg"],
                            "latent-NeRF eval chunk's inputs")
    rows[hg.FWD]["eval_inputs"] = {k: fwd[k] for k in keys}


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
        # two dense launches per step, and the eval render's one behind its
        # shut gate beside the binned one
        want = {at.ATTN: 5 * steps, rz.DENSE: 2 * steps + 1, rz.BINNED: 1}
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
        trainer.flush()           # the frames' PNGs are written by a pool
        trainer.close()
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


def train_paint_chunked(steps: int, seed: int, guidance):
    """(d) Full-width latent-paint as `train_paint_full_width` trains it,
    with `--optim.train_chunk 4`: `steps` steps in chunks of 4 replays of
    the captured step, then the eval orbit (5 frames at 512², one chunk),
    no mesh export. Its launches are exactly `steps` replays and the
    capture's warm-up step (5 attention, 2 dense selection launches each)
    and the eval chunk's binned selection. Then the steady step graphed
    beside eager and the RGB refine of the run's latent checkpoint
    (`refine_paint`). Returns the run's launches."""
    import tempfile
    import torch
    from tpunerf_torch.core.config import parse
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
            "--log.eval_batch", str(n_eval), "--log.save_mesh", "false",
            "--log.log_images", "false", "--optim.train_chunk", "4",
            "--log.save_interval", str(steps + 1)])
        app = LatentPaintApp.create(cfg, guidance=guidance, device="cuda")
        trainer = Trainer(cfg, app, device="cuda")
        scene = app.scene
        tex0 = scene.texture_img.detach().clone()
        chunks, _, launches = timed_chunks(trainer)
        per_step = sorted(t / k for _, k, t in chunks)
        per_replay = trainer.graph.launches
        print(f"latent-paint chunked (train_chunk 4): median chunk "
              f"{1e3 * per_step[len(per_step) // 2]:.3f} ms a step over "
              f"{len(chunks)} chunks; launches a replay "
              f"{json.dumps(per_replay)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        print("latent-paint chunked launches: " + json.dumps(launches))
        if torch.equal(tex0, scene.texture_img.detach()):
            fail("chunked latent-paint left the texture unchanged")
        if per_replay != {at.ATTN: 5, rz.DENSE: 2}:
            fail(f"the captured latent-paint step records {per_replay}, "
                 f"not 5 attention and 2 dense selection launches")
        want = {at.ATTN: 5 * (steps + 1), rz.DENSE: 2 * (steps + 1) + 1,
                rz.BINNED: 1}
        for name, n in want.items():
            if launches.get(name, 0) != n:
                fail(f"chunked latent-paint launched {name} "
                     f"{launches.get(name, 0)} times, expected {n}")
        if not list((Path(tmp) / "paint" / "results").iterdir()):
            fail("chunked latent-paint wrote no eval frames")
        steady_graph_vs_eager(trainer, "latent-paint")
        trainer.graph = None
        refine_paint(cfg, guidance, trainer, tmp)
        del trainer, app
    return launches


def refine_paint(cfg, guidance, trainer, tmp: str) -> None:
    """(d) latent-paint's refine: the run's latent checkpoint loaded in RGB
    mode (`render.nerf_type rgb`, `optim.ckpt`), which decodes its latent
    texture, resized to the texture resolution, into the finetune texture
    (equal bit for bit to the decode and resize done here), then 8 RGB
    steps in chunks of 4 replays and the 5-frame eval orbit: launches
    exactly 9 steps' worth (8 replays, the warm-up step) and the eval
    chunk's binned selection."""
    import dataclasses
    import torch
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.kernels import texture as texk
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer

    trainer.save_checkpoint(True)
    trainer.ckpts.flush()
    ckpt = trainer.ckpt_dir / f"step_{trainer.train_step_idx:06d}.ckpt"
    rcfg = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, nerf_type="rgb"),
        optim=dataclasses.replace(cfg.optim, ckpt=ckpt, iters=8),
        log=dataclasses.replace(cfg.log, exp_name="paint_refine",
                                save_mesh=False))
    app = LatentPaintApp.create(
        rcfg, guidance=dataclasses.replace(guidance, latent_mode=False),
        device="cuda")
    rtrainer = Trainer(rcfg, app, device="cuda")
    scene = app.scene
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    R = scene.texture_resolution
    want = texk.resize_bilinear(guidance.decode_latents(
        saved["texture_img"].cuda()), R, R)
    got = scene.texture_img_rgb_finetune.detach().clone()
    print(f"latent-paint refine load of {ckpt.name}: finetune texture "
          f"{tuple(got.shape)} in [{got.min().item():.3f}, "
          f"{got.max().item():.3f}], the checkpoint's was all zero: "
          f"{saved['texture_img_rgb_finetune'].abs().max().item() == 0}; "
          f"equal to the decode and resize: {torch.equal(got, want)}")
    if not (torch.equal(got, want) and got.abs().max().item() > 0):
        fail("the latent-paint refine did not migrate the texture")
    chunks, _, launches = timed_chunks(rtrainer)
    per_step = sorted(t / k for _, k, t in chunks)
    results = sorted(p.name for p in (Path(tmp) / "paint_refine"
                                      / "results").iterdir())
    print(f"latent-paint refine (RGB, 8 steps, train_chunk 4): chunks "
          f"{[k for _, k, _ in chunks]}, {1e3 * per_step[0]:.3f} .. "
          f"{1e3 * per_step[-1]:.3f} ms a step; results {results}; launches "
          f"{json.dumps(launches)}")
    if (torch.equal(got, scene.texture_img_rgb_finetune.detach())
            or not results):
        fail("the latent-paint refine did not train or write its frames")
    # 8 replays and the warm-up step, and the eval chunk's gated pair
    want = {name: 9 * n for name, n in rtrainer.graph.launches.items()}
    want[rz.BINNED] = 1
    want[rz.DENSE] += 1
    if (rtrainer.graph.launches != {at.ATTN: 5, rz.DENSE: 2}
            or any(launches.get(n, 0) != c for n, c in want.items())):
        fail(f"the latent-paint refine launched {launches}, expected {want}")


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
        # and the dome (1 selection); the eval chunk: both cameras at 512²,
        # each a gated pair (dense and binned launched, the one the bins'
        # overflow names open, which the lines above foretell for the soft
        # ones); no loss reads the soft mask, so no backward kernel runs
        n = lambda name: launches.get(name, 0)  # noqa: E731
        print("latent-paint-mesh launches: " + json.dumps(launches))
        if not (n(at.ATTN) == 5 * steps
                and n(rz.DENSE) == 3 * steps + 2 and n(rz.BINNED) == 2
                and n(rz.SOFT_FWD_DENSE) == 2 * steps + 2
                and n(rz.SOFT_FWD_BINNED) == 2
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
        trainer.flush()
        trainer.close()
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
            # mode 1: two UNet passes a step (image and blended latents),
            # the 512² soft forwards as gated pairs (both kernels launched)
            if soft != 2 * extra_steps * (2 if mode == 1 else 1) \
                    or mlaunch.get(at.ATTN, 0) != \
                    5 * extra_steps * (2 if mode == 1 else 1):
                fail(f"mode {mode} launched its kernels an unexpected "
                     f"number of times")
            if mode == 1:
                mode1 = (mapp, mtrainer, mlaunch)
            else:
                del mapp, mtrainer
    return launches, app, trainer, mode1


# #12/#13 against attention_bwd_plain: f32 in another summation order;
# bf16 also rounds P and dS to bf16 before the products in both, so a score
# near a rounding boundary may round the other way
BWD_TOLS = {"float32": 1e-5, "bfloat16": 2e-2}
# (shape, dtype, what it stands for)
BWD_SHAPES = [((2, 8, 4096, 40), "bfloat16", "a UNet pass (CFG, B = 1)"),
              ((4, 8, 4096, 40), "bfloat16", "config #5's batch"),
              ((1, 8, 4096, 64), "bfloat16", "D = 64"),
              ((1, 8, 4096, 128), "bfloat16", "D = 128"),
              ((1, 1, 4096, 32), "float32", "f32, a VAE mid-attention")]


def attention_bwd_case(shape, dtype: str, label: str, gen) -> dict:
    """#12 and #13 at one shape (q, k, v, dO as views of (B, N, H, D)
    projections, as the UNet passes them): the forward's LSE against
    plain, each kernel against `attention_bwd_plain` and, in bf16, against
    f32 autograd and the kept mma.sync design; two calls bit for bit;
    eager times and, in turns (kernels, mma.sync design, SDPA's backward
    (a yardstick, never used), then back), graph times beside the plain
    backward's; the bounds and their shares."""
    import torch
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    B, H, N, D = shape
    dt = getattr(torch, dtype)
    scale = D ** -0.5
    q, k, v, do = (torch.randn((B, N, H, D), generator=gen, device="cuda")
                   .to(dt).permute(0, 2, 1, 3) for _ in range(4))
    o, lse = at.attention_fwd_cuda(q, k, v, scale, with_lse=True)
    lse_ref = at.attention_lse_plain(q, k, scale)
    lse_err = (lse - lse_ref).abs().max().item()
    delta = torch.sum(o.float() * do.float(), dim=-1)
    bf16 = dtype == "bfloat16"
    args = (q, k, v, do, lse, delta, scale)
    fns = {"dkv": lambda: at.attention_bwd_dkv_cuda(*args),
           "dq": lambda: at.attention_bwd_dq_cuda(*args)}
    if bf16:
        fns.update(dkv_mma=lambda: at.attention_bwd_dkv_mma_cuda(*args),
                   dq_mma=lambda: at.attention_bwd_dq_mma_cuda(*args))

    dk1, dv1 = fns["dkv"]()
    dq1 = fns["dq"]()
    dk2, dv2 = fns["dkv"]()
    dq2 = fns["dq"]()
    same = all(torch.equal(a, b) for a, b in ((dk1, dk2), (dv1, dv2),
                                              (dq1, dq2)))
    want = dict(zip(("dq", "dk", "dv"),
                    at.attention_bwd_plain(q, k, v, o, lse, do, scale)))
    got = {"dq": dq1, "dk": dk1, "dv": dv1}
    rel = BWD_TOLS[dtype]
    errs, ok = {}, lse_err <= 1e-5 * lse_ref.abs().max().item() and same
    for name, g in got.items():
        w = want[name].float()
        errs[name] = (g.float() - w).abs().max().item()
        ok &= g.shape == q.shape and errs[name] <= rel * w.abs().max().item()
    vs_f32, vs_mma, mma_errs = {}, {}, {}
    if bf16:
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        ref = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
            at.attention_plain(qf, kf, vf, scale), (qf, kf, vf),
            do.float())))
        for name, g in got.items():
            e_k = (g.float() - ref[name]).abs().max().item()
            e_p = (want[name].float() - ref[name]).abs().max().item()
            vs_f32[name] = (e_k, e_p)
            ok &= e_k <= 2 * e_p + 1e-6 * ref[name].abs().max().item()
        del qf, kf, vf, ref
        dk_m, dv_m = fns["dkv_mma"]()
        for name, g, m in (("dq", dq1, fns["dq_mma"]()), ("dk", dk1, dk_m),
                           ("dv", dv1, dv_m)):
            vs_mma[name] = (g.float() - m.float()).abs().max().item()
            mma_errs[name] = (m.float() - want[name].float()).abs().max(
            ).item()
            ok &= vs_mma[name] <= rel * m.float().abs().max().item()
        del dk_m, dv_m
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(qs, ks, vs, scale=scale)

    def library():
        return torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)

    plain_ms = cuda_ms(lambda: at.attention_bwd_plain(q, k, v, o, lse, do,
                                                      scale), 2)
    ms = {"dkv": cuda_ms(fns["dkv"], 5), "dq": cuda_ms(fns["dq"], 5),
          "bwd": cuda_ms(lambda: at.attention_bwd_cuda(q, k, v, o, lse, do,
                                                       scale), 5)}
    # in turns: kernels, mma.sync design, SDPA's backward, then back
    order = [n for n in ("dkv", "dq", "dkv_mma", "dq_mma") if n in fns]
    turns = {n: [] for n in order + ["library"]}
    for rnd in range(2):
        for name in (order + ["library"])[::(-1) ** rnd]:
            turns[name].append(cuda_ms(library, 10) if name == "library"
                               else ex.graph_ms(fns[name], 5)[0])
    del qs, ks, vs, out
    graph = {n: sum(v) / len(v) for n, v in turns.items() if n != "library"}
    lib_ms = sum(turns["library"]) / 2
    torch.cuda.synchronize()
    mhz = max_sm_mhz()
    es = 2 if bf16 else 4
    kind = "bf16" if bf16 else "f32"
    BH = B * H
    reads = 4 * BH * N * D * es + 2 * BH * N * 4
    bounds = {"dkv": bound(reads + 2 * BH * N * D * es, 8 * BH * N * N * D,
                           kind, BH * N * N, mhz),
              "dq": bound(reads + BH * N * D * es, 6 * BH * N * N * D, kind,
                          BH * N * N, mhz)}
    print(f"attention_bwd {label} {shape} {dtype}: lse err {lse_err:.3e}; "
          f"max_abs_err vs plain " + ", ".join(
              f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol {rel} of the max); two calls bit for bit: {same}")
    if vs_f32:
        print(f"attention_bwd {label} vs f32 autograd: " + ", ".join(
            f"{n} kernel {a:.3e} / plain bf16 {b:.3e}"
            for n, (a, b) in vs_f32.items()) + "; vs the mma.sync design: "
            + ", ".join(f"{n} {e:.3e}" for n, e in vs_mma.items()))
    for name in ("dkv", "dq"):
        b_ms, b_by = bounds[name]
        old = (f"; mma.sync design " + " / ".join(
            f"{t:.4f}" for t in turns[name + "_mma"]) + " graph, share "
            f"{b_ms / graph[name + '_mma']:.4f}") if bf16 else ""
        print(f"attention_bwd_{name} {label} {shape}: {ms[name]:.4f} ms "
              f"eager, " + " / ".join(f"{t:.4f}" for t in turns[name])
              + f" graph (in turns); bound {b_ms:.4f} ms ({b_by}), share "
              f"graph {b_ms / graph[name]:.4f}" + old)
    both = graph["dkv"] + graph["dq"]
    old = (f", mma.sync design {graph['dkv_mma'] + graph['dq_mma']:.4f}"
           if bf16 else "")
    print(f"attention_bwd {label} {shape}: #12 + #13 {both:.4f} ms graph"
          f"{old}; SDPA backward " + " / ".join(
              f"{t:.4f}" for t in turns["library"]) + " ms eager (in turns),"
          f" ratio {both / lib_ms:.3f}; both kernels + delta "
          f"{ms['bwd']:.4f} ms eager; plain {plain_ms:.4f} ms")
    if not ok:
        fail(f"attention backward kernels disagree with their plain version "
             f"at {shape} {dtype} (or the LSE, or two calls differ, or the "
             f"mma.sync design)")
    return dict(shape=list(shape), dtype=dtype, max_abs_err=errs,
                mma_errs=mma_errs, lse_err=lse_err, ms=ms, graph_ms=graph,
                turns=turns,
                plain_ms=plain_ms,
                bound_ms={n: b[0] for n, b in bounds.items()},
                bound_by={n: b[1] for n, b in bounds.items()},
                library_ms=lib_ms)


def check_attention_bwd(seed: int) -> dict:
    """#12 and #13 at every shape of BWD_SHAPES, and the kept mma.sync
    design beside them. Returns their rows (the first shape's numbers, the
    others under "shapes"), without launches except the kept design's,
    which no path runs: theirs are this check's."""
    import torch
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    gen = torch.Generator(device="cuda").manual_seed(seed)
    _build.reset_launches()
    cases = [attention_bwd_case(*case, gen) for case in BWD_SHAPES]
    mma_launches = {n: _build.LAUNCHES.get(n, 0)
                    for n in (at.ATTN_DKV_MMA, at.ATTN_DQ_MMA)}
    # the bf16 instances at padded head dims 48 and 64 run on wgmma
    sass = attention_sass("attention_bwd")
    for name, ops in sorted(sass.items()):
        if "mma" in name:
            print(f"attention_bwd SASS {name}: {dict(ops)}")
    wg = [ops for name, ops in sass.items() if "wgmma" in name]
    if len(wg) != 4 or not all(ops.get("HGMMA") for ops in wg):
        fail("the bf16 attention backward's wgmma instances are missing "
             "or have no HGMMA in their SASS")
    main = cases[0]
    rows = {}
    for name, part, line in ((at.ATTN_DKV, "dkv", 941), (at.ATTN_DQ, "dq",
                                                         1287)):
        errs = [v for n, v in main["max_abs_err"].items()
                if (n == "dq") == (part == "dq")]
        rows[name] = dict(
            name=name, route="cuda",
            source="tpunerf_torch/csrc/attention_bwd.cu",
            replaces=("jax/experimental/pallas/ops/tpu/flash_attention.py:"
                      f"{line}"),
            max_abs_err=max(errs), ms=main["ms"][part],
            graph_ms=main["graph_ms"][part],
            plain_ms=main["plain_ms"], plain_note="the whole backward",
            bound_ms=main["bound_ms"][part], bound_by=main["bound_by"][part],
            library_ms=main["library_ms"],
            library_note="SDPA's backward: dq, dk and dv together",
            shapes=[dict(shape=c["shape"], dtype=c["dtype"],
                         ms=c["ms"][part], graph_ms=c["graph_ms"][part],
                         bound_ms=c["bound_ms"][part],
                         library_ms=c["library_ms"]) for c in cases[1:]])
        kept = part + "_mma"
        rows[name + "_mma"] = dict(
            rows[name], name=name + "_mma", main_path=False,
            launches=mma_launches[name + "_mma"],
            max_abs_err=max(v for n, v in main["mma_errs"].items()
                            if (n == "dq") == (part == "dq")),
            ms=main["graph_ms"][kept], graph_ms=main["graph_ms"][kept],
            note="the earlier mma.sync design, kept for timing (graph times)",
            shapes=[dict(shape=c["shape"], dtype=c["dtype"],
                         graph_ms=c["graph_ms"][kept],
                         bound_ms=c["bound_ms"][part])
                    for c in cases[1:] if kept in c["graph_ms"]])
    _free_card()
    return rows


def sd_gradient_phases(seed: int, guidance) -> dict:
    """The SD-v1 paths that differentiate through the UNet, at full width
    with `guidance` (bf16 UNet): text-token optimisation, null-text
    inversion, then txt2img and a DDS step. Returns {path: launches}."""
    launches = {"text-token optimisation": text_token_phase(seed, guidance),
                "null-text inversion": null_text_phase(seed, guidance)}
    sampling_phase(seed, guidance)
    return launches


TT_STEPS = 4   # of optimize_text_token's 100
# the gradient of a step through the kernels against the same step
# through attention_bwd_plain, as a share of its largest entry: the
# forward is the same kernel, and the backward's bf16 roundings of P, dS
# and the bf16 gradients may fall otherwise in 19 attention layers of a
# bf16 UNet chain. On an H100 sound steps read 1.35e-3 to 1.6e-3, and a
# layer's dS left unscaled 7.0e-3 in the middle of the 19 backward calls
# and 7.8e-2 in the last; in the first (the layer nearest the loss) it
# reads 1.7e-3, which no limit above the sound steps tells apart, so each
# layer is also held on its own inputs (TT_LAYER_TOL)
TT_GRAD_TOL = 5e-3
# planted faults go into one of a step's 19 backward calls: the first, the
# middle and the last to run
TT_FAULT_CALLS = (0, 9, 18)
# each backward call of a step, the kernels against attention_bwd_plain on
# the call's own inputs: the kernel checks' bf16 tolerance
TT_LAYER_TOL = BWD_TOLS["bfloat16"]


def _ds_unscaled(q, k, v, o, lse, do, scale):
    """A planted fault: the plain backward with dS left unscaled (dq and dk
    too large by 1 / scale)."""
    from tpunerf_torch.kernels import attention as at
    dq, dk, dv = at.attention_bwd_plain(q, k, v, o, lse, do, scale)
    return (dq.float() / scale).to(dq.dtype), (dk.float() / scale).to(
        dk.dtype), dv


def _p_unrounded(q, k, v, o, lse, do, scale):
    """A planted fault of precision alone: the plain backward in f32, P and
    dS not rounded to the inputs' dtype before their products."""
    from tpunerf_torch.kernels import attention as at
    grads = at.attention_bwd_plain(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), scale)
    return tuple(g.to(q.dtype) for g in grads)


def _planted(fault, at_call: int):
    """`attention_bwd_plain`, with `fault` in its `at_call`-th call."""
    from tpunerf_torch.kernels import attention as at
    calls = [0]

    def backward(*args):
        calls[0] += 1
        run = fault if calls[0] - 1 == at_call else at.attention_bwd_plain
        return run(*args)
    return backward


def text_token_phase(seed: int, guidance) -> dict:
    """`optimize_text_token` at its defaults (4 DDIM steps through the UNet,
    the f32 VAE decode and the ViT-L/14 image tower, Adam at 1e-3) cut to
    TT_STEPS steps: ms a step, peak, losses, launches; then one step's
    gradient through the kernels against the same step with the attention
    backward forced through `attention_bwd_plain`, and with a fault
    planted in one layer's plain backward; each of a step's 19 backward
    calls against `attention_bwd_plain` on its own inputs, beside the
    planted faults there; two profiled steps."""
    import torch
    from tpunerf_torch.guidance.clip_vision import clip_preprocess
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.training import text_token_opt as tto
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import make_clip_embedder
    from tpunerf_torch.utils import make_generator

    dev = torch.device("cuda")
    cfg = TrainConfig()
    cfg.optim.seed = seed
    # the app's ViT-L/14 image tower (random from the seed, as PbE's)
    clip = make_clip_embedder(cfg, dev)
    gen = make_generator(seed, dev)
    ref = torch.rand((1, 512, 512, 3), generator=gen, device=dev)
    h, prompt = guidance.latent_size, "a goldfish"
    latents = torch.randn((TT_STEPS, 1, h, h, 4), generator=gen, device=dev)
    _free_card()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    losses, times, stamp = [], [], [time.perf_counter()]

    def on_step(i, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - stamp[0])
        stamp[0] = now
        losses.append(loss.item())

    _build.reset_launches()
    tok, ctx = tto.optimize_text_token(guidance, clip, ref, prompt,
                                       num_steps=TT_STEPS, latents=latents,
                                       on_step=on_step)
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"text-token optimisation (4 DDIM steps, through_sampling, "
          f"{TT_STEPS} of 100 steps): losses "
          + " ".join(f"{v:+.5e}" for v in losses) + "; step ms "
          + " ".join(f"{1e3 * v:.1f}" for v in times)
          + f"; peak {peak:.3f} GiB ({resident:.3f} resident before)")
    print(f"text-token launches: {json.dumps(counts)}")
    # the first UNet pass's first self-attention reads nothing that
    # depends on the tokens: 4 x 5 - 1 backward launches a step
    want = {at.ATTN: 20 * TT_STEPS, at.ATTN_DKV: 19 * TT_STEPS,
            at.ATTN_DQ: 19 * TT_STEPS}
    if not (all(math.isfinite(v) for v in losses)
            and bool(torch.isfinite(tok).all())
            and bool(torch.isfinite(ctx).all())
            and ctx.shape == (2, 77, 768)
            and all(counts.get(n, 0) == c for n, c in want.items())):
        fail(f"text-token optimisation: a loss, the tokens or the context "
             f"is not finite, or its launches are not {want}")

    with torch.no_grad():
        uncond = guidance.get_text_embeds([""])[0:1]
        z = clip(clip_preprocess(ref, 224))
        ref_z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    tok0 = tto.initial_token_embeddings(guidance, prompt)

    def one_step():
        t = tok0.clone().requires_grad_(True)
        with torch.enable_grad():
            loss = tto.text_token_loss(guidance, clip, ref_z, uncond, t,
                                       latents[0])
            (g,) = torch.autograd.grad(loss, t)
        opt = torch.optim.Adam([t], lr=1e-3)
        t.grad = g
        opt.step()
        return loss.detach(), g, t.detach() - tok0

    kernel_backward = at._backward

    def through(backward):
        at._backward = backward
        try:
            return one_step()
        finally:
            at._backward = kernel_backward

    loss_k, g_k, step_k = one_step()
    loss_p, g_p, step_p = through(at.attention_bwd_plain)

    def share(g):
        return ((g - g_p).abs().max() / g_p.abs().max()).item()

    g_err = share(g_k)
    s_err = (step_k - step_p).abs().max().item()
    flips = int(((step_k * step_p) < 0).sum())
    print(f"text-token step, kernels vs attention_bwd_plain: loss "
          f"{loss_k.item():+.6e} / {loss_p.item():+.6e}; gradient max err "
          f"{g_err:.3e} of its max (tol {TT_GRAD_TOL}); token change max "
          f"{step_k.abs().max().item():.3e}, difference {s_err:.3e} "
          f"({flips} of {step_k.numel()} entries change sign)")
    if not (torch.equal(loss_k, loss_p) and g_err <= TT_GRAD_TOL):
        fail("the text-token step's gradient through the attention kernels "
             "disagrees with the same step through attention_bwd_plain")
    faults = {name: [share(through(_planted(fn, c))[1])
                     for c in TT_FAULT_CALLS]
              for name, fn in (("dS unscaled", _ds_unscaled),
                               ("P and dS unrounded", _p_unrounded))}
    print(f"text-token step with a fault planted in backward call "
          f"{' / '.join(map(str, TT_FAULT_CALLS))} of 19, gradient max err "
          f"of its max against the sound plain step: " + "; ".join(
              f"{name} " + " / ".join(f"{e:.3e}" for e in errs)
              for name, errs in faults.items()))
    # every layer on its own inputs: the kernels, and the two planted
    # faults, each against attention_bwd_plain
    layer = {"kernels": [], "dS unscaled": [], "P and dS unrounded": []}

    def held(*args):
        want = at.attention_bwd_plain(*args)
        got = kernel_backward(*args)
        for name, grads in (("kernels", got),
                            ("dS unscaled", _ds_unscaled(*args)),
                            ("P and dS unrounded", _p_unrounded(*args))):
            layer[name].append(max(
                ((g.float() - w.float()).abs().max()
                 / w.float().abs().max()).item()
                for g, w in zip(grads, want)))
        return got

    through(held)
    print(f"text-token step, each of its {len(layer['kernels'])} backward "
          f"calls against attention_bwd_plain on its own inputs, max err of "
          f"the max (tol {TT_LAYER_TOL}): " + "; ".join(
              f"{name} {min(v):.3e} .. {max(v):.3e}"
              for name, v in layer.items()))
    if not (min(faults["dS unscaled"][1:]) > TT_GRAD_TOL
            and len(layer["kernels"]) == 19
            and max(layer["kernels"]) <= TT_LAYER_TOL
            < min(layer["dS unscaled"])):
        fail(f"the text-token step's layers disagree with attention_bwd_plain "
             f"(tol {TT_LAYER_TOL}), or a planted unscaled dS is missed by "
             f"the step's check (tol {TT_GRAD_TOL}, middle and last call) or "
             f"the layers' check")
    profile_steps(None, "text-token", steps=2, step_fn=one_step)
    del clip, tok, ctx, latents
    _free_card()
    return counts


NULL_INNER = 5    # null_optimization's inner steps, cut from its default 10


def null_text_phase(seed: int, guidance) -> dict:
    """`invert` (50 DDIM steps), then `null_optimization` at its defaults
    but NULL_INNER inner steps (50 x 5 Adam steps on the uncond embedding,
    through the UNet, cut from 50 x 10 to keep the script's time), timed,
    with its peak and launches; the CFG sampling with the fitted
    embeddings retraces the trajectory from its end (finite); a profiled
    run of 2 x 5."""
    import torch
    from tpunerf_torch.guidance import sds as sds_lib
    from tpunerf_torch.guidance.schedulers import ddim_step, ddim_timesteps
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.utils import make_generator

    dev = torch.device("cuda")
    gen = make_generator(seed + 1, dev)
    h = guidance.latent_size
    emb = guidance.get_text_embeds(["a goldfish"])
    x0 = torch.randn((1, h, h, 4), generator=gen, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        traj = guidance.invert(x0, emb, 50)
    torch.cuda.synchronize()
    t_inv = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    uncond = guidance.null_optimization(traj, emb,
                                        num_inner_steps=NULL_INNER)
    torch.cuda.synchronize()
    t_null = time.perf_counter() - t0
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        lat, cond = traj[-1], emb[1:]
        for i, t in enumerate(ddim_timesteps(50, device=dev)):
            eps = sds_lib.cfg_eps(guidance.unet_apply, lat, t,
                                  torch.cat([uncond[i], cond]), 7.5)
            lat = ddim_step(guidance.sched, eps, t, lat, 50).prev_sample
        mse = torch.mean((lat - traj[0]) ** 2).item()
    inner = 50 * NULL_INNER
    print(f"null-text inversion (50 x {NULL_INNER}, the defaults but the "
          f"inner steps): invert {t_inv:.3f} s, null_optimization "
          f"{t_null:.3f} s ({1e3 * t_null / inner:.2f} ms an inner step), "
          f"peak {peak:.3f} GiB; retraced latents finite: "
          f"{bool(torch.isfinite(lat).all())}, MSE to the trajectory's first "
          f"{mse:.4e}")
    print(f"null-text launches: {json.dumps(counts)}")
    # 2 DDIM steps of 5 inner steps: 10 passes with a backward, 2 without
    profile_steps(None, "null-text (2 DDIM steps x 5)", steps=1,
                  step_fn=lambda: guidance.null_optimization(traj[:2], emb, 2,
                                                             5))
    # an inner step is one CFG pass: 5 forwards, 4 backwards (the first
    # self-attention reads nothing that depends on the embedding); each of
    # the 50 steps ends with one more pass
    want = {at.ATTN: 5 * (inner + 50), at.ATTN_DKV: 4 * inner,
            at.ATTN_DQ: 4 * inner}
    if not (bool(torch.isfinite(lat).all())
            and bool(torch.isfinite(uncond).all())
            and uncond.shape == (50, 1, 77, 768)
            and all(counts.get(n, 0) == c for n, c in want.items())):
        fail(f"null-text inversion: the embeddings or the retraced latents "
             f"are not finite, or its launches are not {want}")
    del traj, uncond, lat
    _free_card()
    return counts


def sampling_phase(seed: int, guidance) -> None:
    """`prompt_to_img` (50 DDIM steps) and one `train_step_delta_loss`
    step, each timed."""
    import torch
    from tpunerf_torch.utils import make_generator
    dev = torch.device("cuda")
    gen = make_generator(seed + 2, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = guidance.prompt_to_img("a goldfish", 50, generator=gen)
    t_img = time.perf_counter() - t0
    h = guidance.latent_size
    x = torch.randn((1, h, h, 4), generator=gen, device=dev,
                    requires_grad=True)
    ref = torch.randn((1, h, h, 4), generator=gen, device=dev)
    emb = guidance.get_text_embeds(["a goldfish"])
    emb_ref = guidance.get_text_embeds(["a tower"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = guidance.train_step_delta_loss(emb, x, ref, emb_ref,
                                          generator=gen)
    loss.backward()
    torch.cuda.synchronize()
    t_dds = time.perf_counter() - t0
    print(f"prompt_to_img (50 DDIM steps, CFG 7.5): {t_img:.3f} s, "
          f"{img.shape} {img.dtype}, mean {img.mean():.2f}; DDS step "
          f"(train_step_delta_loss + backward): {1e3 * t_dds:.1f} ms, "
          f"gradient finite {bool(torch.isfinite(x.grad).all())}")
    if not (img.shape == (1, 512, 512, 3) and bool(torch.isfinite(
            x.grad).all()) and x.grad.abs().max() > 0):
        fail("prompt_to_img's image or the DDS step's gradient is wrong")


def attention_at_depth_batch(gen) -> dict:
    """#4 at the depth UNet's 64² self-attention with CFG at B = 2: q, k, v
    (4, 8, 4096, 40) bf16 (views of (B, N, H, D) projections, as the UNet
    passes them) against the plain version, eager and in a CUDA graph
    beside SDPA, with its bound."""
    import torch
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.scripts import exp_hash_bwd as ex

    B, H, S, D = 4, 8, 4096, 40
    scale = D ** -0.5
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
    o = at.attention_cuda(q, k, v, scale)
    r = at.attention_plain(q, k, v, scale)
    err = (o.float() - r.float()).abs().max().item()
    tol = 2e-2 * r.float().abs().max().item()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: at.attention_cuda(q, k, v, scale), 20)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v, scale=scale), 20)
    graph_ms, out = ex.graph_ms(lambda: at.attention_cuda(q, k, v, scale), 20)
    lib_graph_ms, _ = ex.graph_ms(lambda: sdpa(q, k, v, scale=scale), 20)
    plain_ms = cuda_ms(lambda: at.attention_plain(q, k, v, scale), 5)
    mhz = max_sm_mhz()
    nbytes, flops, ex2 = 4 * B * H * S * D * 2, 4 * B * H * S * S * D, \
        B * H * S * S
    b_ms, b_by = bound(nbytes, flops, "bf16", ex2, mhz)
    print(f"attention_fwd bf16 {(B, H, S, D)} (config #5's UNet, CFG at "
          f"B = 2): max_abs_err {err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms "
          f"eager, {graph_ms:.4f} graph; SDPA {lib_ms:.4f} eager, "
          f"{lib_graph_ms:.4f} graph; plain {plain_ms:.4f}; bound "
          f"{b_ms:.4f} ms ({b_by}), share graph {b_ms / graph_ms:.3f}")
    if not (err <= tol and torch.equal(out, o)):
        fail("attention kernel at (4, 8, 4096, 40) disagrees with its plain "
             "version, or its graph replay with its eager call")
    return dict(shape=[B, H, S, D], max_abs_err=err, ms=ms,
                graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_graph_ms=lib_graph_ms)


def check_step_raster_kernels(render_fn, batch: int, label: str):
    """#5 and #7 on the very inputs one training render gives them
    (recorded as `render_fn` calls their wrappers, B = `batch` views in one
    launch), each held against its plain version on those inputs: the
    selection bit for bit, the soft forward to 5e-6 absolute. Fails unless
    every view of every call covers pixels and the soft forward has rim
    pixels. Returns (render_fn's result, {kernel: case})."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz

    FWD_TOL = 5e-6    # check_soft_kernels' tolerance
    calls = {rz.DENSE: [], rz.SOFT_FWD_DENSE: []}
    select, soft = rz.select_faces_dense_cuda, rz.soft_prod_dense_cuda

    def rec_select(rows, pix, width=0, *gate):
        calls[rz.DENSE].append((rows.clone(), pix.clone(), width))
        return select(rows, pix, width, *gate)

    def rec_soft(rows, pix, sigma, width=0, *gate):
        calls[rz.SOFT_FWD_DENSE].append((rows.clone(), pix.clone(), sigma,
                                         width))
        return soft(rows, pix, sigma, width, *gate)

    rz.select_faces_dense_cuda, rz.soft_prod_dense_cuda = rec_select, rec_soft
    try:
        with torch.no_grad():
            out = render_fn()
    finally:
        rz.select_faces_dense_cuda, rz.soft_prod_dense_cuda = select, soft
    mism, sel_shapes, covered = 0, [], []
    for rows, pix, width in calls[rz.DENSE]:
        got = select(rows, pix, width)
        ref = rz.select_faces_dense_plain(rows, pix)
        mism += int((got != ref).sum().item())
        sel_shapes.append(tuple(rows.shape))
        covered.append([int((ref[b] >= 0).sum().item())
                        for b in range(ref.shape[0])])
    err, soft_shapes, rim = 0.0, [], []
    for rows, pix, sigma, width in calls[rz.SOFT_FWD_DENSE]:
        got = soft(rows, pix, sigma, width)
        ref = rz.soft_prod_dense_plain(rows, pix, sigma)
        err = max(err, (got - ref).abs().max().item())
        soft_shapes.append(tuple(rows.shape))
        rim.append([int(((ref[b] > 0.01) & (ref[b] < 0.99)).sum().item())
                    for b in range(ref.shape[0])])
    torch.cuda.synchronize()
    P = calls[rz.DENSE][0][1].shape[0] if calls[rz.DENSE] else 0
    print(f"{label}: the step's #5 calls, rows {sel_shapes} over P = {P}: "
          f"mismatches vs plain {mism} (tol 0, exact), covered pixels per "
          f"view {covered}; its #7 calls, rows {soft_shapes}: max_abs_err "
          f"{err:.3e} (tol {FWD_TOL:.0e}), rim pixels per view {rim}")
    if not (sel_shapes and soft_shapes
            and all(sh[0] == batch for sh in sel_shapes + soft_shapes)
            and all(min(c) > 0 for c in covered)
            and all(min(r) > 0 for r in rim)):
        fail(f"{label}: the step did not give #5 and #7 {batch} covered "
             f"views in one launch")
    if mism or err > FWD_TOL:
        fail(f"{label}: #5 or #7 disagrees with its plain version at the "
             f"step's B = {batch} shapes")
    return out, {rz.DENSE: dict(rows=sel_shapes, P=P, mismatches=mism),
                 rz.SOFT_FWD_DENSE: dict(rows=soft_shapes, P=P,
                                         max_abs_err=err)}


def train_depth_full_width(steps: int, seed: int):
    """Eval config #5 at full width: `nascar_depth.yaml` (mode 0,
    `render.batch_size` 2, `body_prob` 1: the one wide camera) on the
    sphere through the port's Trainer with the depth-conditioned stack
    (5-channel UNet with a 1024-wide context in bf16, the 1024-wide 23-layer
    text tower and the VAE in f32, and the 9-channel inpainting UNet for
    img2img; random from the seed): `steps` eager steps, the eval orbit (5
    frames at 512²) before step 1 and after the checkpoint at `steps`, the
    final orbit and the mesh export; then 5 profiled steps, the depth UNet's
    CFG pass (batch 4), the eval chunk with its VAE decode, one masked img2img walk (10
    steps at strength 0.8 with an update and a check mask, the inpaint
    window entered) and one txt2img, each timed and checked. #5 and #7 are
    held against their plain versions on a training render's B = 2 inputs
    first. Returns the run's launch counts and those two cases."""
    import tempfile
    import numpy as np
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import circle_poses, rand_poses
    from tpunerf_torch.guidance.depth import (StableDiffusionDepthGuidance,
                                              normalize_depth)
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer
    from tpunerf_torch.utils import make_generator

    n_eval = 5
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_depth_") as tmp:
        cfg = parse(TrainConfig, [
            "--config_path", str(NASCAR_DEPTH), "--guide.shape_path",
            "sphere", "--optim.iters", str(steps), "--optim.seed", str(seed),
            "--log.exp_root", tmp, "--log.eval_size", str(n_eval),
            "--log.full_eval_size", str(n_eval), "--log.eval_batch",
            str(n_eval), "--log.log_images", "false", "--log.save_interval",
            str(steps)])
        t0 = time.perf_counter()
        dg = StableDiffusionDepthGuidance.create(
            min_step=cfg.optim.min_step, max_step=cfg.optim.max_step,
            use_inpaint=True, unet_dtype=cfg.guide.unet_dtype, device=dev,
            generator=make_generator(seed, dev))
        torch.cuda.synchronize()
        t_stack = time.perf_counter() - t0
        app = LatentPaintMeshApp.create(cfg, device=dev, depth_guidance=dg)
        trainer = Trainer(cfg, app, device=dev)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        scene = app.scene
        counts = {name: (sum(p.numel() for p in m.parameters()),
                         next(m.parameters()).dtype)
                  for name, m in (("depth UNet", dg.unet),
                                  ("inpainting UNet", dg.inpaint_unet),
                                  ("text tower", dg.text_encoder),
                                  ("VAE", dg.vae))}
        print(f"config #5 setup: {t_setup:.2f} s (depth stack {t_stack:.2f} "
              f"s: " + ", ".join(f"{k} {n} {dt}" for k, (n, dt)
                                 in counts.items())
              + f"); {dg.unet.config.in_channels}-channel UNet, context "
              f"{dg.unet.config.cross_attention_dim}, text hidden "
              f"{dg.text_encoder.config.hidden_size} x "
              f"{dg.text_encoder.config.num_layers} layers; B = "
              f"{cfg.render.batch_size}, mode {cfg.optim.mode}, body_prob "
              f"{cfg.render.body_prob}, train grid "
              f"{cfg.render.train_grid_size}, latent {scene.latent_size}, "
              f"texture {scene.texture_resolution}; "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
        if not (app.guidance is dg
                and cfg.render.batch_size == 2 and cfg.optim.mode == 0
                and dg.unet.config.in_channels == 5
                and dg.text_encoder.config.hidden_size == 1024
                and dg.unet.conv_in.weight.dtype == torch.bfloat16):
            fail("config #5 did not build the depth stack it names")
        # the normalised depth the SDS term reads, on two sampled poses
        views = rand_poses(2, trainer.view_cfg, dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        # the step's render: #5 (mesh and dome) and #7 (mesh) at B = 2
        render, b2 = check_step_raster_kernels(
            lambda: scene.render_train(views), 2, "config #5")
        nd = normalize_depth(render["depth"], render["mask"])
        inside = render["mask"] > 0
        lo = [float(nd[b][inside[b]].min()) for b in range(2)]
        hi = [float(nd[b][inside[b]].max()) for b in range(2)]
        print(f"config #5 normalised depth on 2 sampled poses: mask pixels "
              f"{[int(m.sum()) for m in inside]} of {inside[0].numel()}, "
              f"range in the mask {lo} .. {hi}")
        if not (all(abs(v + 1) < 1e-5 for v in lo)
                and all(abs(v - 1) < 1e-5 for v in hi)):
            fail("normalize_depth does not span [-1, 1] inside the mask")
        # which eval chunks overflow their soft bins (one camera)
        ev = circle_poses(n_eval, trainer.view_cfg, dev)
        size = cfg.render.eval_grid_size
        with torch.no_grad():
            fv_img = mrender._project(scene.mesh.vertices, scene.mesh.faces,
                                      ev.theta, ev.phi, ev.radius,
                                      scene.camera)[1]
            over = int(int(rz._soft_bins(fv_img, size, size,
                                         scene.soft_mask_sigma,
                                         rz._SOFT_BIN_K)[1]) > rz._SOFT_BIN_K)
        chunks = []
        eval_render = app.eval_render
        app.eval_render = lambda v, dims: (chunks.append(dims),
                                           eval_render(v, dims))[1]
        before = {k: v.detach().clone() for k, v in scene.named_parameters()}
        try:
            _, times, tail_s, launches = timed_train(trainer, steps)
        finally:
            app.eval_render = eval_render
        train_peak = torch.cuda.max_memory_allocated()
        steady = sorted(times[1:])
        print(f"config #5 steady step (eager, B = 2): median "
              f"{1e3 * _pct(steady, 0.5):.3f} ms, p90 "
              f"{1e3 * _pct(steady, 0.9):.3f}, max "
              f"{1e3 * steady[-1]:.3f} over {len(steady)} steps; first step "
              f"{1e3 * times[0]:.1f} ms (with the step-0 eval); checkpoint, "
              f"eval, final orbit and export {tail_s:.3f} s; peak memory "
              f"{train_peak / 2 ** 30:.3f} GiB ({resident / 2 ** 30:.3f} "
              f"GiB resident before the phase)")
        for k in ("texture_img", "displacement"):
            if torch.equal(before[k], getattr(scene, k).detach()):
                fail(f"config #5 training left {k} unchanged")
        n = lambda name: launches.get(name, 0)  # noqa: E731
        n_chunks = len(chunks)
        print(f"config #5 launches ({steps} steps, {n_chunks} eval chunks of "
              f"{n_eval} at {size}², {over} soft-bin overflow a chunk): "
              f"#4 {n(at.ATTN)}, #5 {n(rz.DENSE)}, #6 {n(rz.BINNED)}, #7 "
              f"{n(rz.SOFT_FWD_DENSE)}, #8 {n(rz.SOFT_FWD_BINNED)}; "
              + json.dumps(launches))
        # a step: one UNet pass (5 long self-attentions over the batch of
        # 4), the mesh and the dome selections, the mesh's soft forward;
        # an eval chunk: the mesh's selection and soft forward at 512², each
        # a gated pair
        if not (n(at.ATTN) == 5 * steps
                and n(rz.DENSE) == 2 * steps + n_chunks
                and n(rz.BINNED) == n_chunks
                and n(rz.SOFT_FWD_DENSE) == steps + n_chunks
                and n(rz.SOFT_FWD_BINNED) == n_chunks
                and n(rz.SOFT_BWD_DENSE) == n(rz.SOFT_BWD_BINNED) == 0
                and n_chunks == 3):
            fail("config #5 launched its kernels an unexpected number of "
                 "times")
        exp = Path(tmp) / cfg.log.exp_name
        ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
        mesh_files = sorted(p.name for p in (exp / "mesh").iterdir())
        evals = len(list((exp / "vis" / "eval").glob("*_rgb.png")))
        print(f"config #5 artifacts: checkpoints {ckpts}, eval frames "
              f"{evals}, results {sorted(p.name for p in (exp / 'results').iterdir())}"
              f", mesh {mesh_files}")
        if (f"step_{steps:06d}.ckpt" not in ckpts or evals != 2 * n_eval
                or mesh_files != ["albedo.png", "mesh.mtl", "mesh.obj"]):
            fail("config #5 did not write its checkpoint, evals or export")

        # the layers: the depth UNet's CFG pass, the eval chunk, its decode
        gen = torch.Generator(device=dev).manual_seed(seed)
        emb = app._select_text(views)
        lat = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
        t = torch.tensor(500, device=dev)
        unet_ms = cuda_ms(lambda: dg._cfg_eps_depth(lat, nd, t, emb, 100.0),
                          10)
        chunk_ms = cuda_ms(lambda: app.eval_render(ev, (size, size)), 3,
                           warmup=1)
        decode_ms = cuda_ms(lambda: dg.decode_latents(scene.texture_img), 3)
        profile_steps(trainer, "config #5 (depth, B = 2)")
        print(f"config #5 layers: depth UNet CFG pass (batch 4 = 2 views x "
              f"[uncond; cond], {tuple(emb.shape)} context) {unet_ms:.3f} ms; "
              f"eval chunk ({n_eval} views at {size}²) {chunk_ms:.3f} ms, of "
              f"which the VAE decode of the {scene.texture_resolution}² "
              f"texture {decode_ms:.3f} ms")

        # img2img: 10 steps at strength 0.8 (8 walked), the check mask for
        # the first 4, the inpaint window 2 < i < 5 on the 9-channel UNet
        upd = torch.zeros((2, 64, 64, 1), device=dev)
        upd[:, :, :32] = 1.0
        chk = torch.zeros_like(upd)
        chk[:, :, :16] = 1.0
        imgs = torch.rand((2, 512, 512, 3), generator=gen, device=dev)
        passes = {"depth": 0, "inpaint": 0}
        cfg_depth, cfg_inpaint = dg._cfg_eps_depth, dg._cfg_eps_inpaint

        def counted(kind, fn):
            def call(*args):
                passes[kind] += 1
                return fn(*args)
            return call

        dg._cfg_eps_depth = counted("depth", cfg_depth)
        dg._cfg_eps_inpaint = counted("inpaint", cfg_inpaint)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            masked = dg.encode_masked_inputs(imgs, upd, generator=gen)
            out = dg.img2img_step(
                emb, render["image"], nd, upd, chk, num_inference_steps=10, strength=0.8, inpaint_lo=2,
                inpaint_hi=5, masked_latents=masked, generator=gen)
            torch.cuda.synchronize()
            i2i_s = time.perf_counter() - t0
        finally:
            dg._cfg_eps_depth, dg._cfg_eps_inpaint = cfg_depth, cfg_inpaint
        print(f"config #5 img2img (10 steps at strength 0.8: "
              f"{passes['depth']} depth and {passes['inpaint']} inpainting "
              f"UNet passes, masked encode at 512²): {i2i_s:.3f} s; output "
              f"{tuple(out.shape)}, |max| {out.abs().max().item():.3f}")
        if not (passes == {"depth": 6, "inpaint": 2}
                and out.shape == (2, 64, 64, 4)
                and bool(torch.isfinite(out).all())):
            fail("config #5 img2img did not walk its window or is not finite")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = dg.prompt_to_img([cfg.guide.text], nd[:1],
                               num_inference_steps=10, generator=gen)
        torch.cuda.synchronize()
        t2i_s = time.perf_counter() - t0
        phase_peak = torch.cuda.max_memory_allocated()
        print(f"config #5 txt2img (10 steps, depth of a training render): "
              f"{t2i_s:.3f} s, image {tuple(img.shape)} in "
              f"[{img.min().item():.3f}, {img.max().item():.3f}]; the "
              f"phase's peak memory {phase_peak / 2 ** 30:.3f} GiB")
        if not (img.shape == (1, 512, 512, 3)
                and bool(torch.isfinite(img).all())):
            fail("config #5 txt2img gave no finite 512² image")
        del trainer, app, img, out
        _free_card()
        # the chunked trainer on the same stack
        chunked = chunked_mesh_case("config #5 (depth, B = 2)", parse(
            TrainConfig, [
                "--config_path", str(NASCAR_DEPTH), "--guide.shape_path",
                "sphere", "--optim.iters", str(MESH_CHUNK_STEPS),
                "--optim.seed", str(seed), "--log.exp_root", tmp,
                "--log.exp_name", "depth_chunked", "--log.eval_size", "0",
                "--log.full_eval_size", "0", "--log.save_mesh", "false",
                "--log.log_images", "false", "--log.save_interval",
                str(MESH_CHUNK_STEPS + 1), "--optim.train_chunk", "8"]),
            lambda c: LatentPaintMeshApp.create(c, device=dev,
                                                depth_guidance=dg))
    return launches, b2, chunked


def _pct(values, q: float) -> float:
    """The q-quantile of `values` by rank (the steady-step convention)."""
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def train_pbe_full_width(steps: int, seed: int):
    """The Paint-by-Example cell at full width, by the command
    `--guide.use_sd false --guide.image <exemplar.png> --optim.use_clip true
    --guide.shape_path sphere` with `body_prob` 0.7 (mode 0, B = 1, body and
    head cameras): a 512² exemplar written from the seed by `write_png` and
    read back by `read_png`; its stack (the 9-channel UNet in bf16, the VAE
    and two ViT-L/14 towers in f32: the exemplar encoder's and the
    `use_clip` embedder's; random from the seed) through the Trainer for
    `steps` eager steps, the eval orbit (5 frames at 512²) before step 1 and
    after the checkpoint at `steps`, the final orbit and the export. Prints
    the steady step by branch (SDS and CLIP), one profiled step of each
    branch, the layers (the UNet's CFG pass, `encode_exemplar`, the CLIP
    branch's decode and CLIP tower forward and backward), the eval chunk,
    peak memory and the launches of #4-#8. Returns the run's launches."""
    import tempfile
    import numpy as np
    import torch
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import circle_poses
    from tpunerf_torch.guidance import vae as vae_lib
    from tpunerf_torch.guidance.clip_vision import img_clip_loss
    from tpunerf_torch.guidance.paint_by_example import PaintByExampleGuidance
    from tpunerf_torch.guidance.schedulers import ddim_step
    from tpunerf_torch.guidance.stable_diffusion import LATENT_GRAY
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.scripts import pbe_step
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer
    from tpunerf_torch.utils import read_png

    n_eval = 5
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pbe_") as tmp:
        image = Path(tmp) / "exemplar.png"
        pixels = pbe_step.exemplar_png(image, seed)
        if not np.array_equal(read_png(image), pixels):
            fail("read_png does not read back the exemplar write_png wrote")
        cfg = parse(TrainConfig, [
            "--guide.use_sd", "false", "--guide.image", str(image),
            "--optim.use_clip", "true", "--guide.shape_path", "sphere",
            "--render.body_prob", "0.7", "--optim.iters", str(steps),
            "--optim.seed", str(seed), "--log.exp_root", tmp,
            "--log.exp_name", "pbe", "--log.eval_size", str(n_eval),
            "--log.full_eval_size", str(n_eval), "--log.eval_batch",
            str(n_eval), "--log.log_images", "false",
            "--log.save_interval", str(steps)])
        t0 = time.perf_counter()
        app = LatentPaintMeshApp.create(cfg, device=dev)
        trainer = Trainer(cfg, app, device=dev)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        g, scene = app.guidance, app.scene
        counts = {name: (sum(p.numel() for p in m.parameters()),
                         next(m.parameters()).dtype)
                  for name, m in (("9-channel UNet", g.unet),
                                  ("VAE", g.vae),
                                  ("exemplar encoder", g.image_encoder),
                                  ("use_clip tower", app.clip))}
        print(f"Paint-by-Example setup: {t_setup:.2f} s (" + ", ".join(
            f"{k} {n} {dt}" for k, (n, dt) in counts.items())
              + f"); exemplar {tuple(pixels.shape)} read back exactly, "
              f"embedding {tuple(app.image_embeds.shape)}, t window "
              f"[{g.min_step}, {g.max_step}], CLIP branch at t <= "
              f"{4 * g.sched.num_train_timesteps // 10}; mode "
              f"{cfg.optim.mode}, body_prob {cfg.render.body_prob}, train "
              f"grid {cfg.render.train_grid_size}, latent "
              f"{scene.latent_size}, texture {scene.texture_resolution}; "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB allocated")
        if not (isinstance(g, PaintByExampleGuidance)
                and g.unet.config.in_channels == 9
                and g.unet.conv_in.weight.dtype == torch.bfloat16
                and app.clip is not None
                and app.clip.config.hidden_size == 1024
                and app.image_embeds.shape == (2, 1, 768)):
            fail("the Paint-by-Example cell did not build the stack it "
                 "names")
        # which eval chunks overflow their soft bins (both cameras)
        ev = circle_poses(n_eval, trainer.view_cfg, dev)
        size = cfg.render.eval_grid_size
        n_over = 0
        with torch.no_grad():
            for spec in (scene.camera, scene.head_camera):
                fv_img = mrender._project(
                    scene.mesh.vertices, scene.mesh.faces, ev.theta, ev.phi,
                    ev.radius, spec)[1]
                n_over += int(rz._soft_bins(
                    fv_img, size, size, scene.soft_mask_sigma,
                    rz._SOFT_BIN_K)[1]) > rz._SOFT_BIN_K
        branches, chunks = [], []
        loss_fn, eval_render = app.loss_fn, app.eval_render

        def recorded(views, draws=None, generator=None, branch=None):
            loss, aux = loss_fn(views, draws, generator, branch)
            branches.append(bool(aux["clip_branch"]))
            return loss, aux

        app.loss_fn = recorded
        app.eval_render = lambda v, dims: (chunks.append(dims),
                                           eval_render(v, dims))[1]
        before = {k: v.detach().clone() for k, v in scene.named_parameters()}
        try:
            losses, times, tail_s, launches = timed_train(trainer, steps)
        finally:
            app.loss_fn, app.eval_render = loss_fn, eval_render
        train_peak = torch.cuda.max_memory_allocated()
        by = {b: [t for t, c in zip(times[1:], branches[1:]) if c == b]
              for b in (False, True)}
        n_clip = sum(branches)
        print(f"Paint-by-Example branches over {steps} steps: {n_clip} CLIP "
              f"(t <= 400), {steps - n_clip} SDS; losses of the CLIP steps "
              + " ".join(f"{v:+.4f}" for v, c in zip(losses, branches) if c))
        if not (by[True] and by[False]):
            fail("the Paint-by-Example run did not take both branches")
        for b, label in ((False, "SDS"), (True, "CLIP")):
            print(f"Paint-by-Example steady {label} step (eager): median "
                  f"{1e3 * _pct(by[b], 0.5):.3f} ms, p90 "
                  f"{1e3 * _pct(by[b], 0.9):.3f}, max "
                  f"{1e3 * max(by[b]):.3f} over {len(by[b])} steps")
        print(f"Paint-by-Example first step {1e3 * times[0]:.1f} ms (with the "
              f"step-0 eval); checkpoint, eval, final orbit and export "
              f"{tail_s:.3f} s; peak memory {train_peak / 2 ** 30:.3f} GiB "
              f"({resident / 2 ** 30:.3f} GiB resident before the phase)")
        for k in ("texture_img", "background_sphere_colors", "displacement"):
            if torch.equal(before[k], getattr(scene, k).detach()):
                fail(f"Paint-by-Example training left {k} unchanged")
        n = lambda name: launches.get(name, 0)  # noqa: E731
        n_chunks = len(chunks)
        print(f"Paint-by-Example launches ({steps} steps, {n_chunks} eval "
              f"chunks of {n_eval} at {size}², {n_over} camera(s) "
              f"overflowing the soft bins): #4 {n(at.ATTN)}, #5 "
              f"{n(rz.DENSE)}, #6 {n(rz.BINNED)}, #7 {n(rz.SOFT_FWD_DENSE)}, "
              f"#8 {n(rz.SOFT_FWD_BINNED)}; " + json.dumps(launches))
        # a step: one UNet pass (5 long self-attentions; the CLIP branch's
        # decode and tower are plain), both cameras' mesh selections and
        # soft forwards, the dome's selection; an eval chunk: both cameras
        # at 512², each a gated pair
        if not (n(at.ATTN) == 5 * steps and n_chunks == 3
                and n(rz.DENSE) == 3 * steps + 2 * n_chunks
                and n(rz.BINNED) == 2 * n_chunks
                and n(rz.SOFT_FWD_DENSE) == 2 * (steps + n_chunks)
                and n(rz.SOFT_FWD_BINNED) == 2 * n_chunks
                and n(rz.SOFT_BWD_DENSE) == n(rz.SOFT_BWD_BINNED) == 0):
            fail("the Paint-by-Example run launched its kernels an "
                 "unexpected number of times")
        exp = Path(tmp) / cfg.log.exp_name
        ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
        mesh_files = sorted(p.name for p in (exp / "mesh").iterdir())
        evals = len(list((exp / "vis" / "eval").glob("*_rgb.png")))
        print(f"Paint-by-Example artifacts: checkpoints {ckpts}, eval frames "
              f"{evals}, mesh {mesh_files}")
        if (f"step_{steps:06d}.ckpt" not in ckpts or evals != 2 * n_eval
                or mesh_files != ["albedo.png", "mesh.mtl", "mesh.obj"]):
            fail("the Paint-by-Example run did not write its checkpoint, "
                 "evals or export")

        # one profiled step of each branch (t forced through the draws)
        for label, t in (("SDS", 500), ("CLIP", 250)):
            forced = torch.tensor(t, device=dev)
            # the trainer's drawn t and its branch give way to the forced t
            app.loss_fn = lambda v, draws=None, generator=None, branch=None: \
                loss_fn(v, {"t": forced}, generator)
            try:
                trainer.train_step()        # warm
                profile_steps(trainer, f"Paint-by-Example {label} (t = {t})",
                              steps=2)
            finally:
                app.loss_fn = loss_fn

        # the layers
        gen = torch.Generator(device=dev).manual_seed(seed)
        lat = torch.randn((1, 64, 64, 4), generator=gen, device=dev)
        mask = (torch.rand((1, 64, 64, 1), generator=gen, device=dev)
                > 0.5).float()
        noise = torch.randn_like(lat)
        t = torch.tensor(250, device=dev)
        masked = lat * (1 - mask) + LATENT_GRAY.to(dev) * mask
        unet_ms = cuda_ms(lambda: g._unet_9ch(lat, masked, 1 - mask, t,
                                              app.image_embeds, 100.0), 10)
        enc_ms = cuda_ms(lambda: g.encode_exemplar(app.ref_image), 5)
        eps = g._unet_9ch(lat, masked, 1 - mask, t, app.image_embeds, 100.0)
        x = lat.clone().requires_grad_(True)

        def decode_fwd_bwd():
            prev = ddim_step(g.sched, eps, t, g.sched.add_noise(x, noise, t),
                             g.sched.num_train_timesteps).prev_sample
            vae_lib.decode_latents(g.vae, prev).sum().backward()

        img = torch.rand((1, 512, 512, 3), generator=gen,
                         device=dev).requires_grad_(True)

        def clip_fwd_bwd():
            img_clip_loss(app.clip, img, app.ref_image,
                          size=app.clip.config.image_size).backward()

        decode_ms = cuda_ms(decode_fwd_bwd, 3, warmup=1)
        clip_ms = cuda_ms(clip_fwd_bwd, 5)
        chunk_ms = cuda_ms(lambda: app.eval_render(ev, (size, size)), 3,
                           warmup=1)
        print(f"Paint-by-Example layers: 9-channel UNet CFG pass (batch 2, "
              f"(2, 1, 768) context) {unet_ms:.3f} ms; encode_exemplar "
              f"(ViT-L/14 at 224² + 5 mapper blocks) {enc_ms:.3f} ms; CLIP "
              f"branch: noising + DDIM step + f32 VAE decode to 512², "
              f"forward and backward {decode_ms:.3f} ms, CLIP (resize to "
              f"224², ViT-L/14 of both images) forward and backward "
              f"{clip_ms:.3f} ms; eval chunk ({n_eval} views at {size}², "
              f"both cameras) {chunk_ms:.3f} ms; the phase's peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        if not (bool(torch.isfinite(x.grad).all()) and x.grad.abs().max() > 0
                and bool(torch.isfinite(img.grad).all())):
            fail("the CLIP branch's layers gave no finite gradient")
        trainer.close()
        del trainer, x, img, eps
        _free_card()
        # the chunked trainer on the same stack: a draw graph, a step graph
        # a branch
        chunked = chunked_mesh_case("Paint-by-Example (use_clip)", parse(
            TrainConfig, [
                "--guide.use_sd", "false", "--guide.image", str(image),
                "--optim.use_clip", "true", "--guide.shape_path", "sphere",
                "--render.body_prob", "0.7", "--optim.iters",
                str(MESH_CHUNK_STEPS), "--optim.seed", str(seed),
                "--log.exp_root", tmp, "--log.exp_name", "pbe_chunked",
                "--log.eval_size", "0", "--log.full_eval_size", "0",
                "--log.save_mesh", "false", "--log.log_images", "false",
                "--log.save_interval", str(MESH_CHUNK_STEPS + 1),
                "--optim.train_chunk", "8"]),
            lambda c: LatentPaintMeshApp.create(c, pbe=g, device=dev))
    return launches, chunked


def silhouette_phase(app, trainer, guidance):
    """The path that launches the soft silhouette's backward kernels at
    full width: d sum(mask²) / d displacement through
    `render_train(...)["soft_mask"]` at 64² (dense, #9) and through
    `render_test(...)["mask"]` at 512² with autograd on (binned, #10), at
    the orbit's radius, where the body camera sees the sphere's rim.
    Returns the launch counts and copies of what reached #10 (rows, ids,
    pix, g, prod, sigma, width) and #9 (rows, pix, g, prod, sigma, width),
    each in its call with the most live pixels (g·prod != 0): the phase's
    own cotangent (the other camera's render is not in the mask, and its g
    is 0)."""
    import torch
    from tpunerf_torch.core.views import circle_poses
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import rasterize as rz

    scene = app.scene
    size = trainer.cfg.render.eval_grid_size
    views = circle_poses(5, trainer.view_cfg, trainer.device)
    grad_binned, grad_dense = rz.soft_grad_binned, rz.soft_grad_dense
    captured, captured_dense = [], []

    def spy_on(fn, store, gi, pi):
        # a call whose kernel's gate is shut (the other of its pair ran)
        # is not recorded, and the gate is not kept with the inputs
        def spy(*args):
            n = pi + 3                    # up to sigma and width
            gate = args[n] if len(args) > n else None
            live = int((args[gi] * args[pi] != 0).sum().item())
            if (gate is None or not int(gate)) and (not store
                                                     or live > store[0]):
                store[:] = [live] + [a.clone() if torch.is_tensor(a) else a
                                     for a in args[:n]]
            return fn(*args)
        return spy

    _build.reset_launches()
    out = {}
    rz.soft_grad_binned = spy_on(grad_binned, captured, 3, 4)
    rz.soft_grad_dense = spy_on(grad_dense, captured_dense, 2, 3)
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
    rz.soft_grad_binned, rz.soft_grad_dense = grad_binned, grad_dense
    scene.zero_grad()
    launches = dict(_build.LAUNCHES)
    print("silhouette phase launches: " + json.dumps(launches))
    if (launches.get(rz.SOFT_BWD_DENSE, 0) <= 0 or not captured
            or not captured_dense):
        fail("the silhouette phase never launched the dense or the binned "
             "backward")
    return launches, captured[1:], captured_dense[1:]


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


def profile_steps(trainer, label: str, steps: int = 5, step_fn=None
                  ) -> float:
    """The profiler's device time by kernel over `steps` train steps (or
    calls of `step_fn`, such as a graph's replay) and the device's idle
    share of their wall time. Returns the device's busy ms a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            (step_fn or trainer.train_step)()
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
    # the attention backward kernels (#12, #13) where the steps ran them
    bwd = [e for e in events if "attention_bwd_" in e.key]
    if bwd:
        bwd_ms = sum(dev_us(e) for e in bwd) / 1e3 / steps
        print(f"  attention backward (#12 + #13) of {label}: {bwd_ms:.4f} "
              f"ms/step, share of the busy time {bwd_ms / busy_ms:.4f}, "
              f"launches/step {sum(e.count for e in bwd) / steps:.1f}")
    # keys read "(anonymous namespace)::select_..._kernel(float const*, ..."
    sel = {e.key.split("::")[-1].split("(")[0]: e for e in events
           if "::select_" in e.key}
    print(f"  selection kernels (#5, #6) of {label}: "
          f"{sum(dev_us(e) for e in sel.values()) / 1e3 / steps:.4f} ms/step,"
          f" launches/step {sum(e.count for e in sel.values()) / steps:.1f}: "
          + ", ".join(f"{name} {dev_us(e) / 1e3 / steps:.4f}"
                      for name, e in sel.items()))
    return busy_ms


# ---------------------------------------------------------------------------
# slice 12: the graphed step, the chunked trainer, the refine stage, traces
# ---------------------------------------------------------------------------

# launch counter name: (the kernel's symbol in a trace, its number)
TRACE_KERNELS = {"hashgrid_fwd": ("hashgrid_fwd_kernel", "#1"),
                 "hashgrid_bwd": ("hashgrid_bwd_kernel", "#2"),
                 "occgrid_lookup": ("occgrid_lookup_kernel", "#3"),
                 "attention_fwd": ("attention_fwd_bf16_kernel", "#4")}


def _free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def check_graphed_steps(seed: int, guidance) -> None:
    """(a) One full-width step captured and replayed against the same step
    run eagerly twice from the same state and generator state
    (`graphed_against_eager`): stage 1 at sand_castle.yaml's defaults and
    the refine stage (an RGB field) and config #3 (the sketch shape's
    loss), each on step 1, which carries the occupancy refresh (its draws
    follow the replay's), and latent-paint (`judge_graphed`).
    The generator must be equal bit for bit. Where the two eager runs
    agree on everything, so must the replay. Where they differ (the loss
    too, in latent-paint-mesh's mode 1, whose forward varies),
    the step is judged once more, captured and run under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, which names
    the operations that have no deterministic form: where it names none
    (the refine step), all three runs must be equal bit for bit; else
    (latent-paint) `graph_agreement` judges it: bit for bit on a group where
    the eager runs agree, elsewhere each tensor within 4x its own eager
    runs' difference or `graph_check.TOL` of its own largest value. The
    first run's differences are printed, not judged: under cuDNN's default
    algorithms two eager runs do not bound a tensor's spread."""
    import dataclasses
    import tempfile
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer

    rgb_guidance = dataclasses.replace(guidance, latent_mode=False)
    quiet = ["--log.eval_size", "0", "--log.full_eval_size", "0",
             "--log.save_mesh", "false", "--log.log_images", "false",
             "--optim.train_chunk", "8", "--optim.seed", str(seed)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        cases = {
            "stage 1 (latent-NeRF) step 1 with its refresh": (
                LatentNeRFApp, guidance, parse(
                    TrainConfig, quiet + ["--log.exp_root", tmp],
                    config_path=SAND_CASTLE)),
            "refine (RGB latent-NeRF) step 1 with its refresh": (
                LatentNeRFApp, rgb_guidance, parse(
                    TrainConfig, quiet + ["--log.exp_root", tmp,
                                          "--render.nerf_type", "rgb"],
                    config_path=SAND_CASTLE)),
            "latent-paint step 1": (
                LatentPaintApp, guidance, parse(TrainConfig, quiet + [
                    "--log.exp_root", tmp, "--guide.text", "a goldfish",
                    "--guide.shape_path", "sphere"])),
            "config #3 (sketch shape) step 1 with its refresh": (
                LatentNeRFApp, guidance, parse(
                    TrainConfig, quiet + ["--log.exp_root", tmp,
                                          "--guide.shape_path", "sphere"],
                    config_path=LEGO_MAN)),
        }

        for label, (app_cls, g, cfg) in cases.items():
            judge_graphed(label, lambda: Trainer(
                cfg, app_cls.create(cfg, guidance=g, device="cuda"),
                device="cuda"))


def judge_graphed(label: str, make_trainer, prepare=None,
                  branch=None) -> dict:
    """`check_graphed_steps`' judgement of one step: a fresh trainer from
    `make_trainer()` (positioned by `prepare(trainer)` where given, as the
    next step's branch is chosen), captured, its replay against two eager
    runs (`graphed_against_eager`); where the eager runs differ, again
    under `torch.use_deterministic_algorithms(True, warn_only=True)` with a
    fresh trainer (where that capture fails, as with an operation whose
    deterministic form reads the host, it is said, and the first run's
    spread judges). `branch`, where given, is the branch the judged step
    must have replayed. Fails where the step does not agree; returns the
    verdict that decided (its groups, "deterministic" and the operations
    named)."""
    import warnings
    import torch
    from tpunerf_torch.scripts.graph_check import (TOL, graph_agreement,
                                                   graphed_against_eager)

    def compare(label):
        trainer = make_trainer()
        if prepare is not None:
            prepare(trainer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = trainer.capture()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        d = graphed_against_eager(trainer)
        verdict = graph_agreement(d)
        if branch is not None and graph.branch != branch:
            fail(f"the judged step of {label} replayed the {graph.branch} "
                 f"branch")
        launches = {str(b): n for b, n in graph.launches_by_branch.items()}
        print(f"graphed step (a), {label}: warm-up and capture "
              f"{capture_s:.2f} s, launches a replay "
              + (json.dumps(graph.launches) if list(launches) == ["None"]
                 else f"by branch (False: SDS, True: CLIP) "
                      f"{json.dumps(launches)}, this step's branch "
                      f"{graph.branch}"))
        for group, v in verdict.items():
            print(f"  {group}: {v['equal']}/{v['tensors']} tensors equal "
                  f"bit for bit to the eager step; largest |replay - "
                  f"eager| {v['replay']:.3e}; two eager runs differ by "
                  f"{v['eager']:.3e}; largest |value| {v['scale']:.3e}; "
                  f"largest share of a tensor's allowance (4x its eager "
                  f"difference or {TOL:g} of its largest |value|) "
                  f"{v['worst']:.3g}; against the eager update on the "
                  f"replay's gradients {v['update']:.3e}; agreed {v['ok']}")
        del trainer, graph
        _free_card()
        return d, verdict

    d, verdict = compare(label)
    if d["replay"]["generator"] != 0.0:
        fail(f"the graphed step draws other numbers than the eager one "
             f"({label})")
    if all(v == 0.0 for v in d["eager"].values()):
        if not all(v["ok"] for v in verdict.values()):
            fail(f"the graphed step differs from the eager one ({label})")
        return {"groups": verdict, "deterministic": False, "named": []}
    # not deterministic (the loss too, where a forward's algorithms vary):
    # two eager runs do not bound a tensor's spread from run to run, so the
    # judge is the step under deterministic algorithms, which also names
    # the cause
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            d2, verdict2 = compare(f"{label}, deterministic algorithms")
        except RuntimeError as exc:
            d2 = None
            refused = str(exc).splitlines()[0][:200]
        finally:
            torch.use_deterministic_algorithms(False)
    if d2 is None:
        _free_card()
        print(f"  the eager runs differ; under deterministic algorithms the "
              f"step cannot be captured ({refused}): judged by the eager "
              f"runs' own spread")
        if not all(v["ok"] for v in verdict.values()):
            fail(f"the graphed step differs from the eager one beyond the "
                 f"eager runs' spread ({label})")
        return {"groups": verdict, "deterministic": None, "named": []}
    named = sorted({str(w.message).split(" does not have")[0][:80]
                    for w in caught if "deterministic" in str(w.message)})
    print(f"  the eager runs differ; operations without a deterministic form "
          f"in this step: {named}; under deterministic algorithms the eager "
          f"runs differ by {max(d2['eager'].values()):.3e}, the replay by "
          f"{max(d2['replay'].values()):.3e}")
    if not (d2["replay"]["generator"] == 0.0
            and all(v["ok"] for v in verdict2.values())):
        fail(f"the graphed step differs from the eager one ({label}, "
             f"deterministic algorithms)")
    if not named and max(max(d2["replay"].values()),
                         max(d2["eager"].values())) != 0.0:
        fail(f"under deterministic algorithms the graphed step is not the "
             f"eager one bit for bit ({label})")
    return {"groups": verdict2, "deterministic": True, "named": named}


def timed_chunks(trainer):
    """`trainer.train()` with each chunk timed between synchronisations.
    Returns ([(first step, steps, seconds)], losses, launch counts of the
    run)."""
    import torch
    from tpunerf_torch.kernels import _build
    chunks, losses = [], []
    real = trainer.run_chunk

    def run_chunk(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(k)
        torch.cuda.synchronize()
        chunks.append((trainer.train_step_idx - k + 1, k,
                       time.perf_counter() - t))
        return out

    trainer.run_chunk = run_chunk
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    try:
        trainer.train(on_step=lambda step, loss: losses.append(loss))
    finally:
        del trainer.run_chunk
    losses = [float(v) for v in losses]
    print("chunks (first step, steps, ms a step): " + ", ".join(
        f"({s}, {k}, {1e3 * t / k:.2f})" for s, k, t in chunks))
    print("losses: " + " ".join(f"{v:+.4e}" for v in losses))
    if (len(losses) != trainer.cfg.optim.iters
            or not all(math.isfinite(v) for v in losses)):
        fail("chunked training produced a non-finite loss or missed steps")
    return chunks, losses, dict(_build.LAUNCHES)


def steady_graph_vs_eager(trainer, label: str, n: int = 10, rounds: int = 2,
                          before_step=None):
    """The step body eager and replayed, `n` each in turns (eager, graph,
    graph, eager, …), each step between synchronisations: the median and
    spread of each (the state trains on; no refresh runs). `before_step()`,
    where given, runs untimed before each step (as moving the generator on
    to a branch)."""
    import torch
    graph = trainer.capture()
    opt = trainer.optimizer
    times = {"eager": [], "graph": []}

    def eager():
        opt.zero_grad(set_to_none=True)
        trainer.step_body()

    order = ["eager", "graph", "graph", "eager"] * rounds
    for kind in order:
        fn = eager if kind == "eager" else graph.replay
        for _ in range(n // 2):
            if before_step is not None:
                before_step()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t)
    out = {}
    for kind, ts in times.items():
        ts = sorted(ts)
        out[kind] = dict(median_ms=1e3 * ts[len(ts) // 2],
                         min_ms=1e3 * ts[0], max_ms=1e3 * ts[-1],
                         p90_ms=1e3 * ts[int(0.9 * (len(ts) - 1))],
                         n=len(ts))
    e, g = out["eager"], out["graph"]
    print(f"{label} steady step, in turns: graphed median "
          f"{g['median_ms']:.3f} ms (min {g['min_ms']:.3f}, p90 "
          f"{g['p90_ms']:.3f}, max {g['max_ms']:.3f}; {g['n']} steps), eager "
          f"median {e['median_ms']:.3f} ms (min {e['min_ms']:.3f}, p90 "
          f"{e['p90_ms']:.3f}, max {e['max_ms']:.3f}; {e['n']} steps); "
          f"eager / graphed {e['median_ms'] / g['median_ms']:.2f}")
    return out


def launched(fn, into):
    """`fn`, adding the kernel launches of each call to the Counter `into`
    (also where it raises, as an export of an empty surface does)."""
    from tpunerf_torch.kernels import _build

    def run(*args, **kwargs):
        before = dict(_build.LAUNCHES)
        try:
            return fn(*args, **kwargs)
        finally:
            into.update({n: c - before.get(n, 0)
                         for n, c in _build.LAUNCHES.items()})
    return run


def train_chunked_full_width(steps: int, seed: int, guidance,
                             config: Path = SAND_CASTLE, extra=(),
                             label: str = "stage 1"):
    """(b) and (e): stage 1 (or config #3: `config`, `extra`) cut as the
    eager run, with `--optim.train_chunk 8` and `--log.trace_steps 5,9`:
    chunks of 8 and 4 (clipped at the checkpoints of steps 12 and 24), the
    refreshes of steps 1 and 16 eager between replays, the 10-frame evals
    and the images as in the eager run, the final orbit cut to 10 frames
    (`log.full_eval_size 10`); the trace holds #1-#4's kernels; with a
    guide shape, the last replay's shape loss. Then the steady step graphed
    beside eager, the profiler's idle share of graphed steps and the
    launches a replay. Returns the run's launches, the trainer, its step-24
    checkpoint and the steady times."""
    import shutil
    from collections import Counter
    import torch
    from tpunerf_torch import profiling
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer

    cfg = parse(TrainConfig, _nerf_argv(
        steps, seed, *extra, "--optim.train_chunk", "8",
        "--log.trace_steps", "5,9", "--log.full_eval_size", "10",
        "--log.exp_name", f"{config.stem}_chunked"), config_path=config)
    exp = Path(cfg.log.exp_dir)
    shutil.rmtree(exp, ignore_errors=True)
    app = LatentNeRFApp.create(cfg, guidance=guidance, device="cuda")
    trainer = Trainer(cfg, app, device="cuda")
    # the eager launches of each refresh and eval, and the launch counts
    # where the trace window opens and closes
    refreshed, evals_launched, window = {}, Counter(), []

    def refresh(**kw):
        refreshed[trainer.train_step_idx] = Counter()
        return launched(real_refresh, refreshed[trainer.train_step_idx])(
            **kw)

    def at_window(fn):
        def run(*args, **kwargs):
            window.append((trainer.train_step_idx, dict(_build.LAUNCHES)))
            return fn(*args, **kwargs)
        return run

    real_refresh = app.scene.update_occupancy
    app.scene.update_occupancy = refresh
    trainer.evaluate = launched(trainer.evaluate, evals_launched)
    exported = Counter()       # the 64³ density grid of the mesh export
    app.export = launched(app.export, exported)
    real_trace = (profiling.start_trace, profiling.stop_trace)
    profiling.start_trace = at_window(profiling.start_trace)
    profiling.stop_trace = at_window(profiling.stop_trace)
    try:
        chunks, _, launches = timed_chunks(trainer)
    finally:
        profiling.start_trace, profiling.stop_trace = real_trace
        del app.scene.update_occupancy, trainer.evaluate, app.export
    lengths = [k for _, k, _ in chunks]
    ckpts = [p.name for p in trainer.ckpts.existing()]
    evals = sorted(p.name for p in (exp / "vis" / "eval").iterdir())
    images = sorted(p.name for p in (exp / "vis" / "train").iterdir())
    per_replay = trainer.graph.launches
    if app.scene.sdf is not None:
        last_shape = float(trainer.graph.aux["shape_loss"])
        print(f"{label} chunked: the last replay's shape loss "
              f"{last_shape:.5f}")
        if not (math.isfinite(last_shape) and last_shape > 0):
            fail(f"{label}: the replayed shape loss is not finite")
    print(f"{label} chunked (train_chunk 8): chunk lengths {lengths}; "
          f"refreshes after steps {list(refreshed)}; checkpoints {ckpts}; "
          f"eval frames {len(evals)}; train images {images}; launches a "
          f"replay {json.dumps(per_replay)}; launches in the run "
          f"{json.dumps(launches)}; of them eager in the evals "
          f"{json.dumps(evals_launched)}, the refreshes "
          f"{json.dumps(refreshed)} and the mesh export "
          f"{json.dumps(exported)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    if not (lengths == [8, 4, 8, 4] and list(refreshed) == [1, 16]
            and ckpts == ["step_000012.ckpt", "step_000024.ckpt"]
            and len(evals) == 3 * cfg.log.eval_size):
        fail(f"the chunked {label} run broke the eager cadence")
    # every launch accounted for: the replays and the capture's warm-up
    # step (one eager step, so what one replay records), and the evals,
    # refreshes and the mesh export run eagerly between
    for name in launches:
        eager = (evals_launched[name] + exported[name]
                 + sum(c[name] for c in refreshed.values()))
        want = (steps + 1) * per_replay.get(name, 0) + eager
        if launches[name] != want:
            fail(f"{name}: {launches[name]} launches in the chunked "
                 f"{label} run, "
                 f"not {steps} replays and the warm-up step x "
                 f"{per_replay.get(name, 0)} and {eager} eager")
    # (e) the trace of steps 5-8 (the chunks holding them: 1-8, 9-12): each
    # of #1-#4 as many times in it as the window's replays times a replay's
    # launches and the refreshes inside the window launched
    trace = exp / "trace" / "trace.json"
    if not trace.exists() or len(window) != 2:
        fail(f"log.trace_steps wrote no trace ({label})")
    (first, opened), (last, closed) = window
    inside = Counter()
    for step, c in refreshed.items():
        if first < step <= last:
            inside.update(c)
    events = json.loads(trace.read_text())["traceEvents"]
    counts = {tag: sum(1 for e in events if e.get("cat") == "kernel"
                       and symbol in str(e.get("name")))
              for name, (symbol, tag) in TRACE_KERNELS.items()}
    want = {tag: (last - first) * per_replay.get(name, 0) + inside[name]
            for name, (symbol, tag) in TRACE_KERNELS.items()}
    counted = {tag: closed.get(name, 0) - opened.get(name, 0)
               for name, (symbol, tag) in TRACE_KERNELS.items()}
    print(f"{label} trace_steps 5,9: {trace.stat().st_size} bytes, "
          f"{len(events)} events, steps {first + 1}-{last}; kernels of "
          f"#1-#4 executed in it: {json.dumps(counts)}; replays x a "
          f"replay's launches + the refreshes in the window: "
          f"{json.dumps(want)}; counted launches in the window: "
          f"{json.dumps(counted)}")
    if not (all(counts.values()) and counts == want == counted):
        fail(f"the trace's kernels of #1-#4 are not the window's replays "
             f"and refreshes ({label})")
    steady = steady_graph_vs_eager(trainer, label)
    busy = profile_steps(trainer, f"{label} graphed", steps=5,
                         step_fn=trainer.graph.replay)
    # the profiler slows the replays down; against the unprofiled median
    med = steady["graph"]["median_ms"]
    print(f"{label} graphed: device busy {busy:.3f} ms (profiled) of the "
          f"unprofiled median {med:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / med):.3f}")
    return launches, trainer, exp / "checkpoints" / "step_000024.ckpt", \
        steady


def rgb_eval_kernels(cap, rows) -> None:
    """#1 and #3 on the inputs of one RGB eval chunk (one pose at 512²: K
    = 64 and S = 128 samples a ray): eager and graphed against their
    bounds by bytes, #1 against its plain version over slices of 2^21
    points (the plain version's time is the sum over the slices), #3
    exactly (`occgrid_case`)."""
    import torch
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import occgrid as og
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    if "eval_x" not in cap or "eval_occ" not in cap:
        fail("no RGB eval chunk reached kernels #1 and #3")
    x, table, cfg = cap["eval_x"], cap["eval_table"], cap["eval_cfg"]
    L, F = cfg.n_levels, cfg.n_features_per_level
    n = x.shape[0]
    new = lambda: hg.hash_encode_cuda(x, table, cfg)  # noqa: E731
    out = new()
    err, plain_ms, ref_max = 0.0, 0.0, 0.0
    step = 1 << 21
    for lo in range(0, n, step):
        xs = x[lo:lo + step]
        plain_ms += cuda_ms(lambda: hg.hash_encode_plain(xs, table, cfg), 1,
                            warmup=0)
        ref = hg.hash_encode_plain(xs, table, cfg)
        err = max(err, (out[lo:lo + step] - ref).abs().max().item())
        ref_max = max(ref_max, ref.abs().max().item())
    del out
    b_ms, b_by = bound(4 * (x.numel() + table.numel() + n * L * F),
                       n * L * 8 * (2 + 2 * F), "f32")
    ms = cuda_ms(new, 10)
    graph, _ = ex.graph_ms(new, 10)
    print(f"{hg.FWD} on the RGB eval chunk's x (N={n}): max_abs_err "
          f"{err:.3e} (tol {1e-5 * ref_max:.3e}); eager {ms:.4f} ms, graph "
          f"{graph:.4f} ms; plain {plain_ms:.3f} ms (slices of 2^21); bound "
          f"{b_ms:.4f} ms ({b_by}), share {b_ms / graph:.3f} (graph)")
    if err > 1e-5 * ref_max:
        fail("#1 disagrees with its plain version on the RGB eval chunk")
    rows[hg.FWD]["rgb_eval_inputs"] = dict(
        n=n, max_abs_err=err, ms=ms, graph_ms=graph, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / graph)
    torch.cuda.empty_cache()
    rows[og.LOOKUP]["rgb_eval_inputs"] = occgrid_case(
        *cap["eval_occ"], "the RGB eval chunk's samples", iters=10)


def refine_full_width(seed: int, guidance, ckpt: Path, rows):
    """(c) The refine stage from stage 1's step-24 checkpoint: first its
    load, as the CLI makes it (migrated heads of 3 channels, the hash table
    and sigma_mlp the checkpoint's), the refine step's split (render fwd+bwd;
    resize + f32 VAE encode fwd+bwd; UNet CFG pass), the step graphed
    beside eager, one RGB eval chunk (one pose at 512²: its time and peak
    memory) and #1, #3 on its inputs; then the CLI itself, `--render.nerf_type
    rgb --optim.ckpt <ckpt> --optim.train_chunk 8`, 16 steps with the
    10-frame RGB eval before step 1 and after the step-16 checkpoint and a
    10-frame final orbit (`log.full_eval_size 10`, cut from 100). Returns
    the CLI run's launches."""
    import dataclasses
    import shutil
    import torch
    from tpunerf_torch import train_latent_nerf
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import circle_poses, rand_poses
    from tpunerf_torch.guidance import sds as sds_lib
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import texture as texk
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import (
        LatentNeRFApp, select_text_embeddings)
    from tpunerf_torch.training.trainer import Trainer

    steps = 16
    argv = _nerf_argv(steps, seed, "--render.nerf_type", "rgb",
                      "--optim.ckpt", str(ckpt), "--optim.train_chunk", "8",
                      "--log.save_interval", str(steps),
                      "--log.full_eval_size", "10",
                      "--log.exp_name", "sand_castle_refine")
    cfg = parse(TrainConfig, argv, config_path=SAND_CASTLE)
    rgb_guidance = dataclasses.replace(guidance, latent_mode=False)
    app = LatentNeRFApp.create(cfg, guidance=rgb_guidance, device="cuda")
    trainer = Trainer(cfg, app, device="cuda")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    got = app.state_dict()
    heads = {k: tuple(got[k].shape) for k in got
             if k.startswith(("field.color_mlp.layers.",
                              "field.bg_mlp.layers."))
             and got[k].shape[0] == 3}
    kept = [k for k in saved if k not in heads]
    same = all(torch.equal(got[k].cpu(), saved[k]) for k in kept)
    geometry = [k for k in saved if k.startswith(("field.hash_table",
                                                  "field.sigma_mlp"))]
    print(f"refine load of {ckpt.name}: migrated heads {json.dumps(heads)} "
          f"(checkpoint's {[tuple(saved[k].shape) for k in heads]}); the "
          f"other {len(kept)} tensors, hash table and sigma_mlp among them "
          f"({geometry}), equal to the checkpoint's: {same}")
    if not (len(heads) == 2 and same and geometry
            and all(saved[k].shape[0] == 4 for k in heads)):
        fail("the refine stage's checkpoint migration is wrong")

    # the refine step's split
    dev, gen, scene = trainer.device, trainer.generator, app.scene
    views = rand_poses(1, trainer.view_cfg, dev, generator=gen)
    text_z = select_text_embeddings(app.text_z, views.dirs)
    img = torch.rand((1, 64, 64, 3), device=dev, generator=gen)
    t = torch.tensor(500, device=dev)

    def render_fwd_bwd():
        out = scene.render_train(views, generator=gen)
        (out["image"].square().mean() + out["sparsity_loss"]).backward()

    def encode_fwd_bwd():
        x = img.clone().requires_grad_(True)
        rgb = texk.resize_bilinear(x, 512, 512)
        rgb_guidance.encode_imgs(rgb, generator=gen).square().mean(
        ).backward()

    lat = torch.randn((1, 64, 64, 4), device=dev, generator=gen)

    def unet_cfg_pass():
        sds_lib.score_gradient(rgb_guidance.unet_apply, rgb_guidance.sched,
                               lat, text_z, 100.0, t=t, generator=gen)

    for name, fn in {
            "render fwd+bwd at 64² (RGB field)": render_fwd_bwd,
            "resize 64->512 + f32 VAE encode fwd+bwd": encode_fwd_bwd,
            "UNet CFG pass (batch 2, 64x64, no grad)": unet_cfg_pass}.items():
        print(f"refine layer {name}: {cuda_ms(fn, 5, warmup=1):.4f} ms")
    steady = steady_graph_vs_eager(trainer, "refine (RGB latent-NeRF)", n=6,
                                   rounds=1)
    per_replay = dict(trainer.graph.launches)
    print(f"refine launches a replay: {json.dumps(per_replay)}")
    trainer.graph = None
    _free_card()

    # one RGB eval chunk: its time, its peak memory, #1 and #3 on its inputs
    dims = (cfg.render.eval_grid_size,) * 2
    orbit = circle_poses(cfg.log.eval_size, trainer.view_cfg, dev)
    chunk = app.max_eval_batch(dims)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with capture_hash_inputs(0) as cap:
        out = app.eval_render(orbit[torch.arange(chunk, device=dev)], dims)
    frame, mask = out["image"], out["mask"]
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    chunk_ms = cuda_ms(lambda: app.eval_render(
        orbit[torch.arange(chunk, device=dev)], dims), 3, warmup=0)
    print(f"RGB eval chunk ({chunk} pose a chunk at {dims[0]}², "
          f"{dims[0] * dims[1] * scene.march.num_samples} samples, "
          f"{dims[0] * dims[1] * scene.march.num_compacted} field points): "
          f"{chunk_ms:.3f} ms, peak memory above the resident "
          f"{peak:.3f} GiB; frame {tuple(frame.shape)} in "
          f"[{frame.min().item():.3f}, {frame.max().item():.3f}], opacity "
          f"(weights_sum) mean {mask.mean().item():.3e}, max "
          f"{mask.max().item():.3e}")
    if not (torch.isfinite(frame).all() and torch.isfinite(mask).all()):
        fail("the RGB eval chunk is not finite")
    del frame, mask, out
    rgb_eval_kernels(cap, rows)
    del cap, app, trainer
    _free_card()

    # the CLI
    exp = Path(cfg.log.exp_dir)
    shutil.rmtree(exp, ignore_errors=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    train_latent_nerf.main(["--config_path", str(SAND_CASTLE), *argv,
                            "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    evals = sorted(p.name for p in (exp / "vis" / "eval").iterdir())
    results = sorted(p.name for p in (exp / "results").iterdir())
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    log = (exp / "log.txt").read_text()
    print(f"refine CLI (guidance built anew, {steps} steps in chunks of 8, "
          f"3 orbits of 10 frames at 512²): {wall:.2f} s; checkpoints "
          f"{ckpts}; eval frames {len(evals)} (steps "
          f"{sorted({int(e[5:11]) for e in evals})}); results {len(results)} "
          f"files; launches {json.dumps(launches)}")
    if not (ckpts == [f"step_{steps:06d}.ckpt"] and len(evals) == 20
            and results and "Restored checkpoint (step 24, model_only=True)"
            in log):
        fail("the refine CLI did not load, train or write its frames")
    # #2 and #4 run in training steps only: 16 replays and the warm-up step
    for name in (hg.BWD, at.ATTN):
        if launches.get(name, 0) != (steps + 1) * per_replay.get(name, 0):
            fail(f"the refine CLI launched {name} {launches.get(name, 0)} "
                 f"times, not {steps + 1} x {per_replay.get(name, 0)}")
    return launches, steady


def sdf_grid_phase() -> None:
    """Config #3's guide shape alone: the C++ library's build, then the
    sphere's 48³ SDF grid (`SDFGrid.from_mesh`, the 2× prefilter
    included) on the card, its time, range and inside share."""
    import torch
    from tpunerf_torch import native
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.fields.sketch_shape import SDFGrid
    from tpunerf_torch.meshrep import shapes
    from tpunerf_torch.training.config import TrainConfig

    cfg = parse(TrainConfig, list(SKETCH), config_path=LEGO_MAN)
    guide = cfg.guide
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    mesh = shapes.load_shape(guide.shape_path).normalize(guide.shape_scale,
                                                         guide.dy)
    t0 = time.perf_counter()
    sdf = SDFGrid.from_mesh(mesh.vertices.numpy(), mesh.faces.numpy(),
                            resolution=48, bound=cfg.render.bound,
                            device=torch.device("cuda"))
    torch.cuda.synchronize()
    sdf_ms = 1e3 * (time.perf_counter() - t0)
    vals = sdf.values
    print(f"config #3 SDF grid (C++, {lib.name}, g++ build {build_s:.2f} "
          f"s): 48³ over {mesh.num_faces} faces "
          f"({48 ** 3 * mesh.num_faces:.3e} point-triangle pairs) in "
          f"{sdf_ms:.1f} ms, prefilter to 96³ included; values "
          f"[{vals.min().item():.4f}, {vals.max().item():.4f}], inside "
          f"share {(vals < 0).float().mean().item():.4f}")
    if not ((vals < 0).any() and (vals > 0).any()):
        fail("the config #3 SDF grid has no inside or no outside")


def bridge_selection(app, trainer, dims) -> dict:
    """#5 on what the extracted mesh gives it, recorded as the paint path
    calls the wrapper: one training render's rows and pixels (64²) and the
    eval chunk's (5 views at `dims`, the dense sweep where the bins
    overflow). Every call of the training render (the mesh's, the dome's)
    bit for bit against the plain version, the mesh's as a `_sel_case`; the
    eval chunk's launch bit
    for bit against the all-pairs design on all its views and, as a
    `_sel_case`, its first view against the plain version (the plain
    sweep of all five is five times as long: one view bounds the phase's
    time). Returns
    {"d": the training render's case, "e": the eval chunk's} for #5's row."""
    import torch
    from tpunerf_torch.core.views import circle_poses, rand_poses
    from tpunerf_torch.kernels import rasterize as rz

    real, calls = rz.select_faces_dense_cuda, []

    def record(rows, pix, width=0, *gate):
        calls.append((rows.clone(), pix.clone(), width))
        return real(rows, pix, width, *gate)

    dev, cfg = trainer.device, trainer.cfg
    rz.select_faces_dense_cuda = record
    try:
        with torch.no_grad():
            app.scene.render_train(rand_poses(
                cfg.render.batch_size, trainer.view_cfg, dev,
                generator=trainer.generator))
            n_train = len(calls)
            app.eval_render(circle_poses(5, trainer.view_cfg, dev), dims)
    finally:
        rz.select_faces_dense_cuda = real
    train, evals = calls[:n_train], calls[n_train:]
    mism = sum(int((real(r, p, w) != rz.select_faces_dense_plain(r, p))
                   .sum().item()) for r, p, w in train)
    print(f"#5 on the bridge's extracted mesh: the training render's calls, "
          f"rows {[tuple(r.shape) for r, _, _ in train]} over P = "
          f"{[p.shape[0] for _, p, _ in train]}: mismatches vs plain {mism} "
          f"(tol 0, exact); the eval chunk's calls, rows "
          f"{[tuple(r.shape) for r, _, _ in evals]}")
    if not train or mism:
        fail("#5 disagrees with its plain version on the bridge's training "
             "render, or was not called")
    cases = {}
    r, p, w = max(train, key=lambda c: c[0].shape[1])   # the mesh's
    cases["d"] = _sel_case(
        rz, f"#5 (d) the bridge's training render at 64², extracted mesh "
        f"F={r.shape[1]}", lambda: real(r, p, w),
        lambda: rz.select_faces_dense_sweep_cuda(r, p),
        lambda: rz.select_faces_dense_plain(r, p), r, p, w, 20)
    if not evals:
        print("  the bridge's eval chunk took the band bins (#6): no dense "
              "call to hold")
        return cases
    r5, p, w = max(evals, key=lambda c: c[0].shape[1])
    out5 = real(r5, p, w)
    same = torch.equal(out5, rz.select_faces_dense_sweep_cuda(r5, p))
    r1 = r5[:1].contiguous()
    cases["e"] = _sel_case(
        rz, f"#5 (e) the bridge's eval chunk at {dims[0]}², its first view, "
        f"extracted mesh F={r1.shape[1]}", lambda: real(r1, p, w),
        lambda: rz.select_faces_dense_sweep_cuda(r1, p),
        lambda: rz.select_faces_dense_plain(r1, p), r1, p, w, 3)
    first = torch.equal(out5[:1], real(r1, p, w))
    ms5 = cuda_ms(lambda: real(r5, p, w), 3)
    cases["e"].update(views=r5.shape[0], all_views_ms=ms5,
                      all_views_equal_all_pairs=same)
    print(f"  #5 (e) the eval chunk's launch, {r5.shape[0]} views: equal to "
          f"the all-pairs design bit for bit {same}; its first view equal to "
          f"the one-view launch {first}; eager {ms5:.4f} ms")
    if not (same and first):
        fail("#5 disagrees with the all-pairs design on the bridge's eval "
             "chunk")
    return cases


def bridge_phase(seed: int, guidance, ckpt: Path, rows, paint_rows) -> dict:
    """The NeRF→mesh bridge (`tpunerf_torch.train_latent_nerf_mesh`) on
    config #3's step-24 checkpoint: `extract_mesh_from_checkpoint` at
    `render.mc_resolution` 128 and `render.iso_level` 10 twice (the density
    grid on the card in 32 chunks of 65,536 points through #1, marching
    tetrahedra on the host; the two meshes equal bit for bit), with the
    density grid's and the marching's ms; then the paint stage as the CLI
    builds it (`paint_config`: the `_mesh` experiment) with the SD-v1 stack
    passed in: the UV build's ms, 4 latent-paint steps and the eval chunk of
    5 frames at 512² before step 1 (#4, #5, #6 or its dense fallback), the
    export; #5 on the extracted mesh's rows (`bridge_selection`, into #5's
    row). Then #1 against its plain version on the density grid's first
    chunk (x (65536, 3)). Returns the path's launches."""
    import shutil
    import numpy as np
    import torch
    from tpunerf_torch import train_latent_nerf_mesh as bridge
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import circle_poses
    from tpunerf_torch.fields import scene as scene_mod
    from tpunerf_torch.fields.latent_nerf import LatentNeRFConfig
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import rasterize as rz
    from tpunerf_torch.meshrep import uv_unwrap
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer

    paint_steps = 4
    cfg = parse(TrainConfig, _nerf_argv(
        paint_steps, seed, *SKETCH, "--optim.ckpt", str(ckpt),
        "--log.exp_name", "lego_man_bridge", "--log.save_interval", "1000",
        "--log.eval_size", "5", "--log.eval_batch", "5",
        "--log.full_eval_size", "0", "--log.log_images", "false"),
        config_path=LEGO_MAN)
    G, iso = cfg.render.mc_resolution, cfg.render.iso_level
    timed, grids = {}, []

    def timing(owner, name, label, keep=None):
        real = getattr(owner, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            timed.setdefault(label, []).append(
                1e3 * (time.perf_counter() - t))
            if keep is not None:
                keep.append(out)
            return out
        setattr(owner, name, run)
        return real

    reals = [(scene_mod.LatentNeRFScene, "density_grid", timing(
        scene_mod.LatentNeRFScene, "density_grid", "density grid", grids)),
        (scene_mod, "marching_tetrahedra", timing(
            scene_mod, "marching_tetrahedra", "marching")),
        (uv_unwrap, "get_or_build_uvs", timing(
            uv_unwrap, "get_or_build_uvs", "UV build"))]
    _build.reset_launches()
    try:
        meshes = []
        for _ in range(2):
            try:
                meshes.append(bridge.extract_mesh_from_checkpoint(cfg))
            finally:
                if grids:
                    grid = grids[-1]
                    print(f"bridge density grid {G}³ of {ckpt.name}: sigma "
                          f"max {grid.max():.4f}, at the centre "
                          f"{grid[G // 2, G // 2, G // 2]:.4f}, mean "
                          f"{grid.mean():.4e}, share above iso {iso} "
                          f"{(grid > iso).mean():.3e}")
        extract_launches = dict(_build.LAUNCHES)
        (m1, m2) = meshes
        same = (torch.equal(m1.vertices, m2.vertices)
                and torch.equal(m1.faces, m2.faces))
        print(f"bridge extract_mesh_from_checkpoint ({G}³, iso {iso}): V "
              f"{m1.num_vertices}, F {m1.num_faces}; density grid ms "
              f"{', '.join(f'{t:.2f}' for t in timed['density grid'])} "
              f"({G ** 3 // scene_mod.DENSITY_CHUNK} chunks of "
              f"{scene_mod.DENSITY_CHUNK}); marching ms "
              f"{', '.join(f'{t:.2f}' for t in timed['marching'])}; the two "
              f"meshes equal bit for bit: {same}; launches "
              f"{json.dumps(extract_launches)}")
        if not (same and m1.num_faces > 0):
            fail("the bridge's mesh is empty or differs between two "
                 "extractions")
        if extract_launches.get(hg.FWD, 0) != 2 * G ** 3 // \
                scene_mod.DENSITY_CHUNK:
            fail("the density grid did not run #1 once a chunk")
        paint_cfg = bridge.paint_config(cfg)
        shutil.rmtree(paint_cfg.log.exp_dir, ignore_errors=True)
        t0 = time.perf_counter()
        app = LatentPaintApp.create(paint_cfg, guidance=guidance,
                                    mesh=m1, device="cuda")
        trainer = Trainer(paint_cfg, app, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        for owner, name, real in reals:
            setattr(owner, name, real)
    print(f"bridge paint stage setup: {setup_s:.2f} s, of it the UV build "
          f"(chart atlas over {m1.num_faces} faces, host) "
          f"{timed['UV build'][0]:.1f} ms; texture "
          f"{tuple(app.scene.texture_img.shape)}")
    tex0 = app.scene.texture_img.detach().clone()
    # the eval chunk's selection bins: overflowing or not, read after the
    # run (the gates choose on the device)
    bins, bin_faces = [], rz._bin_faces
    rz._bin_faces = lambda *a, **k: bins.append((a[4], bin_faces(*a, **k))) \
        or bins[-1][1]
    try:
        _, times, tail_s, paint_launches = timed_train(trainer, paint_steps)
    finally:
        rz._bin_faces = bin_faces
    over = [int(out[1]) > K for K, out in bins]
    route = ("no band bins: the dense sweep (#5)" if not over
             else "the dense sweep (#5; the gated #6 shut: the bins "
                  "overflowed)" if all(over) else "band bins (#6)")
    exp = Path(paint_cfg.log.exp_dir)
    print(f"bridge paint: step ms {', '.join(f'{1e3 * t:.2f}' for t in times)}"
          f" (step 1 carries the eval chunk of 5 frames at "
          f"{paint_cfg.render.eval_grid_size}², by {route}); export "
          f"{tail_s:.3f} s; {obj_summary(exp / 'mesh')}; launches "
          f"{json.dumps(paint_launches)}")
    if torch.equal(tex0, app.scene.texture_img.detach()):
        fail("the bridge's paint stage left the texture unchanged")
    if not (paint_launches.get(at.ATTN, 0) == 5 * paint_steps
            and paint_launches.get(rz.DENSE, 0) >= 2 * paint_steps
            and mesh_written(exp / "mesh")):
        fail("the bridge's paint stage missed its kernels or its export")
    views = circle_poses(5, trainer.view_cfg, trainer.device)
    dims = (paint_cfg.render.eval_grid_size,) * 2
    chunk_ms = cuda_ms(lambda: app.eval_render(views, dims), 3, warmup=1)
    print(f"bridge eval chunk (5 views at {dims[0]}² on the extracted mesh):"
          f" {chunk_ms:.3f} ms")
    paint_rows[rz.DENSE]["inputs"].update(
        bridge_selection(app, trainer, dims))
    launches = dict(extract_launches)
    for name, n in paint_launches.items():
        launches[name] = launches.get(name, 0) + n
    del app, trainer
    _free_card()

    # #1 on the density grid's first chunk, against its plain version
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["params"]
    table = state["field.hash_table"].to("cuda")
    bound = cfg.render.bound
    ax = (np.arange(G) + 0.5) / G * 2 - 1
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = torch.from_numpy((np.stack([gx.ravel(), gy.ravel(), gz.ravel()],
                                     -1)[:scene_mod.DENSITY_CHUNK] * bound
                            ).astype(np.float32)).to("cuda")
    x01 = torch.clamp((pts + bound) / (2 * bound), 0.0, 1.0)
    row, _ = hash_grid_rows(x01, table, None, LatentNeRFConfig().grid,
                            f"the {G}³ density grid's first chunk")
    rows[hg.FWD]["density_grid"] = {
        k: row[k] for k in ("max_abs_err", "ms", "graph_ms", "plain_ms",
                            "bound_ms", "bound_by", "share_of_bound")}
    return launches


# ---------------------------------------------------------------------------
# slice 19: the gated bin-overflow kernels, the chunked latent-paint-mesh
# ---------------------------------------------------------------------------

GATE_CALLS = 20        # launches of one kernel in the graph timing its gate
MESH_CHUNK_STEPS = 16  # a chunked paint-mesh run: two chunks of 8


def check_gates(seed: int, rows_by_name: dict) -> None:
    """Kernels #5-#10 behind their gates (the bin-overflow choice made on
    the device) at the eval chunk's shapes, the sphere under 5 views of the
    orbit at 512² (`scripts.gate_check`): with the gate open each equals
    its plain version (#5, #6 bit for bit; #7, #8 within 5e-6, #9, #10
    within 2e-5 of the largest value) and the ungated call bit for bit;
    with the gate shut it leaves the output it was given unchanged. Then
    GATE_CALLS launches of each in one CUDA graph, shut and open in turns
    (shut, open, open, shut): the ms that a launch returning at its gate
    costs in a step's graph, beside the open launch's. Records
    `gate_shut_graph_ms` and `gate_open_graph_ms` (the lesser of the two
    turns) in the kernels' rows."""
    import torch
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    from tpunerf_torch.scripts import gate_check as gc
    dev = torch.device("cuda")
    cases = gc.gated_cases(dev, n_views=5, seed=seed)
    flags = gc.gate_flags(dev)
    for name, case in cases.items():
        v = gc.check_gate(case, flags)
        fn, out = case[0], torch.empty_like(case[1])
        times = {True: [], False: []}
        for shut in (True, False, False, True):
            times[shut].append(ex.graph_ms(lambda: fn(flags[shut], out),
                                           GATE_CALLS)[0])
        row = rows_by_name[name]
        row["gate_shut_graph_ms"] = min(times[True])
        row["gate_open_graph_ms"] = min(times[False])
        print(f"gate {gc.NUMBERS[name]} {name} (5 views at 512²): shut "
              f"wrote {v['shut_changed']} elements; open vs ungated "
              f"{v['open_vs_ungated']} differing; open vs plain "
              f"{v['err']:.3e} (largest |value| {v['scale']:.3e}, tol "
              f"{gc.TOLS[name]:g}); a launch in a graph of {GATE_CALLS}: "
              f"shut {' / '.join(f'{t:.4f}' for t in times[True])} ms, "
              f"open {' / '.join(f'{t:.4f}' for t in times[False])} ms")
        if not v["ok"]:
            fail(f"the gated {name} disagrees with its plain version or "
                 f"wrote behind a shut gate")


def advance_to_overflow(trainer, overflow: bool, tries: int = 64):
    """Move the trainer's generator on, one step's leading draws at a time,
    until the next step's render has face-selection bins that overflow
    (`overflow`) or hold; its state is otherwise left as it was. Returns
    the draws skipped, None where none of `tries` did."""
    import torch
    from tpunerf_torch.kernels import rasterize as rz
    real = rz._bin_faces
    for skipped in range(tries):
        state = trainer.generator.get_state()
        views = trainer.draw()[0]
        trainer.generator.set_state(state)
        seen = []

        def spy(*args, **kwargs):
            ids, maxc = real(*args, **kwargs)
            if not kwargs.get("margin"):        # the selection's bins
                seen.append(int(maxc) > args[4])
            return ids, maxc
        rz._bin_faces = spy
        try:
            with torch.no_grad():
                trainer.app.scene.render_train(views, with_lighting=True)
        finally:
            rz._bin_faces = real
        if seen and any(seen) == overflow:
            return skipped
        trainer.draw()
    return None


def chunked_mesh_case(label: str, cfg, make_app, prepare=None) -> dict:
    """A latent-paint-mesh configuration (`cfg`, with `--optim.train_chunk
    8`; `make_app(cfg)` builds its app on its stack) through the chunked
    trainer at full width: (i) its graphed step judged against eager
    (`judge_graphed`; Paint-by-Example with `use_clip` once on each branch,
    the generator moved on until the step takes it; else positioned by
    `prepare`); (ii) `MESH_CHUNK_STEPS` steps in chunks of 8 replays, each
    replay's branch recorded, every launch of the run accounted for by the
    replays' recorded launches; (iii) the step in turns (eager, graph,
    graph, eager: median, min, p90, max; per branch); (iv) profiled replays
    (device busy a step, idle share under the profiler and against the
    unprofiled graphed median); the phase's peak memory. Returns the
    chunked run's launches."""
    import torch
    from tpunerf_torch.kernels import _build
    from tpunerf_torch.scripts.graph_check import advance_to_branch
    from tpunerf_torch.training.trainer import Trainer

    def make_trainer():
        return Trainer(cfg, make_app(cfg), device=DEVICE)

    torch.cuda.reset_peak_memory_stats()
    branching = cfg.optim.use_clip and not cfg.guide.use_sd
    branches = (False, True) if branching else (None,)
    names = {None: "", False: ", SDS branch", True: ", CLIP branch"}
    for b in branches:
        judge_graphed(f"{label}{names[b]}", make_trainer,
                      prepare if b is None
                      else (lambda tr, b=b: advance_to_branch(tr, b)),
                      branch=b)
    trainer = make_trainer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = trainer.capture()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replays = []
    real = graph.replay
    graph.replay = lambda: (replays.append(real()), replays[-1])[1]
    try:
        chunks, _, launches = timed_chunks(trainer)
    finally:
        del graph.replay
    want = {}
    for b in replays:
        for name, n in graph.launches_by_branch[b].items():
            want[name] = want.get(name, 0) + n
    per_step = sorted(t / k for _, k, t in chunks)
    by_branch = {str(b): replays.count(b) for b in branches}
    print(f"{label} chunked (train_chunk 8, {MESH_CHUNK_STEPS} steps): "
          f"warm-up and capture {capture_s:.2f} s; chunk ms a step "
          f"{', '.join(f'{1e3 * t:.3f}' for t in per_step)}; replays by "
          f"branch {json.dumps(by_branch)}; launches a replay "
          f"{json.dumps({str(b): n for b, n in graph.launches_by_branch.items()})}"
          f"; the run's launches {json.dumps(launches)}")
    if {n: c for n, c in launches.items() if c} != want:
        fail(f"the chunked {label} run launched {launches}, its replays "
             f"account for {want}")
    if len(replays) != MESH_CHUNK_STEPS:
        fail(f"the chunked {label} run replayed {len(replays)} steps")
    heavy = cfg.optim.mode != 0 or branching
    for b in branches:
        before = None if b is None else (
            lambda b=b: advance_to_branch(trainer, b))
        turns = steady_graph_vs_eager(
            trainer, f"{label}{names[b]}", n=4 if heavy else 10,
            rounds=1 if heavy else 2, before_step=before)
        step_fn = graph.replay if before is None else (
            lambda before=before: (before(), graph.replay()))
        busy = profile_steps(trainer, f"{label}{names[b]} graphed",
                             steps=2 if heavy else 5, step_fn=step_fn)
        med = turns["graph"]["median_ms"]
        print(f"{label}{names[b]}: device busy {busy:.3f} ms a replay "
              f"against the graphed median {med:.3f} ms: idle share "
              f"{max(0.0, 1 - busy / med):.3f}")
    print(f"{label}: the phase's peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    del trainer, graph
    _free_card()
    return launches


def chunked_mesh_phase(seed: int, guidance) -> dict:
    """Latent-paint-mesh with `--optim.train_chunk 8` at full width on the
    SD-v1 stack (the sphere, `body_prob` 0.7; `chunked_mesh_case`): mode 0;
    mode 1 at 512², where the band bins hold, its judged step on a view
    whose selection bins hold, and at 256², on a view whose selection bins
    overflow K = 256 (the dense branch behind the gates), where one is
    found; mode 2. Returns {label: the chunked run's launches}."""
    import tempfile
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp

    def on_view(overflow, grid):
        def prepare(trainer):
            skipped = advance_to_overflow(trainer, overflow)
            print(f"paint-mesh mode 1 at {grid}²: the judged step's "
                  f"selection bins " + ("overflow" if overflow else "hold")
                  + (f" (after {skipped} skipped draws)" if skipped
                     is not None else ": no such view in 64 draws"))
        return prepare

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_chunk_") as tmp:
        for label, mode, grid, prepare in (
                ("paint-mesh mode 0", 0, None, None),
                ("paint-mesh mode 1 at 512²", 1, 512, on_view(False, 512)),
                ("paint-mesh mode 1 at 256²", 1, 256, on_view(True, 256)),
                ("paint-mesh mode 2", 2, None, None)):
            extra = ("--optim.train_chunk", "8") + (
                ("--render.train_grid_size", str(grid)) if grid else ())
            cfg = _mesh_cfg(tmp, f"chunk{len(out)}", seed, mode,
                            MESH_CHUNK_STEPS, 0, extra)
            out[label] = chunked_mesh_case(
                label, cfg, lambda c: LatentPaintMeshApp.create(
                    c, guidance=guidance, device=DEVICE), prepare)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "tpunerf_torch" / "csrc").is_dir():
        fail(f"no tpunerf_torch package beside {Path(__file__).name}")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")

    from tpunerf_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"nvcc build of {len(logs)} sources: "
          f"{time.perf_counter() - t0:.1f} s")
    ptxas = {}   # kernel -> its -Xptxas -v lines (every instance)
    for name, log in logs.items():
        kernel = "?"
        for line in log.splitlines():
            # '_ZN..._<src>_cu_<8 hex><length><name>...'
            entry = re.search(r"entry function .*?_cu_[0-9a-f]{8}(\d+)", line)
            if entry:
                kernel = line[entry.end():entry.end() + int(entry.group(1))]
            elif "registers" in line or "spill" in line:
                print(f"  [{name}] {kernel}: {line.strip()}")
                ptxas.setdefault(kernel, []).append(line.strip())
            elif "C7512" in line:   # wgmma serialised for want of registers
                print(f"  [{name}] {line.strip()[:240]}")
    # #9 keeps no thread's sums in local memory (its first design spilled)
    for kernel in ("soft_bwd_dense_kernel", "soft_bwd_dense_tiles_kernel"):
        lines = ptxas.get(kernel)
        if lines is not None:
            print(f"#9 -Xptxas -v {kernel}: " + "; ".join(lines))
            if any(re.search(r"[1-9]\d* bytes spill stores", ln)
                   for ln in lines):
                fail(f"{kernel} spills (-Xptxas -v)")

    mark("kernel checks")
    rows = check_kernels(args.seed)
    paint_rows = check_raster_kernels(args.seed)
    soft_rows = check_soft_kernels(args.seed)
    check_gates(args.seed, {**paint_rows, **soft_rows})
    check_slivers(args.seed)
    grad_rows = check_attention_bwd(args.seed)
    split_row, variant_row = check_hash_bwd_experiment(args.seed)
    mark("tiny steps against the CPU")
    check_small_steps(args.seed)
    mark("the SD-v1 stack; graphed steps (a)")
    guidance = build_guidance(args.seed)
    check_graphed_steps(args.seed, guidance)
    mark("pretrained weights (guide.model_dir)")
    weights_launches = weights_phase(args.seed, guidance)
    _free_card()
    mark("stage 1")
    eager_launches, app, trainer, captured = train_full_width(
        STEPS, args.seed, guidance)
    main_path = [n for n, r in rows.items() if r.get("main_path") is not False]
    missing = [n for n in main_path if eager_launches.get(n, 0) <= 0]
    if missing:
        fail(f"latent-NeRF path never launched {missing}")
    check_hash_step_inputs(captured, rows)
    del captured
    save_and_eval_split(app, trainer)
    resume_and_eval_only(STEPS, args.seed, guidance, trainer)
    breakdown(app, trainer)
    del app, trainer
    _free_card()
    launches, ctrainer, ckpt, _ = train_chunked_full_width(STEPS, args.seed,
                                                           guidance)
    del ctrainer
    _free_card()
    mark("the refine stage")
    refine_launches, _ = refine_full_width(args.seed, guidance, ckpt, rows)
    _free_card()
    # config #3 (sketch shape) and the NeRF→mesh bridge on its checkpoint
    mark("config #3")
    sdf_grid_phase()
    sketch_eager, sapp, strainer, captured = train_full_width(
        STEPS, args.seed, guidance, LEGO_MAN, SKETCH, "config #3")
    del sapp, strainer, captured
    _free_card()
    sketch_chunked, strainer, sketch_ckpt, _ = train_chunked_full_width(
        STEPS, args.seed, guidance, LEGO_MAN, SKETCH, "config #3")
    del strainer
    _free_card()
    mark("the NeRF→mesh bridge")
    bridge_launches = bridge_phase(args.seed, guidance, sketch_ckpt, rows,
                                   paint_rows)
    _free_card()
    mark("the bridge done")
    for label, counts in (("chunked stage-1", launches),
                          ("refine", refine_launches),
                          ("config #3 eager", sketch_eager),
                          ("config #3 chunked", sketch_chunked)):
        missing = [n for n in main_path if counts.get(n, 0) <= 0]
        if missing:
            fail(f"the {label} path never launched {missing}")
    from tpunerf_torch.kernels import attention as at
    from tpunerf_torch.kernels import hashgrid as hg
    from tpunerf_torch.kernels import rasterize as rz
    missing = [n for n in (hg.FWD, at.ATTN, rz.DENSE)
               if bridge_launches.get(n, 0) <= 0]
    if missing:
        fail(f"the NeRF→mesh bridge never launched {missing}")
    mark("latent-paint")
    paint_launches, papp, ptrainer = train_paint_full_width(
        STEPS, args.seed, guidance)
    paint_breakdown(papp, ptrainer)
    profile_steps(ptrainer, "latent-paint")
    del papp, ptrainer
    _free_card()
    paint_chunked_launches = train_paint_chunked(STEPS, args.seed, guidance)
    _free_card()
    mark("latent-paint-mesh")
    mesh_launches, mapp, mtrainer, mode1 = train_mesh_full_width(
        STEPS, args.seed, guidance)
    sil_launches, sil_inputs, sil_dense = silhouette_phase(mapp, mtrainer,
                                                           guidance)
    # #10 (c) and #9 (d) on the silhouette phase's own g and prod, beside
    # the first designs
    case_c = soft_bwd_case("(c) the silhouette phase's g = 2·mask and prod",
                           *sil_inputs)
    soft_rows[rz.SOFT_BWD_BINNED]["inputs"]["c"] = case_c
    soft_rows[rz.SOFT_BWD_BINNED_SWEEP]["inputs"]["c"] = {
        "ms": case_c["sweep_ms"], "graph_ms": case_c["sweep_graph_ms"],
        "old_bound_ms": case_c["old_bound_ms"]}
    case_d = soft_bwd_dense_case(
        f"(d) the silhouette phase's {math.isqrt(sil_dense[1].shape[0])}² "
        f"g = 2·mask and prod", *sil_dense)
    soft_rows[rz.SOFT_BWD_DENSE]["inputs"]["d"] = case_d
    soft_rows[rz.SOFT_BWD_DENSE_SWEEP]["inputs"]["d"] = {
        "ms": case_d["sweep_ms"], "graph_ms": case_d["sweep_graph_ms"],
        "old_bound_ms": case_d["old_bound_ms"]}
    del sil_inputs, sil_dense
    mesh_breakdown(mapp, mtrainer, mode1)
    profile_steps(mtrainer, "latent-paint-mesh mode 0")
    if mode1 is not None:
        profile_steps(mode1[1], "latent-paint-mesh mode 1", steps=2)
    mode1_launches = mode1[2] if mode1 is not None else {}
    del mapp, mtrainer, mode1
    _free_card()
    mark("chunked latent-paint-mesh")
    mesh_chunked = chunked_mesh_phase(args.seed, guidance)
    _free_card()
    # the SD-v1 paths that differentiate through the UNet (#12, #13)
    mark("the SD-v1 gradient paths")
    grad_launches = sd_gradient_phases(args.seed, guidance)
    # config #5: depth-conditioned SD, B = 2 (its own stack, freed after)
    mark("config #5")
    depth_launches, b2, depth_chunked = train_depth_full_width(STEPS,
                                                               args.seed)
    paint_rows[rz.DENSE]["config5"] = b2[rz.DENSE]
    soft_rows[rz.SOFT_FWD_DENSE]["config5"] = b2[rz.SOFT_FWD_DENSE]
    soft_rows[rz.SOFT_FWD_DENSE]["max_abs_err"] = max(
        soft_rows[rz.SOFT_FWD_DENSE]["max_abs_err"],
        b2[rz.SOFT_FWD_DENSE]["max_abs_err"])
    _free_card()
    # the Paint-by-Example cell (its own stack, freed after)
    mark("Paint-by-Example")
    pbe_launches, pbe_chunked = train_pbe_full_width(STEPS, args.seed)
    _free_card()
    rows[at.ATTN]["config5"] = attention_at_depth_batch(
        torch.Generator(device="cuda").manual_seed(args.seed))
    # each kernel's count comes from the run of the path that was checked
    # for it: the chunked latent-NeRF run for the first four (the attention
    # kernel is on every path; both latent-paint runs hold its count there
    # too), the eager latent-paint run for the two selection kernels (the
    # chunked run beside it; the all-pairs designs of them, on no path,
    # with the launches of their check), the
    # latent-paint-mesh run for the soft forwards (the binned one from its
    # eval chunk or, where those bins overflow, from mode 1's 512² steps),
    # the silhouette phase for the soft backwards, the experiment's run for
    # the cost-split variants

    def counted(rows_, counts, by_path=None):
        # the kept first designs, on no path, carry their checks' launches
        return [row if row.get("main_path") is False
                else dict(row, launches=counts.get(name, 0),
                          **({"launches_by_path": {
                              k: c.get(name, 0) for k, c in by_path.items()}}
                             if by_path else {}))
                for name, row in rows_.items()]

    soft_counts = {
        rz.SOFT_FWD_DENSE: mesh_launches.get(rz.SOFT_FWD_DENSE, 0),
        rz.SOFT_FWD_BINNED: mesh_launches.get(rz.SOFT_FWD_BINNED, 0)
        or mode1_launches.get(rz.SOFT_FWD_BINNED, 0),
        rz.SOFT_BWD_DENSE: sil_launches.get(rz.SOFT_BWD_DENSE, 0),
        rz.SOFT_BWD_BINNED: sil_launches.get(rz.SOFT_BWD_BINNED, 0)}
    # #1-#4: the chunked stage-1 run (config #4's stage 1 as its recipe
    # runs it: replays counted), beside the other paths that run them
    own_stacks = {"config #5 (depth, B = 2)": depth_launches,
                  "Paint-by-Example (use_clip)": pbe_launches}
    # the chunked latent-paint-mesh runs: each path's own kernels
    chunked_paths = {**{f"{k} chunked": c for k, c in mesh_chunked.items()},
                     "config #5 chunked": depth_chunked,
                     "Paint-by-Example (use_clip) chunked": pbe_chunked}
    for label, counts in chunked_paths.items():
        need = [at.ATTN, rz.DENSE, rz.SOFT_FWD_DENSE] + (
            [rz.BINNED, rz.SOFT_FWD_BINNED] if "mode 1" in label else [])
        missing = [n for n in need if counts.get(n, 0) <= 0]
        if missing:
            fail(f"the {label} path never launched {missing}")
    paint_paths = {"latent-paint eager": paint_launches,
                   "latent-paint chunked": paint_chunked_launches,
                   "nerf→mesh bridge": bridge_launches, **own_stacks,
                   **chunked_paths}
    by_path = {"stage 1 eager": eager_launches, "stage 1 chunked": launches,
               "refine CLI (chunked)": refine_launches,
               "config #3": sketch_eager,
               "config #3 chunked": sketch_chunked,
               "latent-NeRF CLI from guide.model_dir": weights_launches,
               **paint_paths, **grad_launches}
    kernels = (counted(rows, launches, by_path)
               + counted(paint_rows, paint_launches, paint_paths)
               + counted(soft_rows, soft_counts,
                         {"latent-paint-mesh mode 0": mesh_launches,
                          **own_stacks, **chunked_paths}))
    # #12/#13: the text-token run, beside null-text inversion
    kernels += counted(grad_rows, grad_launches["text-token optimisation"],
                       grad_launches)
    # launches from the experiment's own runs
    kernels += [split_row, variant_row]
    if any(k["launches"] <= 0 for k in kernels):
        fail("a kernel of the main paths was never launched")
    mark("end")
    # the card once more, where the end of a long output still shows it
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
