"""Experiment: kernel #9 (the dense soft backward) at other block shapes.

#9 gives a block a chunk of faces of one view and a number of warps that
share its kept (tile, face) pairs; a segment of the live-tile list holds as
many tiles as the block has threads. This builds csrc/rasterize.cu once per
(faces a block, warps a block), with those constants in place of the
committed ones, into build/exp_soft_bwd_dense/, and times each build's #9
in a CUDA graph on the projected sphere at four inputs: (a) the wide camera
at 64² with N(0, 1) g, (b) the head camera at 64² (hardly a live pixel),
(c) the 5 views of the eval orbit dense at 512², (d) (a)'s rows with the
silhouette's cotangent 2·mask. Each build is held to the committed kernel's
first design (`soft_grad_dense_sweep_cuda`) within 2e-5 of the largest
gradient and to itself bit for bit over two calls. The builds are timed in
turns, then again in the reverse order, in one process: compare them only
within one run.

    python -m tpunerf_torch.scripts.exp_soft_bwd_dense [--shapes 8x8 16x8
        32x8 32x16] [--iters 20] [--seed 0]

It runs only on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import rasterize as rz
from tpunerf_torch.scripts import card

OUT = _build.BUILD_DIR.parent / "exp_soft_bwd_dense"
SIGMA = 1e-4
TOL = 2e-5


def constants(faces: int, warps: int) -> dict:
    """#9's constants for a block of `faces` faces and `warps` warps: a
    segment a thread's tile, batches that keep the static shared memory of
    the pairs' sums under 48 KB."""
    return dict(kQFaces=faces, kQWarps=warps, kLTiles=32 * warps,
                kQBatch=32 if warps * faces <= 256 else 16)


def patched_source(faces: int, warps: int) -> str:
    """csrc/rasterize.cu with #9's constants replaced."""
    src = (_build.CSRC / "rasterize.cu").read_text()
    for name, value in constants(faces, warps).items():
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise RuntimeError(f"no single constant {name} in rasterize.cu")
    return src


def build(faces: int, warps: int) -> subprocess.Popen:
    """Start nvcc on `patched_source` into OUT."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"rasterize_{faces}x{warps}.cu"
    path.write_text(patched_source(faces, warps))
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def entry(lib: ctypes.CDLL):
    """#9 of a build, with the contract of `rz.soft_grad_dense_cuda`."""
    size, fn = lib.soft_bwd_dense_scratch, lib.soft_bwd_dense
    size.argtypes, size.restype = [_build.INT] * 3, _build.LONG
    fn.argtypes = ([_build.VOIDP] * 7 + [_build.LONG] + [_build.INT] * 4
                   + [_build.FLOAT] * 2 + [_build.VOIDP])
    fn.restype = _build.INT

    def grad(rows, pix, g, prod, width):
        B, F, _ = rows.shape
        P = pix.shape[0]
        scratch = torch.empty((max(size(B, P, width), 4),),
                              dtype=torch.int32, device=rows.device)
        out = torch.empty((B, F, 6), dtype=torch.float32, device=rows.device)
        _build.check(fn(rows.data_ptr(), pix.data_ptr(), g.data_ptr(),
                        prod.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                        None, scratch.numel(), B, F, P, width, SIGMA,
                        rz._soft_margin(SIGMA),
                        _build.stream_ptr(rows.device)), "soft_bwd_dense")
        return out
    return grad


def ptxas_lines(log: str) -> list:
    """The registers and spill lines of soft_bwd_dense_kernel and
    soft_bwd_dense_tiles_kernel in an nvcc -Xptxas -v log."""
    found, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(soft_bwd_dense_"
                      r"(?:tiles_)?kernel)", line)
        if "Compiling entry function" in line:
            kernel = m.group(1) if m else None
        elif kernel and ("registers" in line or "spill" in line):
            found.append(f"{kernel}: {line.strip()}")
    return found


def inputs(seed: int) -> dict:
    """{case: (rows, pix, g, prod, width)} on the projected sphere."""
    from tpunerf_torch.core.views import (ViewSamplerConfig, circle_poses,
                                          rand_poses)
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    vcfg = ViewSamplerConfig()

    def rows_of(views, spec):
        return rz._soft_rows(mrender._project(
            mesh.vertices, mesh.faces, views.theta, views.phi, views.radius,
            spec)[1]).contiguous()

    def case(rows, size, cotangent="random"):
        pix = rz.pixel_grid_ndc(size, size, dev)
        prod = rz.soft_prod_dense_cuda(rows, pix, SIGMA, size)
        g = (torch.randn(prod.shape, generator=gen, device=dev)
             if cotangent == "random" else (2.0 * (1.0 - prod)).contiguous())
        return rows, pix, g, prod, size

    poses = rand_poses(4, vcfg, dev, generator=gen)
    wide = rows_of(poses[:1], mrender.CameraSpec(look_at_height=0.25))
    return {"a": case(wide, 64),
            "b": case(rows_of(poses[:1], mrender.HEAD_CAMERA), 64),
            "c": case(rows_of(circle_poses(5, vcfg, dev),
                              mrender.BODY_CAMERA), 512),
            "d": case(wide, 64, "silhouette")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["8x8", "16x8", "32x8",
                                                    "32x16"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the experiment "
                           "times kernels on the card")
    from tpunerf_torch.scripts.exp_hash_bwd import graph_ms
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes]
    procs = {s: build(*s) for s in shapes}   # all nvcc runs at once
    grads = {}
    ok = True
    for s, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {s}:\n{log}")
        print(f"{s[0]} faces x {s[1]} warps: {constants(*s)}; -Xptxas -v "
              "of #9's two kernels: " + "; ".join(ptxas_lines(log)))
        grads[s] = entry(ctypes.CDLL(str(OUT / f"rasterize_{s[0]}x{s[1]}"
                                            ".so")))
    cases = inputs(args.seed)
    times = {s: {k: [] for k in cases} for s in shapes}
    for s in shapes:
        for key, (rows, pix, g, prod, width) in cases.items():
            got = grads[s](rows, pix, g, prod, width)
            ref = rz.soft_grad_dense_sweep_cuda(rows, pix, g, prod, SIGMA)
            torch.cuda.synchronize()
            err = ((got - ref).abs().max()
                   / ref.abs().max().clamp(min=1e-30)).item()
            same = torch.equal(got, grads[s](rows, pix, g, prod, width))
            if not (err <= TOL and same):
                print(f"FAIL {s} ({key}): err {err:.3e}, same bits {same}")
                ok = False
    for s in shapes + shapes[::-1]:          # in turns, then reversed
        for key, (rows, pix, g, prod, width) in cases.items():
            times[s][key].append(graph_ms(
                lambda: grads[s](rows, pix, g, prod, width), args.iters)[0])
    for s in shapes:
        print(json.dumps({"faces": s[0], "warps": s[1], "graph_ms": {
            k: [round(t, 5) for t in v] for k, v in times[s].items()}}))
    smi = card.nvidia_smi("name,power.limit")
    print(f"card: {smi[0] if smi else torch.cuda.get_device_name(0)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
