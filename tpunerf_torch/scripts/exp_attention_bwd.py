"""Experiment: the design choices of the wgmma attention backward (#12, #13).

Builds csrc/attention_bwd.cu once per variant, each the committed source
with one choice undone, into build/exp_attention_bwd/; prints the -Xptxas -v
lines of each build's wgmma kernel (registers, spills, and C7512: ptxas
serialised the wgmma for want of registers); holds each build's #12 and #13
to the committed kernels' kept mma.sync design within the bf16 tolerance;
and times both in CUDA graphs, in turns and then in the reverse order, at
the UNet's (2, 8, 4096, 40) and at (1, 8, 4096, 64), bf16. Variants:

    committed  the source as the package builds it;
    tile64     #12 with 64-query tiles (48 committed);
    unfolded   dS as (dP − Δ)·P·s, the plain version's order
               ((dP·s − Δ·s)·P committed);
    no_turns   the two warpgroups issue without taking turns;
    ss13       #13 reads Q and dO from shared memory at DP = 48 too;
    stages6    six stages in the ring (four committed).

    python -m tpunerf_torch.scripts.exp_attention_bwd [--variants committed
        tile64 ...] [--iters 5] [--seed 0]

Compare the builds only within one run. It runs only on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import subprocess
import sys

import torch

from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import attention as at
from tpunerf_torch.scripts import card

OUT = _build.BUILD_DIR.parent / "exp_attention_bwd"
TOL = 2e-2      # the card checks' bf16 tolerance, of the largest entry
SHAPES = [(2, 8, 4096, 40), (1, 8, 4096, 64)]
VARIANTS = {
    "committed": [],
    "tile64": [("static constexpr int T = DKV ? 48 : 64;",
                "static constexpr int T = 64;")],
    "unfolded": [
        ("const float d2[2] = {dl.x * scale, dl.y * scale};",
         "const float d2[2] = {dl.x, dl.y};"),
        ("sy[4 * n + e] = fmaf(sy[4 * n + e], scale, -d2[e & 1]) * p;",
         "sy[4 * n + e] = (sy[4 * n + e] - d2[e & 1]) * p * scale;"),
        ("rd[i] = db[r] * scale;", "rd[i] = db[r];"),
        ("sy[e] = fmaf(sy[e], scale, -rd[i]) * p;",
         "sy[e] = (sy[e] - rd[i]) * p * scale;")],
    "no_turns": [
        ("      named_sync(1 + wg);\n", ""),
        ("      if (wg + 1 < WG || j + 1 < nt) named_arrive(1 + (wg + 1) % WG);"
         "\n", ""),
        ("    if (wg == WG - 1) named_arrive(1);\n", "")],
    "ss13": [("static constexpr bool kSS = DKV || DP == 64;",
              "static constexpr bool kSS = true;")],
    "stages6": [("  static constexpr int kStages = 4;\n  static constexpr int "
                 "kTile = T", "  static constexpr int kStages = 6;\n  static "
                 "constexpr int kTile = T")],
}


def patched_source(name: str) -> str:
    """csrc/attention_bwd.cu with variant `name`'s replacements."""
    src = (_build.CSRC / "attention_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: no single {old!r} in "
                               "attention_bwd.cu")
        src = src.replace(old, new)
    return src


def build(name: str) -> subprocess.Popen:
    """Start nvcc on `patched_source(name)` into OUT."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"attention_bwd_{name}.cu"
    path.write_text(patched_source(name))
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-o", str(path.with_suffix(".so")), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(log: str) -> list:
    """The C7512, registers and spill lines of the wgmma kernel's four
    instances in an nvcc -Xptxas -v log."""
    found, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"wgmma_kernelILi(\d+)ELb(\d)", line)
        if "C7512" in line and m:
            found.append(f"<{m.group(1)}, {'dkv' if m.group(2) == '1' else 'dq'}>"
                         " wgmma serialised (C7512)")
        elif "Compiling entry function" in line:
            kernel = (f"<{m.group(1)}, {'dkv' if m.group(2) == '1' else 'dq'}>"
                      if m else None)
        elif kernel and ("registers" in line or "spill" in line):
            found.append(f"{kernel} {line.strip()}")
    return found


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The attention wrappers calling `lib`'s entries instead of the
    package's build."""
    saved = _build._libs.get("attention_bwd")
    _build._libs["attention_bwd"] = lib
    at._fns.clear()
    try:
        yield
    finally:
        _build._libs["attention_bwd"] = saved
        at._fns.clear()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the experiment "
                           "times kernels on the card")
    from tpunerf_torch.scripts.exp_hash_bwd import graph_ms
    _build.build_all()
    _build.load("attention_bwd")
    procs = {v: build(v) for v in args.variants}   # all nvcc runs at once
    libs = {}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n{log}")
        print(f"{v}: -Xptxas -v " + "; ".join(ptxas_lines(log)))
        libs[v] = ctypes.CDLL(str(OUT / f"attention_bwd_{v}.so"))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = True
    for shape in SHAPES:
        B, H, N, D = shape
        scale = D ** -0.5
        q, k, v, do = (torch.randn((B, N, H, D), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       .permute(0, 2, 1, 3) for _ in range(4))
        o, lse = at.attention_fwd_cuda(q, k, v, scale, with_lse=True)
        delta = torch.sum(o.float() * do.float(), dim=-1)
        args_ = (q, k, v, do, lse, delta, scale)
        ref = (at.attention_bwd_dq_mma_cuda(*args_),
               *at.attention_bwd_dkv_mma_cuda(*args_))
        times = {name: {"dkv": [], "dq": []} for name in libs}
        for rnd in range(2):
            for name, lib in list(libs.items())[::(-1) ** rnd]:
                with using(lib):
                    if rnd == 0:
                        got = (at.attention_bwd_dq_cuda(*args_),
                               *at.attention_bwd_dkv_cuda(*args_))
                        err = max(((g.float() - r.float()).abs().max()
                                   / r.float().abs().max()).item()
                                  for g, r in zip(got, ref))
                        if err > TOL:
                            print(f"FAIL {name} {shape}: {err:.3e} of the "
                                  "max against the mma.sync design")
                            ok = False
                    times[name]["dkv"].append(graph_ms(
                        lambda: at.attention_bwd_dkv_cuda(*args_),
                        args.iters)[0])
                    times[name]["dq"].append(graph_ms(
                        lambda: at.attention_bwd_dq_cuda(*args_),
                        args.iters)[0])
        for name, t in times.items():
            both = [a + b for a, b in zip(t["dkv"], t["dq"])]
            print(f"{name} {shape}: #12 " + " / ".join(
                f"{x:.4f}" for x in t["dkv"]) + " ms graph, #13 " + " / ".join(
                f"{x:.4f}" for x in t["dq"]) + ", together " + " / ".join(
                f"{x:.4f}" for x in both))
    smi = card.nvidia_smi("name,power.limit")
    print(f"card: {smi[0] if smi else torch.cuda.get_device_name(0)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
