"""Experiment: where the hash-grid table gradient's time goes on the card.

Counterpart of the JAX package's scripts/exp_hash_bwd.py (kernel #11).

The split of today's #2 (`hashgrid_bwd_split`, printed first). Kernel #2
keeps the table's gradient in fixed point in shared memory: pass 1 reads a
block's g for each level's max |g|, pass 2 reads g again with x, finds the
8 corners and adds the rounded updates to 64-bit sums (a biased low word
and a carry word, native integer shared atomics), the sums are converted
into the block's slice, and a second kernel adds the slices in block order.
The modes run these parts alone, on #2's own grid:

  full    both kernels of #2 (at 1x the resident blocks, #2 itself)
  gmax    pass 1: g read once, the per-level maxima
  addr    pass 2 without the adds: g and x read, cells, corners, the
          rounded updates, folded into integer sums
  accum   pass 2's shared adds and the conversion into slices, on stand-in
          slots and updates from a hash: it reads neither x nor g
  reduce  the second kernel over slices of full size

If full ≈ gmax + addr + accum + reduce, the parts run one after the other;
if less, they overlap. Each mode runs at 0.5x, 1x, 2x and 4x #2's resident
blocks a part (its counterpart of the points-per-block sweep below) and is
held to its plain version bit for bit: the sums are integers.

The first design of this split (`hashgrid_bwd_variant`: the first #2, one
level a block, f32 shared atomics), printed second, has two parts: the
address part (load x and g, floor and clamp, hash, the 8 trilinear
weights) and the accumulation part (shared-memory atomicAdds, then one
global atomicAdd per non-zero slot). Its modes:

  full    that first #2, at any number of points per block
  global  every update an atomicAdd straight to the global table gradient,
          no shared copy
  addr    the address part alone (per-level Σ idx and Σ w·g)
  accum   the accumulation part alone, on stand-in slots with the hash's
          spread and payloads made from the same hash: it reads neither x
          nor g, so addr + accum counts no load twice

If full ≈ addr + accum, the two parts run one after the other; if full ≈
max(addr, accum), they overlap. Every mode runs at 2048 … 32768 points per
block (8192 is its own setting).

Both on the default grid (L=12, T=2^11, F=2). A time is one replay of
`iters` calls captured in a CUDA graph, between CUDA events, over `iters`:
no host time falls between launches, as in the JAX script's lax.scan. Each
call is timed as the wrapper makes it, the fill of its outputs included.
Each mode's result is held against its plain PyTorch version.

    python -m tpunerf_torch.scripts.exp_hash_bwd [--n 262144] [--seed 0]
        [--iters 50] [--device cuda]

It runs on the card; `--device cpu` runs the plain versions and prints no
times. Without a card and without `--device cpu` it exits non-zero.
"""
from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpunerf_torch.fields.encoding import (HashGridConfig,
                                           corner_indices_and_weights)
from tpunerf_torch.kernels import hashgrid as hg
from tpunerf_torch.scripts import card

CFG = HashGridConfig()   # the JAX script's grid: L=12, T=2^11, F=2
FULL_N = 262144          # 64² rays × 64 samples, the JAX script's N
SWEEP = (2048, 4096, 8192, 16384, 32768)
ITERS = 50
WARMUP = 3
# every mode against its plain version: f32 sums in another order (atomics
# in run-dependent order), so 1e-5 of the largest value; addr's Σ idx exact
REL_TOL = 1e-5


def make_inputs(n: int, seed: int, device):
    """x (n, 3) uniform in [0, 1) and g (n, L·F) standard normal, f32, from
    numpy's generator (the JAX script's draws)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    g = rng.normal(0, 1, (n, CFG.out_dim)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(g).to(device))


def graph_ms(fn, iters: int = ITERS):
    """(ms per call, the last call's output): `iters` calls of `fn`
    captured in one CUDA graph after WARMUP calls (`card.capture`); one
    untimed replay, then one replay between CUDA events. Each replay
    counts the launches it runs."""
    replay, out = card.capture(fn, iters, WARMUP)
    replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, out


def _compare(mode: str, out, ref, dtable_sum: torch.Tensor) -> dict:
    if mode == "addr":
        (idx, wg), (ref_idx, ref_wg) = out, ref
        tol = REL_TOL * ref_wg.abs().max().item()
        err = (wg - ref_wg).abs().max().item()
        # Σ_f over every (point, corner) is also the table gradient's sum
        sum_err = (wg - dtable_sum).abs().max().item()
        idx_equal = bool(torch.equal(idx, ref_idx))
        return dict(max_abs_err=err, tol=tol, idx_equal=idx_equal,
                    sum_err=sum_err,
                    ok=idx_equal and err <= tol and sum_err <= tol)
    tol = REL_TOL * ref.abs().max().item()
    err = (out - ref).abs().max().item()
    return dict(max_abs_err=err, tol=tol, ok=err <= tol)


def run(device, n: int = FULL_N, seed: int = 0,
        iters: int = ITERS) -> List[dict]:
    """One row per (mode, points per block): ms (None off the card), max
    |err| against the plain version, the tolerance, ok. On the card each
    row's result is the output of its timed graph."""
    device = torch.device(device)
    x, g = make_inputs(n, seed, device)
    refs = {m: hg.hash_bwd_variant_plain(x, g, CFG, m)
            for m in ("full", "addr", "accum")}
    refs["global"] = refs["full"]
    dtable_sum = refs["full"].sum(dim=1)
    rows = []
    for mode in hg.VARIANT_MODES:
        for ppb in SWEEP:
            def call(mode=mode, ppb=ppb):
                return hg.hash_bwd_variant(x, g, CFG, mode, ppb)
            if device.type == "cuda":
                ms, out = graph_ms(call, iters)
            else:
                ms, out = None, call()
            rows.append(dict(mode=mode, points_per_block=ppb, ms=ms,
                             **_compare(mode, out, refs[mode], dtable_sum)))
    return rows


def split_resident(device) -> int:
    """#2's resident blocks: the card's own where `device` is one, else
    (plain versions) the H100's one block an SM."""
    device = torch.device(device)
    if device.type == "cuda":
        return hg._resident(hg.BWD, CFG, device.index
                            if device.index is not None
                            else torch.cuda.current_device())
    return card.SMS


def split_slices(blocks: int, seed: int, device) -> torch.Tensor:
    """reduce's input: slices of #2's full size, N(0, 1) f32 from numpy."""
    shape = hg._split_partial_shape(CFG, blocks)
    rng = np.random.default_rng(seed + blocks)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(device)


def _equal(out, ref) -> bool:
    if isinstance(out, tuple):
        return all(torch.equal(a, b) for a, b in zip(out, ref))
    return torch.equal(out, ref)


def run_split(device, n: int = FULL_N, seed: int = 0,
              iters: int = ITERS) -> List[dict]:
    """One row per (grid factor, mode) of today's #2 taken apart: blocks a
    part, ms (None off the card), equal to the plain version bit for bit,
    ok; on the card each row's result is the output of its timed graph,
    and full at 1x is also held bit for bit against #2 (`hash_bwd_cuda`)."""
    device = torch.device(device)
    x, g = make_inputs(n, seed, device)
    on_card = device.type == "cuda"
    resident = split_resident(device)
    rows = []
    for factor in hg.SPLIT_FACTORS:
        blocks = hg.split_blocks(n, CFG, factor, resident)
        gmax = hg.hash_bwd_split_plain(x, g, CFG, "gmax", blocks)
        partial = split_slices(blocks, seed, device)
        for mode in hg.SPLIT_MODES:
            ref = hg.hash_bwd_split_plain(x, g, CFG, mode, blocks, gmax,
                                          partial)

            def call(mode=mode, blocks=blocks, gmax=gmax, partial=partial):
                return hg.hash_bwd_split(x, g, CFG, mode, blocks, gmax,
                                         partial)
            ms, out = graph_ms(call, iters) if on_card else (None, call())
            row = dict(mode=mode, factor=factor, blocks=blocks, ms=ms,
                       equal=_equal(out, ref))
            row["ok"] = row["equal"]
            if on_card and mode == "full" and factor == 1:
                row["equals_2"] = torch.equal(out, hg.hash_bwd_cuda(x, g,
                                                                    CFG))
                row["ok"] = row["ok"] and row["equals_2"]
            rows.append(row)
    return rows


def format_split_row(r: dict, base_ms: float = None,
                     b_ms: float = None) -> str:
    t = "plain" if r["ms"] is None else f"{r['ms']:.4f} ms"
    line = (f"split {r['mode']} {r['factor']}x ({r['blocks']} blocks a "
            f"part): {t}  equal to plain: {r['equal']}")
    if "equals_2" in r:
        line += f"  equal to #2: {r['equals_2']}"
    if r["ms"] is not None and base_ms and b_ms:
        line += (f"  share of #2's {base_ms:.4f} ms {r['ms'] / base_ms:.3f},"
                 f" of the bound {b_ms / r['ms']:.3f}")
    return line + ("" if r["ok"] else "  FAIL")


def split_sum_lines(rows: List[dict]) -> List[str]:
    """Per grid factor: full against gmax + addr + accum + reduce (the
    parts one after the other) and the largest part (all overlapped)."""
    ms = {(r["mode"], r["factor"]): r["ms"] for r in rows}
    out = []
    for factor in hg.SPLIT_FACTORS:
        parts = [ms[m, factor] for m in ("gmax", "addr", "accum", "reduce")]
        blocks = next(r["blocks"] for r in rows if r["factor"] == factor)
        out.append(
            f"split of #2 at {factor}x ({blocks} blocks a part): full "
            f"{ms['full', factor]:.4f} ms; gmax {parts[0]:.4f} + addr "
            f"{parts[1]:.4f} + accum {parts[2]:.4f} + reduce {parts[3]:.4f}"
            f" = {sum(parts):.4f} (serial), max {max(parts):.4f} "
            f"(overlapped); full - serial {ms['full', factor] - sum(parts):+.4f}")
    return out


def format_row(r: dict) -> str:
    t = "plain" if r["ms"] is None else f"{r['ms']:.4f} ms"
    line = (f"variant {r['mode']} ppb={r['points_per_block']}: {t}  "
            f"max|err|={r['max_abs_err']:.2e} (tol {r['tol']:.2e})")
    if r["mode"] == "addr":
        line += (f"  Σidx {'equal' if r['idx_equal'] else 'DIFFERS'}"
                 f"  |Σw·g − Σdtable|={r['sum_err']:.2e}")
    return line + ("" if r["ok"] else "  FAIL")


def split_lines(rows: List[dict]) -> List[str]:
    """Per points per block: full against addr + accum (serial) and
    max(addr, accum) (overlapped), and global."""
    ms = {(r["mode"], r["points_per_block"]): r["ms"] for r in rows}
    out = []
    for ppb in sorted({r["points_per_block"] for r in rows}):
        a, c = ms["addr", ppb], ms["accum", ppb]
        out.append(f"split ppb={ppb}: full {ms['full', ppb]:.4f} ms; addr "
                   f"{a:.4f} + accum {c:.4f} = {a + c:.4f} (serial), max "
                   f"{max(a, c):.4f} (overlapped); global "
                   f"{ms['global', ppb]:.4f}")
    return out


def table_bytes(n: int) -> int:
    """Bytes #2 must move: x and g read once, the table gradient written
    once."""
    L, T, F = CFG.n_levels, CFG.table_size, CFG.n_features_per_level
    return 4 * (n * 3 + n * L * F + L * T * F)


def bound_ms(n: int) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time #2's work takes on the
    card, counted as row 2 is: `table_bytes`, and 8 corners × (2 + 2F) f32
    operations per (point, level)."""
    L, F = CFG.n_levels, CFG.n_features_per_level
    return card.bound(table_bytes(n), n * L * 8 * (2 + 2 * F), "f32")


def shared_atomics(n: int) -> int:
    """Shared-memory updates of full and accum: 8·F per (point, level)."""
    return n * CFG.n_levels * 8 * CFG.n_features_per_level


def atomics_bound_ms(n: int, sm_mhz: float) -> float:
    """At one conflict-free warp-wide shared atomic per SM per clock."""
    return shared_atomics(n) / (card.SMS * card.WARP * sm_mhz * 1e6) * 1e3


def index_add_operands(x: torch.Tensor, g: torch.Tensor):
    """The plain table gradient's last call, `index_add_(0, flat, wg)`,
    with its operands precomputed: flat (L·N·8,) slots, wg (L·N·8, F)."""
    L, T, F = CFG.n_levels, CFG.table_size, CFG.n_features_per_level
    N = x.shape[0]
    idx8, w8 = corner_indices_and_weights(x, CFG)
    g_lnf = g.reshape(N, L, F).permute(1, 0, 2)
    wg = (w8[..., None] * g_lnf[:, :, None, :]).reshape(-1, F).contiguous()
    flat = (idx8 + torch.arange(L, device=x.device)[:, None, None] * T
            ).reshape(-1)
    return flat, wg


def sass_atomics() -> Dict[str, Counter]:
    """Atomic opcodes per F = 2 backward kernel in `cuobjdump -sass` of the
    built library: whether the shared f32 add is a native ATOMS.ADD or a
    compare-and-swap loop."""
    found = {}
    for head, chunk in card.sass_functions("hashgrid").items():
        m = re.search(r"(hashgrid_bwd\w*?_kernel)ILi2E(?:Li(\d)E)?", head)
        if m is None:
            continue
        modes = hg.SPLIT_MODES if "split" in m.group(1) else hg.VARIANT_MODES
        name = m.group(1) + ("" if m.group(2) is None else
                             f"<{modes[int(m.group(2))]}>")
        found[name] = Counter(re.findall(
            r"\b(?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+", chunk))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=FULL_N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = card.device_of(args.device)
    on_card = device.type == "cuda"
    L, T, F = CFG.n_levels, CFG.table_size, CFG.n_features_per_level
    print(f"L={L} T={T} F={F} N={args.n}")
    if on_card:
        x, g = make_inputs(args.n, args.seed, device)
        base_ms, base = graph_ms(lambda: hg.hash_bwd_cuda(x, g, CFG),
                                 args.iters)
        ref = hg.hash_bwd_plain(x, g, CFG)
        err = (base - ref).abs().max().item()
        print(f"kernel #2 (hashgrid_bwd, fixed point):  {base_ms:.4f} ms  "
              f"max|err|={err:.2e}")
    else:
        print("device cpu: plain versions, no times")

    b_ms, b_by = bound_ms(args.n)
    srows = run_split(device, args.n, args.seed, args.iters)
    for r in srows:
        print(format_split_row(r, base_ms if on_card else None, b_ms))
    if on_card:
        for line in split_sum_lines(srows):
            print(line)
    print("the split of the first #2 (hashgrid_bwd_variant):")
    rows = run(device, args.n, args.seed, args.iters)
    for r in rows:
        print(format_row(r))
    ok = all(r["ok"] for r in rows + srows)
    if not on_card:
        return 0 if ok else 1

    full = hg.hash_bwd_variant_cuda(x, g, CFG, "full", 8192)
    err = (full - base).abs().max().item()
    tol = REL_TOL * base.abs().max().item()
    print(f"variant full ppb=8192 vs kernel #2: max|err|={err:.2e} "
          f"(tol {tol:.2e})")
    ok = ok and err <= tol
    for line in split_lines(rows):
        print(line)
    print(f"bound: x {args.n * 12 / 1e6:.2f} MB + g "
          f"{args.n * L * F * 4 / 1e6:.2f} MB + dtable "
          f"{L * T * F * 4 / 1e6:.2f} MB = {table_bytes(args.n) / 1e6:.2f} "
          f"MB at {card.MEM_BYTES_PER_S / 1e12:.2f} TB/s -> {b_ms:.4f} ms "
          f"({b_by}; full, global, addr)")
    mhz = card.max_sm_mhz()
    if mhz is not None:
        print(f"bound shared atomics: {shared_atomics(args.n)} updates / "
              f"({card.SMS} SMs x {card.WARP} lanes x {mhz:.0f} MHz) -> "
              f"{atomics_bound_ms(args.n, mhz):.4f} ms (full, accum; one "
              f"native warp-wide shared atomic per SM per clock)")
    flat, wg = index_add_operands(x, g)

    def lib_call():
        return torch.zeros((L * T, F), device=device).index_add_(0, flat, wg)
    print(f"index_add_ yardstick (zero-fill + index_add_ of {flat.numel()} "
          f"precomputed slots and w·g, eager): "
          f"{card.cuda_ms(lib_call, 10):.4f} ms")
    print(f"plain version (hash_bwd_plain, eager): "
          f"{card.cuda_ms(lambda: hg.hash_bwd_plain(x, g, CFG), 5):.4f} ms")
    for name, ops in sass_atomics().items():
        print(f"sass {name}: " + ", ".join(f"{op} x{k}" for op, k in
                                           sorted(ops.items())))
    smi = card.nvidia_smi("name,power.limit")
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{smi[0] if smi else 'unavailable'} | max SM clock {mhz} MHz")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
