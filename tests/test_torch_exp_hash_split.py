"""Kernel #11 since its redesign: today's kernel #2 taken apart on its own
grid (tpunerf_torch/kernels/hashgrid.py `hash_bwd_split`, run by
tpunerf_torch/scripts/exp_hash_bwd.py), on the CPU.

Each part's plain version is held to an integer emulation written here in
numpy, exactly: gmax (each chunk's max |g| per level), addr (each chunk's
sums of the slot ids and of the rounded fixed-point updates, with the
exponents of gmax), accum (the stand-in updates summed into their slots
and converted once), reduce (the slices added in block order). full is
#2's own emulation and stays within the tolerances of the JAX package's
table gradient: its custom VJP and its Pallas kernel in interpret mode. The
CUDA modes are held against these plain versions bit for bit on the card
(test_torch_kernels_cuda.py)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from _torch_port import assert_close_to_max
from tpunerf.fields import encoding as jenc
from tpunerf.kernels import hashgrid as jhg
from tpunerf_torch.fields import encoding as tenc
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import hashgrid as thg
from tpunerf_torch.scripts import exp_hash_bwd as texp

ROOT = Path(__file__).resolve().parents[1]
N = 777
# the small grid of tests/test_hashgrid_kernel.py, the default one, and two
# whose parts are not whole levels alike: level groups of 3 and 2
# ("groups") and each level cut into two slot ranges ("split")
CONFIGS = {
    "small": dict(n_levels=4, log2_hashmap_size=9, base_resolution=4,
                  desired_resolution=32),
    "default": {},
    "groups": dict(n_levels=16, log2_hashmap_size=12),
    "split": dict(n_levels=3, n_features_per_level=1, log2_hashmap_size=15),
}


def _inputs(name, seed=3, odd=False):
    cfg = tenc.HashGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(N, 3)).astype(np.float32)
    x[:4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1e-7, 1 - 1e-7, 0.5]]
    g = rng.standard_normal((N, cfg.out_dim)).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.01] *= 1e4     # a heavy tail
    if odd:
        g[5, 0], g[300, -1], g[700, 1] = np.inf, np.nan, -np.inf
    return cfg, x, g


def _chunks(n, blocks):
    c = -(-n // blocks)
    return [(b * c, min(n, (b + 1) * c)) for b in range(blocks)]


def _np_gmax(g, cfg, blocks):
    L, F = cfg.n_levels, cfg.n_features_per_level
    a = np.abs(g.reshape(-1, L, F))
    a = np.where(np.isfinite(a), a, 0).astype(np.float32)
    out = np.zeros((blocks, L), np.float32)
    for b, (lo, hi) in enumerate(_chunks(len(g), blocks)):
        if lo < hi:
            out[b] = a[lo:hi].max(axis=(0, 2))
    return out


def _np_exponent(gmax):
    """#2's exponent: the largest s ≤ 126 with 2^s · G < 2^30, 0 at G = 0."""
    bits = gmax.astype(np.float32).view(np.int32).astype(np.int64)
    s = np.minimum(29 - ((bits >> 23) - 127), 126)
    return np.where(bits == 0, 0, s)


def _np_fmix32(n):
    h = np.arange(n * 8, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> 16
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> 13
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> 16
    return h.reshape(n, 8)


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("blocks", [1, 3, 7])
@pytest.mark.parametrize("name", ["small", "default"])
def test_gmax_equals_the_emulation(name, blocks, odd):
    cfg, x, g = _inputs(name, odd=odd)
    out = thg.hash_bwd_split(torch.from_numpy(x), torch.from_numpy(g), cfg,
                             "gmax", blocks)
    np.testing.assert_array_equal(out.numpy(), _np_gmax(g, cfg, blocks))


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("name", ["small", "default", "split"])
def test_addr_equals_the_integer_emulation(name, odd):
    """Σ idx (uint32, wrapping) and Σ v (int64) over each chunk's updates
    (point, corner, feature), v = rint(w·g_f·2^s) in f32 with s from gmax
    and a non-finite g counting 0; corners and weights from the JAX
    package's encoding."""
    cfg, x, g = _inputs(name, seed=5, odd=odd)
    blocks = 3
    L, F = cfg.n_levels, cfg.n_features_per_level
    jcfg = jenc.HashGridConfig(**CONFIGS[name])
    idx, w = (np.asarray(a) for a in
              jenc.corner_indices_and_weights(jnp.asarray(x), jcfg))
    gl = g.reshape(N, L, F).transpose(1, 0, 2)               # (L, N, F)
    gl = np.where(np.isfinite(gl), gl, 0).astype(np.float32)
    gmax = _np_gmax(g, cfg, blocks)
    scale = np.ldexp(np.float32(1), _np_exponent(gmax)).astype(np.float32)
    ref_idx = np.zeros((blocks, L), np.int64)
    ref_v = np.zeros((blocks, L), np.int64)
    for b, (lo, hi) in enumerate(_chunks(N, blocks)):
        wg = (w[:, lo:hi, :, None] * gl[:, lo:hi, None, :]).astype(np.float32)
        v = np.rint((wg * scale[b][:, None, None, None]).astype(np.float32))
        ref_v[b] = v.astype(np.int64).sum(axis=(1, 2, 3))
        ref_idx[b] = idx[:, lo:hi].astype(np.int64).sum(axis=(1, 2)) * F
    ref_idx = (ref_idx % 2 ** 32).astype(np.uint32).view(np.int32)
    out_idx, out_v = thg.hash_bwd_split(
        torch.from_numpy(x), torch.from_numpy(g), cfg, "addr", blocks,
        torch.from_numpy(gmax))
    np.testing.assert_array_equal(out_idx.numpy(), ref_idx)
    np.testing.assert_array_equal(out_v.numpy(), ref_v)
    assert (ref_v != 0).all()
    # without gmax the plain version takes its own
    again = thg.hash_bwd_split(torch.from_numpy(x), torch.from_numpy(g), cfg,
                               "addr", blocks)
    assert torch.equal(again[1], out_v)


@pytest.mark.parametrize("name", ["small", "default", "groups", "split"])
def test_accum_equals_the_integer_emulation(name):
    """The stand-ins of h = fmix32(p·8 + c): slot h & (T − 1), update
    (int32)h >> 3, summed per chunk into every level's and feature's slot
    within each part, converted once to f32 and · 2^-28; the slices' tails
    past a part's values 0."""
    cfg, x, g = _inputs(name, seed=7)
    blocks = 4
    T, F = cfg.table_size, cfg.n_features_per_level
    h = _np_fmix32(N)
    slots = (h & np.uint32(T - 1)).astype(np.int64)
    v = (h.view(np.int32) >> 3).astype(np.int64)
    assert (v < 0).any() and (v > 0).any() and np.abs(v).max() < 2 ** 28
    parts = thg.table_parts(cfg, thg.BWD_VALUE_BYTES)
    most = max(nl * nj for _, nl, _, nj in parts)
    ref = np.zeros((len(parts), blocks, most * F), np.float32)
    for b, (lo, hi) in enumerate(_chunks(N, blocks)):
        sums = np.zeros(T, np.int64)
        np.add.at(sums, slots[lo:hi].ravel(), v[lo:hi].ravel())
        back = (sums.astype(np.float32) * np.float32(2.0 ** -28)).astype(
            np.float32)
        for k, (_, nl, j0, nj) in enumerate(parts):
            ref[k, b, :nl * nj * F] = np.tile(back[j0:j0 + nj], F * nl)
    out = thg.hash_bwd_split(torch.from_numpy(x), torch.from_numpy(g), cfg,
                             "accum", blocks)
    np.testing.assert_array_equal(out.numpy(), ref)
    # neither x nor g is read
    other = thg.hash_bwd_split(torch.from_numpy(x[::-1].copy()),
                               torch.from_numpy(-g), cfg, "accum", blocks)
    assert torch.equal(out, other)


@pytest.mark.parametrize("name", ["small", "default", "groups", "split"])
def test_reduce_adds_the_slices_in_block_order(name):
    cfg, x, g = _inputs(name)
    blocks = 5
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    parts = thg.table_parts(cfg, thg.BWD_VALUE_BYTES)
    most = max(nl * nj for _, nl, _, nj in parts)
    rng = np.random.default_rng(9)
    partial = (rng.standard_normal((len(parts), blocks, most * F))
               * 10.0 ** rng.integers(-3, 4, (len(parts), blocks, 1))
               ).astype(np.float32)
    ref = np.zeros((L, T, F), np.float32)
    for k, (l0, nl, j0, nj) in enumerate(parts):
        acc = np.zeros(nl * nj * F, np.float32)
        for b in range(blocks):                  # f32, block by block
            acc = (acc + partial[k, b, :nl * nj * F]).astype(np.float32)
        ref[l0:l0 + nl, j0:j0 + nj] = acc.reshape(F, nl, nj).transpose(
            1, 2, 0)
    out = thg.hash_bwd_split(torch.from_numpy(x), torch.from_numpy(g), cfg,
                             "reduce", blocks,
                             partial=torch.from_numpy(partial))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name", ["small", "default"])
def test_full_is_the_fixed_point_emulation_near_the_jax_gradients(name):
    cfg, x, g = _inputs(name, seed=11)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    out = thg.hash_bwd_split(xt, gt, cfg, "full", 3)
    assert torch.equal(out, thg.hash_bwd_fixed_point_plain(xt, gt, cfg, 3))
    jcfg = jenc.HashGridConfig(**CONFIGS[name])
    table = jnp.zeros((cfg.n_levels, cfg.table_size,
                       cfg.n_features_per_level), jnp.float32)
    _, vjp = jax.vjp(lambda t: jenc.hash_encode(jnp.asarray(x), t, jcfg),
                     table)
    # sums in another order, each update rounded to 2^-s < G·2^-30
    assert_close_to_max(out.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                        1e-5, "full vs the JAX VJP")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jhg._hash_bwd_pallas(jnp.asarray(x), jnp.asarray(g),
                                              jcfg))
    # the Pallas kernel contracts bf16 one-hot operands: 2e-2 of max
    assert_close_to_max(out.numpy(), ref, 2e-2, "full vs the Pallas kernel")


@pytest.mark.parametrize("mode,blocks,n", [
    ("vpu", 3, N), ("global", 3, N), ("Full", 3, N),
    ("full", 0, N), ("full", -1, N), ("full", 1.5, N), ("full", True, N),
    ("full", 2, 20000), ("gmax", 1 << 31, N), ("reduce", 3, N),
])
def test_bad_mode_grid_or_operands_raise(mode, blocks, n):
    cfg = tenc.HashGridConfig()
    x = torch.rand((n, 3), generator=torch.Generator().manual_seed(0))
    g = torch.zeros((n, cfg.out_dim))
    # reduce without its slices is refused too
    for fn in (thg.hash_bwd_split, thg.hash_bwd_split_plain):
        with pytest.raises(ValueError):
            fn(x, g, cfg, mode, blocks)


def test_split_blocks_are_the_grids_of_2():
    cfg = tenc.HashGridConfig()
    parts = len(thg.table_parts(cfg, thg.BWD_VALUE_BYTES))
    n = texp.FULL_N
    got = [thg.split_blocks(n, cfg, f, 132) for f in thg.SPLIT_FACTORS]
    assert got == [33, 66, 132, 264]
    # 1x is #2's own grid; none over #2's points a block
    assert got[1] == thg.grid_blocks(n, parts, 132, thg.BWD_MIN_POINTS,
                                     thg.BWD_MAX_POINTS)
    assert all(-(-n // b) <= thg.BWD_MAX_POINTS for b in got)
    assert thg.split_blocks(20000, cfg, 0.01, 132) == 3   # the points cap


def test_cpu_tensors_launch_nothing():
    cfg, x, g = _inputs("small")
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    _build.reset_launches()
    for mode in thg.SPLIT_MODES:
        partial = torch.zeros(thg._split_partial_shape(cfg, 2))
        thg.hash_bwd_split(xt, gt, cfg, mode, 2, partial=partial)
    assert _build.LAUNCHES.get(thg.SPLIT, 0) == 0


def test_run_split_on_the_cpu_holds_every_mode():
    rows = texp.run_split("cpu", n=N, seed=1)
    assert [(r["mode"], r["factor"]) for r in rows] == [
        (m, f) for f in thg.SPLIT_FACTORS for m in thg.SPLIT_MODES]
    assert all(r["ok"] and r["equal"] and r["ms"] is None for r in rows)


def test_cli_prints_the_split_first_then_the_first_design():
    res = subprocess.run(
        [sys.executable, "-m", "tpunerf_torch.scripts.exp_hash_bwd",
         "--device", "cpu", "--n", str(N)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    split = [i for i, ln in enumerate(lines) if ln.startswith("split ")]
    variant = [i for i, ln in enumerate(lines) if ln.startswith("variant ")]
    assert len(split) == len(thg.SPLIT_MODES) * len(thg.SPLIT_FACTORS)
    assert split and variant and max(split) < min(variant)
    assert not any(" ms" in lines[i] or "FAIL" in lines[i] for i in split)
