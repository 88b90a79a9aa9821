"""The host side and the arithmetic of the hash-grid kernels' design
(tpunerf_torch/kernels/hashgrid.py, csrc/hashgrid.cu), on the CPU: how the
table is cut into parts that fit shared memory, and kernel #2's fixed-point
accumulation, emulated by `hash_bwd_fixed_point_plain`, against the JAX
package's table gradient (the VJP of tpunerf/fields/encoding.py's
hash_encode). The kernels themselves are held against the emulation bit for
bit on the card (test_torch_kernels_cuda.py)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max
from tpunerf.fields import encoding as jenc
from tpunerf_torch.fields import encoding as tenc
from tpunerf_torch.kernels import hashgrid as thg

CONFIGS = {
    "tiny": dict(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                 desired_resolution=64),
    "default": {},
    "small": dict(n_levels=4, log2_hashmap_size=9, base_resolution=4,
                  desired_resolution=32),
    "groups": dict(n_levels=16, log2_hashmap_size=12),
    "split": dict(n_levels=3, n_features_per_level=1, log2_hashmap_size=15),
    "f4": dict(n_levels=5, n_features_per_level=4, log2_hashmap_size=13),
    "f8": dict(n_levels=2, n_features_per_level=8, log2_hashmap_size=12),
    "l32": dict(n_levels=32, log2_hashmap_size=11),
}
BUDGET = thg.SMEM_BYTES - thg.SMEM_RESERVED


@pytest.mark.parametrize("value_bytes", [thg.FWD_VALUE_BYTES,
                                         thg.BWD_VALUE_BYTES])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_parts_cover_every_value_once_within_shared_memory(
        name, value_bytes):
    cfg = tenc.HashGridConfig(**CONFIGS[name])
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    parts = thg.table_parts(cfg, value_bytes)
    covered = np.zeros((L, T), np.int64)
    for l0, nl, j0, nj in parts:
        assert nl >= 1 and nj >= 1
        assert nl * nj * F * value_bytes <= BUDGET <= 227 * 1024
        covered[l0:l0 + nl, j0:j0 + nj] += 1
    assert (covered == 1).all()
    assert len(parts) <= 64                  # csrc/hashgrid.cu kMaxParts
    whole = [p for p in parts if p[3] == T]
    if whole:                                # level groups: even sizes
        assert len(whole) == len(parts)
        sizes = [nl for _, nl, _, _ in parts]
        assert max(sizes) - min(sizes) <= 1
        assert [l0 for l0, _, _, _ in parts] == list(
            np.cumsum([0] + sizes[:-1]))
    else:                                    # one level a part, cut evenly
        assert all(nl == 1 for _, nl, _, _ in parts)
        assert len({nj for _, _, _, nj in parts}) == 1


def test_default_table_parts():
    cfg = tenc.HashGridConfig()
    # #1 stages the whole default table (192 KiB) in one block
    assert thg.table_parts(cfg, thg.FWD_VALUE_BYTES) == [(0, 12, 0, 2048)]
    # #2 holds 8 bytes a value: two groups of 6 levels, 192 KiB each
    assert thg.table_parts(cfg, thg.BWD_VALUE_BYTES) == [(0, 6, 0, 2048),
                                                         (6, 6, 0, 2048)]
    # a table whose single level does not fit #2 is cut into slot ranges
    split = tenc.HashGridConfig(**CONFIGS["split"])
    assert thg.table_parts(split, thg.BWD_VALUE_BYTES)[:2] == [
        (0, 1, 0, 16384), (0, 1, 16384, 16384)]


def _jax_dtable(x, g, cfg_kwargs):
    jcfg = jenc.HashGridConfig(**cfg_kwargs)
    table = jnp.zeros((jcfg.n_levels, jcfg.table_size,
                       jcfg.n_features_per_level), jnp.float32)
    _, vjp = jax.vjp(lambda t: jenc.hash_encode(jnp.asarray(x), t, jcfg),
                     table)
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("blocks", [1, 7, 66])
@pytest.mark.parametrize("g_kind", ["normal", "heavy"])
@pytest.mark.parametrize("name", ["tiny", "default"])
def test_fixed_point_emulation_matches_jax_vjp(name, g_kind, blocks):
    cfg = tenc.HashGridConfig(**CONFIGS[name])
    rng = np.random.default_rng(11)
    x = rng.uniform(size=(3000, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1],
             [0.25, 0.75, 1.0], [1e-7, 1 - 1e-7, 0.5], [0, 1, 0],
             [0.125, 0.375, 0.625]]
    g = rng.standard_normal((3000, cfg.out_dim)).astype(np.float32)
    if g_kind == "heavy":                    # 1 % of the entries × 1e4
        g[rng.uniform(size=g.shape) < 0.01] *= 1e4
    ref = _jax_dtable(x, g, CONFIGS[name])
    out = thg.hash_bwd_fixed_point_plain(torch.from_numpy(x),
                                         torch.from_numpy(g), cfg, blocks)
    # the same tolerance as the f32 kernels: sums in another order, and
    # each update rounded to 2^-s < G · 2^-30
    assert_close_to_max(out.numpy(), ref, 1e-5, "fixed-point dtable")
    plain = thg.hash_bwd_plain(torch.from_numpy(x), torch.from_numpy(g), cfg)
    assert_close_to_max(out.numpy(), plain.numpy(), 1e-5, "vs plain")


def test_fixed_point_exponent_bounds_every_update():
    gmax = np.array([0.0, 1e-45, 1e-40, 1e-30, 2.0 ** -20, 0.37, 1.0,
                     1.0 + 2.0 ** -23, 4.5, 1e4, 2.0 ** 30, 1e30,
                     3.4028235e38], np.float32)
    s = thg.fixed_point_exponent(torch.from_numpy(gmax)).numpy()
    assert s[0] == 0
    for G, e in zip(gmax[1:].astype(np.float64), s[1:]):
        assert -126 <= e <= 126
        assert G * 2.0 ** e < 2.0 ** thg.FIXED_POINT_BITS        # fits
        # the largest such exponent, unless capped at 126
        assert e == 126 or G * 2.0 ** (e + 1) >= 2.0 ** thg.FIXED_POINT_BITS
    # the largest update, rint(w·g·2^s) with w ≤ 1 and |g| ≤ G, fits 2^30
    v = np.round(gmax[1:].astype(np.float64) * 2.0 ** s[1:].astype(
        np.float64))
    assert (v <= 2 ** 30).all()


def _carry_words(updates):
    """Kernel #2's two words for one slot after the atomic adds of
    `updates` (int64), in this order: the uint32 low word, biased by 2^31,
    and the int32 high word, which gets (carry out of the low word) −
    [v < 0] at each add."""
    u = updates % 2 ** 32                           # the uint32 each adds
    running = 2 ** 31 + np.cumsum(u)                # the low word, unwrapped
    carries = np.diff(running // 2 ** 32, prepend=0)
    hi = (carries - (updates < 0)).sum()
    return int(running[-1] % 2 ** 32), int(hi), carries


@pytest.mark.parametrize("sign", [1, -1, 0])
def test_carry_words_hold_the_worst_case_sums(sign):
    # the most a slot takes in one block: 8 updates a point, BWD_MAX_POINTS
    # points, each as large as the exponent allows (|v| < 2^30), in a
    # random order
    n = 8 * thg.BWD_MAX_POINTS
    rng = np.random.default_rng(12)
    mags = 2 ** 30 - rng.integers(1, 2 ** 16, n, dtype=np.int64)
    signs = np.full(n, sign) if sign else rng.choice([-1, 1], n)
    updates = mags * signs
    lo, hi, carries = _carry_words(updates)
    assert set(np.unique(carries)) <= {0, 1}        # one carry an add
    assert abs(hi) <= 2 ** 14 + 1 < 2 ** 31         # the note's bound
    # decoded exactly, as the flush does: hi · 2^32 + lo − 2^31
    assert hi * 2 ** 32 + lo - 2 ** 31 == int(updates.sum())
    # small running sums around 0 (the usual case) never carry
    small = rng.integers(-2 ** 20, 2 ** 20, 1000, dtype=np.int64)
    assert not (_carry_words(small)[2] - (small < 0)).any()


def test_fixed_point_emulation_on_lattice_points_zero_and_non_finite_g():
    cfg = tenc.HashGridConfig(**CONFIGS["tiny"])
    res = cfg.level_resolutions()
    # points on level 0's lattice: one corner of weight 1 each
    pts = np.array(list(itertools.product(range(0, res[0] + 1, 3),
                                          repeat=3)), np.float32) / res[0]
    g = np.random.default_rng(13).standard_normal(
        (len(pts), cfg.out_dim)).astype(np.float32)
    x, gt = torch.from_numpy(pts), torch.from_numpy(g)
    out = thg.hash_bwd_fixed_point_plain(x, gt, cfg, 3)
    assert_close_to_max(out.numpy(), _jax_dtable(pts, g, CONFIGS["tiny"]),
                        1e-5, "lattice points")
    zero = thg.hash_bwd_fixed_point_plain(x, torch.zeros_like(gt), cfg, 3)
    assert not zero.any()
    gt[5, 2] = float("inf")                  # level 1, in chunk 0
    bad = thg.hash_bwd_fixed_point_plain(x, gt, cfg, 3)
    _same_non_finite(bad, thg.hash_bwd_plain(x, gt, cfg))
    assert torch.isfinite(bad[[0, 2, 3]]).all()
    assert 1 <= (~torch.isfinite(bad[1])).sum() <= 8


def _same_non_finite(out, ref):
    """out has NaN, +inf and -inf exactly where ref does, and its finite
    values within 1e-5 of ref's largest."""
    out, ref = torch.as_tensor(out), torch.as_tensor(ref)
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(out), kind(ref)), kind.__name__
    fin = torch.isfinite(ref)
    assert_close_to_max(out[fin].numpy(), ref[fin].numpy(), 1e-5,
                        "finite values")


@pytest.mark.parametrize("blocks", [1, 3, 66])
def test_fixed_point_emulation_spreads_non_finite_g_as_the_jax_vjp(blocks):
    # inf, -inf and NaN in g reach only the slots that their point
    # touches (+inf and -inf on one slot, or a zero weight, give NaN), as
    # in the f32 sums of the plain version and of the JAX package
    cfg = tenc.HashGridConfig(**CONFIGS["tiny"])
    rng = np.random.default_rng(14)
    x = rng.uniform(size=(3000, 3)).astype(np.float32)
    x[0] = [0.5, 0.5, 0.5]                   # on a lattice: zero weights
    g = rng.standard_normal((3000, cfg.out_dim)).astype(np.float32)
    for (p, j), v in {(0, 1): np.inf, (5, 2): -np.inf, (7, 2): np.inf,
                      (100, 7): np.nan, (2000, 3): np.inf}.items():
        g[p, j] = v
    out = thg.hash_bwd_fixed_point_plain(torch.from_numpy(x),
                                         torch.from_numpy(g), cfg, blocks)
    assert torch.isnan(out).any() and torch.isinf(out).any()
    _same_non_finite(out, _jax_dtable(x, g, CONFIGS["tiny"]))
    _same_non_finite(out, thg.hash_bwd_plain(torch.from_numpy(x),
                                             torch.from_numpy(g), cfg))


@pytest.mark.parametrize("n, parts, resident, lo, hi", [
    (262144, 2, 132, thg.BWD_MIN_POINTS, thg.BWD_MAX_POINTS),
    (262144, 1, 132, thg.FWD_MIN_POINTS, 0),
    (10 ** 7, 2, 132, thg.BWD_MIN_POINTS, thg.BWD_MAX_POINTS),
    (70001, 48, 132, thg.BWD_MIN_POINTS, thg.BWD_MAX_POINTS),
    (1, 2, 132, thg.BWD_MIN_POINTS, thg.BWD_MAX_POINTS),
    (0, 1, 132, thg.FWD_MIN_POINTS, 0),
])
def test_grid_blocks_fill_the_card_within_the_point_limits(n, parts,
                                                           resident, lo, hi):
    blocks = thg.grid_blocks(n, parts, resident, lo, hi)
    if n == 0:
        assert blocks == 0
        return
    chunk = -(-n // blocks)
    assert blocks >= 1
    assert hi == 0 or chunk <= hi             # #2's bound on its sums
    # no more blocks than slots on the card, unless the bound needs them;
    # no block smaller than the least, unless n is
    assert blocks <= max(1, resident // parts) or chunk > hi // 2
    assert blocks == 1 or n // blocks >= lo
