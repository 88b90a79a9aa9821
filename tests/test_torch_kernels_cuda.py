"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; whether there is
one is decided inside each test. The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX; the marker is
registered there.)
"""
import numpy as np
import pytest
import torch

from tpunerf_torch.fields.encoding import HashGridConfig
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import attention as at
from tpunerf_torch.kernels import hashgrid as hg
from tpunerf_torch.kernels import occgrid as og
from tpunerf_torch.kernels import rasterize as rz

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close_to_max(actual, expected, rel, what):
    err = (actual.float() - expected.float()).abs().max().item()
    tol = rel * expected.float().abs().max().item()
    assert err <= tol, f"{what}: max error {err:.3e} > {tol:.3e}"


def _max_abs(d) -> float:
    return d.abs().max().item() if d.numel() else 0.0


def _launched(name, fn):
    before = _build.LAUNCHES.get(name, 0)
    out = fn()
    assert _build.LAUNCHES[name] == before + 1, name
    return out


# the tiny field's grid, the default one, one whose table exceeds shared
# memory (#1 in 3 level groups, #2 in 6) and one whose single level does
# not fit #2's 64-bit sums (#2 cuts each level's slots in two)
GRIDS = {
    "tiny": dict(n_levels=4, log2_hashmap_size=12, base_resolution=8,
                 desired_resolution=64),
    "default": {},
    "groups": dict(n_levels=16, log2_hashmap_size=12),
    "split": dict(n_levels=3, n_features_per_level=1, log2_hashmap_size=15),
}


def _hash_inputs(cfg, n, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 3), generator=gen, device=dev)
    x[:4] = torch.tensor([[0.0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5],
                          [1, 0, 1]])[:n]
    table = torch.rand((cfg.n_levels, cfg.table_size,
                        cfg.n_features_per_level), generator=gen,
                       device=dev) * 2 - 1
    g = torch.randn((n, cfg.out_dim), generator=gen, device=dev)
    return x, table, g


@pytest.mark.parametrize("grid", list(GRIDS))
def test_hashgrid_kernels_match_plain(grid):
    dev = _card()
    cfg = HashGridConfig(**GRIDS[grid])
    x, table, g = _hash_inputs(cfg, 70001, 0, dev)
    out = _launched(hg.FWD, lambda: hg.hash_encode_cuda(x, table, cfg))
    dt = _launched(hg.BWD, lambda: hg.hash_bwd_cuda(x, g, cfg))
    # f32 both; the forward sums 8 corners in another order, the backward
    # in fixed point and in another order
    _close_to_max(out, hg.hash_encode_plain(x, table, cfg), 1e-5, "forward")
    _close_to_max(dt, hg.hash_bwd_plain(x, g, cfg), 1e-5, "backward")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_hash_bwd_kernel_equals_its_fixed_point_emulation(grid):
    dev = _card()
    cfg = HashGridConfig(**GRIDS[grid])
    x, _, g = _hash_inputs(cfg, 70001, 1, dev)
    dt = hg.hash_bwd_cuda(x, g, cfg)
    blocks = hg.bwd_blocks(x.shape[0], cfg, x.device)
    # the same f32 products, exact integer sums, the same conversions and
    # the same order of the chunk sums: bit for bit, and so every call
    assert torch.equal(dt, hg.hash_bwd_fixed_point_plain(x, g, cfg, blocks))
    assert torch.equal(dt, hg.hash_bwd_cuda(x, g, cfg))


@pytest.mark.parametrize("n", [0, 1, 255])
def test_hashgrid_kernels_at_ragged_and_empty_n(n):
    dev = _card()
    cfg = HashGridConfig()
    x, table, g = _hash_inputs(cfg, n, 2, dev)
    out = hg.hash_encode_cuda(x, table, cfg)
    dt = hg.hash_bwd_cuda(x, g, cfg)
    assert out.shape == (n, cfg.out_dim) and dt.shape == table.shape
    ref = hg.hash_bwd_plain(x, g, cfg)
    if n == 0:
        assert torch.equal(dt, ref)        # all zeros, written by #2
        return
    _close_to_max(out, hg.hash_encode_plain(x, table, cfg), 1e-5, "forward")
    _close_to_max(dt, ref, 1e-5, "backward")


@pytest.mark.parametrize("grid", ["tiny", "default"])
def test_hashgrid_kernels_on_the_cube_faces_and_corners(grid):
    dev = _card()
    cfg = HashGridConfig(**GRIDS[grid])
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((20000, 3), generator=gen, device=dev)
    # every point on a face, a third of them on an edge or a corner
    axis = torch.randint(0, 3, (20000,), generator=gen, device=dev)
    side = torch.randint(0, 2, (20000,), generator=gen, device=dev).float()
    x[torch.arange(20000, device=dev), axis] = side
    rows = torch.arange(0, 20000, 3, device=dev)
    x[rows, (axis[rows] + 1) % 3] = 1.0
    x[:8] = torch.tensor([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)],
                         dtype=torch.float32)
    _, table, g = _hash_inputs(cfg, 20000, 4, dev)
    _close_to_max(hg.hash_encode_cuda(x, table, cfg),
                  hg.hash_encode_plain(x, table, cfg), 1e-5, "forward")
    _close_to_max(hg.hash_bwd_cuda(x, g, cfg), hg.hash_bwd_plain(x, g, cfg),
                  1e-5, "backward")


def test_hash_bwd_heavy_tailed_and_non_finite_g():
    dev = _card()
    cfg = HashGridConfig()
    x, _, g = _hash_inputs(cfg, 262144, 5, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    heavy = torch.rand(g.shape, generator=gen, device=dev) < 0.01
    g = torch.where(heavy, g * 1e4, g)
    _close_to_max(hg.hash_bwd_cuda(x, g, cfg), hg.hash_bwd_plain(x, g, cfg),
                  1e-5, "heavy-tailed g")
    # inf, -inf and NaN in g reach only the slots that their point
    # touches, as in the plain version's f32 sums; the rest is finite
    x[0] = 0.5                  # on the even levels' lattices: zero weights
    for (p, j), v in {(0, 1): float("inf"), (1000, 5): float("inf"),
                      (2000, 5): -float("inf"), (3000, 16): float("nan")
                      }.items():
        g[p, j] = v
    dt = hg.hash_bwd_cuda(x, g, cfg)
    blocks = hg.bwd_blocks(x.shape[0], cfg, x.device)
    emu = hg.hash_bwd_fixed_point_plain(x, g, cfg, blocks)
    plain = hg.hash_bwd_plain(x, g, cfg)
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(dt), kind(emu)), kind.__name__
        assert torch.equal(kind(dt), kind(plain)), kind.__name__
    fin = torch.isfinite(plain)
    assert torch.isfinite(dt[3]).all() and not fin.all()
    assert torch.equal(dt[fin], emu[fin])
    _close_to_max(dt[fin], plain[fin], 1e-5, "finite slots")


def test_hashgrid_graph_replay_equals_eager():
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    dev = _card()
    cfg = HashGridConfig()
    x, table, g = _hash_inputs(cfg, 70001, 7, dev)
    out, dt = hg.hash_encode_cuda(x, table, cfg), hg.hash_bwd_cuda(x, g, cfg)
    _build.reset_launches()
    ms, gout = ex.graph_ms(lambda: hg.hash_encode_cuda(x, table, cfg), 3)
    assert ms > 0 and torch.equal(gout, out)
    ms, gdt = ex.graph_ms(lambda: hg.hash_bwd_cuda(x, g, cfg), 3)
    assert ms > 0 and torch.equal(gdt, dt)
    assert _build.LAUNCHES[hg.FWD] == ex.WARMUP + 2 * 3
    assert _build.LAUNCHES[hg.BWD] == ex.WARMUP + 2 * 3


def test_level_per_block_forward_matches_plain():
    dev = _card()
    cfg = HashGridConfig()
    x, table, _ = _hash_inputs(cfg, 70001, 8, dev)
    out = _launched(hg.FWD_LEVEL,
                    lambda: hg.hash_encode_level_cuda(x, table, cfg))
    _close_to_max(out, hg.hash_encode_plain(x, table, cfg), 1e-5,
                  "level-per-block forward")


@pytest.mark.parametrize("ppb", [2048, 8192])
@pytest.mark.parametrize("mode", ["full", "global", "addr", "accum"])
def test_hash_bwd_variants_match_plain(mode, ppb):
    dev = _card()
    cfg = HashGridConfig()
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((70001, 3), generator=gen, device=dev)
    g = torch.randn((x.shape[0], cfg.out_dim), generator=gen, device=dev)
    out = _launched(hg.VARIANT,
                    lambda: hg.hash_bwd_variant(x, g, cfg, mode, ppb))
    ref = hg.hash_bwd_variant_plain(x, g, cfg, mode, ppb)
    # f32 sums in another order (atomics: run-dependent): 1e-5 of max;
    # addr's per-level Σ idx is exact
    if mode == "addr":
        assert torch.equal(out[0], ref[0])
        _close_to_max(out[1], ref[1], 1e-5, "addr Σ w·g")
    else:
        _close_to_max(out, ref, 1e-5, mode)


def test_hash_bwd_variant_full_matches_the_baseline_kernel():
    dev = _card()
    cfg = HashGridConfig()
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((262144, 3), generator=gen, device=dev)
    g = torch.randn((x.shape[0], cfg.out_dim), generator=gen, device=dev)
    full = _launched(hg.VARIANT, lambda: hg.hash_bwd_variant_cuda(
        x, g, cfg, "full", 8192))
    _close_to_max(full, hg.hash_bwd_cuda(x, g, cfg), 1e-5, "full vs #2")


@pytest.mark.parametrize("grid", ["default", "split", "groups"])
def test_hash_bwd_split_modes_equal_plain(grid):
    """Every part of #2 on #2's grid, at 0.5x ... 4x the resident blocks,
    bit for bit against its plain version; full at 1x against #2."""
    dev = _card()
    cfg = HashGridConfig(**GRIDS[grid])
    x, _, g = _hash_inputs(cfg, 70001, 21, dev)
    resident = hg._resident(hg.BWD, cfg, dev.index or 0)
    for factor in hg.SPLIT_FACTORS:
        blocks = hg.split_blocks(x.shape[0], cfg, factor, resident)
        gmax = _launched(hg.SPLIT, lambda: hg.hash_bwd_split(
            x, g, cfg, "gmax", blocks))
        assert torch.equal(gmax, hg.hash_bwd_split_plain(x, g, cfg, "gmax",
                                                         blocks))
        partial = torch.randn(hg._split_partial_shape(cfg, blocks),
                              device=dev)
        for mode in ("full", "addr", "accum", "reduce"):
            out = _launched(hg.SPLIT, lambda: hg.hash_bwd_split(
                x, g, cfg, mode, blocks, gmax, partial))
            ref = hg.hash_bwd_split_plain(x, g, cfg, mode, blocks, gmax,
                                          partial)
            if mode == "addr":
                assert torch.equal(out[0], ref[0]) and torch.equal(out[1],
                                                                   ref[1])
            else:
                assert torch.equal(out, ref), (mode, factor)
        if factor == 1:
            assert blocks == hg.bwd_blocks(x.shape[0], cfg, dev)
            assert torch.equal(hg.hash_bwd_split(x, g, cfg, "full", blocks),
                               hg.hash_bwd_cuda(x, g, cfg))


def test_hash_bwd_split_at_full_width_and_non_finite_g():
    """full at 1x is #2 bit for bit at the main path's N; with inf and NaN
    in g, gmax, addr and full still equal their plain versions."""
    dev = _card()
    cfg = HashGridConfig()
    x, _, g = _hash_inputs(cfg, 262144, 22, dev)
    blocks = hg.bwd_blocks(x.shape[0], cfg, dev)
    assert torch.equal(hg.hash_bwd_split(x, g, cfg, "full", blocks),
                       hg.hash_bwd_cuda(x, g, cfg))
    g = g.clone()
    g[5, 3], g[70000, 0], g[200000, 23] = float("inf"), float("nan"), -1e30
    for mode in ("gmax", "addr"):
        out = hg.hash_bwd_split(x, g, cfg, mode, blocks)
        ref = hg.hash_bwd_split_plain(x, g, cfg, mode, blocks)
        for a, b in zip(out, ref) if mode == "addr" else [(out, ref)]:
            assert torch.equal(a, b), mode
    # full: NaN where plain's sums are, the same bits elsewhere
    out = hg.hash_bwd_split(x, g, cfg, "full", blocks)
    ref = hg.hash_bwd_split_plain(x, g, cfg, "full", blocks)
    nan = torch.isnan(ref)
    assert nan.any() and torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


def test_experiment_graph_counts_the_kernels_that_run():
    from tpunerf_torch.scripts import exp_hash_bwd as ex
    dev = _card()
    x, g = ex.make_inputs(70001, 5, dev)
    _build.reset_launches()
    ms, out = ex.graph_ms(
        lambda: hg.hash_bwd_variant_cuda(x, g, ex.CFG, "full", 4096), 4)
    # the warm-ups and two replays of 4 calls ran; the capture ran none
    assert _build.LAUNCHES[hg.VARIANT] == ex.WARMUP + 2 * 4
    assert ms > 0
    _close_to_max(out, hg.hash_bwd_plain(x, g, ex.CFG), 1e-5, "graph")


def test_hash_encode_autograd_runs_the_kernels():
    dev = _card()
    cfg = HashGridConfig()
    x = torch.rand((4096, 3), device=dev)
    table = torch.randn((12, 2048, 2), device=dev, requires_grad=True)
    before = dict(_build.LAUNCHES)
    hg.hash_encode_auto(x, table, cfg).square().sum().backward()
    assert _build.LAUNCHES[hg.FWD] == before.get(hg.FWD, 0) + 1
    assert _build.LAUNCHES[hg.BWD] == before.get(hg.BWD, 0) + 1
    assert table.grad is not None and torch.isfinite(table.grad).all()


def _occ_inputs(dev, n, bound, seed):
    """Packed words of a random 128³ grid and n samples over [−1.2, 1.2]·bound,
    every 32nd on cell walls, where rounding decides the cell."""
    G = 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.rand((G ** 3,), generator=gen, device=dev) * 0.02
    packed = og.pack_bits(grid > 0.01)
    x = (torch.rand((n, 3), generator=gen, device=dev) * 2.4 - 1.2) * bound
    walls = (torch.randint(0, G + 1, (n, 3), generator=gen, device=dev)
             .float() * (2.0 / G) - 1.0) * bound
    x[::32] = walls[::32]
    return G, packed, x


def test_occupancy_lookup_matches_plain_exactly():
    dev = _card()
    G, packed, x = _occ_inputs(dev, 4096 * 128, 1.0, 1)
    x = x.reshape(1, 4096, 128, 3)
    out = _launched(og.LOOKUP,
                    lambda: og.occupancy_lookup_cuda(x, packed, G, 1.0))
    assert out.shape == x.shape[:-1] and out.dtype == torch.bool
    assert torch.equal(out, og.occupancy_lookup_plain(x, packed, G, 1.0))
    assert torch.equal(out, og.occupancy_lookup_scalar_cuda(x, packed, G,
                                                            1.0))


@pytest.mark.parametrize("case", ["ragged", "offset view", "bound 0.7",
                                  "bound 2.0", "tiny"])
def test_occupancy_lookup_paths_match_plain_exactly(case):
    """The 4-wide path with a ragged tail, the one-sample path of a view
    that does not start on 16 bytes, the quotients of a bound that is no
    power of two, the products of one that is, a launch of 3 samples."""
    dev = _card()
    bound = float(case.split()[1]) if case.startswith("bound") else 1.0
    n = {"ragged": 4096 * 128 + 3, "tiny": 3}.get(case, 100003)
    G, packed, x = _occ_inputs(dev, n + 1, bound, 2)
    x = x[1:] if case == "offset view" else x[:n]
    assert (x.data_ptr() % 16 == 0) == (case != "offset view")
    out = _launched(og.LOOKUP,
                    lambda: og.occupancy_lookup_cuda(x, packed, G, bound))
    ref = og.occupancy_lookup_plain(x, packed, G, bound)
    assert torch.equal(out, ref)
    assert case == "tiny" or (ref.any() and not ref.all())
    assert torch.equal(out, og.occupancy_lookup_scalar_cuda(x, packed, G,
                                                            bound))


def test_occupancy_lookup_graph_replay_equals_eager():
    dev = _card()
    G, packed, x = _occ_inputs(dev, 4096 * 128, 1.0, 3)
    eager = og.occupancy_lookup_cuda(x, packed, G, 1.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        og.occupancy_lookup_cuda(x, packed, G, 1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = og.occupancy_lookup_cuda(x, packed, G, 1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    # (B, N, H, D) projections viewed as (B, H, N, D), as the UNet passes them
    q, k, v = (torch.randn((2, 4096, 8, 40), generator=gen, device=dev)
               .to(dt).permute(0, 2, 1, 3) for _ in range(3))
    out = _launched(at.ATTN, lambda: at.attention_cuda(q, k, v, 40 ** -0.5))
    assert out.dtype == dt and out.shape == q.shape
    # f32: another summation order; bf16: the plain path rounds P to bf16
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close_to_max(out, at.attention_plain(q, k, v, 40 ** -0.5), rel,
                  "attention")


def test_attention_kernel_matches_plain_at_the_depth_unets_cfg_batch():
    """Config #5's UNet: CFG over B = 2 views gives q, k, v (4, 8, 4096,
    40) bf16 at its 64² self-attention."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn((4, 4096, 8, 40), generator=gen, device=dev)
               .to(torch.bfloat16).permute(0, 2, 1, 3) for _ in range(3))
    out = _launched(at.ATTN, lambda: at.attention_cuda(q, k, v, 40 ** -0.5))
    assert out.dtype == torch.bfloat16 and out.shape == (4, 8, 4096, 40)
    _close_to_max(out, at.attention_plain(q, k, v, 40 ** -0.5), 2e-2,
                  "attention at B = 4")


def _bf16_qkv(dev, B, H, N, D, layout, seed):
    """bf16 q, k, v (B, H, N, D): views of (B, N, H, D) projections, as the
    UNet passes them, or contiguous."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, N, H, D) if layout == "strided" else (B, H, N, D)
    out = []
    for _ in range(3):
        t = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        out.append(t.permute(0, 2, 1, 3) if layout == "strided" else t)
    return out


@pytest.mark.parametrize("n,d,layout", [
    (4096, 40, "strided"), (4096 + 77, 40, "strided"),
    (1000, 40, "contiguous"), (4096, 8, "strided"), (1000, 8, "contiguous"),
    (4096 + 77, 64, "strided"), (4096, 64, "contiguous"),
    (1000, 128, "strided"), (4096 + 77, 128, "contiguous")])
def test_attention_bf16_error_against_f32(n, d, layout):
    """The kernel's error against f32 attention on the same bf16 inputs is
    at most twice the plain bf16 path's, plus 1e-6: a skipped or doubled
    128-key tile would be far above it."""
    dev = _card()
    q, k, v = _bf16_qkv(dev, 2, 3, n, d, layout, seed=n + d)
    scale = d ** -0.5
    out = _launched(at.ATTN, lambda: at.attention_cuda(q, k, v, scale))
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = at.attention_plain(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    plain = (at.attention_plain(q, k, v, scale).float() - ref).abs().max()
    assert err <= 2 * plain.item() + 1e-6, (err, plain.item())


@pytest.mark.parametrize("n", [4096, 4096 + 77, 1000])
def test_attention_bf16_uniform_is_mean_of_v(n):
    """q = 0: every logit is 0, so each output row is the mean of v over all
    N keys; a lost tile, or a padded key of the ragged tile that is not
    masked, moves the mean."""
    dev = _card()
    _, k, v = _bf16_qkv(dev, 1, 2, n, 40, "strided", seed=5)
    q = torch.zeros_like(k)
    out = at.attention_cuda(q, k, v, 40 ** -0.5).float()
    mean = v.float().mean(dim=2, keepdim=True).expand_as(out)
    # P = 1 is exact in bf16; the output's rounding to bf16 is 2^-9
    assert ((out - mean).abs() <= 2 ** -8 * mean.abs() + 1e-6).all()


def test_attention_bf16_routes_each_query_to_its_key():
    """One dominant key per routed query, in the first, a middle and the
    last (ragged) key tile: the output row is that key's v row."""
    dev = _card()
    n, d = 4096 + 77, 40
    _, _, v = _bf16_qkv(dev, 1, 1, n, d, "strided", seed=6)
    gen = torch.Generator(device=dev).manual_seed(7)
    k = (torch.randn((1, 1, n, d), generator=gen, device=dev) * 0.01
         ).to(torch.bfloat16)
    q = torch.zeros_like(k)
    # query -> key; channel c holds the pair's logit 16 * 16 / sqrt(40)
    routes = {0: n - 1, 130: 2000, 2100: 5, n - 1: 1500, 64: 4100}
    for c, (qi, ki) in enumerate(routes.items()):
        k[0, 0, ki] = 0
        k[0, 0, ki, c] = 16
        q[0, 0, qi, c] = 16
    out = at.attention_cuda(q, k, v, d ** -0.5).float()
    for qi, ki in routes.items():
        want = v[0, 0, ki].float()
        got = out[0, 0, qi]
        assert ((got - want).abs() <= 2 ** -8 * want.abs() + 1e-3).all(), \
            (qi, ki)


def test_attention_bf16_refuses_what_it_cannot_copy():
    dev = _card()
    q, k, v = _bf16_qkv(dev, 1, 2, 256, 12, "strided", seed=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        at.attention_cuda(q, k, v, 12 ** -0.5)
    buf = torch.zeros(2 * 256 * 40 + 1, dtype=torch.bfloat16, device=dev)
    off = buf[1:].view(1, 2, 256, 40)   # 2 bytes off 16-byte alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.attention_cuda(off, off, off, 40 ** -0.5)


def test_attention_bf16_graph_replay_equals_eager():
    dev = _card()
    q, k, v = _bf16_qkv(dev, 2, 8, 4096, 40, "strided", seed=9)
    eager = at.attention_cuda(q, k, v, 40 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        at.attention_cuda(q, k, v, 40 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = at.attention_cuda(q, k, v, 40 ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _projected_sphere(dev, n_views, seed):
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    views = rand_poses(n_views, ViewSamplerConfig(), dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    fv_cam, fv_img, _ = mrender._project(
        mesh.vertices, mesh.faces, views.theta, views.phi, views.radius,
        mrender.CameraSpec(look_at_height=0.25))
    valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
    return fv_img, fv_cam[..., 2], valid


@pytest.mark.parametrize("size", [64, 100])
def test_dense_selection_kernel_matches_plain_exactly(size):
    dev = _card()
    fv_img, fv_z, valid = _projected_sphere(dev, 3, 3)
    # duplicate faces: exact z ties everywhere they are visible
    fv_img = torch.cat([fv_img, fv_img[:, :500]], dim=1)
    fv_z = torch.cat([fv_z, fv_z[:, :500]], dim=1)
    valid = torch.cat([valid, valid[:, :500]], dim=1)
    valid[:, 7] = valid[:, 3968 + 7] = False    # a face and its copy
    rows = rz._face_rows(fv_img, fv_z, valid)
    pix = rz.pixel_grid_ndc(size, size, dev)   # 100² is no multiple of 64
    out = _launched(rz.DENSE, lambda: rz.select_faces_dense(rows, pix))
    ref = rz.select_faces_dense_plain(rows, pix)
    assert out.dtype == torch.int32 and out.shape == (3, size * size)
    assert torch.equal(out, ref)               # 0 mismatches
    assert (ref >= 0).any() and (ref < 0).any() and not (ref == 7).any()
    assert not (ref >= 3968).any()             # a copy never beats its twin


def test_binned_selection_kernel_matches_plain_and_dense_exactly():
    dev = _card()
    fv_img, fv_z, valid = _projected_sphere(dev, 2, 4)
    H = W = 512     # 2-row bands: the sphere's bins stay under K = 256
    pix = rz.pixel_grid_ndc(H, W, dev)
    before = dict(_build.LAUNCHES)
    fid = rz._select_faces_batched(pix, fv_img, fv_z, valid, H, W)
    # both kernels launched, the dense one behind its shut gate
    assert _build.LAUNCHES[rz.BINNED] == before.get(rz.BINNED, 0) + 1
    assert _build.LAUNCHES[rz.DENSE] == before.get(rz.DENSE, 0) + 1
    rows = rz._face_rows(fv_img, fv_z, valid)
    assert torch.equal(fid, rz.select_faces_dense_plain(rows, pix))
    assert torch.equal(fid, rz.select_faces_dense(rows, pix))


def _eval_orbit(dev, n_views):
    """The sphere under `n_views` views of the eval orbit (wide camera)."""
    from tpunerf_torch.core.views import ViewSamplerConfig, circle_poses
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    views = circle_poses(n_views, ViewSamplerConfig(), dev)
    fv_cam, fv_img, _ = mrender._project(
        mesh.vertices, mesh.faces, views.theta, views.phi, views.radius,
        mrender.CameraSpec(look_at_height=0.25))
    valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
    return fv_img, fv_cam[..., 2], valid


def _binned_rows(fv_img, fv_z, valid, H, W):
    B, F = valid.shape
    ylo, yhi = rz._band_ranges(H, W, -(-H * W // 1024), fv_img.device)
    ids, maxc = rz._bin_faces(fv_img, valid, ylo, yhi, rz._BIN_K)
    assert int(maxc) <= rz._BIN_K
    rows = torch.cat([rz._face_rows(fv_img, fv_z, valid),
                      rz._filler_row(fv_img.device).expand(B, 1, 12)],
                     dim=1).contiguous()
    return rows, ids


@pytest.mark.parametrize("case", ["64", "100", "512 fallback"])
def test_culled_dense_selection_equals_the_sweep_and_plain(case):
    dev = _card()
    size = int(case.split()[0])
    if size == 512:            # the eval chunk's 5 views, as on overflow
        fv_img, fv_z, valid = _eval_orbit(dev, 5)
    else:
        fv_img, fv_z, valid = _projected_sphere(dev, 3, 12)
        # exact z ties: a copy of the first 500 faces
        fv_img = torch.cat([fv_img, fv_img[:, :500]], dim=1)
        fv_z = torch.cat([fv_z, fv_z[:, :500]], dim=1)
        valid = torch.cat([valid, valid[:, :500]], dim=1)
    rows = rz._face_rows(fv_img, fv_z, valid).contiguous()
    pix = rz.pixel_grid_ndc(size, size, dev)   # 100 is no multiple of 8
    out = _launched(rz.DENSE, lambda: rz.select_faces_dense(rows, pix, size))
    old = _launched(rz.DENSE_SWEEP,
                    lambda: rz.select_faces_dense_sweep_cuda(rows, pix))
    assert torch.equal(out, old)
    assert torch.equal(out, rz.select_faces_dense_cuda(rows, pix, 0))
    assert torch.equal(out, rz.select_faces_dense_plain(rows, pix))
    assert (out >= 0).any() and (out < 0).any()


@pytest.mark.parametrize("views", [5, 1])
def test_culled_binned_selection_equals_the_sweep_and_plain(views):
    dev = _card()
    H = W = 512
    fv_img, fv_z, valid = _eval_orbit(dev, views)
    rows, ids = _binned_rows(fv_img, fv_z, valid, H, W)
    pix = rz.pixel_grid_ndc(H, W, dev)
    out = _launched(rz.BINNED,
                    lambda: rz.select_faces_binned(rows, ids, pix, W))
    old = _launched(rz.BINNED_SWEEP,
                    lambda: rz.select_faces_binned_sweep_cuda(rows, ids, pix))
    assert torch.equal(out, old)
    assert torch.equal(out, rz.select_faces_binned_cuda(rows, ids, pix, 0))
    assert torch.equal(out, rz.select_faces_binned_plain(rows, ids, pix))
    # and through the scene's entry: the binned kernel, the fallback's gate
    # shut (its launch returns at once)
    before = dict(_build.LAUNCHES)
    fid = rz._select_faces_batched(pix, fv_img, fv_z, valid, H, W)
    assert _build.LAUNCHES[rz.BINNED] == before[rz.BINNED] + 1
    assert _build.LAUNCHES[rz.DENSE] == before.get(rz.DENSE, 0) + 1
    assert torch.equal(fid, rz.select_faces_dense(rows[:, :-1].contiguous(),
                                                  pix, W))


def _hard_rows(dev, seed, n=400):
    """Face rows with NaN, ±inf, ±0 coefficients, the filler, degenerate
    faces, coordinates up to 1e20, and vertices on pixel centres of the
    64² grid with coplanar copies (edges and exact ties)."""
    rng = np.random.default_rng(seed)
    fv = (rng.uniform(-1.1, 1.1, (n, 1, 2))
          + rng.uniform(-0.2, 0.2, (n, 3, 2))).astype(np.float32)
    fv[:40] = ((rng.integers(0, 64, (40, 3, 2)) + 0.5) / 32 - 1.0)
    fv[40:60] = fv[:20]                                   # coplanar copies
    fv[60:70, 2] = fv[60:70, 1]                           # zero area
    fv[70:100] *= 10.0 ** rng.integers(0, 21, (30, 1, 1))
    z = rng.uniform(-3.0, -1.0, (n, 3)).astype(np.float32)
    z[40:60] = z[:20]
    rows = rz._face_rows(torch.from_numpy(fv)[None],
                         torch.from_numpy(z)[None],
                         torch.ones((1, n), dtype=torch.bool))[0].numpy()
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    for k in range(100, 180):
        idx = rng.choice(12, rng.integers(1, 4), replace=False)
        rows[k, idx] = rng.choice(vals, len(idx))
    return torch.from_numpy(rows)[None].to(dev).contiguous()


def test_culled_selection_on_nan_inf_and_degenerate_rows():
    dev = _card()
    rows = _hard_rows(dev, 13)
    pix = rz.pixel_grid_ndc(64, 64, dev)
    ref = rz.select_faces_dense_plain(rows, pix)
    for width in (64, 0):
        assert torch.equal(rz.select_faces_dense(rows, pix, width), ref)
    assert torch.equal(rz.select_faces_dense_sweep_cuda(rows, pix), ref)
    assert (ref >= 0).any()
    # banded: every face in every band's bin, the filler after them
    F = rows.shape[1]
    frows = torch.cat([rows, rz._filler_row(dev).expand(1, 1, 12)],
                      dim=1).contiguous()
    ids = torch.arange(512, dtype=torch.int32, device=dev).clamp(max=F)
    ids = ids.expand(1, 4, -1).contiguous()
    bref = rz.select_faces_binned_plain(frows, ids, pix)
    for width in (64, 0):
        assert torch.equal(rz.select_faces_binned(frows, ids, pix, width),
                           bref)
    assert torch.equal(rz.select_faces_binned_sweep_cuda(frows, ids, pix),
                       bref)


def test_culled_selection_graph_replay_equals_eager():
    dev = _card()
    fv_img, fv_z, valid = _eval_orbit(dev, 5)
    rows, ids = _binned_rows(fv_img, fv_z, valid, 512, 512)
    pix512 = rz.pixel_grid_ndc(512, 512, dev)
    drows = rz._face_rows(*_projected_sphere(dev, 1, 14)).contiguous()
    pix64 = rz.pixel_grid_ndc(64, 64, dev)
    calls = {rz.DENSE: lambda: rz.select_faces_dense(drows, pix64, 64),
             rz.BINNED: lambda: rz.select_faces_binned(rows, ids, pix512,
                                                       512)}
    for name, fn in calls.items():
        eager = fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        before = _build.LAUNCHES[name]
        _build.CAPTURED.clear()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        # the capture ran nothing: it counts as captured, not launched
        assert _build.LAUNCHES[name] == before and _build.CAPTURED[name] == 1
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), name


def _soft_inputs(dev, size, n_views, seed, wide=True):
    """Soft rows of the projected sphere (the wide camera sees its rim),
    with a degenerate face, a face outside the view and a padded row."""
    fv_img, _, _ = _projected_sphere(dev, n_views, seed)
    fv_img = fv_img.clone()
    fv_img[:, 5, 2] = fv_img[:, 5, 1]
    fv_img[:, 6] += 3.0
    rows = rz._soft_rows(fv_img).contiguous()
    rows[:, 9, 15] = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    pix = rz.pixel_grid_ndc(size, size, dev)
    return fv_img, rows, pix, gen


@pytest.mark.parametrize("size", [64, 50])
def test_dense_soft_kernels_match_plain(size):
    dev = _card()
    _, rows, pix, gen = _soft_inputs(dev, size, 2, 5)
    P = pix.shape[0]                           # 50² is no multiple of 32
    prod = _launched(rz.SOFT_FWD_DENSE,
                     lambda: rz.soft_prod_dense(rows, pix, 1e-4))
    ref = rz.soft_prod_dense_plain(rows, pix, 1e-4)
    assert prod.shape == (2, P)
    # a product of the same factors in eight slices: rounding only
    assert (prod - ref).abs().max().item() <= 5e-6
    assert ((ref > 0.01) & (ref < 0.99)).any() and (ref == 0).any()
    g = torch.randn((2, P), generator=gen, device=dev)
    grad = _launched(rz.SOFT_BWD_DENSE,
                     lambda: rz.soft_grad_dense(rows, pix, g, prod, 1e-4))
    # each backward with its own forward's prod; sums in another order
    _close_to_max(grad, rz.soft_grad_dense_plain(rows, pix, g, ref, 1e-4),
                  2e-5, "dense soft backward")
    assert torch.isfinite(grad).all()
    assert grad[:, 6].abs().max() == 0 and grad[:, 9].abs().max() == 0
    # deterministic: no atomics
    assert torch.equal(grad, rz.soft_grad_dense(rows, pix, g, prod, 1e-4))


def test_binned_soft_kernels_match_plain_and_dense():
    dev = _card()
    H = W = 512
    fv_img, _, pix, gen = _soft_inputs(dev, H, 2, 6)
    B, F = fv_img.shape[:2]
    K = rz._SOFT_BIN_K
    ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    if int(maxc) > K:                          # bins that hold, whatever K
        K = -(-int(maxc) // 128) * 128
        ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    rows = rz._with_filler(rz._soft_rows(fv_img)).contiguous()
    prod = _launched(rz.SOFT_FWD_BINNED,
                     lambda: rz.soft_prod_binned(rows, ids, pix, 1e-4))
    ref = rz.soft_prod_binned_plain(rows, ids, pix, 1e-4)
    assert (prod - ref).abs().max().item() <= 5e-6
    g = torch.randn(prod.shape, generator=gen, device=dev)
    grad = _launched(rz.SOFT_BWD_BINNED, lambda: rz.soft_grad_binned(
        rows, ids, pix, g, prod, 1e-4))
    plain = rz._slots_to_faces(
        rz.soft_grad_binned_plain(rows, ids, pix, g, ref, 1e-4), ids, F)
    _close_to_max(grad, plain, 2e-5, "binned soft backward")
    # against the dense kernels: the bins drop tails below 1e-12
    dense_rows = rows[:, :F].contiguous()
    dense = rz.soft_prod_dense(dense_rows, pix, 1e-4)
    assert (prod.reshape(B, -1) - dense).abs().max().item() <= 1e-5
    _close_to_max(grad,
                  rz.soft_grad_dense(dense_rows, pix,
                                     g.reshape(B, -1).contiguous(), dense,
                                     1e-4), 1e-4, "binned vs dense backward")


def _binned_bwd_inputs(dev, n_views, seed, cotangent="random"):
    """512² bins of the projected sphere (widened where K overflows), rows
    with the filler, the kernel's prod and a cotangent: N(0, 1), or the
    silhouette loss's 2·mask, which with prod leaves only the rim live."""
    H = W = 512
    fv_img, _, pix, gen = _soft_inputs(dev, H, n_views, seed)
    K = rz._SOFT_BIN_K
    ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    if int(maxc) > K:
        K = -(-int(maxc) // 128) * 128
        ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    rows = rz._with_filler(rz._soft_rows(fv_img)).contiguous()
    prod = rz.soft_prod_binned_cuda(rows, ids, pix, 1e-4, W)
    if cotangent == "random":
        g = torch.randn(prod.shape, generator=gen, device=dev)
    else:
        g = 2.0 * (1.0 - prod)
    return rows, ids, pix, g, prod


@pytest.mark.parametrize("case", ["512 random", "0 random",
                                  "512 silhouette"])
def test_culled_binned_soft_backward_matches_plain_and_the_sweep(case):
    dev = _card()
    width, cotangent = int(case.split()[0]), case.split()[1]
    rows, ids, pix, g, prod = _binned_bwd_inputs(dev, 2, 12, cotangent)
    B, F = rows.shape[0], rows.shape[1] - 1
    grad = _launched(rz.SOFT_BWD_BINNED, lambda: rz.soft_grad_binned(
        rows, ids, pix, g, prod, 1e-4, width))
    assert grad.shape == (B, F, 6) and torch.isfinite(grad).all()
    plain = rz._slots_to_faces(
        rz.soft_grad_binned_plain(rows, ids, pix, g, prod, 1e-4), ids, F)
    assert plain.abs().max() > 0
    _close_to_max(grad, plain, 2e-5, "culled binned backward vs plain")
    sweep = _launched(rz.SOFT_BWD_BINNED_SWEEP,
                      lambda: rz.soft_grad_binned_sweep_cuda(
                          rows, ids, pix, g, prod, 1e-4))
    _close_to_max(grad, sweep, 2e-5, "culled vs the first binned design")
    dense_rows = rows[:, :F].contiguous()
    gd, pd = (a.reshape(B, -1).contiguous() for a in (g, prod))
    _close_to_max(grad, rz.soft_grad_dense(dense_rows, pix, gd, pd, 1e-4),
                  1e-4, "culled binned vs dense backward")
    # fixed orders: two calls give the same bits
    assert torch.equal(grad, rz.soft_grad_binned(rows, ids, pix, g, prod,
                                                 1e-4, width))


def test_binned_soft_face_sum_equals_its_twin():
    """The face sum against `_slots_to_faces_ordered` on the kernel's own
    slot rows (those of bands with no live pixel are never written: zero
    there), bit for bit; filler slots take no part."""
    dev = _card()
    rows, ids, pix, g, prod = _binned_bwd_inputs(dev, 2, 13, "silhouette")
    F = rows.shape[1] - 1
    slot_rows, slot_of, span, live = rz._soft_bwd_binned_rows(
        rows, ids, pix, g, prod, 1e-4, 512)
    faces = rz._soft_bwd_faces(rows, ids, slot_rows, slot_of, span, live)
    # each band's row: its live halves' rows, half 0 + half 1
    halves = [torch.where(((live[:, :, h, None] != 0) & (ids < F))[..., None],
                          slot_rows[:, :, h], 0.0) for h in (0, 1)]
    assert torch.equal(faces, rz._slots_to_faces_ordered(
        halves[0] + halves[1], ids, F))
    assert (live == 0).any() and (live != 0).any()
    # the span is each face's first and last band
    held = torch.zeros(ids.shape[:2] + (F + 1,), dtype=torch.bool,
                       device=dev).scatter_(2, ids.long(), True)[..., :F]
    band = torch.arange(ids.shape[1], device=dev)[None, :, None]
    big = torch.full_like(band, 1 << 30)
    first = torch.where(held, band, big).amin(1)
    last = torch.where(held, band, -1).amax(1)
    assert torch.equal(span[1].long(), last)
    assert torch.equal(span[0].long()[last >= 0], first[last >= 0])


@pytest.mark.parametrize("k", [0, 1, 2])
def test_culled_binned_soft_backward_gives_nan_where_plain_does(k):
    """A face with a NaN or an infinite vertex: plain gives its gradient NaN
    wherever a band holds it, and finite gradients to the other faces where
    prod is finite; the kernel the same, within 2e-5 elsewhere."""
    dev = _card()
    rows, pix = _non_finite_rows(dev, k, 14)
    B, F = rows.shape[:2]
    nb = 4
    ids = torch.cat([torch.arange(F, dtype=torch.int32, device=dev),
                     torch.full((16,), F, dtype=torch.int32, device=dev)]
                    ).expand(B, nb, -1).contiguous()
    clean = torch.cat([rows[:, :200], rows[:, 201:]], dim=1).contiguous()
    prod = rz._band_maps(rz.soft_prod_dense_plain(clean, pix, 1e-4), nb)
    g = torch.randn(prod.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(k))
    g[:, 2] = 0.0                                # a band with no live pixel
    rows_f = rz._with_filler(rows).contiguous()
    grad = rz.soft_grad_binned(rows_f, ids, pix, g, prod, 1e-4, 64)
    plain = rz._slots_to_faces(
        rz.soft_grad_binned_plain(rows_f, ids, pix, g, prod, 1e-4), ids, F)
    assert torch.equal(torch.isnan(grad), torch.isnan(plain))
    assert torch.isnan(plain[0, 200]).all() and not torch.isnan(plain[1]).any()
    fin = torch.isfinite(plain)
    _close_to_max(grad[fin], plain[fin], 2e-5, "finite faces beside a NaN one")


def test_culled_binned_soft_backward_graph_replay_equals_eager():
    dev = _card()
    rows, ids, pix, g, prod = _binned_bwd_inputs(dev, 1, 15)
    eager = rz.soft_grad_binned(rows, ids, pix, g, prod, 1e-4, 512)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rz.soft_grad_binned(rows, ids, pix, g, prod, 1e-4, 512)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rz.soft_grad_binned(rows, ids, pix, g, prod, 1e-4, 512)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _dense_bwd_inputs(dev, size, n_views, seed, cotangent="random"):
    """Soft rows of the projected sphere (wide camera, with the degenerate,
    outside and padded faces of _soft_inputs) at size², the kernel's prod
    and a cotangent: N(0, 1), or the silhouette loss's 2·mask."""
    _, rows, pix, gen = _soft_inputs(dev, size, n_views, seed)
    prod = rz.soft_prod_dense_cuda(rows, pix, 1e-4, size)
    if cotangent == "random":
        g = torch.randn(prod.shape, generator=gen, device=dev)
    else:
        g = 2.0 * (1.0 - prod)
    return rows, pix, g, prod


@pytest.mark.parametrize("case", ["64 random", "64 silhouette", "50 random",
                                  "512 random"])
def test_culled_dense_soft_backward_matches_plain_the_sweep_and_10(case):
    dev = _card()
    size, cotangent = int(case.split()[0]), case.split()[1]
    rows, pix, g, prod = _dense_bwd_inputs(dev, size, 2, 16, cotangent)
    B, F = rows.shape[:2]
    grad = _launched(rz.SOFT_BWD_DENSE, lambda: rz.soft_grad_dense(
        rows, pix, g, prod, 1e-4, size))
    assert grad.shape == (B, F, 6) and torch.isfinite(grad).all()
    plain = rz.soft_grad_dense_plain(rows, pix, g, prod, 1e-4)
    assert plain.abs().max() > 0
    _close_to_max(grad, plain, 2e-5, "culled dense backward vs plain")
    sweep = _launched(rz.SOFT_BWD_DENSE_SWEEP,
                      lambda: rz.soft_grad_dense_sweep_cuda(
                          rows, pix, g, prod, 1e-4))
    _close_to_max(grad, sweep, 2e-5, "culled vs the first dense design")
    # #10 on bins of every face (K a multiple of 128): the same function
    K = -(-(F + 1) // 128) * 128
    nb = -(-pix.shape[0] // 1024)
    ids = torch.cat([torch.arange(F, dtype=torch.int32, device=dev),
                     torch.full((K - F,), F, dtype=torch.int32, device=dev)]
                    ).expand(B, nb, K).contiguous()
    via10 = rz.soft_grad_binned(rz._with_filler(rows).contiguous(), ids, pix,
                                rz._band_maps(g, nb), rz._band_maps(prod, nb),
                                1e-4, size)
    _close_to_max(grad, via10, 1e-4, "culled dense vs binned backward")
    # outside and padded faces: exactly 0; fixed orders: the same bits
    assert grad[:, 6].abs().max() == 0 and grad[:, 9].abs().max() == 0
    assert torch.equal(grad, rz.soft_grad_dense(rows, pix, g, prod, 1e-4,
                                                size))


def test_culled_dense_soft_backward_without_tiles_of_8_by_4():
    """width 0 (32 pixels in a row) and a width that no 8 x 4 tile fits
    give plain's gradients too, and the wide tiles' within rounding."""
    dev = _card()
    rows, pix, g, prod = _dense_bwd_inputs(dev, 64, 1, 17)
    plain = rz.soft_grad_dense_plain(rows, pix, g, prod, 1e-4)
    for width in (0, 63, 64):
        _close_to_max(rz.soft_grad_dense(rows, pix, g, prod, 1e-4, width),
                      plain, 2e-5, f"dense backward at width {width}")


@pytest.mark.parametrize("k", [0, 1, 2])
def test_culled_dense_soft_backward_gives_nan_where_plain_does(k):
    """A face with a NaN or an infinite vertex: plain gives its gradient
    NaN (every share is), finite gradients to the other faces where prod is
    finite; #9 the same, within 2e-5 elsewhere."""
    dev = _card()
    rows, pix = _non_finite_rows(dev, k, 18)
    clean = torch.cat([rows[:, :200], rows[:, 201:]], dim=1).contiguous()
    prod = rz.soft_prod_dense_plain(clean, pix, 1e-4)
    g = torch.randn(prod.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(k))
    grad = rz.soft_grad_dense(rows, pix, g, prod, 1e-4, 64)
    plain = rz.soft_grad_dense_plain(rows, pix, g, prod, 1e-4)
    assert torch.equal(torch.isnan(grad), torch.isnan(plain))
    assert torch.isnan(plain[0, 200]).all()
    assert int(torch.isnan(plain).sum()) == 6
    fin = torch.isfinite(plain)
    _close_to_max(grad[fin], plain[fin], 2e-5, "finite faces beside a NaN one")


def test_culled_dense_soft_backward_graph_replay_equals_eager():
    dev = _card()
    rows, pix, g, prod = _dense_bwd_inputs(dev, 64, 2, 19, "silhouette")
    eager = rz.soft_grad_dense(rows, pix, g, prod, 1e-4, 64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rz.soft_grad_dense(rows, pix, g, prod, 1e-4, 64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rz.soft_grad_dense(rows, pix, g, prod, 1e-4, 64)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _head_camera_rows(dev, size, seed):
    """Soft rows of the sphere under the head camera, which it fills."""
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    views = rand_poses(1, ViewSamplerConfig(), dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    fv_img = mrender._project(mesh.vertices, mesh.faces, views.theta,
                              views.phi, views.radius,
                              mrender.HEAD_CAMERA)[1]
    return rz._soft_rows(fv_img).contiguous()


@pytest.mark.parametrize("case", ["64 wide", "64 head", "50 wide",
                                  "512 wide"])
def test_culled_dense_soft_forward_matches_plain_and_the_sweep(case):
    dev = _card()
    size, camera = int(case.split()[0]), case.split()[1]
    if camera == "head":
        rows = _head_camera_rows(dev, size, 8)
        pix = rz.pixel_grid_ndc(size, size, dev)
    else:
        _, rows, pix, _ = _soft_inputs(dev, size, 2 if size < 512 else 1, 9)
    prod = _launched(rz.SOFT_FWD_DENSE,
                     lambda: rz.soft_prod_dense(rows, pix, 1e-4, size))
    ref = rz.soft_prod_dense_plain(rows, pix, 1e-4)
    assert (prod - ref).abs().max().item() <= 5e-6
    # the wide camera sees the rim; the head camera's view is all sphere
    assert ((ref > 0.01) & (ref < 0.99)).any() == (camera == "wide")
    # the same 8 slices, skipped factors exactly 1: bit for bit
    assert torch.equal(prod, rz.soft_prod_dense_sweep_cuda(rows, pix, 1e-4))
    # the other tiling (32 in a row) too
    assert torch.equal(prod, rz.soft_prod_dense_cuda(rows, pix, 1e-4, 0))


@pytest.mark.parametrize("width", [512, 0])
def test_culled_binned_soft_forward_matches_plain_and_the_sweep(width):
    dev = _card()
    H = W = 512
    fv_img, _, pix, _ = _soft_inputs(dev, H, 2, 10)
    K = rz._SOFT_BIN_K
    ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    if int(maxc) > K:
        K = -(-int(maxc) // 128) * 128
        ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    rows = rz._with_filler(rz._soft_rows(fv_img)).contiguous()
    prod = _launched(rz.SOFT_FWD_BINNED,
                     lambda: rz.soft_prod_binned(rows, ids, pix, 1e-4, width))
    ref = rz.soft_prod_binned_plain(rows, ids, pix, 1e-4)
    assert (prod - ref).abs().max().item() <= 5e-6
    assert torch.equal(prod, rz.soft_prod_binned_sweep_cuda(rows, ids, pix,
                                                            1e-4))


BAD_FACES = [[[0.3, 0.3], [0.35, 0.3], [float("nan"), 0.32]],
             [[-0.5, 0.5], [float("inf"), 0.5], [-0.45, 0.55]],
             [[0.9, -0.9], [0.92, -0.9], [0.9, -float("inf")]]]


def _non_finite_rows(dev, k, seed):
    """Soft rows of two views of the sphere at 64²; the first view also
    holds BAD_FACES[k] (a NaN, an inf or a -inf vertex coordinate) as face
    200, the second a copy of its face 200 there."""
    _, rows, pix, _ = _soft_inputs(dev, 64, 2, seed)
    bad = rz._soft_rows(torch.tensor([[BAD_FACES[k]]], device=dev))
    mid = torch.cat([bad, rows[1:, 200:201]], dim=0)
    return torch.cat([rows[:, :200], mid, rows[:, 200:]],
                     dim=1).contiguous(), pix


@pytest.mark.parametrize("k", [0, 1, 2])
def test_culled_soft_forward_gives_nan_where_plain_does(k):
    dev = _card()
    rows, pix = _non_finite_rows(dev, k, 11)
    ref = rz.soft_prod_dense_plain(rows, pix, 1e-4)
    # the plain version: NaN at every pixel of the first view, none in the
    # second
    assert torch.isnan(ref[0]).all() and not torch.isnan(ref[1]).any()
    prod = rz.soft_prod_dense(rows, pix, 1e-4, 64)
    assert torch.equal(torch.isnan(prod), torch.isnan(ref))
    assert _max_abs(prod[1] - ref[1]) <= 5e-6
    sweep = rz.soft_prod_dense_sweep_cuda(rows, pix, 1e-4)
    assert torch.equal(prod[1], sweep[1])
    # banded: bins that hold every face in every band
    ids = torch.arange(rows.shape[1], dtype=torch.int32, device=dev).expand(
        2, 4, -1).contiguous()
    got = rz.soft_prod_binned(rz._with_filler(rows).contiguous(), ids, pix,
                              1e-4, 64).reshape(2, -1)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert _max_abs(got[1] - ref[1]) <= 5e-6


def test_soft_silhouette_autograd_runs_the_kernels():
    dev = _card()
    fv_img, _, _, gen = _soft_inputs(dev, 64, 1, 7)
    before = dict(_build.LAUNCHES)
    v = fv_img.clone().requires_grad_()
    rz.soft_silhouette(64, 64, v).square().sum().backward()
    assert _build.LAUNCHES[rz.SOFT_FWD_DENSE] == \
        before.get(rz.SOFT_FWD_DENSE, 0) + 1
    assert _build.LAUNCHES[rz.SOFT_BWD_DENSE] == \
        before.get(rz.SOFT_BWD_DENSE, 0) + 1
    assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0
    # card against CPU, the whole pair
    c = fv_img.cpu().requires_grad_()
    rz.soft_silhouette(64, 64, c).square().sum().backward()
    _close_to_max(v.grad.cpu(), c.grad, 1e-4, "soft silhouette gradient")


def test_wrappers_raise_instead_of_falling_back():
    dev = _card()
    cfg = HashGridConfig()
    with pytest.raises(TypeError):
        hg.hash_encode_cuda(torch.rand((8, 3), device=dev, dtype=torch.float64),
                            torch.zeros((12, 2048, 2), device=dev), cfg)
    x, g = torch.rand((8, 3), device=dev), torch.zeros((8, 24), device=dev)
    for mode, ppb in (("vpu", 8192), ("full", 100)):
        with pytest.raises(ValueError):
            hg.hash_bwd_variant(x, g, cfg, mode, ppb)
    with pytest.raises(TypeError):
        q = torch.zeros((1, 1, 8, 40), device=dev, dtype=torch.float16)
        at.attention(q, q, q, 1.0)
    with pytest.raises(ValueError):
        q = torch.zeros((1, 1, 8, 160), device=dev)
        at.attention(q, q, q, 1.0)
    pix = rz.pixel_grid_ndc(8, 8, dev)
    with pytest.raises(TypeError):
        rz.select_faces_dense(torch.zeros((1, 4, 12), device=dev,
                                          dtype=torch.float64), pix)
    with pytest.raises(ValueError):
        rz.select_faces_dense(torch.zeros((1, 12, 4), device=dev)
                              .transpose(1, 2), pix)
    with pytest.raises(ValueError):
        rz.select_faces_binned(torch.zeros((1, 4, 12), device=dev),
                               torch.zeros((1, 1, 64), device=dev,
                                           dtype=torch.int64), pix)
    with pytest.raises(TypeError):
        rz.soft_prod_dense(torch.zeros((1, 4, 16), device=dev,
                                       dtype=torch.float64), pix, 1e-4)
    with pytest.raises(ValueError):
        rz.soft_grad_dense(torch.zeros((1, 4, 16), device=dev), pix,
                           torch.zeros((1, 63), device=dev),
                           torch.zeros((1, 64), device=dev), 1e-4)
    with pytest.raises(ValueError):      # a CPU map beside CUDA rows
        rz.soft_grad_dense(torch.zeros((1, 4, 16), device=dev), pix,
                           torch.zeros((1, 64)),
                           torch.zeros((1, 64), device=dev), 1e-4)


def test_tiny_app_step_goes_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--optim.iters", "2",
        "--render.train_grid_size", "16", "--log.exp_root", str(tmp_path),
        "--log.eval_size", "0", "--log.full_eval_size", "0",
        "--log.save_mesh", "false", "--log.log_images", "false",
        "--log.save_interval", "100"])
    app = LatentNeRFApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # two steps; the refresh at step 1 adds one forward encode
    assert _build.LAUNCHES[hg.FWD] == 3 and _build.LAUNCHES[hg.BWD] == 2
    assert _build.LAUNCHES[og.LOOKUP] == 2


def test_tiny_paint_step_and_eval_go_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.shape_path", "sphere",
        "--guide.texture_resolution", "32", "--optim.iters", "2",
        "--render.train_grid_size", "24", "--render.eval_grid_size", "512",
        "--log.exp_root", str(tmp_path), "--log.eval_size", "0",
        "--log.full_eval_size", "2", "--log.save_mesh", "true",
        "--log.log_images", "false", "--log.save_interval", "100"])
    app = LatentPaintApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # mesh and dome per step; the 512² eval render takes the band bins,
    # beside the dense kernel behind its shut gate
    assert _build.LAUNCHES[rz.DENSE] == 5 and _build.LAUNCHES[rz.BINNED] == 1
    assert (tmp_path / "default" / "mesh" / "mesh.obj").exists()


def test_tiny_mesh_app_step_and_eval_go_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.shape_path", "sphere",
        "--guide.texture_resolution", "32", "--optim.iters", "2",
        "--render.train_grid_size", "24", "--render.eval_grid_size", "64",
        "--render.body_prob", "0.5", "--log.exp_root", str(tmp_path),
        "--log.eval_size", "0", "--log.full_eval_size", "2",
        "--log.save_mesh", "true", "--log.log_images", "false",
        "--log.save_interval", "100"])
    app = LatentPaintMeshApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # two cameras per step and per eval chunk; no loss reads the soft mask
    assert _build.LAUNCHES[rz.SOFT_FWD_DENSE] == 2 * 2 + 2
    assert _build.LAUNCHES.get(rz.SOFT_BWD_DENSE, 0) == 0
    assert app.scene.displacement.abs().max() > 0
    assert (tmp_path / "default" / "mesh" / "mesh.obj").exists()


def _needles(seed, n, dev):
    """(n, 3, 2) needles (an angle of 1e-6 to 1e-5 rad at vertex 0, long
    edges 0.05 to 0.6 and 0.5 to 1.5 times that) and pixels on their axes
    1 to 8 cull margins (σ = 1e-4) beyond both ends; drawn on the host."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 6), generator=gen, dtype=torch.float64)
    tip = u[:, :2] * 1.6 - 0.8
    th, ang = u[:, 2] * 2 * np.pi, 10.0 ** (u[:, 3] - 6.0)
    length = (u[:, 4] * 0.55 + 0.05)[:, None]
    a = torch.stack([th.cos(), th.sin()], -1) * length
    b = torch.stack([(th + ang).cos(), (th + ang).sin()], -1) * length * (
        u[:, 5] + 0.5)[:, None]
    faces = torch.stack([tip, tip + a, tip + b], 1).float()
    f = faces.double()
    mid = (f[:, 1] + f[:, 2]) / 2
    axis = (mid - f[:, 0]) / (mid - f[:, 0]).norm(dim=-1, keepdim=True)
    dist = torch.linspace(1.0, 8.0, 32, dtype=torch.float64)[
        None, :, None] * (27.7e-4) ** 0.5
    pix = torch.cat([f[:, 0, None] - dist * axis[:, None],
                     mid[:, None] + dist * axis[:, None]], 1)
    return faces.to(dev), pix.reshape(-1, 2).float().to(dev)


def test_soft_kernels_keep_slivers_as_plain_does():
    """Fault C.3: needles beside the sphere, at the image's pixels and on
    the needles' axes, where the plain version's rounded inside test holds
    for some far pixel (factor 0). The culls keep every sliver, so #7 and
    #8 equal plain within 5e-6, #9 and #10 within 2e-5."""
    dev = _card()
    fv, _, pix, gen = _soft_inputs(dev, 64, 2, 12)
    needles, beyond = _needles(3, 256, dev)
    fv = torch.cat([fv, needles.expand(2, -1, -1, -1)], 1)
    rows = rz._soft_rows(fv).contiguous()
    B, F = rows.shape[:2]
    pix = torch.cat([pix, beyond]).contiguous()
    P, nb = pix.shape[0], pix.shape[0] // 1024
    assert torch.isinf(rz._soft_cull_boxes(rows[:, -256:], 1e-4)).all()
    ref = rz.soft_prod_dense_plain(rows, pix, 1e-4)
    prod = _launched(rz.SOFT_FWD_DENSE,
                     lambda: rz.soft_prod_dense(rows, pix, 1e-4, 0))
    assert _max_abs(prod - ref) <= 5e-6
    assert torch.equal(prod, rz.soft_prod_dense_sweep_cuda(rows, pix, 1e-4))
    K = -(-(F + 1) // 128) * 128
    ids = torch.cat([torch.arange(F, dtype=torch.int32, device=dev),
                     torch.full((K - F,), F, dtype=torch.int32, device=dev)]
                    ).expand(B, nb, K).contiguous()
    frows = rz._with_filler(rows).contiguous()
    binned = rz.soft_prod_binned(frows, ids, pix, 1e-4, 0).reshape(B, P)
    assert _max_abs(binned - ref) <= 5e-6
    g = torch.randn((B, P), generator=gen, device=dev)
    plain = rz.soft_grad_dense_plain(rows, pix, g, ref, 1e-4)
    _close_to_max(rz.soft_grad_dense(rows, pix, g, ref, 1e-4, 0), plain,
                  2e-5, "#9 with slivers")
    _close_to_max(rz.soft_grad_binned(frows, ids, pix, rz._band_maps(g, nb),
                                      rz._band_maps(ref, nb), 1e-4, 0),
                  plain, 2e-5, "#10 with slivers")


def test_latent_nerf_eval_chunk_on_the_card_equals_the_cpu(tmp_path,
                                                          monkeypatch):
    """The tiny latent-NeRF eval render (#1 and #3 under no_grad, the tiny
    VAE, the resize of `jax.image.resize`) on the card against the CPU, on
    the same weights, f32 throughout: 1e-4 of the largest value."""
    dev = _card()
    # cuDNN's convolutions take TF32 by default: 1e-3 of the frames
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.core.views import ViewSamplerConfig, circle_poses
    from tpunerf_torch.guidance.stable_diffusion import \
        StableDiffusionGuidance
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.unet_dtype", "float32",
        "--render.mlp_dtype", "float32", "--log.exp_root", str(tmp_path)])
    cpu = torch.device("cpu")
    apps = {}
    for d in (cpu, dev):
        g = StableDiffusionGuidance.create(tiny=True, unet_dtype="float32",
                                           device=d)
        if d == dev:
            for name in ("unet", "text_encoder", "vae"):
                getattr(g, name).load_state_dict(
                    getattr(apps[cpu].guidance, name).state_dict())
        apps[d] = LatentNeRFApp.create(cfg, guidance=g, device=d)
    apps[cpu].init_params(torch.Generator().manual_seed(4))
    apps[dev].load_state_dict(apps[cpu].state_dict())
    views = circle_poses(5, ViewSamplerConfig(), cpu)
    before = {n: _build.LAUNCHES.get(n, 0) for n in (hg.FWD, og.LOOKUP)}
    got = apps[dev].eval_render(views.to(dev), (96, 96))["image"]
    assert all(_build.LAUNCHES[n] > before[n] for n in before)
    ref = apps[cpu].eval_render(views, (96, 96))["image"]
    assert got.shape == (5, 96, 96, 3)
    _close_to_max(got.cpu(), ref, 1e-4, "eval chunk, card vs CPU")


def test_async_save_of_card_tensors_holds_the_values_of_the_save(tmp_path):
    """Tensors on the card changed in place right after an asynchronous
    save (as the next Adam step changes them) do not reach the file."""
    dev = _card()
    from tpunerf_torch.training.checkpoints import CheckpointManager
    mgr = CheckpointManager(tmp_path, max_keep=2)
    w = torch.randn(1 << 20, device=dev)
    m = torch.randn(1 << 20, device=dev)
    want_w, want_m = w.cpu().clone(), m.cpu().clone()
    mgr.save(1, {"w": w}, {"state": {0: {"exp_avg": m}}}, async_write=True)
    w.mul_(-2.0)
    m.add_(1.0)
    params, opt, _ = mgr.load()
    assert torch.equal(params["w"], want_w)
    assert torch.equal(opt["state"][0]["exp_avg"], want_m)


def _tiny_trainer(tmp_path, app_kind, nerf_type, dev, *extra):
    """A tiny app and its chunked trainer on `dev`."""
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer
    argv = ["--guide.tiny_diffusion", "true", "--guide.unet_dtype",
            "float32", "--render.nerf_type", nerf_type,
            "--optim.train_chunk", "4", "--log.exp_root", str(tmp_path),
            "--log.exp_name", f"{app_kind}_{nerf_type}_{dev.type}",
            "--log.eval_size", "0", "--log.full_eval_size", "0",
            "--log.save_mesh", "false", "--log.log_images", "false",
            "--log.save_interval", "100", *extra]
    if app_kind == "nerf":
        cfg = parse(TrainConfig, argv + [
            "--render.train_grid_size", "16", "--render.mlp_dtype",
            "float32"])
        app = LatentNeRFApp.create(cfg, device=dev)
    else:
        cfg = parse(TrainConfig, argv + [
            "--guide.shape_path", "sphere", "--guide.texture_resolution",
            "32", "--render.train_grid_size", "24"])
        app = LatentPaintApp.create(cfg, device=dev)
    return Trainer(cfg, app, device=dev)


@pytest.mark.parametrize("app_kind, nerf_type, deterministic", [
    ("nerf", "latent", False), ("nerf", "rgb", True),
    ("paint", "latent", True)],
    ids=["latent-NeRF", "refine-deterministic", "latent-paint-deterministic"])
def test_tiny_graphed_step_equals_the_eager_step(tmp_path, app_kind,
                                                 nerf_type, deterministic):
    """Step 1 (with its occupancy refresh) from one state, eager twice and
    replayed: latent-NeRF equal bit for bit throughout, and so the refine
    step under deterministic algorithms (cuDNN's default backward
    algorithms of the VAE encoder add in another order each run, so that
    two eager runs do not bound the spread without them); latent-paint
    under deterministic algorithms within `graph_agreement`'s bound, each
    tensor against its own eager runs' difference (grid_sample's backward
    adds with atomics and has no deterministic form), the loss and the
    generator bit for bit. Then four replays in a chunk launch the kernels
    a replay records four times, and nothing else but the refreshes
    between them."""
    import collections
    import warnings
    from tpunerf_torch.scripts.graph_check import (graph_agreement,
                                                   graphed_against_eager)
    dev = _card()
    trainer = _tiny_trainer(tmp_path, app_kind, nerf_type, dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            d = graphed_against_eager(trainer)
        finally:
            torch.use_deterministic_algorithms(False)
    assert d["replay"]["loss"] == 0.0 and d["eager"]["loss"] == 0.0
    assert d["replay"]["generator"] == 0.0
    if app_kind == "nerf":
        assert max(d["replay"].values()) == max(d["eager"].values()) == 0.0
    for group, verdict in graph_agreement(d).items():
        assert verdict["ok"], (group, verdict)
    # the chunked run replays the graph and counts its launches a replay
    eager = collections.Counter()
    post = trainer.post_step

    def counted_post_step():
        before = dict(_build.LAUNCHES)
        post()
        eager.update({n: c - before.get(n, 0)
                      for n, c in _build.LAUNCHES.items()})

    trainer.post_step = counted_post_step
    _build.reset_launches()
    trainer.cfg.optim.iters = trainer.train_step_idx + 4
    trainer.train()
    for name, n in trainer.graph.launches.items():
        assert _build.LAUNCHES[name] == 4 * n + eager[name], name


def _tiny_mesh_trainer(tmp_path, case, dev):
    """A tiny latent-paint-mesh app (the sphere, a 24² train grid, 128² in
    mode 1, where the band bins are built) and its chunked trainer on
    `dev`: "mode0", "mode1", "mode2" with text SD, "depth" (B = 2), "pbe"
    (Paint-by-Example with `use_clip`, 16² latents)."""
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.scripts import pbe_step
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer
    argv = ["--guide.tiny_diffusion", "true", "--guide.unet_dtype",
            "float32", "--guide.shape_path", "sphere",
            "--guide.texture_resolution", "32", "--render.body_prob", "0.7",
            "--render.train_grid_size", "128" if case == "mode1" else "24",
            "--optim.train_chunk", "4", "--log.exp_root", str(tmp_path),
            "--log.exp_name", case, "--log.eval_size", "0",
            "--log.full_eval_size", "0", "--log.save_mesh", "false",
            "--log.log_images", "false", "--log.save_interval", "100"]
    if case.startswith("mode"):
        argv += ["--optim.mode", case[4]]
    elif case == "depth":
        argv += ["--guide.diffusion_name", "sd-depth",
                 "--render.batch_size", "2"]
    else:
        image = tmp_path / "exemplar.png"
        pbe_step.exemplar_png(image, 0, size=64)
        argv += ["--guide.use_sd", "false", "--guide.image", str(image),
                 "--optim.use_clip", "true"]
    cfg = parse(TrainConfig, argv)
    app = LatentPaintMeshApp.create(cfg, device=dev)
    if case == "pbe":
        app.scene.latent_size = 16
    return Trainer(cfg, app, device=dev)


@pytest.mark.parametrize("case", ["mode0", "mode1", "mode2", "depth",
                                  "pbe-sds", "pbe-clip"])
def test_tiny_paint_mesh_graphed_step_equals_the_eager_step(tmp_path, case):
    """Latent-paint-mesh's step from one state, eager twice and replayed,
    under deterministic algorithms: the loss and the generator bit for
    bit, every other tensor within `graph_agreement`'s bound (the texture's
    grid_sample backward adds with atomics); mode 1 at 128², where the
    band bins are built and the gated kernels run; Paint-by-Example with
    `use_clip` on each branch (the generator moved on until the step takes
    it). Then four replays in a chunk launch the kernels that each
    replayed branch records, and nothing else."""
    import warnings
    from tpunerf_torch.scripts.graph_check import (advance_to_branch,
                                                   graph_agreement,
                                                   graphed_against_eager)
    dev = _card()
    trainer = _tiny_mesh_trainer(tmp_path, case.split("-")[0], dev)
    branch = None
    if case.startswith("pbe"):
        branch = case.endswith("clip")
        advance_to_branch(trainer, branch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            d = graphed_against_eager(trainer)
        finally:
            torch.use_deterministic_algorithms(False)
    assert trainer.graph.branch == branch
    assert d["replay"]["loss"] == 0.0 and d["eager"]["loss"] == 0.0
    assert d["replay"]["generator"] == 0.0
    for group, verdict in graph_agreement(d).items():
        assert verdict["ok"], (group, verdict)
    replays = []
    graph = trainer.graph
    real = graph.replay
    graph.replay = lambda: replays.append(real()) or replays[-1]
    _build.reset_launches()
    trainer.cfg.optim.iters = trainer.train_step_idx + 4
    trainer.train()
    want = {}
    for b in replays:
        for name, n in graph.launches_by_branch[b].items():
            want[name] = want.get(name, 0) + n
    assert len(replays) == 4
    assert {n: c for n, c in _build.LAUNCHES.items() if c} == want
    if case == "mode1":
        assert {rz.DENSE, rz.BINNED, rz.SOFT_FWD_DENSE,
                rz.SOFT_FWD_BINNED} <= set(want)


@pytest.mark.parametrize("kernel", [rz.DENSE, rz.BINNED, rz.SOFT_FWD_DENSE,
                                    rz.SOFT_FWD_BINNED, rz.SOFT_BWD_DENSE,
                                    rz.SOFT_BWD_BINNED])
def test_gated_kernels_match_plain_open_and_write_nothing_shut(kernel):
    """Each kernel of a gated pair at the eval chunk's shapes
    (`scripts.gate_check`): with its gate open it equals its plain version
    (bit for bit for the selection) and the same call without a gate bit
    for bit; with its gate shut it leaves the output it was given as it
    was; each call is one launch."""
    from tpunerf_torch.scripts import gate_check
    dev = _card()
    case = gate_check.gated_cases(dev, n_views=2)[kernel]
    before = _build.LAUNCHES.get(kernel, 0)
    verdict = gate_check.check_gate(case, gate_check.gate_flags(dev))
    assert verdict["ok"], verdict
    assert _build.LAUNCHES[kernel] == before + 3


def test_tiny_refine_step_on_the_card_equals_the_cpu(tmp_path, monkeypatch):
    """An RGB (refine) latent-NeRF step, the same weights and draws on the
    card and the CPU, f32: the loss and the field's gradients within 1e-4
    of the largest (the VAE encoder and the UNet sum in other orders)."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    cpu = torch.device("cpu")
    tr = {d: _tiny_trainer(tmp_path, "nerf", "rgb", d) for d in (cpu, dev)}
    for name in ("unet", "text_encoder", "vae"):
        getattr(tr[dev].app.guidance, name).load_state_dict(
            getattr(tr[cpu].app.guidance, name).state_dict())
    tr[dev].app.text_z.copy_(tr[cpu].app.text_z)
    tr[dev].app.load_state_dict(tr[cpu].app.state_dict())
    gen = torch.Generator().manual_seed(3)
    views = rand_poses(1, ViewSamplerConfig(), cpu, generator=gen)
    draws = dict(u=torch.rand((1, 256, 128), generator=gen),
                 vae_noise=torch.randn((1, 16, 16, 4), generator=gen),
                 t=torch.tensor(600),
                 noise=torch.randn((1, 16, 16, 4), generator=gen))
    out = {}
    for d, t in tr.items():
        loss, _ = t.app.loss_fn(views.to(d), **{k: v.to(d)
                                                for k, v in draws.items()})
        loss.backward()
        out[d] = (loss.detach().cpu(),
                  [p.grad.cpu() for p in t.app.scene.field.parameters()])
    _close_to_max(out[dev][0], out[cpu][0], 1e-4, "loss")
    for g, ref in zip(out[dev][1], out[cpu][1]):
        _close_to_max(g, ref, 1e-4, "field gradient")


def test_hash_and_occupancy_kernels_at_the_rgb_eval_chunks_size():
    """#1 on 16,777,216 points (a 512² pose's K = 64 samples) and #3 on
    33,554,432 (its S = 128), against their plain versions in slices of
    2^21 (#1 within 1e-5 of the largest, as at 70,001 points; #3
    exactly): 64-bit offsets throughout."""
    dev = _card()
    cfg = HashGridConfig()
    n = 512 * 512 * 64
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((n, 3), generator=gen, device=dev)
    table = (torch.rand((cfg.n_levels, cfg.table_size,
                         cfg.n_features_per_level), generator=gen,
                        device=dev) * 2 - 1) * 1e-2
    out = hg.hash_encode_cuda(x, table, cfg)
    for lo in range(0, n, 1 << 21):
        _close_to_max(out[lo:lo + (1 << 21)],
                      hg.hash_encode_plain(x[lo:lo + (1 << 21)], table, cfg),
                      1e-5, f"#1 points {lo}..")
    del out
    G, bnd = 128, 1.0
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (G ** 3 // 32,),
                           generator=gen, device=dev, dtype=torch.int32)
    xs = (torch.rand((1, 512 * 512, 128, 3), generator=gen, device=dev)
          * 2 - 1) * bnd
    got = og.occupancy_lookup_cuda(xs, packed, G, bnd)
    flat, ref_flat = got.reshape(-1), xs.reshape(-1, 3)
    for lo in range(0, flat.numel(), 1 << 21):
        assert torch.equal(flat[lo:lo + (1 << 21)], og.occupancy_lookup_plain(
            ref_flat[lo:lo + (1 << 21)], packed, G, bnd)), lo


def test_tiny_depth_app_step_on_the_card_equals_the_cpu(monkeypatch):
    """Config #5's step at the tiny size (`scripts.depth_step`):
    depth-guided latent-paint-mesh, B = 2 (body and head camera), mode 0,
    the same weights and draws on the card and the CPU, f32: the loss within
    1e-4 of its summed terms, the gradients within 2e-4 of the largest
    (paint-mesh's tolerances), through #5 and #7 (the tiny UNet's 256 tokens
    take the plain attention, not #4)."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from tpunerf_torch.scripts import depth_step
    _build.reset_launches()
    (l_cpu, g_cpu), (l_dev, g_dev), scale = depth_step.tiny_depth_steps(
        dev, 6)
    for name in (rz.DENSE, rz.SOFT_FWD_DENSE):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert abs(l_dev - l_cpu) <= 1e-4 * scale, (l_dev, l_cpu, scale)
    assert set(g_dev) == set(g_cpu) == {"background_sphere_colors",
                                        "displacement", "texture_img"}
    for k, ref in g_cpu.items():
        _close_to_max(g_dev[k], ref, 2e-4, k)


def test_tiny_pbe_app_step_on_the_card_equals_the_cpu(monkeypatch):
    """The Paint-by-Example step at the tiny size (`scripts.pbe_step`):
    latent-paint-mesh with `use_sd false`, an exemplar PNG and `use_clip`,
    one body view, mode 0, the same weights and draws on the card and the
    CPU, f32, in both branches (t = 250: the CLIP branch through the DDIM
    step, the VAE decode and the CLIP tower; t = 500: SDS): the loss within
    1e-4 of its scale, the gradients within 2e-4 of the largest, through #4
    (the tiny UNet's 64² self-attention in the SDS branch, f32), #5 and
    #7."""
    dev = _card()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    from tpunerf_torch.scripts import pbe_step
    _build.reset_launches()
    out = pbe_step.tiny_pbe_steps(dev, 7)
    for name in (at.ATTN, rz.DENSE, rz.SOFT_FWD_DENSE):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert set(out) == {"clip", "sds"}
    for branch, ((l_cpu, g_cpu), (l_dev, g_dev), scale) in out.items():
        assert abs(l_dev - l_cpu) <= pbe_step.LOSS_TOL * scale, \
            (branch, l_dev, l_cpu, scale)
        assert set(g_dev) == set(g_cpu) == {
            "background_sphere_colors", "displacement", "texture_img"}
        for k, ref in g_cpu.items():
            _close_to_max(g_dev[k], ref, pbe_step.GRAD_TOL, f"{branch} {k}")


def test_a_512_exemplar_png_loads_onto_the_card(tmp_path):
    """`read_png` → `load_image` on the card's machine (no Pillow there): a
    512² exemplar written by `write_png` comes back exactly at 512² and,
    resized as PIL resizes, at 224², on the card."""
    dev = _card()
    from tpunerf_torch.scripts import pbe_step
    from tpunerf_torch.utils import load_image, read_png, resize_pil_bicubic
    path = tmp_path / "exemplar.png"
    img = pbe_step.exemplar_png(path, 3)
    assert np.array_equal(read_png(path), img)
    for size in (512, 224):
        got = load_image(path, size)
        assert got.device.type == dev.type and got.shape == (1, size, size,
                                                             3)
        want = img if size == 512 else resize_pil_bicubic(img, size, size)
        assert torch.equal(got.cpu()[0], torch.from_numpy(
            want.astype(np.float32) / 255.0))


def test_attention_kernel_refuses_inputs_that_need_a_gradient():
    """With grad mode on and an input that requires a gradient, `attention`
    runs the kernel forward and the backward kernels #12 and #13 (each
    launched once) and its gradients equal `attention_bwd_plain`'s on the
    forward's own output and log-sum-exp; the forward kernel alone
    (`attention_fwd_cuda`) still refuses such inputs, as its output has no
    history; under no_grad `attention` launches the forward alone."""
    dev = _card()
    q, k, v = (torch.randn((1, 2, 2048, 40), device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    q.requires_grad_(True)
    k.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd history"):
        at.attention_fwd_cuda(q, k, v, 40 ** -0.5)
    _build.reset_launches()
    out = at.attention(q, k, v, 40 ** -0.5)
    do = torch.randn_like(out)
    dq, dk = torch.autograd.grad(out, (q, k), do)
    assert {n: _build.LAUNCHES.get(n, 0) for n in
            (at.ATTN, at.ATTN_DKV, at.ATTN_DQ)} == {
        at.ATTN: 1, at.ATTN_DKV: 1, at.ATTN_DQ: 1}
    with torch.no_grad():
        o, lse = at.attention_fwd_cuda(q, k, v, 40 ** -0.5, with_lse=True)
    assert torch.equal(o, out.detach())
    pq, pk, _ = at.attention_bwd_plain(q.detach(), k.detach(), v, o, lse,
                                       do, 40 ** -0.5)
    _close_to_max(dq, pq, BWD_BF16_TOL, "dq")
    _close_to_max(dk, pk, BWD_BF16_TOL, "dk")
    with torch.no_grad():
        at.attention(q, k, v, 40 ** -0.5)
    assert _build.LAUNCHES[at.ATTN] == 3
    assert _build.LAUNCHES[at.ATTN_DKV] == 1


def test_attention_function_refuses_a_second_derivative():
    """As JAX's flash attention, the kernels are differentiable once: where
    the output's gradient itself has history (here 2·out), a gradient taken
    with create_graph carries an error node, and differentiating it raises
    instead of treating the kernels' gradients as constants."""
    dev = _card()
    q, k, v = (torch.randn((1, 2, 2048, 40), device=dev, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out = at.attention(q, k, v, 40 ** -0.5)
    (dq,) = torch.autograd.grad((out * out).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dq.float().sum().backward()


# #12/#13 against attention_bwd_plain: f32 in another summation order;
# bf16 also rounds P and dS to bf16 before the products in both, so a score
# near a rounding boundary may round the other way
BWD_F32_TOL = 1e-5
BWD_BF16_TOL = 2e-2


def _bwd_inputs(dev, B, H, N, D, dtype, layout, seed):
    """q, k, v, do as `_bf16_qkv` makes them, in `dtype`, with the
    forward's output and log-sum-exp from the kernel."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, N, H, D) if layout == "strided" else (B, H, N, D)
    out = []
    for _ in range(4):
        t = torch.randn(shape, generator=gen, device=dev).to(dtype)
        out.append(t.permute(0, 2, 1, 3) if layout == "strided" else t)
    q, k, v, do = out
    o, lse = at.attention_fwd_cuda(q, k, v, D ** -0.5, with_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,layout", [
    (4096, 40, "strided"), (4096 + 77, 40, "contiguous"),
    (1000, 64, "strided"), (4096, 64, "contiguous"),
    (1000, 128, "contiguous"), (2048 + 5, 128, "strided"),
    (1000, 8, "strided")])
def test_attention_bwd_kernels_match_plain(dtype, n, d, layout):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v, o, lse, do = _bwd_inputs(dev, 2, 3, n, d, dt, layout, n + d)
    scale = d ** -0.5
    _close_to_max(lse, at.attention_lse_plain(q, k, scale), 1e-5, "lse")
    _build.reset_launches()
    got = at.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    assert _build.LAUNCHES[at.ATTN_DKV] == 1
    assert _build.LAUNCHES[at.ATTN_DQ] == 1
    want = at.attention_bwd_plain(q, k, v, o, lse, do, scale)
    rel = BWD_F32_TOL if dtype == "float32" else BWD_BF16_TOL
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        _close_to_max(g, w, rel, name)


@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("b,h,n,d", [
    (1, 3, 4096 + 77, 40), (3, 5, 1000, 40), (1, 2, 40, 40),
    (1, 133, 256, 40), (1, 3, 4096 + 77, 64), (3, 5, 1000, 64),
    (1, 2, 40, 64), (2, 3, 130, 16)])
def test_attention_bwd_wgmma_ring_edges(b, h, n, d, layout):
    """The wgmma kernels (padded head dims 48 and 64) where a ring of tiles
    can go wrong: N not a multiple of the 64-row tiles or of a block's 128
    rows, N below one tile (a block's second warpgroup holds no row), B·H
    not a multiple of the 132 SMs, and strided (B, N, H, D) views; each
    against `attention_bwd_plain` within the bf16 tolerance."""
    dev = _card()
    q, k, v, o, lse, do = _bwd_inputs(dev, b, h, n, d, torch.bfloat16,
                                      layout, 7 * n + d)
    scale = d ** -0.5
    _build.reset_launches()
    got = at.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    assert _build.LAUNCHES[at.ATTN_DKV] == 1
    assert _build.LAUNCHES[at.ATTN_DQ] == 1
    want = at.attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        assert bool(torch.isfinite(g).all()), name
        _close_to_max(g, w, BWD_BF16_TOL, name)


def test_attention_bwd_wgmma_agrees_with_the_mma_design():
    """The kept mma.sync design (timed only) and the wgmma kernels on the
    same inputs at the UNet's (2, 8, 4096, 40): both round P and dS to bf16
    and differ only in summation order, so they agree within the bf16
    tolerance; each wrapper counts its own launches."""
    dev = _card()
    q, k, v, o, lse, do = _bwd_inputs(dev, 2, 8, 4096, 40, torch.bfloat16,
                                      "strided", 21)
    scale = 40 ** -0.5
    delta = torch.sum(o.float() * do.float(), dim=-1)
    _build.reset_launches()
    new = (at.attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale),
           *at.attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale))
    old = (at.attention_bwd_dq_mma_cuda(q, k, v, do, lse, delta, scale),
           *at.attention_bwd_dkv_mma_cuda(q, k, v, do, lse, delta, scale))
    assert {n: _build.LAUNCHES.get(n, 0) for n in (
        at.ATTN_DKV, at.ATTN_DQ, at.ATTN_DKV_MMA, at.ATTN_DQ_MMA)} == {
        at.ATTN_DKV: 1, at.ATTN_DQ: 1, at.ATTN_DKV_MMA: 1, at.ATTN_DQ_MMA: 1}
    for name, a, b in zip(("dq", "dk", "dv"), new, old):
        _close_to_max(a, b, BWD_BF16_TOL, name)
    with pytest.raises(TypeError, match="bf16 only"):
        at.attention_bwd_dq_mma_cuda(q.float(), k.float(), v.float(),
                                     do.float(), lse, delta, scale)


def test_attention_bwd_bf16_takes_a_misaligned_output_gradient():
    """The tensor-core kernels copy 16-byte chunks: the wrappers refuse a
    misaligned do, and attention_bwd_cuda copies it first."""
    dev = _card()
    q, k, v, o, lse, do = _bwd_inputs(dev, 1, 2, 256, 40, torch.bfloat16,
                                      "contiguous", 3)
    buf = torch.zeros(do.numel() + 1, dtype=torch.bfloat16, device=dev)
    off = buf[1:].view(do.shape)
    off.copy_(do)
    delta = torch.sum(o.float() * do.float(), dim=-1)
    with pytest.raises(ValueError, match="16-byte"):
        at.attention_bwd_dq_cuda(q, k, v, off, lse, delta, 40 ** -0.5)
    got = at.attention_bwd_cuda(q, k, v, o, lse, off, 40 ** -0.5)
    want = at.attention_bwd_cuda(q, k, v, o, lse, do, 40 ** -0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [40, 64, 128])
def test_attention_bwd_bf16_error_against_f32(d):
    """The bf16 kernels' gradients against f32 autograd of attention on the
    same bf16 inputs: at most twice the plain bf16 backward's error, plus
    1e-6 of the largest gradient."""
    dev = _card()
    q, k, v, o, lse, do = _bwd_inputs(dev, 1, 2, 4096 + 77, d,
                                      torch.bfloat16, "strided", d)
    scale = d ** -0.5
    got = at.attention_bwd_cuda(q, k, v, o, lse, do, scale)
    plain = at.attention_bwd_plain(q, k, v, o, lse, do, scale)
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = torch.autograd.grad(at.attention_plain(qf, kf, vf, scale),
                              (qf, kf, vf), do.float())
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        err = (g.float() - r).abs().max().item()
        e_plain = (p.float() - r).abs().max().item()
        tol = 2 * e_plain + 1e-6 * r.abs().max().item()
        assert err <= tol, (name, err, e_plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_kernels_are_bit_identical_over_two_calls(dtype):
    dev = _card()
    args = _bwd_inputs(dev, 2, 8, 4096, 40, getattr(torch, dtype), "strided",
                       11)
    first = at.attention_bwd_cuda(*args, 40 ** -0.5)
    second = at.attention_bwd_cuda(*args, 40 ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_bwd_graph_replay_equals_eager():
    dev = _card()
    args = _bwd_inputs(dev, 2, 8, 4096, 40, torch.bfloat16, "strided", 12)
    eager = at.attention_bwd_cuda(*args, 40 ** -0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        at.attention_bwd_cuda(*args, 40 ** -0.5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = at.attention_bwd_cuda(*args, 40 ** -0.5)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)
