"""The port's occupancy grid (tpunerf_torch.fields.occupancy and
kernels/occgrid.py) against the JAX package's: bit packing, the lookup
(exact, cell walls included), the Pallas lookup kernel in interpret mode,
fixed-K compaction (exact; `compact_samples`' indices too), and the EMA
refresh with injected jitter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunerf.fields import occupancy as jocc
from tpunerf.kernels import occgrid as jog
from tpunerf_torch.fields import occupancy as tocc
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import occgrid as tog


def _grid_and_points(G=32, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    grid = (rng.uniform(size=(G ** 3,)) * 0.02).astype(np.float32)
    x = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    # points exactly on cell walls and on the box faces
    x[:200] = (rng.integers(0, G + 1, size=(200, 3)) * (2.0 / G)
               - 1.0).astype(np.float32)
    return grid, x


def test_pack_bits_matches_jax_words():
    occ = np.random.default_rng(1).uniform(size=(32 ** 3,)) < 0.3
    ref = np.asarray(jog.pack_bits(jnp.asarray(occ)))
    out = tog.pack_bits(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref)


def test_cell_centers_exact():
    for G in (32, 128):
        jcfg, tcfg = (jocc.OccupancyGridConfig(resolution=G),
                      tocc.OccupancyGridConfig(resolution=G))
        np.testing.assert_array_equal(
            tocc.cell_centers(tcfg, torch.device("cpu")).numpy(),
            np.asarray(jocc.cell_centers(jcfg)))


@pytest.mark.parametrize("G", [32, 128])
def test_occupied_matches_jax_exactly(G):
    grid, x = _grid_and_points(G)
    jcfg = jocc.OccupancyGridConfig(resolution=G)
    tcfg = tocc.OccupancyGridConfig(resolution=G)
    ref = np.asarray(jocc.occupied(jnp.asarray(grid), jnp.asarray(x), jcfg))
    out = tocc.occupied(torch.from_numpy(grid), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tocc.lookup(torch.from_numpy(grid), torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jocc.lookup(jnp.asarray(grid), jnp.asarray(x), jcfg)))


def test_plain_lookup_matches_pallas_kernel_interpret():
    """The port's plain lookup against the JAX package's Pallas kernel in
    interpret mode (its own 16³-cube packing on its side): exact bools."""
    from jax.experimental.pallas import tpu as pltpu
    G = 64
    grid, x = _grid_and_points(G, n=1000, seed=2)
    cfg = tocc.OccupancyGridConfig(resolution=G)
    occ = grid > cfg.density_threshold
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jog.occupancy_lookup_packed(
            jnp.asarray(x), jog.pack_bits_blocked(jnp.asarray(occ), G), G,
            1.0))
    out = tog.occupancy_lookup_plain(torch.from_numpy(x),
                                     tog.pack_bits(torch.from_numpy(occ)), G,
                                     1.0)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("k", [4, 8, 16])
def test_compact_gather_exact(k):
    rng = np.random.default_rng(k)
    S = 16
    occ = rng.uniform(size=(2, 7, S)) < 0.4
    occ[0, 0] = True          # more occupied than K
    occ[0, 1] = False         # none occupied
    t = rng.uniform(size=(2, 7, S)).astype(np.float32) + 0.5
    xyz = rng.uniform(-1, 1, size=(2, 7, S, 3)).astype(np.float32)
    ref = jocc.compact_gather(jnp.asarray(occ), k, jnp.asarray(t),
                              jnp.asarray(xyz))
    out = tocc.compact_gather(torch.from_numpy(occ), k, torch.from_numpy(t),
                              torch.from_numpy(xyz))
    # a one-hot contraction with a single 1.0 on the JAX side: exact
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", ["none", "some", "all", "more_than_k"])
def test_compact_samples_matches_jax_exactly(case):
    """Indices and valid flags equal JAX's, invalid slots holding index 0:
    rays with no occupied sample, a few, all S, and more than K (the first
    K in depth order)."""
    S, k = 24, 8
    rng = np.random.default_rng(len(case))
    occ = {"none": np.zeros((3, 5, S), bool),
           "some": rng.uniform(size=(3, 5, S)) < 0.2,
           "all": np.ones((3, 5, S), bool),
           "more_than_k": rng.uniform(size=(3, 5, S)) < 0.7}[case]
    ref_idx, ref_valid = jocc.compact_samples(jnp.asarray(occ), k)
    idx, valid = tocc.compact_samples(torch.from_numpy(occ), k)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert not idx[~valid].any()
    if case == "more_than_k":
        assert occ.sum(-1).max() > k and valid.all()


def test_update_with_injected_jitter_matches_jax():
    G = 32
    jcfg = jocc.OccupancyGridConfig(resolution=G)
    tcfg = tocc.OccupancyGridConfig(resolution=G)
    grid, _ = _grid_and_points(G)
    key = jax.random.key(3)

    def jfn(x):
        return jnp.exp(-4.0 * jnp.sum(x * x, axis=-1)) + 0.1 * x[:, 0]

    def tfn(x):
        return torch.exp(-4.0 * torch.sum(x * x, dim=-1)) + 0.1 * x[:, 0]

    ref = np.asarray(jocc.update(jnp.asarray(grid), jfn, key, jcfg))
    u = np.array(jax.random.uniform(key, (G ** 3, 3)))
    out = tocc.update(torch.from_numpy(grid), tfn, tcfg,
                      u=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_cpu_tensors_take_the_plain_path():
    grid, x = _grid_and_points()
    packed = tog.pack_bits(torch.from_numpy(grid) > 0.01)
    _build.reset_launches()
    tog.occupancy_lookup(torch.from_numpy(x), packed, 32, 1.0)
    assert _build.LAUNCHES.get(tog.LOOKUP, 0) == 0
