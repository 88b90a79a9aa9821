"""Kernel #3's design, held in PyTorch on the CPU.

The kernel multiplies by 1/bound and by 0.5 in place of the reference's two
quotients where bound is a power of two, and takes four samples a thread
where xyz starts on 16 bytes. Here its arithmetic (`_kernel_cell_index`)
is held bit for bit to the plain `cell_index` and to the JAX package's
`lookup` on samples that stress the rounding (cell walls and the floats
next to them, ±0, subnormals, ±bound), and the wrapper's choices
(`_pow2_bound`, `_lookup_plan`, `_lookup_operands`) to what the kernel
takes. Inputs are seeded numpy arrays, float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunerf.fields import occupancy as jocc
from tpunerf_torch.kernels import occgrid as og

G = 32


def _hard_samples(bound: float, seed: int) -> np.ndarray:
    """(n, 3) samples: every cell wall, the floats one and two steps either
    side of it, ±0, subnormals, ±bound, points just outside the grid, and
    uniform points; coordinates shuffled across the three axes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    walls = (np.arange(G + 1, dtype=f32) * f32(2.0 / G) - f32(1.0)) * f32(bound)
    vals = [walls]
    for steps in (1, 2):
        up, down = walls.copy(), walls.copy()
        for _ in range(steps):
            up = np.nextafter(up, f32(np.inf))
            down = np.nextafter(down, f32(-np.inf))
        vals += [up, down]
    tiny = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, 1.1754942e-38,
                     -1.1754942e-38], f32)
    edge = np.array([bound, -bound, np.nextafter(f32(bound), f32(0)),
                     np.nextafter(f32(-bound), f32(0)), 1.5 * bound,
                     -1.5 * bound], f32)
    vals += [tiny, edge, rng.uniform(-1.2, 1.2, 400).astype(f32) * f32(bound)]
    v = np.concatenate(vals).astype(f32)
    return np.stack([rng.permutation(v) for _ in range(3)], axis=-1)


@pytest.mark.parametrize("bound", [1.0, 0.5, 2.0])
def test_products_equal_the_quotients_and_jax_bit_for_bit(bound):
    assert og._pow2_bound(bound)
    x = _hard_samples(bound, int(bound * 8))
    xt = torch.from_numpy(x)
    got = og._kernel_cell_index(xt, G, bound)
    assert torch.equal(got, og.cell_index(xt, G, bound))
    # the JAX package's lookup on a grid whose value is the cell's index
    cfg = jocc.OccupancyGridConfig(resolution=G, bound=bound)
    ids = np.asarray(jocc.lookup(jnp.arange(G ** 3, dtype=jnp.float32),
                                 jnp.asarray(x), cfg))
    np.testing.assert_array_equal(got.numpy(), ids.astype(np.int64))
    # the walls' neighbours do land in two cells: the test is not vacuous
    assert len(np.unique(got.numpy())) > 3 * G


@pytest.mark.parametrize("bound, pow2", [
    (1.0, True), (0.5, True), (2.0, True), (-4.0, True), (2.0 ** -126, True),
    (2.0 ** 127, True), (2.0 ** -127, True), (2.0 ** -128, False),
    (0.7, False), (3.0, False), (1.0 + 2 ** -23, False), (0.0, False),
    (float("inf"), False), (float("nan"), False)])
def test_only_exact_reciprocals_take_the_products(bound, pow2):
    assert og._pow2_bound(bound) is pow2


def test_other_bounds_take_the_quotients():
    x = torch.from_numpy(_hard_samples(0.7, 3))
    vec, pow2 = og._lookup_plan(0, 0.7)
    assert vec and not pow2
    assert torch.equal(og._kernel_cell_index(x, G, 0.7),
                       og.cell_index(x, G, 0.7))
    # a product by the rounded reciprocal is not the quotient everywhere:
    # why 0.7 keeps the quotients
    u = (x * (1.0 / 0.7) + 1.0) * 0.5
    idx = torch.clamp((u * G).to(torch.int32), 0, G - 1).to(torch.int64)
    flat = (idx[..., 0] * G + idx[..., 1]) * G + idx[..., 2]
    assert not torch.equal(flat, og.cell_index(x, G, 0.7))


@pytest.mark.parametrize("n, offset, vec", [
    (4096 * 128, 0, True), (4096 * 128 + 3, 0, True), (1, 0, True),
    (255, 1, False), (1000, 2, False), (1000, 4, True)])
def test_the_wrapper_takes_four_wide_loads_only_on_16_bytes(n, offset, vec):
    """An offset view (a slice of a larger array) starts 12·offset bytes
    into its storage: the 4-wide path only where that is a multiple of 16;
    the view is passed on as it is, with no copy."""
    base = torch.zeros((n + offset, 3))
    x = base[offset:]
    xf = og._lookup_operands(x, torch.zeros(G ** 3 // 32, dtype=torch.int32),
                             G)
    assert xf.data_ptr() == x.data_ptr() and xf.shape == (n, 3)
    assert xf.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
    assert og._lookup_plan(xf.data_ptr(), 1.0) == (vec, True)
    assert (base.data_ptr() % 16 == 0) and ((12 * offset) % 16 == 0) is vec


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    words = torch.zeros(G ** 3 // 32, dtype=torch.int32)
    with pytest.raises(TypeError):
        og._lookup_operands(torch.zeros((4, 3), dtype=torch.float64), words,
                            G)
    with pytest.raises(ValueError):
        og._lookup_operands(torch.zeros((4, 2)), words, G)
    with pytest.raises(ValueError):
        og._lookup_operands(torch.zeros((4, 3)), words[:-1], G)
    with pytest.raises(ValueError, match="CUDA"):
        og.occupancy_lookup_cuda(torch.zeros((4, 3)), words, G, 1.0)
