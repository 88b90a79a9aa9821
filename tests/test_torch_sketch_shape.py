"""The port's sketch-shape guidance (tpunerf_torch.fields.sketch_shape, the
C++ SDF grid of tpunerf_torch.native, the shape loss in the scene and the
latent-NeRF step) against the JAX package's on the same inputs: the SDF
grid by numpy (bit for bit) and by C++ (1e-6), the 2× prefilter, the
one-gather and trilinear lookups, the loss and its gradient; a scene's
state_dict holds no SDF. The sketch-guided train step is held to JAX's in
test_torch_train_step.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, one_torch_thread  # noqa: F401
from tpunerf import native as jnative
from tpunerf.fields import sketch_shape as jss
from tpunerf_torch import native as tnative
from tpunerf_torch.fields import sketch_shape as tss
from tpunerf_torch.fields.scene import LatentNeRFScene as TScene
from tpunerf_torch.meshrep import shapes as tshapes

CPU = torch.device("cpu")
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def torus(R: float = 0.5, r: float = 0.2, n: int = 16, m: int = 8):
    """A closed, outward-wound torus about the y axis (genus 1: points in
    its hole are outside although every direction from them meets it)."""
    u = np.arange(n) * 2 * np.pi / n
    v = np.arange(m) * 2 * np.pi / m
    U, V = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([(R + r * np.cos(V)) * np.cos(U), r * np.sin(V),
                      (R + r * np.cos(V)) * np.sin(U)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    a = i * m + j
    b = ((i + 1) % n) * m + j
    c = ((i + 1) % n) * m + (j + 1) % m
    d = i * m + (j + 1) % m
    faces = np.concatenate([np.stack([a, d, c], -1).reshape(-1, 3),
                            np.stack([a, c, b], -1).reshape(-1, 3)])
    return verts.astype(np.float32), faces.astype(np.int32)


def _meshes():
    ico = tshapes.icosphere(1, radius=0.5)
    return {"icosphere": (ico.vertices.numpy(), ico.faces.numpy()),
            "torus": torus()}


MESHES = _meshes()


def _jax_numpy_grid(monkeypatch, verts, faces, G):
    """The JAX package's SDFGrid.from_mesh down its numpy path."""
    monkeypatch.setattr(jnative, "sdf_grid", lambda *a, **k: None)
    return jss.SDFGrid.from_mesh(verts, faces, resolution=G)


def test_torus_is_wound_outward_with_an_empty_hole():
    verts, faces = MESHES["torus"]
    wn = tss._winding_number_np(
        np.array([[0.5, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.5, 0.0]]),
        verts.astype(np.float64), faces.astype(np.int64))
    np.testing.assert_allclose(wn, [1.0, 0.0, 0.0], atol=1e-9)


@pytest.mark.parametrize("name, G", [("icosphere", 12), ("torus", 10)])
def test_numpy_sdf_grid_equals_jax(monkeypatch, name, G):
    verts, faces = MESHES[name]
    ref = np.asarray(_jax_numpy_grid(monkeypatch, verts, faces, G).values)
    got = tss.SDFGrid.from_mesh(verts, faces, resolution=G,
                                use_native=False, device=CPU)
    # the same numpy code on the same inputs
    np.testing.assert_array_equal(got.values.numpy(), ref)
    assert (ref < 0).any() and (ref > 0).any()
    if name == "torus":      # the hole's centre lies outside
        assert ref[G // 2, G // 2, G // 2] > 0


@pytest.mark.skipif(not jnative.native_available(),
                    reason="the JAX package's native library is not built")
@pytest.mark.parametrize("name, G", [("icosphere", 16), ("torus", 16)])
def test_native_sdf_grid_matches_jax_native(name, G):
    verts, faces = MESHES[name]
    ref = jnative.sdf_grid(verts, faces, G, 1.0)
    got = tnative.sdf_grid(verts, faces, G, 1.0)
    # one source, built with and without -march=native (FMA contraction)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))


def test_native_sdf_grid_matches_the_numpy_one():
    verts, faces = MESHES["torus"]
    G = 10
    np.testing.assert_allclose(tnative.sdf_grid(verts, faces, G, 0.8),
                               tss.sdf_grid_np(verts, faces, G, 0.8),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("G", [7, 12])
def test_prefilter_matches_jax_image_resize(G):
    values = np.random.default_rng(G).standard_normal(
        (G, G, G)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(values), (2 * G,) * 3, "linear")
    got = tss.prefilter(torch.from_numpy(values))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def grids():
    """The icosphere's 12³ grid in both packages, the port's built from
    the JAX grid's values."""
    verts, faces = MESHES["icosphere"]
    jgrid = jss.SDFGrid.from_mesh(verts, faces, resolution=12)
    tgrid = tss.SDFGrid(torch.from_numpy(np.array(jgrid.values)), 1.0)
    return jgrid, tgrid


def _points(n=4096, G2=24):
    """Uniform points past the bound (the clamp), and points whose index
    u is exactly k + ½ (the rounding's ties, half to even)."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.05, 1.05, (n, 3)).astype(np.float32)
    ties = (np.arange(0, G2 + 1, 3) / (G2 / 2) - 1.0).astype(np.float32)
    x[:len(ties)] = ties[:, None]
    return x


def test_sample_fast_and_sample_match_jax(grids):
    jgrid, tgrid = grids
    x = _points()
    ref_fast = np.asarray(jgrid.sample_fast(jnp.asarray(x)))
    # on the JAX package's own prefiltered copy: the same gathered slots
    shared = tss.SDFGrid(tgrid.values, 1.0)
    shared.pref = torch.from_numpy(np.array(jgrid._pref))
    np.testing.assert_array_equal(
        shared.sample_fast(torch.from_numpy(x)).numpy(), ref_fast)
    # on the port's prefilter
    np.testing.assert_allclose(tgrid.sample_fast(torch.from_numpy(x)).numpy(),
                               ref_fast, rtol=0, atol=1e-6)
    ref = np.asarray(jgrid.sample(jnp.asarray(x)))
    np.testing.assert_allclose(tgrid.sample(torch.from_numpy(x)).numpy(),
                               ref, rtol=0, atol=1e-6)


def test_shape_loss_and_its_gradient_match_jax(grids):
    """σ in three bands: α = 1 − exp(−σ·0.05) clipped at 1e-5 (σ < 2e-4:
    no gradient in either), well conditioned (σ ≥ 0.02), and between them,
    where 1 − exp(·) cancels: there the libraries' exp, an ulp apart, give
    α to 2^-24/α relative, and the gradient, ∝ 1/α, as much."""
    jgrid, tgrid = grids
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-1, 1, (2, 32, 9, 3)).astype(np.float32)
    sig = np.concatenate([rng.uniform(0, 1e-4, (2, 32, 2)),
                          rng.uniform(2e-4, 0.02, (2, 32, 2)),
                          rng.uniform(0.02, 60, (2, 32, 5))], -1
                         ).astype(np.float32)
    valid = rng.uniform(size=(2, 32, 9)) < 0.7

    def jloss(s):
        return jss.sketch_shape_loss(jgrid, jnp.asarray(xyz), s,
                                     jnp.asarray(valid), 0.3)

    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(sig))
    ref_g = np.asarray(ref_g)
    s = torch.from_numpy(sig).requires_grad_(True)
    loss = tss.sketch_shape_loss(tgrid, torch.from_numpy(xyz), s,
                                 torch.from_numpy(valid), 0.3)
    loss.backward()
    got = s.grad.numpy()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    clipped, mid, bulk = sig < 1e-4, (sig >= 2e-4) & (sig < 0.02), \
        sig >= 0.02
    assert not got[clipped].any() and not ref_g[clipped].any()
    assert_close_to_max(got[bulk], ref_g[bulk], 1e-6, "dL/dσ, σ ≥ 0.02")
    alpha = 1.0 - np.exp(-sig[mid].astype(np.float64) * 0.05)
    tol = 2 * 2.0 ** -24 / alpha * np.abs(ref_g[mid]) + \
        1e-6 * np.abs(ref_g).max()
    assert (np.abs(got[mid] - ref_g[mid]) <= tol).all()
    assert got[mid][valid[mid]].all()


def test_the_sdf_stays_out_of_the_state_dict(tmp_path):
    """A scene with a guide shape holds the same state_dict keys as one
    without (the SDF grid and its prefiltered copy are buffers that are
    not saved), and either loads the other's checkpoint."""
    plain = TScene.create(tiny=True, mlp_dtype="float32", device=CPU)
    shaped = TScene.create(tiny=True, mlp_dtype="float32", device=CPU,
                           shape_path="icosphere", sdf_resolution=12)
    assert shaped.sdf is not None and plain.sdf is None
    assert tuple(shaped.sdf.values.shape) == (12, 12, 12)
    assert tuple(shaped.sdf.pref.shape) == (24 ** 3,)
    assert list(shaped.state_dict()) == list(plain.state_dict())
    assert not any("sdf" in k for k in shaped.state_dict())
    torch.save(plain.state_dict(), tmp_path / "s.pt")
    shaped.load_state_dict(torch.load(tmp_path / "s.pt"))
    plain.load_state_dict(shaped.state_dict())
