"""The band bins' overflow choice of latent-paint-mesh's renders, made on the
device so that a step is one CUDA graph, against the JAX package's
`lax.cond` functions on the same inputs, with the overflow flag both ways:
the face selection (`_select_faces_batched`, dense against binned, ids
equal) and the soft silhouette with its vertex gradient
(`_soft_batched_pallas`, forward and custom VJP), the Pallas kernels in
interpret mode as the JAX package's own tests run them, at the tolerances
of tests/test_torch_rasterize.py and tests/test_torch_soft_silhouette.py.
Where the flag holds one branch, the other branch's result is poisoned, to
show that the choice keeps only the flagged one. The chunked trainer on
these steps is held in tests/test_torch_trainer_chunk.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere as j_uv_sphere
from tpunerf_torch.kernels import rasterize as TR

CPU = torch.device("cpu")
H = W = 128
# products of up to ~400 factors in another order, exp of another library:
# tests/test_torch_soft_silhouette.py's tolerance
FWD_ATOL = 5e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _spheres(n_lat, n_lon, scale):
    """Two views of a UV sphere: NDC xy (2, F, 3, 2) and camera z
    (2, F, 3)."""
    mesh = j_uv_sphere(n_lat, n_lon)
    out = []
    for theta, phi, r in ((1.0, 0.7, 1.3), (0.6, 2.1, 1.5)):
        tr = jcam.camera_transform_from_view(theta, phi, r)
        fv_cam, fv_img, _ = jcam.prepare_vertices(
            mesh.vertices * scale, mesh.faces, jcam.perspective_projection(),
            tr)
        out.append((np.asarray(fv_img, np.float32),
                    np.asarray(fv_cam[..., 2], np.float32)))
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JR, "_SOFT_INTERPRET", True)


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["bins-hold", "bins-overflow"])
def test_gated_face_selection_equals_jax_lax_cond(monkeypatch, overflow):
    """The selection at 128² with bins of K = 128 (they hold) and 64 (they
    overflow): ids equal to JAX's `lax.cond` of the dense and the binned
    Pallas sweeps; the branch the flag does not name gives wrong ids
    here and none of them is kept."""
    fv_img, fv_z = _spheres(12, 16, 0.6)
    B, F = fv_z.shape[:2]
    K = 64 if overflow else 128
    valid = np.ones((B, F), bool)
    assert TR.uses_bins(H, W, F, K)
    pix = TR.pixel_grid_ndc(H, W, CPU)
    nb = H * W // 1024
    ylo, yhi = TR._band_ranges(H, W, nb, CPU)
    maxc = TR._bin_faces(_t(fv_img), _t(valid), ylo, yhi, K)[1]
    assert bool(maxc > K) == overflow
    ref = JR._select_faces_batched(
        JR.pixel_grid_ndc(H, W), jnp.asarray(fv_img), jnp.asarray(fv_z),
        jnp.asarray(valid), H, W, K=K, interpret=True)
    # the branch not taken: the dense sweep where the bins hold names face
    # 0 everywhere, the binned one where they overflow its slot 0
    name = "select_faces_binned" if overflow else "select_faces_dense"
    shape = (B, nb, 1024) if overflow else (B, H * W)
    skips = []

    def poisoned(*args):
        skips.append(int(args[-1]))
        return torch.zeros(shape, dtype=torch.int32)
    monkeypatch.setattr(TR, name, poisoned)
    got = TR._select_faces_batched(pix, _t(fv_img), _t(fv_z), _t(valid),
                                   H, W, K=K)
    assert skips == [1]                        # its kernel's gate: shut
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("overflow", [False, True],
                         ids=["bins-hold", "bins-overflow"])
def test_gated_soft_silhouette_equals_jax_lax_cond(interpret, monkeypatch,
                                                   overflow):
    """The soft silhouette of two views at 128² with bins of K = 128 (they
    hold) and 32 (they overflow): the mask and the vertex gradient of a
    random cotangent equal to JAX's `_soft_batched_pallas` (its `lax.cond`
    forward and backward); the branch the flag does not name gives NaN
    here, forward and backward, and none of it is kept."""
    fv, _ = _spheres(12, 16, 0.6)
    B, F = fv.shape[:2]
    sigma, K = 1e-4, 32 if overflow else 128
    assert TR.uses_bins(H, W, F, K)
    assert bool(TR._soft_bins(_t(fv), H, W, sigma, K)[1] > K) == overflow
    poisoned = []
    for name in (("soft_prod_binned_plain", "soft_grad_binned_plain")
                 if overflow else
                 ("soft_prod_dense_plain", "soft_grad_dense_plain")):
        fn = getattr(TR, name)
        monkeypatch.setattr(
            TR, name, lambda *a, _f=fn, _n=name: poisoned.append(_n)
            or torch.full_like(_f(*a), float("nan")))
    g = np.random.default_rng(3).normal(size=(B, H, W)).astype(np.float32)
    v = _t(fv).requires_grad_()
    got = TR.soft_silhouette(H, W, v, sigma=sigma, bin_k=K)
    (got * _t(g)).sum().backward()
    assert len(poisoned) == 2
    pal = JR._soft_batched_pallas(jnp.asarray(fv), H, W, sigma, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pal),
                               atol=FWD_ATOL)
    ref_grad = np.asarray(jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f, H, W, sigma, K) * g))(jnp.asarray(fv)))
    scale = float(np.abs(ref_grad).max())
    assert scale > 0
    # the same closed form on both sides, summed in another order
    np.testing.assert_allclose(v.grad.numpy(), ref_grad, atol=2e-5 * scale)
