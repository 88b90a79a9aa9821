"""The port's DIB-R soft silhouette against the JAX package's: the plain
forward against the XLA scan (`_soft_tile`) and the Pallas kernels in
interpret mode, dense and band-binned; the closed-form backward against the
Pallas VJP, `jax.grad` of the scan and torch autograd of the plain forward;
the soft bins; `dibr_rasterization`.

Inputs are projected procedural spheres and hand-made triangles, float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import rasterize as TR

CPU = torch.device("cpu")
# products of up to ~400 factors in another order, exp of another library:
# the tolerance the JAX package holds its own two versions to
FWD_ATOL = 5e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _sphere(n_lat=12, n_lon=16, theta=1.0, phi=0.7, r=1.3):
    mesh = uv_sphere(n_lat, n_lon)
    tr = jcam.camera_transform_from_view(theta, phi, r)
    _, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * 0.6, mesh.faces, jcam.perspective_projection(), tr)
    return np.array(fv_img, np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JR, "_SOFT_INTERPRET", True)


def _grad_check(got, ref, strict_rel=5e-6, loose_rel=5e-4, frac=2e-3):
    """Closed form against autodiff: equal to `strict_rel` of the largest
    gradient but for a few entries — at an exact tie of two edge distances
    the closed form gives the whole gradient to the first minimal edge and
    autodiff splits it; the JAX package measures one face in ~350 off by
    ~1e-4 relative, and holds its own pair to these same three numbers."""
    scale = max(float(np.abs(ref).max()), 1.0)
    diff = np.abs(np.asarray(got) - np.asarray(ref))
    assert (diff > strict_rel * scale).mean() < frac, \
        ((diff > strict_rel * scale).sum(), diff.max())
    assert diff.max() < loose_rel * scale, diff.max()


def test_soft_rows_equal_jax_bitwise():
    fv = _sphere()
    fv[5] = fv[5][[0, 0, 0]]                       # a degenerate face
    ref = np.asarray(JR._soft_rows(jnp.asarray(fv)))
    got = TR._soft_rows(_t(fv)[None])[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (fv.shape[0], 16) and (got[5, :3] == [0, 0, -1]).all()
    staged = TR._soft_stage(_t(ref)).numpy()
    w = fv[:, [1, 2, 0]] - fv
    np.testing.assert_allclose(
        staged[:, 16:], 1 / np.maximum((w * w).sum(-1), 1e-10), rtol=1e-6)


def test_dense_forward_matches_the_scan_and_the_pallas_kernel(interpret):
    fv = _sphere()
    H = W = 32
    sigma = 1e-4
    ref = np.asarray(JR._soft_tile(JR.pixel_grid_ndc(H, W), jnp.asarray(fv),
                                   sigma, 256)).reshape(H, W)
    pal = np.asarray(JR._soft_batched_pallas(jnp.asarray(fv)[None], H, W,
                                             sigma, 768))[0]
    before = dict(_build.LAUNCHES)
    got = TR.soft_silhouette(H, W, _t(fv)[None], sigma=sigma)[0].numpy()
    assert dict(_build.LAUNCHES) == before       # the CPU launches nothing
    np.testing.assert_allclose(got, ref, atol=FWD_ATOL)
    np.testing.assert_allclose(got, pal, atol=FWD_ATOL)
    assert got.max() == 1.0 and got.min() == 0.0
    assert ((got > 0.01) & (got < 0.99)).any()   # a soft rim exists


def test_dense_backward_matches_pallas_vjp_jax_grad_and_autograd(interpret):
    fv = _sphere()
    H = W = 32
    sigma = 1e-4
    g = np.random.default_rng(0).normal(size=(H, W)).astype(np.float32)
    pix = JR.pixel_grid_ndc(H, W)
    ref_scan = jax.grad(lambda v: jnp.sum(
        JR._soft_tile(pix, v, sigma, 256).reshape(H, W) * g))(jnp.asarray(fv))
    ref_pal = jax.grad(lambda v: jnp.sum(
        JR._soft_batched_pallas(v[None], H, W, sigma, 768)[0] * g))(
        jnp.asarray(fv))
    v = _t(fv)[None].requires_grad_()
    (TR.soft_silhouette(H, W, v, sigma=sigma)[0] * _t(g)).sum().backward()
    got = v.grad[0].numpy()
    assert got.shape == fv.shape and np.abs(got).max() > 1.0
    # the same closed form on both sides; sums over pixels in another order
    # and prod/(1 − p) near an edge with another exp: 2e-5 of the largest
    scale = float(np.abs(np.asarray(ref_pal)).max())
    np.testing.assert_allclose(got, np.asarray(ref_pal), atol=2e-5 * scale)
    _grad_check(got, ref_scan)
    # torch autograd of the plain forward, the scan's twin in the port
    v2 = _t(fv)[None].requires_grad_()
    prod = TR.soft_prod_dense_plain(TR._soft_rows(v2),
                                    TR.pixel_grid_ndc(H, W, CPU), sigma)
    ((1.0 - prod).reshape(H, W) * _t(g)).sum().backward()
    _grad_check(got, v2.grad[0].numpy())


def test_degenerate_and_outside_faces(interpret):
    # a healthy face, a zero-area face, a face wholly outside the view
    fv = np.array([[[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]],
                   [[0.2, 0.2], [0.2, 0.2], [0.2, 0.2]],
                   [[3.0, 3.0], [4.0, 3.0], [3.0, 4.0]]], np.float32)
    sigma, H, W = 1e-3, 16, 16
    ref = np.asarray(JR._soft_tile(JR.pixel_grid_ndc(H, W), jnp.asarray(fv),
                                   sigma, 256)).reshape(H, W)
    pal = np.asarray(JR._soft_batched_pallas(jnp.asarray(fv)[None], H, W,
                                             sigma, 768))[0]
    v = _t(fv)[None].requires_grad_()
    got = TR.soft_silhouette(H, W, v, sigma=sigma)
    np.testing.assert_allclose(got[0].detach().numpy(), ref, atol=FWD_ATOL)
    np.testing.assert_allclose(got[0].detach().numpy(), pal, atol=FWD_ATOL)
    assert ref[0, 15] < 0.5       # the zero-area face is not "inside"
    got.square().sum().backward()
    grad = v.grad[0].numpy()
    assert np.isfinite(grad).all()            # no 0/0 at covered pixels
    assert (grad[2] == 0).all() and np.abs(grad[0]).max() > 0
    ref_grad = jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f[None], H, W, sigma, 768) ** 2))(
        jnp.asarray(fv))
    np.testing.assert_allclose(
        grad, np.asarray(ref_grad),
        atol=2e-5 * float(np.abs(np.asarray(ref_grad)).max()))


def test_soft_bins_equal_jax_ids(interpret):
    fv = np.stack([_sphere(theta=1.0, phi=0.7), _sphere(theta=0.6, phi=2.1)])
    H = W = 128
    sigma, K = 1e-4, 128
    nb = H * W // 1024
    ids_j, over_j = JR._soft_batched_bins(jnp.asarray(fv), H, W, sigma, K, nb)
    ids_t, maxc = TR._soft_bins(_t(fv), H, W, sigma, K)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert ids_t.dtype == torch.int32 and not bool(over_j)
    assert int(maxc) <= K
    # the margin widens the bins: without it they hold fewer faces
    ylo, yhi = TR._band_ranges(H, W, nb, CPU)
    valid = torch.ones(fv.shape[:2], dtype=torch.bool)
    _, hard = TR._bin_faces(_t(fv), valid, ylo, yhi, K)
    assert int(hard) < int(maxc)
    # the gate, as the JAX package's `_soft_bins_engage`
    for args in ((H, W, fv.shape[1], K), (64, 64, fv.shape[1], K),
                 (H, W, fv.shape[1], TR._SOFT_BIN_K)):
        assert TR.uses_bins(*args) == JR._soft_bins_engage(*args)
    assert TR.uses_bins(H, W, fv.shape[1], K)


def test_binned_forward_and_backward_match_jax(interpret, monkeypatch):
    fv = np.stack([_sphere(theta=1.0, phi=0.7), _sphere(theta=0.6, phi=2.1)])
    H = W = 128
    sigma, K = 1e-4, 128
    calls = []
    plain = TR.soft_prod_binned_plain
    monkeypatch.setattr(TR, "soft_prod_binned_plain",
                        lambda *a: calls.append("binned") or plain(*a))
    g = np.random.default_rng(1).normal(size=(2, H, W)).astype(np.float32)
    v = _t(fv).requires_grad_()
    got = TR.soft_silhouette(H, W, v, sigma=sigma, bin_k=K)
    assert calls == ["binned"]
    # not the overflow branch: the flag the forward saved keeps the binned
    # product
    assert int(TR._soft_bins(v.detach(), H, W, sigma, K)[1]) <= K
    pal = JR._soft_batched_pallas(jnp.asarray(fv), H, W, sigma, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pal),
                               atol=FWD_ATOL)
    pix = JR.pixel_grid_ndc(H, W)
    for b in range(2):
        ref = JR._soft_tile(pix, jnp.asarray(fv[b]), sigma, 256)
        np.testing.assert_allclose(got[b].detach().numpy(),
                                   np.asarray(ref).reshape(H, W),
                                   atol=FWD_ATOL)
    (got * _t(g)).sum().backward()
    ref_grad = np.asarray(jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f, H, W, sigma, K) * g))(jnp.asarray(fv)))
    scale = float(np.abs(ref_grad).max())
    # the same rows per (band, slot) summed back by id in another order
    np.testing.assert_allclose(v.grad.numpy(), ref_grad, atol=2e-5 * scale)
    # binned against dense in the port: the bins drop only faces whose tail
    # is below 1e-12 (gradient tail ~1e-7 at this sigma)
    v2 = _t(fv).requires_grad_()
    dense = TR.soft_silhouette(H, W, v2, sigma=sigma, bin_k=10 ** 6)
    np.testing.assert_allclose(dense.detach().numpy(), got.detach().numpy(),
                               atol=1e-6)
    (dense * _t(g)).sum().backward()
    np.testing.assert_allclose(v2.grad.numpy(), v.grad.numpy(),
                               atol=1e-5 * scale)
    for b in range(2):
        ref_scan = jax.grad(lambda f: jnp.sum(
            JR._soft_tile(pix, f, sigma, 256).reshape(H, W) * g[b]))(
            jnp.asarray(fv[b]))
        _grad_check(v.grad[b].numpy(), np.asarray(ref_scan))


def test_overflowing_bins_take_the_dense_sweep_forward_and_backward(
        interpret, monkeypatch):
    F = 160
    tri = np.array([[-0.8, -0.8], [0.8, -0.8], [0.0, 0.8]], np.float32)
    fv = (np.broadcast_to(tri, (F, 3, 2))
          + 0.001 * np.arange(F, dtype=np.float32)[:, None, None])[None]
    sigma, K, H, W = 1e-3, 64, 128, 128
    assert int(TR._soft_bins(_t(fv), H, W, sigma, K)[1]) > K
    assert bool(JR._soft_batched_bins(jnp.asarray(fv), H, W, sigma, K,
                                      H * W // 1024)[1])
    calls = []
    for name in ("soft_prod_dense_plain", "soft_prod_binned_plain",
                 "soft_grad_dense_plain", "soft_grad_binned_plain"):
        fn = getattr(TR, name)
        # the binned branch runs (the choice is made on the device) and
        # gives NaN here: what is kept must be the dense branch's
        poison = "binned" in name
        monkeypatch.setattr(
            TR, name, lambda *a, _f=fn, _n=name, _p=poison: calls.append(_n)
            or (torch.full_like(_f(*a), float("nan")) if _p else _f(*a)))
    v = _t(fv).requires_grad_()
    got = TR.soft_silhouette(H, W, v, sigma=sigma, bin_k=K)
    g = np.random.default_rng(2).normal(size=(1, H, W)).astype(np.float32)
    (got * _t(g)).sum().backward()
    # backward took the branch forward took: both ran, the dense one kept
    assert calls == ["soft_prod_dense_plain", "soft_prod_binned_plain",
                     "soft_grad_dense_plain", "soft_grad_binned_plain"]
    assert torch.isfinite(got).all() and torch.isfinite(v.grad).all()
    pal = JR._soft_batched_pallas(jnp.asarray(fv), H, W, sigma, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pal),
                               atol=FWD_ATOL)
    ref_grad = np.asarray(jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f, H, W, sigma, K) * g))(jnp.asarray(fv)))
    # 160 near-coincident faces: prod/(1 − p) over long products, 1e-4
    np.testing.assert_allclose(
        v.grad.numpy(), ref_grad,
        atol=1e-4 * max(float(np.abs(ref_grad).max()), 1.0))


def test_slots_to_faces_drops_the_filler():
    rows = torch.arange(2 * 2 * 3 * 6, dtype=torch.float32).reshape(2, 2, 3, 6)
    ids = torch.tensor([[[0, 2, 4], [2, 4, 4]], [[1, 4, 4], [4, 4, 4]]],
                       dtype=torch.int32)           # 4 faces, filler id 4
    out = TR._slots_to_faces(rows, ids, 4)
    assert out.shape == (2, 4, 6)
    np.testing.assert_array_equal(out[0, 0].numpy(), rows[0, 0, 0].numpy())
    np.testing.assert_array_equal(out[0, 2].numpy(),
                                  (rows[0, 0, 1] + rows[0, 1, 0]).numpy())
    assert (out[0, 1] == 0).all() and (out[0, 3] == 0).all()
    np.testing.assert_array_equal(out[1, 1].numpy(), rows[1, 0, 0].numpy())
    assert out[1, [0, 2, 3]].abs().sum() == 0


def test_dibr_rasterization_matches_jax(rng):
    mesh = uv_sphere(12, 16)
    tr = jcam.camera_transform_from_view(
        jnp.asarray([1.0, 0.5]), jnp.asarray([0.7, 2.0]),
        jnp.asarray([1.3, 1.2]))
    fv_cam, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * 0.6, mesh.faces, jcam.perspective_projection(), tr)
    feats = rng.uniform(size=(2, mesh.faces.shape[0], 3, 5)).astype(
        np.float32)
    ref = JR.dibr_rasterization(24, 24, fv_cam[..., 2], fv_img,
                                jnp.asarray(feats))
    got = TR.dibr_rasterization(24, 24, _t(fv_cam[..., 2]), _t(fv_img),
                                _t(feats))
    same = got[2].numpy() == np.asarray(ref[2])
    assert (~same).sum() <= 2, "only pixels within rounding of an edge"
    np.testing.assert_allclose(got[0].numpy()[same],
                               np.asarray(ref[0])[same], atol=2e-5)
    # against the scan's other formulation of the distance (dot/|w|² where
    # the rows multiply by a reciprocal): a residual's rounding, ~6e-8 of a
    # coordinate, moves d² by ~1e-9 and so p = exp(−d²/σ) by ~1e-5 at σ =
    # 1e-4; these poses reach 9.6e-6
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=2e-5)
    assert got[1].shape == (2, 24, 24)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    pix = TR.pixel_grid_ndc(8, 8, CPU)
    with pytest.raises(TypeError):
        TR._check_soft(torch.zeros((1, 4, 16), dtype=torch.float64), pix)
    with pytest.raises(ValueError, match=r"\(B, F, 16\)"):
        TR._check_soft(torch.zeros((1, 4, 12)), pix)
    with pytest.raises(ValueError, match="contiguous"):
        TR._check_soft(torch.zeros((1, 16, 4)).transpose(1, 2), pix)
    with pytest.raises(ValueError, match=r"\(B, P\)"):
        TR._check_soft(torch.zeros((1, 4, 16)), pix, torch.zeros((1, 63)))
    with pytest.raises(ValueError, match="int32"):
        TR._check_soft(torch.zeros((1, 4, 16)), pix,
                       ids=torch.zeros((1, 1, 8), dtype=torch.int64))
    # a CPU tensor never reaches a launch
    with pytest.raises(ValueError, match="CUDA"):
        TR.soft_prod_dense_cuda(torch.zeros((1, 4, 16)), pix, 1e-4)
