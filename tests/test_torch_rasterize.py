"""The port's hard rasterizer against the JAX package's: the plain versions
of the two face-selection kernels against the Pallas kernels in interpret
mode (equal ids), the band bins, the overflow rule, the whole `rasterize`
with its gradients, and the hand-derived oracle cases. All f32, inputs made
with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere as j_uv_sphere
from tpunerf_torch.kernels import rasterize as TR


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _sphere_proj(n_lat=24, n_lon=32, scale=0.6, theta=1.0, phi=0.7, r=1.3):
    mesh = j_uv_sphere(n_lat, n_lon)
    tr = jcam.camera_transform_from_view(theta, phi, r)
    fv_cam, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * scale, mesh.faces, jcam.perspective_projection(), tr)
    return np.asarray(fv_img), np.asarray(fv_cam[..., 2])


def _random_tris(rng, F):
    fv_img = rng.uniform(-1.2, 1.2, (F, 3, 2)).astype(np.float32)
    fv_z = rng.uniform(-3.0, -1.0, (F, 3)).astype(np.float32)
    return fv_img, fv_z


def _dense_both(fv_img, fv_z, valid, H, W):
    pix = JR.pixel_grid_ndc(H, W)
    ref = JR._select_faces_pallas(pix, jnp.asarray(fv_img), jnp.asarray(fv_z),
                                  jnp.asarray(valid), interpret=True)
    rows = TR._face_rows(_t(fv_img)[None], _t(fv_z)[None], _t(valid)[None])
    got = TR.select_faces_dense(rows, TR.pixel_grid_ndc(H, W, torch.device("cpu")))
    return got[0].numpy(), np.asarray(ref), rows


def test_pixel_grid_and_band_ranges_equal_jax_bitwise():
    for H, W in ((24, 24), (128, 128), (96, 160)):
        np.testing.assert_array_equal(TR.pixel_grid_ndc(H, W, torch.device("cpu")).numpy(),
                                      np.asarray(JR.pixel_grid_ndc(H, W)))
        nb = -(-H * W // 1024)
        ylo, yhi = TR._band_ranges(H, W, nb, torch.device("cpu"))
        jlo, jhi = JR._band_ranges(H, W, nb)
        np.testing.assert_array_equal(ylo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(yhi.numpy(), np.asarray(jhi))


def test_face_rows_equal_jax(rng):
    fv_img, fv_z = _random_tris(rng, 300)
    fv_img[7] = fv_img[7, 0]                  # zero-area face
    valid = np.ones(300, bool)
    valid[11] = False
    ref = np.asarray(JR._face_rows(jnp.asarray(fv_img), jnp.asarray(fv_z),
                                   jnp.asarray(valid)))
    got = TR._face_rows(_t(fv_img), _t(fv_z), _t(valid)).numpy()
    # the same f32 operations in the same order; XLA may contract a
    # multiply-add, which moves a coefficient by an ulp
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    for bad in (7, 11):
        np.testing.assert_array_equal(got[bad], [0, 0, -1] + [0] * 9)


def test_dense_plain_equals_pallas_on_random_triangles(rng):
    fv_img, fv_z = _random_tris(rng, 500)
    got, ref, _ = _dense_both(fv_img, fv_z, np.ones(500, bool), 40, 40)
    np.testing.assert_array_equal(got, ref)
    assert (ref >= 0).mean() > 0.5


def test_dense_plain_equals_pallas_on_a_sphere():
    """Shared edges are exact z ties between neighbours, and pixel centres
    may lie on them: the lowest-id rule and the inclusive edges decide."""
    fv_img, fv_z = _sphere_proj()
    got, ref, _ = _dense_both(fv_img, fv_z, np.ones(len(fv_z), bool), 48, 48)
    np.testing.assert_array_equal(got, ref)
    assert (ref >= 0).any() and (ref < 0).any()


def test_dense_plain_with_degenerate_and_invalid_faces(rng):
    fv_img, fv_z = _random_tris(rng, 64)
    # a near full-screen face in front of everything, then made invalid
    fv_img[5] = [[-3, -3], [3, -3], [0, 3]]
    fv_z[5] = -0.5
    fv_img[9] = [[0.1, 0.1], [0.1, 0.1], [0.4, 0.4]]      # collinear
    valid = np.ones(64, bool)
    got, ref, _ = _dense_both(fv_img, fv_z, valid, 32, 32)
    np.testing.assert_array_equal(got, ref)
    assert (got == 5).mean() > 0.9
    valid[5] = False
    got, ref, _ = _dense_both(fv_img, fv_z, valid, 32, 32)
    np.testing.assert_array_equal(got, ref)
    assert not (got == 5).any() and not (got == 9).any()


def test_dense_plain_chunking_keeps_the_tie_rule(monkeypatch):
    """Coplanar overlapping copies of one face: the lowest id wins whether
    the copies fall into one block of the sweep or into several."""
    tri = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]], np.float32)
    fv_img = np.broadcast_to(tri, (37, 3, 2)).copy()
    fv_z = np.full((37, 3), -2.0, np.float32)
    rows = TR._face_rows(_t(fv_img)[None], _t(fv_z)[None],
                         torch.ones((1, 37), dtype=torch.bool))
    pix = TR.pixel_grid_ndc(16, 16, torch.device("cpu"))
    whole = TR.select_faces_dense_plain(rows, pix)
    monkeypatch.setattr(TR, "_PLAIN_BLOCK", 5 * 256)      # 5 faces a block
    parts = TR.select_faces_dense_plain(rows, pix)
    assert torch.equal(whole, parts)
    assert set(np.unique(whole.numpy())) == {-1, 0}


def test_bins_equal_jax(rng):
    fv_img, _ = _sphere_proj()
    F = fv_img.shape[0]
    H = W = 128
    nb = H * W // 1024
    valid = np.ones(F, bool)
    valid[::17] = False
    for K in (64, 512):                       # overflowing and roomy
        jlo, jhi = JR._band_ranges(H, W, nb)
        jids, jmax = JR._bin_faces(jnp.asarray(fv_img), jnp.asarray(valid),
                                   jlo, jhi, K, 0.0)
        ylo, yhi = TR._band_ranges(H, W, nb, torch.device("cpu"))
        ids, maxc = TR._bin_faces(_t(fv_img)[None], _t(valid)[None], ylo, yhi,
                                  K)
        np.testing.assert_array_equal(ids[0].numpy(), np.asarray(jids))
        assert int(maxc) == int(jmax)


def test_binned_plain_equals_pallas_binned_and_dense():
    fv_a, z_a = _sphere_proj()
    fv_b, z_b = _sphere_proj(theta=0.6, phi=2.1, r=1.5)
    fv_img, fv_z = np.stack([fv_a, fv_b]), np.stack([z_a, z_b])
    B, F = fv_z.shape[:2]
    K, H, W = 512, 128, 128
    assert TR.uses_bins(H, W, F, K)
    valid = np.ones((B, F), bool)
    ref = JR._select_faces_batched(
        JR.pixel_grid_ndc(H, W), jnp.asarray(fv_img), jnp.asarray(fv_z),
        jnp.asarray(valid), H, W, K=K, interpret=True)
    pix = TR.pixel_grid_ndc(H, W, torch.device("cpu"))
    launched = []
    binned = TR.select_faces_binned
    TR.select_faces_binned = lambda *a: launched.append(1) or binned(*a)
    try:
        got = TR._select_faces_batched(pix, _t(fv_img), _t(fv_z), _t(valid),
                                       H, W, K=K)
    finally:
        TR.select_faces_binned = binned
    assert launched == [1], "the binned sweep must have run"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and the bins change nothing: the dense sweep gives the same image
    rows = TR._face_rows(_t(fv_img), _t(fv_z), _t(valid))
    assert torch.equal(got, TR.select_faces_dense(rows, pix))


def test_binned_overflow_takes_the_dense_sweep(monkeypatch):
    """Bins that overflow K must route through the dense sweep (a dropped
    face would be silently wrong), as tests/test_rasterize.py holds JAX.
    The choice is made on the device: both sweeps run (the binned one gated
    shut on a card), and the dense one's ids are kept, whatever the binned
    one gives (here slots that would name wrong faces)."""
    F, K, H, W = 200, 64, 128, 128
    tri = np.array([[-0.9, -0.9], [0.9, -0.9], [0.0, 0.9]], np.float32)
    fv_img = np.broadcast_to(tri, (F, 3, 2)).copy()
    fv_z = np.broadcast_to((-2.0 + 0.001 * np.arange(F, dtype=np.float32))
                           [:, None], (F, 3)).copy()
    valid = np.ones(F, bool)
    ref = JR._select_faces_batched(
        JR.pixel_grid_ndc(H, W), jnp.asarray(fv_img)[None],
        jnp.asarray(fv_z)[None], jnp.asarray(valid)[None], H, W, K=K,
        interpret=True)

    swept = []

    def wrong(rows, ids, pix, width, skip):
        swept.append(int(skip))            # the binned kernel's gate: shut
        return torch.zeros((1, ids.shape[1], 1024), dtype=torch.int32)

    monkeypatch.setattr(TR, "select_faces_binned", wrong)
    got = TR._select_faces_batched(TR.pixel_grid_ndc(H, W, torch.device("cpu")), _t(fv_img)[None],
                                   _t(fv_z)[None], _t(valid)[None], H, W, K=K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert swept == [1]
    assert (got.numpy() == F - 1).any()       # the nearest copy wins


def test_the_gate_is_static_and_the_same_on_every_device():
    assert TR.uses_bins(512, 512, 3968) and TR.uses_bins(128, 128, 513)
    assert not TR.uses_bins(64, 64, 3968)     # the training grid
    assert not TR.uses_bins(512, 512, 512)    # too few faces


@pytest.mark.parametrize("case", ["sphere", "random"])
def test_rasterize_matches_jax(case, rng):
    """Whole `rasterize` against the JAX package's (which on the CPU takes
    its chunked scan, barycentrics divided by the face area, where the port
    follows the kernel's pre-reduced rows). A pixel may differ only where
    its centre lies within rounding of an edge: at most 0.2 % of the
    pixels here (JAX's own two formulations are held equal on such inputs
    by tests/test_rasterize.py). Features are compared on the rest."""
    if case == "sphere":
        fv_img, fv_z = _sphere_proj(12, 16)
    else:
        fv_img, fv_z = _random_tris(rng, 120)
    F = fv_z.shape[0]
    feats = rng.normal(size=(1, F, 3, 5)).astype(np.float32)
    H = W = 40
    jimg, jidx = JR.rasterize(H, W, jnp.asarray(fv_z)[None],
                              jnp.asarray(fv_img)[None], jnp.asarray(feats))
    timg, tidx = TR.rasterize(H, W, _t(fv_z)[None], _t(fv_img)[None],
                              _t(feats))
    same = tidx.numpy() == np.asarray(jidx)
    assert (~same).sum() <= 0.002 * H * W, int((~same).sum())
    assert tidx.dtype == torch.int32 and (tidx.numpy() >= 0).any()
    # same gathers and f32 barycentrics: rounding only
    np.testing.assert_allclose(timg.numpy()[same], np.asarray(jimg)[same],
                               atol=2e-5)


def test_rasterize_gradients_match_jax(rng):
    fv_img, fv_z = _sphere_proj(12, 16)
    F = fv_z.shape[0]
    feats = rng.normal(size=(1, F, 3, 3)).astype(np.float32)
    g = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    H = W = 32

    def jloss(fi, ff):
        img, _ = JR.rasterize(H, W, jnp.asarray(fv_z)[None], fi, ff)
        return jnp.sum(img * g)

    _, jidx = JR.rasterize(H, W, jnp.asarray(fv_z)[None],
                           jnp.asarray(fv_img)[None], jnp.asarray(feats))
    jg_img, jg_feat = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(fv_img)[None], jnp.asarray(feats))
    t_img = _t(fv_img)[None].requires_grad_()
    t_feat = _t(feats).requires_grad_()
    timg, tidx = TR.rasterize(H, W, _t(fv_z)[None], t_img, t_feat)
    assert np.array_equal(tidx.numpy(), np.asarray(jidx)), \
        "choose a pose without pixels on edges for the gradient check"
    (timg * _t(g)).sum().backward()
    # scatter-adds of the same terms in another order
    for got, ref in ((t_img.grad, jg_img), (t_feat.grad, jg_feat)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())
    assert t_img.grad.abs().sum() > 0 and t_feat.grad.abs().sum() > 0


# --- the hand-derived oracle cases of tests/test_oracle_raster.py ---------

def _pix_axes(n=8):
    xs = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    ys = 1.0 - (np.arange(n) + 0.5) / n * 2.0
    return xs, ys


def _raster8(fv_img, fv_z, feats):
    return TR.rasterize(8, 8, _t(fv_z, np.float32), _t(fv_img, np.float32),
                        _t(feats, np.float32))


def test_oracle_halfplane_and_inclusive_boundary():
    """NDC triangle (−1,−1),(1,−1),(−1,1): a pixel centre is inside iff
    x + y ≤ 0; the 8 centres exactly on the hypotenuse are covered."""
    _, fid = _raster8([[[[-1, -1], [1, -1], [-1, 1]]]], np.full((1, 1, 3), -2),
                      np.ones((1, 1, 3, 1)))
    xs, ys = _pix_axes(8)
    inside = (xs[None, :] + ys[:, None]) <= 0.0
    assert int(np.sum(np.isclose(xs[None, :] + ys[:, None], 0.0))) == 8
    np.testing.assert_array_equal(fid[0].numpy(), np.where(inside, 0, -1))


@pytest.mark.parametrize("z_second,winner", [(-2.0, 1), (-3.0, 0)])
def test_oracle_near_face_wins_and_lowest_id_on_ties(z_second, winner):
    """z = −2 is nearer than z = −3: listed second it wins every pixel;
    at equal depth the lower id wins."""
    tri = [[-3.0, -3.0], [3.0, -3.0], [0.0, 3.0]]
    _, fid = _raster8([[tri, tri]], [[[-3.0] * 3, [z_second] * 3]],
                      np.ones((1, 2, 3, 1)))
    assert (fid.numpy() == winner).all()


def test_oracle_ndc_y_flip():
    _, fid = _raster8([[[[-0.9, 0.05], [0.9, 0.05], [0.0, 0.95]]]],
                      np.full((1, 1, 3), -2), np.ones((1, 1, 3, 1)))
    fid = fid[0].numpy()
    assert (fid[4:] == -1).all() and (fid[:4] == 0).any()


def test_oracle_barycentric_affine_exactness():
    tri = np.array([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]])
    f = lambda p: 0.3 + 0.5 * p[..., 0] - 0.25 * p[..., 1]  # noqa: E731
    img, fid = _raster8(tri[None, None], np.full((1, 1, 3), -2),
                        f(tri)[None, None, :, None])
    xs, ys = _pix_axes(8)
    px = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)
    covered = fid[0].numpy() >= 0
    np.testing.assert_allclose(img[0, ..., 0].numpy()[covered],
                               f(px)[covered], atol=1e-5)


def test_soft_silhouette_of_one_triangle_is_an_oracle():
    """Inside the triangle the mask is 1; outside it is exp(−d²/σ) of the
    distance to the nearest edge, here the bottom edge y = −0.5."""
    tri = torch.tensor([[[[-0.6, -0.5], [0.6, -0.5], [0.0, 0.7]]]])
    sigma = 1e-2
    mask = TR.soft_silhouette(8, 8, tri, sigma=sigma)[0].numpy()
    xs, ys = _pix_axes(8)
    assert mask[3, 3] == 1.0 and mask[3, 4] == 1.0         # interior
    for row in (6, 7):                                     # below the base
        d = -0.5 - ys[row]
        # 1 − (1 − p) in f32: an ulp of 1
        np.testing.assert_allclose(mask[row, 3], np.exp(-d * d / sigma),
                                   rtol=1e-5, atol=1.2e-7)
    assert mask[0, 0] < 1e-12                              # far corner
    feats, soft, fid = TR.dibr_rasterization(
        8, 8, torch.full((1, 1, 3), -2.0), tri, torch.ones((1, 1, 3, 1)),
        sigma=sigma)
    np.testing.assert_array_equal(soft[0].numpy(), mask)
    assert ((fid[0].numpy() >= 0) == (mask == 1.0)).all()
