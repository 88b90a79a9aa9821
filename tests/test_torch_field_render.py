"""The port's field and renderer (tpunerf_torch.fields) against the JAX
package's on the same weights and draws: camera and poses, rays and the
AABB span, compositing, trunc_exp, the tiny latent-NeRF field, and a whole
train render with an occupancy grid that prunes samples."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree
from tpunerf.core import camera as jcam
from tpunerf.core import views as jviews
from tpunerf.fields import volume_render as jvr
from tpunerf.fields.latent_nerf import trunc_exp as jtrunc_exp
from tpunerf.fields.scene import LatentNeRFScene as JScene
from tpunerf_torch.core import camera as tcam
from tpunerf_torch.core import views as tviews
from tpunerf_torch.fields import volume_render as tvr
from tpunerf_torch.fields.latent_nerf import trunc_exp as ttrunc_exp
from tpunerf_torch.fields.scene import LatentNeRFScene as TScene
from tpunerf_torch.weights import load_flax_params

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scenes():
    """Tiny scenes (f32 MLPs) holding the same parameters, with an
    occupancy grid in which about half the cells are empty."""
    js = JScene.create(tiny=True, mlp_dtype="float32")
    params = jax.jit(js.init_params)(jax.random.key(0))
    G = js.occ_cfg.resolution
    grid = np.random.default_rng(0).uniform(size=(G ** 3,)) * 0.02
    params["occ_grid"] = jnp.asarray(grid, jnp.float32)
    ts = TScene.create(tiny=True, mlp_dtype="float32", device=CPU)
    load_flax_params(ts, np_tree(params), "scene")
    return js, params, ts


def _views(key, n=2):
    jv = jviews.rand_poses(key, n, jviews.ViewSamplerConfig())
    tv = tviews.ViewBatch(theta=_t(jv.theta), phi=_t(jv.phi),
                          radius=_t(jv.radius),
                          dirs=_t(jv.dirs).long(), is_body=_t(jv.is_body))
    return jv, tv


def test_rand_poses_with_injected_draws():
    key = jax.random.key(4)
    cfg = jviews.ViewSamplerConfig(body_prob=0.5)
    ref = jviews.rand_poses(key, 64, cfg)
    u = np.stack([np.asarray(jax.random.uniform(k, (64,)))
                  for k in jax.random.split(key, 4)])
    out = tviews.rand_poses(64, tviews.ViewSamplerConfig(body_prob=0.5), CPU,
                            u=_t(u))
    for name in ("theta", "phi", "radius"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6)
    np.testing.assert_array_equal(out.dirs.numpy(), np.asarray(ref.dirs))
    np.testing.assert_array_equal(out.is_body.numpy(),
                                  np.asarray(ref.is_body))


def test_camera_transforms_match_jax():
    rng = np.random.default_rng(1)
    theta = np.concatenate([[0.0, math.pi], rng.uniform(0, math.pi, 30)]
                           ).astype(np.float32)
    phi = rng.uniform(0, 2 * math.pi, 32).astype(np.float32)
    radius = rng.uniform(1, 1.5, 32).astype(np.float32)
    pos_j = jcam.spherical_camera_position(theta, phi, radius)
    pos_t = tcam.spherical_camera_position(_t(theta), _t(phi), _t(radius))
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-6)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    M_j = jcam.look_at_transform(pos_j, np.zeros(3, np.float32), up)
    M_t = tcam.look_at_transform(pos_t, torch.zeros(3), _t(up))
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-5)
    dirs_j = jcam.get_view_direction(theta, phi, math.radians(30),
                                     math.radians(60))
    dirs_t = tcam.get_view_direction(_t(theta), _t(phi), math.radians(30),
                                     math.radians(60))
    np.testing.assert_array_equal(dirs_t.numpy(), np.asarray(dirs_j))


def test_generate_rays_match_jax():
    jv, tv = _views(jax.random.key(2), 3)
    ref = jvr.generate_rays(jv.theta, jv.phi, jv.radius, 16, 12,
                            fovy=math.pi / 3, look_at_height=0.25)
    out = tvr.generate_rays(tv.theta, tv.phi, tv.radius, 16, 12,
                            fovy=math.pi / 3, look_at_height=0.25)
    for a, b, name in zip(out, ref, ("origins", "dirs", "near", "far")):
        # the same f32 ops, matrix products summed in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_composite_matches_jax():
    rng = np.random.default_rng(3)
    sigma = rng.uniform(0, 30, (2, 5, 16)).astype(np.float32)
    color = rng.standard_normal((2, 5, 16, 4)).astype(np.float32)
    dt = rng.uniform(0.01, 0.05, (2, 5, 1)).astype(np.float32)
    valid = rng.uniform(size=(2, 5, 16)) < 0.7
    t = np.sort(rng.uniform(0.5, 2, (2, 5, 16)), -1).astype(np.float32)
    ref = jvr.composite(sigma, color, dt, valid, t)
    out = tvr.composite(*(_t(a) for a in (sigma, color, dt, valid, t)))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_trunc_exp_clamps_forward_and_backward():
    x = np.array([-40.0, -15.5, -15.0, -1.0, 0.0, 3.0, 15.0, 15.5, 100.0],
                 np.float32)
    ref, vjp = jax.vjp(jtrunc_exp, jnp.asarray(x))
    (gref,) = vjp(jnp.ones_like(ref))
    xt = _t(x).requires_grad_(True)
    out = ttrunc_exp(xt)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), rtol=1e-6)
    assert xt.grad[-1] == pytest.approx(math.exp(15.0), rel=1e-6)


def test_tiny_field_matches_jax(scenes):
    js, params, ts = scenes
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    d = rng.standard_normal((500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sig_j, col_j = js.field.apply(params["field"], x, d)
    bg_j = js.field.apply(params["field"], d, method=js.field.background)
    with torch.no_grad():
        sig_t, col_t = ts.field(_t(x), _t(d))
        bg_t = ts.field.background(_t(d))
    # same arithmetic, other summation order: ~1e-5 relative
    assert_close_to_max(sig_t.numpy(), np.asarray(sig_j), 1e-5, "sigma")
    assert_close_to_max(col_t.numpy(), np.asarray(col_j), 1e-5, "color")
    assert_close_to_max(bg_t.numpy(), np.asarray(bg_j), 1e-5, "background")


def test_train_render_with_injected_jitter_matches_jax(scenes):
    js, params, ts = scenes
    jv, tv = _views(jax.random.key(6), 2)
    key = jax.random.key(7)
    ref = jax.jit(js.render_train)(params, jv, key, jnp.asarray(1))
    # render_rays draws its jitter as uniform(key, (B, P, S))
    u = np.asarray(jax.random.uniform(key, (2, ts.train_grid_size ** 2,
                                            ts.march.num_samples)))
    with torch.no_grad():
        out = ts.render_train(tv, u=_t(u))
    valid, ref_valid = out["valid"].numpy(), np.asarray(ref["valid"])
    assert 0 < valid.mean() < 1       # the grid prunes some samples
    # Rays agree to ~1e-7 (test_generate_rays_match_jax), so a sample that
    # lies within that distance of a cell wall may fall in another cell on
    # each side, and its ray then compacts other samples. The lookup itself
    # is exact on equal inputs (test_torch_occupancy.py). Compare the rays
    # whose compacted samples agree, and require nearly all to.
    xyz, ref_xyz = out["xyzs"].numpy(), np.asarray(ref["xyzs"])
    same = (np.all(valid == ref_valid, axis=-1)
            & np.all(np.abs(xyz - ref_xyz) <= 1e-5, axis=(-1, -2)))
    assert same.mean() >= 0.999, same.mean()
    for name in ("image", "weights_sum", "depth", "sigmas", "weights"):
        a = out[name].numpy().reshape(*same.shape, -1)
        b = np.asarray(ref[name]).reshape(*same.shape, -1)
        assert_close_to_max(a[same], b[same], 1e-5, name)
    for name in ("sparsity_loss", "opacity_loss"):
        # means over all rays: the rays that differ move them by at most
        # their share
        np.testing.assert_allclose(float(out[name]), float(ref[name]),
                                   rtol=1e-5 + 2 * (1 - same.mean()))


def test_sketch_shape_and_mesh_extraction_name_their_slice(scenes):
    _, _, ts = scenes
    with pytest.raises(NotImplementedError, match="A.7"):
        TScene.create(tiny=True, shape_path="sphere")
    with pytest.raises(NotImplementedError, match="A.7"):
        ts.extract_mesh()
