"""The shading and geometry parts of latent-paint-mesh in the port against
the JAX package's: uniform Laplacian, vertex normals, SH lighting, the
displacement MLP (through weights.py), the DDIM step, and the renderer's
displacement / normals / lights / soft-mask branches with their gradients.
Procedural meshes, float32, inputs from a numpy seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree
from tpunerf.guidance import schedulers as jsched
from tpunerf.meshrep import render as jrender
from tpunerf.meshrep import shapes as jshapes
from tpunerf.meshrep.displacement_mlp import DisplacementMLP as JMLP
from tpunerf.meshrep.laplacian import UniformLaplacian as JLap
from tpunerf_torch.core import camera as tcam
from tpunerf_torch.guidance import schedulers as tsched
from tpunerf_torch.meshrep import render as trender
from tpunerf_torch.meshrep import shapes as tshapes
from tpunerf_torch.meshrep.displacement_mlp import DisplacementMLP as TMLP
from tpunerf_torch.meshrep.laplacian import UniformLaplacian as TLap
from tpunerf_torch.weights import load_flax_params

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", ["sphere", "icosphere"])
def test_uniform_laplacian_matches_jax(rng, shape):
    jm = jshapes.load_shape(shape)
    faces = np.asarray(jm.faces)
    V = jm.num_vertices
    jl = JLap.from_faces(faces, V)
    tl = TLap.from_faces(faces, V, CPU)
    np.testing.assert_array_equal(tl.src.numpy(), np.asarray(jl.src))
    np.testing.assert_array_equal(tl.dst.numpy(), np.asarray(jl.dst))
    np.testing.assert_array_equal(tl.inv_degree.numpy(),
                                  np.asarray(jl.inv_degree))
    v = rng.normal(size=(V, 3)).astype(np.float32)
    # a scatter-add of ≤ 32 neighbours in another order: f32 rounding
    np.testing.assert_allclose(tl.matvec(_t(v)).numpy(),
                               np.asarray(jl.matvec(jnp.asarray(v))),
                               atol=2e-6)
    v0 = jl.matvec(jm.vertices)
    ref, ref_grad = jax.value_and_grad(lambda x: jl.loss(x, v0))(
        jnp.asarray(v))
    x = _t(v).requires_grad_()
    loss = tl.loss(x, _t(v0))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert_close_to_max(x.grad.numpy(), np.asarray(ref_grad), 1e-5,
                        "laplacian loss gradient")
    # constant fields have zero Laplacian coordinates (the sphere's two
    # unreferenced vertices have no neighbours: −v there)
    used = tl.inv_degree > 0
    assert tl.matvec(torch.ones((V, 3)))[used].abs().max() < 1e-6


def test_vertex_normals_match_jax_with_gradient(rng):
    jm = jshapes.uv_sphere(12, 16)
    verts = (np.asarray(jm.vertices)
             + 0.05 * rng.normal(size=jm.vertices.shape)).astype(np.float32)
    faces = np.asarray(jm.faces)
    w = rng.normal(size=verts.shape).astype(np.float32)
    ref, ref_grad = jax.value_and_grad(
        lambda v: jnp.sum(jrender.compute_vertex_normals(v, jm.faces) * w))(
        jnp.asarray(verts))
    ref_n = jrender.compute_vertex_normals(jnp.asarray(verts), jm.faces)
    v = _t(verts).requires_grad_()
    got = trender.compute_vertex_normals(v, _t(faces))
    # a scatter-add of ≤ 16 face normals in another order, then a normalise
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_n),
                               atol=1e-6)
    used = np.zeros(len(verts), bool)
    used[faces.reshape(-1)] = True      # unreferenced vertices stay zero
    np.testing.assert_allclose(got.detach().norm(dim=-1).numpy()[used], 1.0,
                               atol=1e-6)
    assert (got.detach().numpy()[~used] == 0).all()
    (got * _t(w)).sum().backward()
    assert_close_to_max(v.grad.numpy(), np.asarray(ref_grad), 2e-5,
                        "vertex-normal gradient")


def test_sh_lighting_matches_jax(rng):
    n = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    lights = rng.normal(size=(2, 9)).astype(np.float32)
    ref = jrender.spherical_harmonic_lighting(jnp.asarray(n),
                                              jnp.asarray(lights))
    got = trender.spherical_harmonic_lighting(_t(n), _t(lights))
    assert got.shape == (2, 6, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # band 0 alone: constant 0.282095 · l0
    flat = torch.zeros((1, 9))
    flat[0, 0] = 3.0
    np.testing.assert_allclose(
        trender.spherical_harmonic_lighting(_t(n[:1]), flat).numpy(),
        3.0 * 0.282095, atol=1e-6)
    assert trender._SH_C == jrender._SH_C


def test_displacement_mlp_matches_jax_through_the_weight_bridge(rng):
    jm = JMLP()
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(verts))
    # the output layer starts at zero: give it values so the test sees it
    params = jax.tree_util.tree_map(lambda a: a, params)
    tree = np_tree(params)
    tree["params"]["out_proj"]["kernel"] = rng.normal(
        size=(128, 3)).astype(np.float32)
    tm = load_flax_params(TMLP(), tree, "displacement_mlp")
    ref = jm.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                   jnp.asarray(verts))
    got = tm(_t(verts))
    assert got.shape == (50, 3)
    # five GroupNorm layers at flax's eps 1e-6; f32 matmuls
    assert_close_to_max(got.detach().numpy(), np.asarray(ref), 2e-5,
                        "displacement MLP")
    assert all(n.eps == 1e-6 for n in tm.norms)
    fresh = TMLP()
    assert fresh(_t(verts)).abs().max() == 0     # zero-initialised output
    with pytest.raises(KeyError):
        load_flax_params(TMLP(depth=4), tree, "displacement_mlp")


def test_ddim_timesteps_and_step_match_jax(rng):
    for n in (50, 20, 7):
        np.testing.assert_array_equal(
            tsched.ddim_timesteps(n, device=CPU).numpy(),
            np.asarray(jsched.ddim_timesteps(n)))
    js = jsched.NoiseSchedule.scaled_linear()
    ts = tsched.NoiseSchedule.scaled_linear(device=CPU)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    for t in (981, 181, 1):          # t = 1 steps past 0: uses ᾱ₀
        ref = jsched.ddim_step(js, jnp.asarray(eps), jnp.asarray(t),
                               jnp.asarray(x), 50)
        got = tsched.ddim_step(ts, _t(eps), torch.tensor(t), _t(x), 50)
        # 1/√ᾱ_t reaches ~15 at t = 981: relative tolerance
        np.testing.assert_allclose(got.pred_x0.numpy(),
                                   np.asarray(ref.pred_x0), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(got.prev_sample.numpy(),
                                   np.asarray(ref.prev_sample), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(ts.final_alpha_cumprod.item(),
                               float(js.final_alpha_cumprod), rtol=1e-7)


def _render_inputs(rng):
    jm = jshapes.uv_sphere(12, 16)
    verts = np.asarray(jm.vertices, np.float32) * 0.6
    faces = np.asarray(jm.faces)
    uv = np.asarray(jm.vt)[np.asarray(jm.ft)][None].astype(np.float32)
    tex = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    disp = (0.02 * rng.normal(size=verts.shape)).astype(np.float32)
    lights = np.zeros((1, 9), np.float32)
    lights[0, 0] = 3.0
    lights[0, 1:] = 0.3 * rng.normal(size=8)
    return verts, faces, uv, tex, disp, lights


@pytest.mark.parametrize("camera", ["body", "head"])
def test_render_with_displacement_normals_lights_and_soft_mask(rng, camera):
    verts, faces, uv, tex, disp, lights = _render_inputs(rng)
    theta, phi, radius = [1.0, 0.6], [0.7, 2.1], [1.3, 1.2]
    jspec = getattr(jrender, f"{camera.upper()}_CAMERA")
    tspec = getattr(trender, f"{camera.upper()}_CAMERA")
    assert (jspec.fovy, jspec.look_at_height) == (tspec.fovy,
                                                  tspec.look_at_height)
    kw = dict(dims=(24, 24), detach_uv=False, compute_normals=True,
              soft_mask_sigma=1e-4)
    ref = jrender.render_single_view_texture(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uv),
        jnp.asarray(tex), theta, phi, radius, spec=jspec,
        displacement=jnp.asarray(disp), lights=jnp.asarray(lights), **kw)
    got = trender.render_single_view_texture(
        _t(verts), _t(faces), _t(uv), _t(tex), theta, phi, radius,
        spec=tspec, displacement=_t(disp), lights=_t(lights), **kw)
    same = got.face_idx.numpy() == np.asarray(ref.face_idx)
    assert (~same).sum() <= 2, "only pixels within rounding of an edge"
    assert (got.face_idx >= 0).any()
    # the head camera's narrow field is filled by the sphere
    assert (got.face_idx < 0).any() == (camera == "body")
    for name in ("image", "depth", "normals", "lighting"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape, name
        # barycentrics of f32 projections; normals by a scatter-add
        np.testing.assert_allclose(g[same], r[same], atol=5e-5, err_msg=name)
    # the soft mask: another formulation of the edge distance on the JAX
    # side (the XLA scan divides where the rows multiply by a reciprocal);
    # a coordinate's rounding moves p = exp(−d²/σ) by ~1e-5 at σ = 1e-4,
    # more under these cameras' magnification: 2.3e-5 seen
    np.testing.assert_allclose(got.mask.numpy(), np.asarray(ref.mask),
                               atol=5e-5)
    assert got.lighting.min() >= 1e-8 and got.lighting.max() <= 1.0
    assert got.mask.shape == (2, 24, 24, 1)


def test_render_gradients_reach_displacement_and_lights(rng):
    verts, faces, uv, tex, disp, lights = _render_inputs(rng)
    theta, phi, radius = [1.0], [0.7], [1.3]
    w = rng.normal(size=(1, 24, 24, 3)).astype(np.float32)
    wm = rng.normal(size=(1, 24, 24, 1)).astype(np.float32)

    def jloss(d, l):
        out = jrender.render_single_view_texture(
            jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uv),
            jnp.asarray(tex[:1]), theta, phi, radius,
            spec=jrender.BODY_CAMERA, dims=(24, 24), detach_uv=False,
            displacement=d, compute_normals=True, lights=l,
            soft_mask_sigma=1e-4)
        return (jnp.sum(out.image * out.lighting * w)
                + jnp.sum(out.normals * w) + jnp.sum(out.mask * wm)
                + jnp.sum(out.depth * wm))

    ref_d, ref_l = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(disp),
                                                   jnp.asarray(lights))
    d, l = _t(disp).requires_grad_(), _t(lights).requires_grad_()
    out = trender.render_single_view_texture(
        _t(verts), _t(faces), _t(uv), _t(tex[:1]), theta, phi, radius,
        spec=trender.BODY_CAMERA, dims=(24, 24), detach_uv=False,
        displacement=d, compute_normals=True, lights=l, soft_mask_sigma=1e-4)
    ((out.image * out.lighting * _t(w)).sum() + (out.normals * _t(w)).sum()
     + (out.mask * _t(wm)).sum() + (out.depth * _t(wm)).sum()).backward()
    # the soft mask's term is the closed form on this side and autodiff of
    # the scan on JAX's: equal but at ties (see test_torch_soft_silhouette);
    # everything else is autodiff of the same f32 graph
    ref_d = np.asarray(ref_d)
    diff = np.abs(d.grad.numpy() - ref_d)
    scale = np.abs(ref_d).max()
    assert (diff > 2e-5 * scale).mean() < 5e-3, (diff.max(), scale)
    assert diff.max() < 1e-3 * scale, (diff.max(), scale)
    assert_close_to_max(l.grad.numpy(), np.asarray(ref_l), 2e-5, "lights")
    assert np.abs(ref_d).max() > 0 and np.abs(np.asarray(ref_l)).max() > 0


def test_required_devices_have_no_default():
    with pytest.raises(TypeError):
        tcam.perspective_projection(math.pi / 3)
    with pytest.raises(TypeError):
        trender.CameraSpec().projection()
    from tpunerf_torch.kernels.rasterize import pixel_grid_ndc
    with pytest.raises(TypeError):
        pixel_grid_ndc(8, 8)
    assert trender.CameraSpec().projection(CPU).device.type == "cpu"
