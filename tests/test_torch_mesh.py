"""The port's mesh stack against the JAX package's: camera functions, OBJ
IO, `Mesh`, the procedural shapes, the UV unwrap and the hard renderer."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpunerf.core import camera as jcam
from tpunerf.core import obj_io as jobj
from tpunerf.meshrep import render as jrender
from tpunerf.meshrep import shapes as jshapes
from tpunerf.meshrep import uv_unwrap as junwrap
from tpunerf.meshrep.mesh import Mesh as JMesh
from tpunerf_torch.core import camera as tcam
from tpunerf_torch.core import obj_io as tobj
from tpunerf_torch.meshrep import render as trender
from tpunerf_torch.meshrep import shapes as tshapes
from tpunerf_torch.meshrep import uv_unwrap as tunwrap
from tpunerf_torch.meshrep.mesh import Mesh as TMesh
from tpunerf_torch.utils import write_png


def _t(a):
    return torch.from_numpy(np.array(a))


def test_camera_transform_matches_jax_including_overhead(rng):
    theta = np.array([0.0, 1e-6, 0.3, 1.2, math.pi / 2, 2.5], np.float32)
    phi = rng.uniform(0, 2 * math.pi, 6).astype(np.float32)
    radius = rng.uniform(1.0, 1.5, 6).astype(np.float32)
    ref = np.asarray(jcam.camera_transform_from_view(theta, phi, radius,
                                                     look_at_height=0.25))
    got = tcam.camera_transform_from_view(_t(theta), _t(phi), _t(radius),
                                          look_at_height=0.25).numpy()
    assert got.shape == (6, 4, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # the overhead poses took the alternate up vector and stay orthonormal
    rot = got[:2, :3]
    np.testing.assert_allclose(rot @ rot.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-5)


def test_projection_and_prepare_vertices_match_jax(rng):
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, size=(70, 3)).astype(np.int32)
    theta = np.array([0.8, 1.9], np.float32)
    phi = np.array([0.3, 4.0], np.float32)
    # radius 0.5 puts part of the cloud behind the camera: no near clip
    radius = np.array([0.5, 1.4], np.float32)
    for fovy in (math.pi / 3, math.pi / 4):
        np.testing.assert_allclose(
            tcam.perspective_projection(fovy, device="cpu").numpy(),
            np.asarray(jcam.perspective_projection(fovy)), rtol=1e-7)
    jtr = jcam.camera_transform_from_view(theta, phi, radius)
    ttr = tcam.camera_transform_from_view(_t(theta), _t(phi), _t(radius))
    ref = jcam.prepare_vertices(jnp.asarray(verts), jnp.asarray(faces),
                                jcam.perspective_projection(), jtr)
    got = tcam.prepare_vertices(_t(verts), _t(faces),
                                tcam.perspective_projection(device="cpu"), ttr)
    assert (np.asarray(ref[0])[..., 2] > 0).any(), "some vertex is behind"
    for g, r, name in zip(got, ref, ("camera", "image", "normals")):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        # a divide by a −z near zero amplifies rounding: relative tolerance
        np.testing.assert_allclose(g.numpy(), r, rtol=2e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(
        tcam.face_normals(_t(verts)[_t(faces).long()], unit=False).numpy(),
        np.asarray(jcam.face_normals(jnp.asarray(verts)[faces], unit=False)),
        atol=1e-6)


def test_obj_round_trip_equals_the_jax_package(tmp_path, rng):
    obj = tmp_path / "quad.obj"
    obj.write_text(
        "# a quad, a triangle with negative indices, mixed forms\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\nf -1/1 -5/2 -4/3\n")
    j, t = jobj.load_mesh(obj), tobj.load_mesh(obj)
    for f in ("vertices", "faces", "uvs", "face_uvs_idx"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert t.faces.shape == (3, 3)
    albedo = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    jp = jobj.save_obj_with_mtl(tmp_path / "j", j.vertices, j.faces, j.uvs,
                                j.face_uvs_idx, albedo)
    tp = tobj.save_obj_with_mtl(tmp_path / "t", t.vertices, t.faces, t.uvs,
                                t.face_uvs_idx, albedo)
    for a, b in zip(jp[:2], tp[:2]):
        assert a.read_text() == b.read_text()
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(tp[2])),
                                  np.asarray(Image.open(jp[2])))
    back = tobj.load_obj(tp[0])
    np.testing.assert_allclose(back.vertices, t.vertices)
    np.testing.assert_array_equal(back.faces, t.faces)

    off = tmp_path / "tet.off"
    off.write_text("OFF\n4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n"
                   "3 0 1 2\n4 0 1 2 3\n")
    j, t = jobj.load_mesh(off), tobj.load_mesh(off)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.vertices, j.vertices)
    with pytest.raises(ValueError, match="not implemented"):
        tobj.load_mesh(tmp_path / "x.ply")


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 1), (4, 6, 3), (3, 3, 4)])
def test_write_png_reads_back(tmp_path, rng, shape):
    from PIL import Image
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    back = np.asarray(Image.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, img.reshape(back.shape))
    with pytest.raises(TypeError):
        write_png(tmp_path / "b.png", img.astype(np.float32))


def test_mesh_normalize_and_standardize_match_jax(tmp_path, rng):
    verts = rng.normal(size=(30, 3)).astype(np.float32) * 3 + 1
    faces = rng.integers(0, 30, size=(20, 3)).astype(np.int32)
    j = JMesh(jnp.asarray(verts), jnp.asarray(faces))
    t = TMesh(_t(verts), _t(faces))
    np.testing.assert_allclose(
        t.normalize(0.6, 0.25).vertices.numpy(),
        np.asarray(j.normalize(0.6, 0.25).vertices), atol=1e-6)
    np.testing.assert_allclose(t.standardize().vertices.numpy(),
                               np.asarray(j.standardize().vertices),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t.vertices.numpy(), verts)  # not in place
    assert (t.num_vertices, t.num_faces) == (30, 20)


@pytest.mark.parametrize("name", ["sphere", "env_sphere", "icosphere", None])
def test_procedural_shapes_equal_jax_array_for_array(name):
    j, t = jshapes.load_shape(name), tshapes.load_shape(name)
    for f in ("vertices", "faces", "vt", "ft"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b.numpy().dtype == np.asarray(a).dtype
    if name == "sphere":
        assert t.num_faces == 3968
    if name == "env_sphere":
        assert t.num_faces == 960


def test_shape_resolution_chain(tmp_path, monkeypatch):
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    monkeypatch.setenv("TPUNERF_SHAPE_DIRS", f"/nonexistent:{tmp_path}")
    assert tshapes.resolve_shape_path("shapes/tri.obj") == tmp_path / "tri.obj"
    assert tshapes.load_shape("shapes/tri.obj").num_faces == 1
    with pytest.raises(FileNotFoundError, match="TPUNERF_SHAPE_DIRS"):
        tshapes.load_shape("shapes/absent.obj")
    assert tshapes._DEFAULT_SHAPE_DIRS == jshapes._DEFAULT_SHAPE_DIRS


def test_uv_unwrap_of_the_icosphere_equals_jax(tmp_path):
    mesh = tshapes.icosphere()
    v, f = mesh.vertices.numpy(), mesh.faces.numpy()
    jvt, jft = junwrap.get_or_build_uvs(v, f, tmp_path / "j")
    tvt, tft = tunwrap.get_or_build_uvs(v, f, tmp_path / "t")
    np.testing.assert_array_equal(tvt, jvt)
    np.testing.assert_array_equal(tft, jft)
    assert tvt.min() >= 0 and tvt.max() <= 1 and tft.shape == f.shape
    # the cache is read back
    cvt, cft = tunwrap.get_or_build_uvs(v[:3], f[:1], tmp_path / "t")
    np.testing.assert_array_equal(cvt, tvt)
    gvt, gft = tunwrap.grid_atlas(v, f)
    jg = junwrap.grid_atlas(v, f)
    np.testing.assert_array_equal(gvt, jg[0])
    np.testing.assert_array_equal(gft, jg[1])
    assert tunwrap.atlas_utilization(tvt, tft) == \
        junwrap.atlas_utilization(jvt, jft)


def _planar_grid_chart(n: int = 24):
    """A planar n×n quad grid (2n² faces, no overlap)."""
    gx, gy = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    local = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    vid = lambda i, j: i * (n + 1) + j  # noqa: E731
    ft = np.array([[vid(i, j), vid(i + 1, j), vid(i, j + 1)]
                   for i in range(n) for j in range(n)]
                  + [[vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
                     for i in range(n) for j in range(n)], np.int32)
    return local, ft


def _chart_case(name: str):
    if name == "crossing slivers":
        # each one's interior samples lie outside the other; edges cross
        return np.array([[0.0, 0.45], [2.0, 0.55], [0.0, 0.55],
                         [0.95, -0.5], [1.05, 2.0], [1.05, -0.5]],
                        np.float32), np.array([[0, 1, 2], [3, 4, 5]],
                                              np.int32)
    if name == "adjacent faces":
        return (np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
                         np.float32), np.array([[0, 1, 2], [1, 3, 2]],
                                               np.int32))
    local, ft = _planar_grid_chart()
    if name == "planar grid":
        return local, ft
    # a crossing deep inside the grid; a face folded into another one
    # (no edges cross: its interior samples lie inside that face)
    V = len(local)
    extra = np.array([[0.3, 0.45], [2.5, 0.55], [0.3, 0.55],
                      [1.15, -0.5], [1.25, 2.0], [1.25, -0.5]],
                     np.float32) * 8
    if name == "planar grid with a crossing":
        return (np.concatenate([local, extra]), np.concatenate(
            [ft, np.array([[V, V + 1, V + 2], [V + 3, V + 4, V + 5]],
                          np.int32)]))
    fold = np.array([[10.1, 10.1], [10.4, 10.1], [10.1, 10.4]], np.float32)
    return (np.concatenate([local, fold]),
            np.concatenate([ft, np.array([[V, V + 1, V + 2]], np.int32)]))


@pytest.mark.parametrize("name, overlaps", [
    ("crossing slivers", True), ("adjacent faces", False),
    ("planar grid", False), ("planar grid with a crossing", True),
    ("planar grid with a folded face", True)])
def test_chart_overlap_tests_equal_jax(name, overlaps):
    """The port tests only the pairs whose boxes share a grid cell; its
    answers are the all-pairs tests' of the JAX package, in memory linear
    in the chart."""
    import tracemalloc
    local, ft = _chart_case(name)
    tris = local[ft]
    tracemalloc.start()
    got = tunwrap._chart_overlaps(local, ft)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert got == junwrap._chart_overlaps(local, ft) == overlaps
    crossing = tunwrap._edges_properly_intersect(tris)
    assert crossing == junwrap._edges_properly_intersect(tris)
    assert crossing == (overlaps and "folded" not in name)
    assert peak < 64 * 2 ** 20, f"{peak / 2 ** 20:.0f} MB"


def _blob_mesh(G: int, seed: int, noise: float):
    """An extracted noisy blob, as the NeRF→mesh bridge gives the UV
    unwrap: charts of many faces, some of them folded."""
    from tpunerf_torch.fields.marching import marching_tetrahedra
    ax = np.linspace(-1, 1, G)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    rng = np.random.default_rng(seed)
    vals = ((0.55 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)) * 30 + 10
            + rng.normal(0, noise, X.shape)).astype(np.float32)
    return marching_tetrahedra(vals, 10.0)


@pytest.mark.parametrize("mesh", ["uv sphere", "blob, smooth",
                                  "blob, folded charts"])
def test_chart_atlas_equals_jax(mesh):
    if mesh == "uv sphere":
        m = tshapes.uv_sphere()
        v, f = m.vertices.numpy(), m.faces.numpy()
    else:
        v, f = _blob_mesh(24, 0, 0.5) if mesh == "blob, smooth" \
            else _blob_mesh(24, 1, 2.0)
    charts = tunwrap.grow_charts(v, f)
    assert charts == junwrap.grow_charts(v, f)
    adj = tunwrap._face_adjacency(f)
    assert [sorted(a) for a in adj] == \
        [sorted(a) for a in junwrap._face_adjacency(f)]
    normals = tunwrap._face_normals_np(v, f)
    folded = sum(tunwrap._chart_overlaps(
        *tunwrap._project_chart(v, f, c, normals)[::2]) for c in charts)
    assert (folded > 0) == (mesh == "blob, folded charts")
    vt, ft = tunwrap.chart_atlas(v, f)
    jvt, jft = junwrap.chart_atlas(v, f)
    np.testing.assert_array_equal(vt, jvt)
    np.testing.assert_array_equal(ft, jft)


def test_full_chain_quadrant_texture_oracle():
    """Camera (0,0,2), fovy π/2: world (x, y, 0) lands at NDC (x/2, y/2).
    A [−2, 2]² quad with uv = (world + 2)/4 under nearest sampling of a 2×2
    texture gives four exact quadrants, depth 2 everywhere (the hand-derived
    case of tests/test_oracle_raster.py)."""
    verts = torch.tensor([[-2.0, -2.0, 0.0], [2.0, -2.0, 0.0],
                          [2.0, 2.0, 0.0], [-2.0, 2.0, 0.0]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]], dtype=torch.int32)
    uv_face_attr = tcam.index_vertices_by_faces((verts[:, :2] + 2.0) / 4.0,
                                                faces)[None]
    tex = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                        [[0.0, 0.0, 1.0], [1.0, 1.0, 0.0]]])
    out = trender.render_single_view_texture(
        verts, faces, uv_face_attr, tex[None], math.pi / 2, 0.0, 2.0,
        spec=trender.CameraSpec(fovy=math.pi / 2), dims=(8, 8),
        interpolation_mode="nearest")
    expected = np.zeros((8, 8, 3), np.float32)
    expected[:4, :4] = [1, 0, 0]
    expected[:4, 4:] = [0, 1, 0]
    expected[4:, :4] = [0, 0, 1]
    expected[4:, 4:] = [1, 1, 0]
    np.testing.assert_allclose(out.image[0].numpy(), expected, atol=1e-6)
    assert (out.mask[0] == 1.0).all()
    np.testing.assert_allclose(out.depth[0].numpy(), 2.0, atol=1e-5)


def test_renderers_match_jax_on_the_dome_seen_from_inside(rng):
    """The radius-5 dome from radius 1.3: faces behind the camera go
    through the divide by −z like any other, as in the JAX package."""
    jm, tm = jshapes.env_sphere(), tshapes.env_sphere()
    colors = rng.uniform(size=(1, jm.num_faces, 3, 4)).astype(np.float32)
    spec = dict(look_at_height=0.25)
    ref_img, ref_mask = jrender.render_single_view(
        jm.vertices, jm.faces, jnp.asarray(colors), [1.0, 0.4], [0.7, 3.0],
        [1.3, 1.1], spec=jrender.CameraSpec(**spec), dims=(24, 24))
    img, mask = trender.render_single_view(
        tm.vertices, tm.faces, _t(colors), [1.0, 0.4], [0.7, 3.0],
        [1.3, 1.1], spec=trender.CameraSpec(**spec), dims=(24, 24))
    assert (mask == 1).all() and (np.asarray(ref_mask) == 1).all()
    close = np.abs(img.numpy() - np.asarray(ref_img)).max(-1) <= 1e-4
    assert (~close).sum() <= 2, "only pixels within rounding of an edge"


@pytest.mark.parametrize("kw", ["compute_normals", "lights", "displacement",
                                "soft_mask_sigma"])
def test_mesh_slice_branches_match_jax(rng, kw):
    """Each branch of the textured renderer that latent-paint-mesh adds,
    switched on alone, against the JAX package's."""
    jm = jshapes.uv_sphere(12, 16)
    verts = np.asarray(jm.vertices, np.float32) * 0.6
    faces = np.asarray(jm.faces)
    uv = np.asarray(jm.vt)[np.asarray(jm.ft)][None].astype(np.float32)
    tex = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    opts = {"compute_normals": dict(compute_normals=True),
            "lights": dict(compute_normals=True,
                           lights=rng.normal(size=(1, 9)).astype(np.float32)),
            "displacement": dict(displacement=(0.03 * rng.normal(
                size=verts.shape)).astype(np.float32)),
            "soft_mask_sigma": dict(soft_mask_sigma=1e-3)}[kw]
    conv = lambda f: {k: f(v) if isinstance(v, np.ndarray) else v  # noqa
                      for k, v in opts.items()}
    ref = jrender.render_single_view_texture(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uv),
        jnp.asarray(tex), [1.0], [0.7], [1.3], dims=(24, 24),
        **conv(jnp.asarray))
    got = trender.render_single_view_texture(
        _t(verts), _t(faces), _t(uv), _t(tex), [1.0], [0.7], [1.3],
        dims=(24, 24), **conv(_t))
    same = got.face_idx.numpy() == np.asarray(ref.face_idx)
    assert (~same).sum() <= 2, "only pixels within rounding of an edge"
    for name in ("image", "mask", "depth", "normals", "lighting"):
        g, r = getattr(got, name), getattr(ref, name)
        assert (g is None) == (r is None), name
        if g is not None:
            # f32 barycentrics; the soft mask's exp(−d²/σ) at σ = 1e-3
            np.testing.assert_allclose(g.numpy()[same], np.asarray(r)[same],
                                       atol=2e-5, err_msg=name)
    assert (got.normals is not None) == (kw in ("compute_normals", "lights"))
    assert (got.lighting is not None) == (kw == "lights")
    if kw == "soft_mask_sigma":
        assert ((got.mask > 0.01) & (got.mask < 0.99)).any()
