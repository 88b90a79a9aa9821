"""Kernel #9's design, the culled dense soft backward, held in PyTorch on
the CPU.

The kernel skips a (warp tile, face) pair when the box of the tile's live
pixels (g·prod ≠ 0) lies wholly outside the face's vertex box widened by
m = sqrt(27.7 sigma), and a tile with no live pixel altogether; it sums
each face over its kept tiles in tile order. Its twin here
(`_soft_bwd_dense_kept`) makes a culled plain version: the plain shares of
the skipped pairs zeroed. That version is held to the unculled plain one
within the tail bound the cull implies (each skipped share is at most
|g·prod|·2e^-27.7·m/sigma, checked in float64), to JAX's dense VJP at 64²
(where JAX does not bin, so its dense Pallas kernels run, in interpret
mode) within the tolerance of tests/test_torch_soft_silhouette.py, and to
the plain version's NaN on faces with a non-finite vertex, which are never
skipped, nor are slivers (needles of 1e-6 to 1e-5 rad, added to the
spheres). Inputs are projected spheres and seeded numpy arrays, float32."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import rasterize as TR

CPU = torch.device("cpu")
# the large CPU maps of this file on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")
H = 64
# the sums over pixels in another order, prod / (1 - p) near an edge: the
# tolerance tests/test_torch_soft_silhouette.py holds the dense VJP to
BWD_REL = 2e-5


def _sphere(theta, phi, r=1.3):
    mesh = uv_sphere(12, 16)
    tr = jcam.camera_transform_from_view(theta, phi, r)
    _, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * 0.6, mesh.faces, jcam.perspective_projection(), tr)
    return np.array(fv_img, np.float32)


def _with_slivers(fv, seed):
    """Each view's faces and 12 needles after them: an angle of 1e-6 to
    1e-5 rad at vertex 0, tips inside NDC. Their rounded inside test can
    hold far beyond the tip, so the cull never skips them."""
    rng = np.random.default_rng(seed)
    B, n = fv.shape[0], 12
    tip = rng.uniform(-0.8, 0.8, (B, n, 2))
    th = rng.uniform(0.0, 2 * np.pi, (B, n))
    ang = 10.0 ** rng.uniform(-6.0, -5.0, (B, n))
    length = rng.uniform(0.05, 0.6, (B, n, 1))
    a = np.stack([np.cos(th), np.sin(th)], -1) * length
    b = np.stack([np.cos(th + ang), np.sin(th + ang)], -1) * length * 1.2
    needles = np.stack([tip, tip + a, tip + b], 2).astype(np.float32)
    return np.concatenate([fv, needles], 1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JR, "_SOFT_INTERPRET", True)


def _scene(sigma, cotangent, seed=0, slivers=False):
    """Two views of the sphere at H² (with needles after its faces where
    `slivers`), their rows, the plain forward's prod and a cotangent g,
    (B, P): "random" N(0, 1) everywhere, "silhouette" d sum(mask²)/d mask =
    2 mask, which with prod makes only the rim live."""
    fv = np.stack([_sphere(1.0, 0.7), _sphere(0.6, 2.1)])
    if slivers:
        fv = _with_slivers(fv, seed)
    rows = TR._soft_rows(torch.from_numpy(fv)).contiguous()
    pix = TR.pixel_grid_ndc(H, H, CPU)
    prod = TR.soft_prod_dense_plain(rows, pix, sigma)
    if cotangent == "random":
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            size=prod.shape).astype(np.float32))
    else:
        g = 2.0 * (1.0 - prod)
    return fv, rows, pix, g, prod


def _pixel_mask(kept, P, width):
    """(B, T, F) tile-face pairs → (B, F, P) face-pixel pairs: each pixel
    takes its warp tile's entry."""
    tiles = TR._soft_tile_pixels(P, width, False)            # (T, 32)
    tile_of = torch.full((P,), -1, dtype=torch.int64)
    t = torch.arange(tiles.shape[0])[:, None].expand_as(tiles)
    tile_of[tiles[tiles >= 0]] = t[tiles >= 0]
    assert (tile_of >= 0).all()                 # every pixel has a tile
    return kept[:, tile_of, :].transpose(1, 2)


def _grads(rows, pix, g, prod, sigma, mask=None, dtype=torch.float32):
    """The plain face gradients (B, F, 6) in `dtype`, with g zeroed at the
    face-pixel pairs where `mask` is False (the culled twin)."""
    rows, pix, g, prod = (a.to(dtype) for a in (rows, pix, g, prod))
    tab = TR._soft_stage(rows)
    px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
    gm = g[:, None, :] if mask is None else g[:, None, :] * mask
    return TR._soft_grad_rows_plain(tab, px, py, sigma, gm, prod[:, None, :])


@pytest.mark.parametrize("slivers", [False, True],
                         ids=["sphere", "sphere+slivers"])
@pytest.mark.parametrize("cotangent", ["random", "silhouette"])
@pytest.mark.parametrize("sigma", [1e-4, 1e-3])
def test_skipped_shares_stay_within_the_tail_bound(sigma, cotangent,
                                                   slivers):
    _, rows, pix, g, prod = _scene(sigma, cotangent, int(sigma * 1e5),
                                   slivers)
    kept = TR._soft_bwd_dense_kept(rows, pix, g, prod, sigma, H)
    mask = _pixel_mask(kept, pix.shape[0], H)                # (B, F, P)
    if slivers:
        assert kept[..., -12:].all()          # needles: kept at every tile
    live = ((g * prod) != 0)[:, None, :]
    pairs = live.expand_as(mask).sum()
    skipped = (live & ~mask).sum()
    assert pairs > 0 and skipped > 0.5 * pairs
    full = _grads(rows, pix, g, prod, sigma, dtype=torch.float64)
    culled = _grads(rows, pix, g, prod, sigma, mask, dtype=torch.float64)
    # a skipped pixel is farther than m from the face, up to an f32 step of
    # the box: p·d ≤ e^(−d²/σ)·d is falling there, so each share ≤
    # |g·prod|·2·m·e^(−27.7(1 − 3e-5))/σ
    m = TR._soft_margin(sigma)
    per = 2.0 * m * math.exp(-27.7 * (1 - 3e-5)) / sigma * 1.01
    gp = (g * prod).abs().double()[:, None, :]
    bound = per * (gp * ~mask).sum(-1, keepdim=True)
    diff = (culled - full).abs()
    assert diff.max() > 0                       # the cull does drop a tail
    assert (diff <= bound + 1e-12 * full.abs().max()).all(), \
        float((diff - bound).max())
    # and the tail is far below the tolerance the kernel is held to
    assert diff.max() <= 1e-6 * BWD_REL * full.abs().max()


@pytest.mark.parametrize("cotangent", ["random", "silhouette"])
def test_culled_twin_matches_jax_dense_vjp(interpret, cotangent):
    sigma = 1e-4
    fv, rows, pix, g, prod = _scene(sigma, cotangent, seed=3)
    B, F = rows.shape[:2]
    assert not JR._soft_bins_engage(H, H, F, JR._SOFT_BIN_K)
    kept = TR._soft_bwd_dense_kept(rows, pix, g, prod, sigma, H)
    got = _grads(rows, pix, g, prod, sigma,
                 _pixel_mask(kept, pix.shape[0], H))
    gi = g.reshape(B, H, H).numpy()
    ref = np.asarray(jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f, H, H, sigma, JR._SOFT_BIN_K) * gi))(
            jnp.asarray(fv))).reshape(B, F, 6)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, atol=BWD_REL * scale)
    # the unculled plain version, as the CPU path runs it
    plain = TR.soft_grad_dense(rows, pix, g, prod, sigma, H)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=BWD_REL * scale)


@pytest.mark.parametrize("width", [H, 0])
def test_dead_tiles_skip_every_finite_face(width):
    sigma = 1e-4
    _, rows, pix, g, prod = _scene(sigma, "silhouette")
    g = g.clone()
    g[:, :H * 8] = 0.0                                  # the top rows dead
    kept = TR._soft_bwd_dense_kept(rows, pix, g, prod, sigma, width)
    tiles = TR._soft_tile_pixels(pix.shape[0], width, False)
    gp = g * prod
    tile_live = ((gp[:, tiles.clamp(min=0)] != 0) & (tiles >= 0)).any(-1)
    assert tile_live.any() and not tile_live.all()
    assert not tile_live[:, :(H * 8) // 32].any()
    assert not kept[~tile_live].any()                   # finite faces only
    # interior and far tiles are dead: the rim keeps a few pairs
    assert 0 < kept.sum() < 0.2 * kept.numel()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_faces_are_never_skipped(bad):
    """A face with a non-finite vertex: the plain gradient is NaN (its
    shares are NaN at every pixel, live or not), and the twin keeps it at
    every tile, dead ones included, so it gives the same."""
    sigma = 1e-4
    fv = _sphere(1.0, 0.7)[None]
    clean = TR._soft_rows(torch.from_numpy(fv))
    bad_fv = fv.copy()
    bad_fv[0, 40].reshape(-1)[3] = bad
    rows = TR._soft_rows(torch.from_numpy(bad_fv)).contiguous()
    F = rows.shape[1]
    pix = TR.pixel_grid_ndc(H, H, CPU)
    # a finite prod (that of the faces without the bad one) and dead rows
    prod = TR.soft_prod_dense_plain(clean, pix, sigma)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=prod.shape).astype(np.float32))
    g[:, :H * 16] = 0.0
    kept = TR._soft_bwd_dense_kept(rows, pix, g, prod, sigma, H)
    assert kept[..., 40].all()
    others = torch.arange(F) != 40
    assert not kept[:, :(H * 16) // 32][..., others].any()
    plain = _grads(rows, pix, g, prod, sigma)
    twin = _grads(rows, pix, g, prod, sigma,
                  _pixel_mask(kept, pix.shape[0], H))
    assert torch.isnan(plain[0, 40]).all() and torch.isnan(twin[0, 40]).all()
    assert torch.isfinite(plain[0, others]).all()
    scale = float(plain[0, others].abs().max())
    assert (twin[0, others] - plain[0, others]).abs().max() <= BWD_REL * scale


@pytest.mark.parametrize("width", [H, 0, H - 1])
def test_soft_grad_dense_on_the_cpu_is_the_plain_version(width):
    sigma = 1e-4
    _, rows, pix, g, prod = _scene(sigma, "random", seed=6)
    _build.reset_launches()
    got = TR.soft_grad_dense(rows, pix, g, prod, sigma, width)
    assert torch.equal(got, TR.soft_grad_dense_plain(rows, pix, g, prod,
                                                     sigma))
    assert _build.LAUNCHES.get(TR.SOFT_BWD_DENSE, 0) == 0


def test_dense_and_banded_twins_take_the_same_live_boxes():
    """At a width of 32 a dense 8 × 4 tile and a band's 32 × 1 tile differ,
    but with width 0 both twins tile by 32 pixels in a row: the dense
    twin's pairs are the banded twin's on bins of every face."""
    sigma = 1e-4
    _, rows, pix, g, prod = _scene(sigma, "silhouette")
    B, F = rows.shape[:2]
    dense = TR._soft_bwd_dense_kept(rows, pix, g, prod, sigma, 0)
    nb = pix.shape[0] // 1024
    ids = torch.cat([torch.arange(F, dtype=torch.int32),
                     torch.full((8,), F, dtype=torch.int32)]).expand(
        B, nb, -1).contiguous()
    banded = TR._soft_bwd_kept(TR._with_filler(rows), ids, pix,
                               TR._band_maps(g, nb), TR._band_maps(prod, nb),
                               sigma, 0)
    assert torch.equal(banded[..., :F].reshape(B, nb * 32, F), dense)


@pytest.mark.parametrize("faces,warps", [(8, 8), (16, 8), (32, 8), (32, 16),
                                         (4, 8), (8, 4)])
def test_block_shape_experiment_builds_only_what_fits(faces, warps):
    """The experiment's sources (tpunerf_torch/scripts/exp_soft_bwd_dense.py)
    replace each of #9's constants once, keep a thread a live tile of a
    segment and the kernel's static shared memory under 48 KB."""
    import re

    from tpunerf_torch.scripts import exp_soft_bwd_dense as ex
    src = ex.patched_source(faces, warps)
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int (kQFaces|kQWarps|kLTiles|kQBatch) = (\d+);", src)}
    assert c == ex.constants(faces, warps)
    assert c["kLTiles"] == 32 * c["kQWarps"] and faces <= 32
    smem = (faces * 6 * 16 + c["kQBatch"] * 32 * 16
            + c["kQBatch"] * faces * 6 * 4 + 2 * 4 * 32 * warps
            + c["kQBatch"] * faces * 2 + c["kQBatch"] * 4 + warps * 4 + 32)
    assert smem <= 48 * 1024


def test_block_shape_experiment_refuses_the_cpu():
    from tpunerf_torch.scripts import exp_soft_bwd_dense as ex
    if torch.cuda.is_available():
        pytest.skip("the refusal is for machines without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main([])
