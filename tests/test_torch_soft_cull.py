"""The soft-silhouette forward kernels' cull, held in PyTorch on the CPU.

Kernels #7 and #8 skip a (face, warp tile) pair when the tile's pixels all
lie outside the face's vertex box widened by m = sqrt(27.7 sigma). Their
twins here (`_soft_cull_boxes`, `_soft_tile_pixels`, `_soft_tile_boxes`,
`_soft_kept`) are held to three things: every pair the rule skips has a
factor 1 - p of exactly 1.0f under the plain `_soft_face_prob`, slivers
(needles with an angle of 1e-6 to 1e-5 rad, whose rounded inside test can
hold far beyond their tip) included; a face with a non-finite vertex and a
sliver are never skipped; and the plain sweep with the skipped
factors set to 1 equals `soft_prod_dense_plain` bit for bit, and JAX's
Pallas forward (interpret mode) within the tolerance of
tests/test_torch_soft_silhouette.py. Inputs are seeded numpy arrays,
float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere
from tpunerf_torch.kernels import rasterize as TR

# products of up to ~400 factors in another order, exp of another library
FWD_ATOL = 5e-6
SIGMAS = [1e-5, 1e-4, 1e-3]


def _sphere(n_lat=12, n_lon=16, theta=1.0, phi=0.7, r=1.3):
    mesh = uv_sphere(n_lat, n_lon)
    tr = jcam.camera_transform_from_view(theta, phi, r)
    _, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * 0.6, mesh.faces, jcam.perspective_projection(), tr)
    return np.array(fv_img, np.float32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JR, "_SOFT_INTERPRET", True)


def _slivers(rng, n: int, far: bool = False) -> np.ndarray:
    """(n, 3, 2) needles: an angle of 1e-6 to 1e-5 rad at vertex 0, long
    edges of 0.05 to 0.6; tips inside NDC, or (far) 2 to 3 away from it."""
    tip = rng.uniform(-0.8, 0.8, (n, 2))
    if far:
        tip = rng.choice([-1.0, 1.0], (n, 2)) * rng.uniform(2.0, 3.0, (n, 2))
    th = rng.uniform(0.0, 2 * np.pi, n)
    ang = 10.0 ** rng.uniform(-6.0, -5.0, n)
    length = rng.uniform(0.05, 0.6, n)[:, None]
    stretch = rng.uniform(0.5, 1.5, n)[:, None]
    a = np.stack([np.cos(th), np.sin(th)], -1) * length
    b = np.stack([np.cos(th + ang), np.sin(th + ang)], -1) * length * stretch
    return np.stack([tip, tip + a, tip + b], 1)


def _faces(seed: int) -> np.ndarray:
    """(n, 3, 2) random, zero-area, thin and tiny triangles, then slivers
    near (60:70) and far (70:75) from the pixels."""
    rng = np.random.default_rng(seed)
    n = 60
    c = rng.uniform(-0.8, 0.8, (n, 1, 2))
    tri = c + rng.uniform(-0.15, 0.15, (n, 3, 2))
    tri[10:20, 2] = tri[10:20, 1]                       # zero area
    tri[20:25, 1:] = tri[20:25, :1]                     # a point
    d = rng.uniform(-0.2, 0.2, (10, 1, 2))              # thin: 1e-3 wide
    tri[25:35] = c[25:35] + np.concatenate(
        [np.zeros_like(d), d, d + 1e-3 * np.stack([-d[..., 1], d[..., 0]],
                                                  -1)], axis=1)
    tri[35:40] = c[35:40] + rng.uniform(-1e-4, 1e-4, (5, 3, 2))  # tiny
    tri = np.concatenate([tri, _slivers(rng, 10), _slivers(rng, 5, True)])
    return tri.astype(np.float32)


SLIVERS = slice(60, 75)


def _vertex_boxes(rows: torch.Tensor, sigma: float) -> torch.Tensor:
    """The vertex boxes widened by the margin, slivers' too (the boxes the
    cull had before it kept slivers)."""
    vx, vy = rows[:, 9:15:2], rows[:, 10:15:2]
    m = torch.tensor(TR._soft_margin(sigma), dtype=torch.float32)
    return torch.stack([vx.amin(-1) - m, vx.amax(-1) + m,
                        vy.amin(-1) - m, vy.amax(-1) + m], dim=-1)


def _beyond_the_tips(tri: np.ndarray, sigma: float) -> torch.Tensor:
    """Pixels on each sliver's axis behind its sharp vertex and past its
    short edge, 1 to 8 margins out: where its long edge forms are nearly
    parallel and round to either sign."""
    m = TR._soft_margin(sigma)
    tip = tri[:, 0].astype(np.float64)
    mid = (tri[:, 1] + tri[:, 2]).astype(np.float64) / 2
    axis = (mid - tip) / np.linalg.norm(mid - tip, axis=-1, keepdims=True)
    dist = np.linspace(1.0, 8.0, 57)[None, :, None] * m
    pts = np.concatenate([tip[:, None] - dist * axis[:, None],
                          mid[:, None] + dist * axis[:, None]], 1)
    return torch.from_numpy(pts.reshape(-1, 2).astype(np.float32))


def _step_out(v: np.ndarray, direction: float, steps: int) -> np.ndarray:
    for _ in range(steps):
        v = np.nextafter(v, np.float32(direction * np.inf))
    return v


def _pixels_around_boxes(boxes: torch.Tensor, seed: int) -> torch.Tensor:
    """Pixels over the plane plus, for each face, pixels one and three f32
    steps outside each side and two corners of its widened box."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform(-1.2, 1.2, (600, 2)).astype(np.float32)]
    b = boxes.numpy()
    mid_x, mid_y = (b[:, 0] + b[:, 1]) / 2, (b[:, 2] + b[:, 3]) / 2
    for k in (1, 3):
        x0, x1 = _step_out(b[:, 0], -1, k), _step_out(b[:, 1], 1, k)
        y0, y1 = _step_out(b[:, 2], -1, k), _step_out(b[:, 3], 1, k)
        pts += [np.stack(xy, -1) for xy in ((x0, mid_y), (x1, mid_y),
                                            (mid_x, y0), (mid_x, y1),
                                            (x0, y0), (x1, y1))]
    return torch.from_numpy(np.concatenate(pts).astype(np.float32))


@pytest.mark.parametrize("sigma", SIGMAS)
def test_every_skipped_factor_is_exactly_one(sigma):
    tri = _faces(int(sigma * 1e6))
    rows = TR._soft_rows(torch.from_numpy(tri))
    rows[40:45, 15] = 0.0                               # valid = 0
    boxes = TR._soft_cull_boxes(rows, sigma)
    vboxes = _vertex_boxes(rows, sigma)
    pix = torch.cat([_pixels_around_boxes(vboxes, 3),
                     _beyond_the_tips(tri[SLIVERS], sigma)])
    # each pixel a tile of its own: its box is the point
    tiles = torch.arange(pix.shape[0])[:, None].expand(-1, 32)
    kept = TR._soft_kept(boxes, TR._soft_tile_boxes(pix, tiles))  # (P, F)
    p = TR._soft_face_prob(TR._soft_stage(rows), pix[:, 0][None],
                           pix[:, 1][None], sigma)[0]            # (F, P)
    factor = 1.0 - p
    skipped = ~kept.T
    assert skipped.float().mean() > 0.5
    assert (factor[skipped] == 1.0).all(), factor[skipped].min()
    # the rule is not vacuous: pixels just outside a box are skipped, and
    # some kept pairs are live
    assert skipped[:, 600:].any() and (factor[~skipped] != 1.0).any()
    # slivers are kept at every pixel: outside their widened vertex boxes,
    # where a box cull would skip them, their factor is 0 at some pixels (a
    # spurious inside)
    assert not skipped[SLIVERS].any()
    beyond = ~TR._soft_kept(vboxes, TR._soft_tile_boxes(pix, tiles)).T
    assert ((factor[SLIVERS] == 0.0) & beyond[SLIVERS]).any()
    # every other face keeps its vertex box
    others = torch.ones(rows.shape[0], dtype=torch.bool)
    others[SLIVERS] = False
    assert torch.equal(boxes[others], vboxes[others])


def test_margin_and_boxes_are_f32():
    sigma = 1e-4
    m = TR._soft_margin(sigma)
    assert m == float(np.float32(np.sqrt(27.7 * sigma)))
    rows = TR._soft_rows(torch.from_numpy(_faces(1)))
    boxes = TR._soft_cull_boxes(rows, sigma)
    v = rows[:, 9:15].reshape(-1, 3, 2).numpy()
    m32 = np.float32(m)
    # the slivers' boxes are the plane; every other face's is f32
    inf = float("inf")
    assert (boxes[SLIVERS] == torch.tensor([-inf, inf, -inf, inf])).all()
    boxes, v = boxes[:SLIVERS.start], v[:SLIVERS.start]
    np.testing.assert_array_equal(boxes[:, 0].numpy(),
                                  v[..., 0].min(-1) - m32)
    np.testing.assert_array_equal(boxes[:, 3].numpy(),
                                  v[..., 1].max(-1) + m32)


def test_the_sliver_test_is_the_f32_one_of_the_kernels():
    """`_soft_cull_boxes` keeps a face whole-plane exactly where its rows'
    edge normals give |n0 × n1| < 2^-10 · max |n_k|², each product and sum
    rounded to f32 (csrc/rasterize.cu:sliver); a face with an angle of
    2e-3 rad keeps its box, and a degenerate face (normals 0) too."""
    rng = np.random.default_rng(7)
    tri = np.concatenate([_slivers(rng, 20), _faces(5)[:60]])
    wide = _slivers(rng, 20)
    wide[:, 2] = wide[:, 0] + (wide[:, 2] - wide[:, 0]) @ np.array(
        [[np.cos(2e-3), np.sin(2e-3)], [-np.sin(2e-3), np.cos(2e-3)]])
    tri = np.concatenate([tri, wide]).astype(np.float32)
    rows = TR._soft_rows(torch.from_numpy(tri))
    whole = torch.isinf(TR._soft_cull_boxes(rows, 1e-4)[:, 0])
    r = rows.numpy()
    f32 = np.float32
    cross = (r[:, 0] * r[:, 4]).astype(f32) - (r[:, 1] * r[:, 3]).astype(f32)
    l2 = np.max([(r[:, 3 * k] * r[:, 3 * k]).astype(f32)
                 + (r[:, 3 * k + 1] * r[:, 3 * k + 1]).astype(f32)
                 for k in range(3)], axis=0)
    want = ~(np.abs(cross) >= f32(2.0 ** -10) * l2)
    assert np.array_equal(whole.numpy(), want)
    assert whole[:20].all() and not whole[-20:].any()
    assert not whole[30:40].any()                       # zero area


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_a_face_with_a_non_finite_vertex_is_never_skipped(bad):
    tri = _faces(2)[:6].copy()
    for k in range(6):                  # each of the six coordinates
        tri[k].reshape(-1)[k] = bad
    rows = TR._soft_rows(torch.from_numpy(tri))
    boxes = TR._soft_cull_boxes(rows, 1e-4)
    inf = float("inf")
    assert (boxes == torch.tensor([-inf, inf, -inf, inf])).all()
    far = torch.tensor([[50.0, 50.0], [-50.0, 3.0]])
    tiles = torch.tensor([[0] * 32, [1] * 32, [-1] * 32])  # and a dead tile
    assert TR._soft_kept(boxes, TR._soft_tile_boxes(far, tiles)).all()


def test_tile_boxes_cover_live_pixels_and_give_up_on_nan():
    pix = torch.tensor([[0.1, 0.2], [-0.3, 0.5], [0.7, -0.4],
                        [float("nan"), 0.0]])
    tiles = torch.tensor([[0, 1, 2] + [-1] * 29, [-1] * 32,
                          [0, 3] + [-1] * 30])
    box = TR._soft_tile_boxes(pix, tiles)
    inf = float("inf")
    assert box[0].tolist() == pytest.approx([-0.3, 0.7, -0.4, 0.5])
    assert box[1].tolist() == [inf, -inf, inf, -inf]      # no live pixel
    assert box[2].tolist() == [-inf, inf, -inf, inf]      # a NaN pixel


@pytest.mark.parametrize("P, width, banded, shape", [
    (4096, 64, False, "8x4"), (2500, 50, False, "row"),
    (48 * 30, 48, False, "8x4"), (262144, 512, True, "16x2"),
    (4096, 64, True, "2x16"), (10000, 100, True, "row"),
    (100, 0, False, "row")])
def test_tile_pixels_cover_every_pixel_once(P, width, banded, shape):
    tiles = TR._soft_tile_pixels(P, width, banded)
    live = tiles[tiles >= 0]
    assert torch.equal(live.sort().values, torch.arange(P))
    w = TR._soft_tile_width(P, width, banded)
    if shape == "row":
        assert w == 0
    else:
        # a tile's pixels span its block of the image, nothing wider
        first = tiles[0]
        cols = first % w
        rows = first // w
        tw, th = (int(s) for s in shape.split("x"))
        assert int(cols.max() - cols.min()) + 1 == tw
        assert int(rows.max() - rows.min()) + 1 == th


def _culled_plain(rows, pix, sigma, width):
    """The plain dense sweep with the factors the tile cull skips set to
    1.0, in the same chunks and order as `soft_prod_dense_plain`."""
    B, F, _ = rows.shape
    P = pix.shape[0]
    tiles = TR._soft_tile_pixels(P, width)
    kept_t = TR._soft_kept(TR._soft_cull_boxes(rows, sigma),
                           TR._soft_tile_boxes(pix, tiles))   # (B, T, F)
    kept = torch.zeros((B, F, P), dtype=torch.bool)
    live = tiles >= 0
    lane_tile = torch.arange(tiles.shape[0])[:, None].expand_as(tiles)
    kept[:, :, tiles[live]] = kept_t[:, lane_tile[live], :].transpose(1, 2)
    tab = TR._soft_stage(rows)
    px, py = pix[:, 0][None, None, :], pix[:, 1][None, None, :]
    prod = rows.new_ones((B, P))
    chunk = max(1, TR._PLAIN_BLOCK // max(B * P, 1))
    n_skipped = 0
    for f0 in range(0, F, chunk):
        p = TR._soft_face_prob(tab[:, f0:f0 + chunk], px, py, sigma)[0]
        k = kept[:, f0:f0 + chunk]
        n_skipped += int((~k).sum())
        prod = prod * torch.prod(torch.where(k, 1.0 - p, 1.0), dim=-2)
    return prod, n_skipped / kept.numel()


@pytest.mark.parametrize("size, width", [(32, 32), (32, 0), (40, 40)])
def test_culled_sweep_equals_the_plain_sweep_and_jax(size, width, interpret):
    sigma = 1e-4
    fv = np.stack([_sphere(), _sphere(theta=2.2, phi=0.3, r=1.1)])
    rows = TR._soft_rows(torch.from_numpy(fv))
    pix = TR.pixel_grid_ndc(size, size, torch.device("cpu"))
    got, skipped = _culled_plain(rows, pix, sigma, width)
    assert skipped > 0.5
    assert torch.equal(got, TR.soft_prod_dense_plain(rows, pix, sigma))
    pal = np.asarray(JR._soft_batched_pallas(jnp.asarray(fv), size, size,
                                             sigma, 768))
    np.testing.assert_allclose(1.0 - got.reshape(2, size, size).numpy(), pal,
                               atol=FWD_ATOL)
