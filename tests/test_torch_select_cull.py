"""The face-selection kernels' cull, held in PyTorch on the CPU.

Kernels #5 and #6 skip a (face, warp tile) pair when one of the face's three
edge forms (a, b, c) is < 0 at the worst corner of the tile's box of pixels,
x = (a >= 0 ? xmax : xmin), y = (b >= 0 ? ymax : ymin), with no margin. Its
twins here (`_sel_tile_boxes`, `_sel_kept`, with the tilings the soft
forwards share) are held to three things: every pair the rule skips has no
hit under the plain sweep's arithmetic, at every pixel of the tile; NaN and
inf coefficients never make the rule skip a pair that could hit; and the
plain sweeps with the skipped pairs left out equal `select_faces_dense_plain`
and `select_faces_binned_plain` bit for bit, and JAX's Pallas selection
(interpret mode). Inputs are seeded numpy arrays, float32."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpunerf.kernels.rasterize as JR
from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from tpunerf.core import camera as jcam
from tpunerf.meshrep.shapes import uv_sphere
from tpunerf_torch.kernels import rasterize as TR

CPU = torch.device("cpu")
# the large CPU maps of this file on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")
INF, NAN = float("inf"), float("nan")


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _sphere(n_lat=12, n_lon=16, theta=1.0, phi=0.7, r=1.3):
    """(F, 3, 2) image-space vertices and (F, 3) z of the JAX package's
    sphere under its camera."""
    mesh = uv_sphere(n_lat, n_lon)
    tr = jcam.camera_transform_from_view(theta, phi, r)
    fv_cam, fv_img, _ = jcam.prepare_vertices(
        mesh.vertices * 0.6, mesh.faces, jcam.perspective_projection(), tr)
    return (np.array(fv_img, np.float32),
            np.array(fv_cam[..., 2], np.float32))


def _dome():
    """The port's 960-face background dome under a sampled training pose,
    seen from inside."""
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    dome = shapes.env_sphere()
    views = rand_poses(1, ViewSamplerConfig(), CPU,
                       generator=torch.Generator().manual_seed(3))
    fv_cam, fv_img, _ = mrender._project(
        dome.vertices, dome.faces, views.theta, views.phi, views.radius,
        mrender.CameraSpec(look_at_height=0.25))
    return fv_img[0].numpy(), fv_cam[0, ..., 2].numpy()


def _random(seed, n=300):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.1, 1.1, (n, 1, 2))
    fv = (c + rng.uniform(-0.2, 0.2, (n, 3, 2))).astype(np.float32)
    fv[:20] = rng.uniform(-1.5, 1.5, (20, 3, 2))           # large faces
    fv[20:30, 2] = fv[20:30, 1]                            # zero area
    z = rng.uniform(-3.0, -1.0, (n, 3)).astype(np.float32)
    return fv, z


def _edge_tie(seed, size=32, n=200):
    """Vertices on pixel centres of a size² grid, depths from a set of 3
    values, and coplanar copies of the first 60 faces: pixels exactly on
    edges and exact z ties."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, size, (n, 3, 2))
    fv = ((cells + 0.5) / size * 2.0 - 1.0).astype(np.float32)
    fv[..., 1] = -fv[..., 1]
    z = np.repeat(-2.0 - 0.5 * rng.integers(0, 3, (n, 1)), 3, 1)
    return (np.concatenate([fv, fv[:60]]),
            np.concatenate([z, z[:60]]).astype(np.float32))


def _large(seed):
    """Faces with coordinates up to 1e20: products and sums in the edge
    forms that overflow to inf (and inf - inf = NaN coefficients)."""
    rng = np.random.default_rng(seed)
    fv, z = _random(seed, 120)
    scale = 10.0 ** rng.integers(0, 21, (120, 1, 1))
    return (fv * scale).astype(np.float32), z


def _rows(fv, z):
    return TR._face_rows(_t(fv)[None], _t(z)[None],
                         torch.ones((1, len(fv)), dtype=torch.bool))[0]


def _special_rows(seed):
    """Rows written by hand: coefficients ±0, ±inf, NaN, the filler, and
    random ones with an edge that is -0.0 at pixel centres."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (64, 12)).astype(np.float32)
    vals = np.array([0.0, -0.0, INF, -INF, NAN, 1.0, -1.0, 0.5],
                    np.float32)
    for k in range(64):                 # 1-3 entries of each row replaced
        idx = rng.choice(12, rng.integers(1, 4), replace=False)
        base[k, idx] = rng.choice(vals, len(idx))
    base[0] = [0, 0, -1] + [0] * 9      # the filler
    base[1] = [-1, 0, -0.0, 0, -1, -0.0, 1, 1, 1, 0, 0, 1]
    return torch.from_numpy(base)


def _hits(rows, pix):
    """(F, P) True where the pixel passes all three edges of the row, in the
    plain sweep's arithmetic (`_sweep_plain`)."""
    t = rows.unsqueeze(-1)
    px, py = pix[:, 0][None], pix[:, 1][None]

    def affine(i):
        return t[:, i, :] * px + t[:, i + 1, :] * py + t[:, i + 2, :]

    return (affine(0) >= 0.0) & (affine(3) >= 0.0) & (affine(6) >= 0.0)


INPUTS = {
    "sphere": lambda: _rows(*_sphere()),
    "sphere back": lambda: _rows(*_sphere(theta=2.2, phi=0.3, r=1.1)),
    "dome": lambda: _rows(*_dome()),
    "random": lambda: _rows(*_random(1)),
    "edge and tie": lambda: _rows(*_edge_tie(2)),
    "large": lambda: _rows(*_large(4)),
    "special": lambda: _special_rows(5),
}


def _tilings(size, seed):
    """(pix, tiles) pairs: the size² grid under the dense 8 x 4, the banded
    and the 32-in-a-row tilings, and 32-pixel tiles of scattered pixels."""
    pix = TR.pixel_grid_ndc(size, size, CPU)
    P = pix.shape[0]
    out = [(pix, TR._soft_tile_pixels(P, size, False)),
           (pix, TR._soft_tile_pixels(P, 0, False))]
    if TR._soft_tile_width(P, size, True):
        out.append((pix, TR._soft_tile_pixels(P, size, True)))
    rng = np.random.default_rng(seed)
    scattered = torch.from_numpy(rng.uniform(-1.3, 1.3, (32 * 40, 2))
                                 .astype(np.float32))
    out.append((scattered, torch.arange(32 * 40).reshape(40, 32)))
    return out


@pytest.mark.parametrize("name", list(INPUTS))
def test_every_skipped_pair_has_no_hit(name):
    rows = INPUTS[name]()
    kept_any = skipped_any = 0
    for pix, tiles in _tilings(32, 7):
        hits = _hits(rows, pix)                               # (F, P)
        kept = TR._sel_kept(rows, TR._soft_tile_boxes(pix, tiles))  # (T, F)
        live = tiles >= 0
        for j in range(tiles.shape[0]):
            p = tiles[j][live[j]]
            skipped = ~kept[j]
            assert not (hits[skipped][:, p]).any(), (name, j)
        skipped_any += int((~kept).sum())
        kept_any += int(kept.sum())
    assert kept_any and skipped_any


@pytest.mark.parametrize("name", ["sphere", "dome"])
def test_the_rule_is_not_vacuous(name):
    """At 64², 8 x 4 tiles: most pairs are skipped, and the kept ones hold
    every hit and some misses."""
    rows = INPUTS[name]()
    pix = TR.pixel_grid_ndc(64, 64, CPU)
    tiles = TR._soft_tile_pixels(4096, 64, False)
    kept = TR._sel_kept(rows, TR._soft_tile_boxes(pix, tiles))
    assert kept.float().mean() < 0.2
    hit_tiles = _hits(rows, pix)[:, tiles].any(-1).T             # (T, F)
    assert (kept | ~hit_tiles).all() and (kept & ~hit_tiles).any()


def test_non_finite_corners_keep_the_pair():
    box = torch.tensor([[-1.0, 0.0, -0.5, 0.5],     # xmax = 0
                        [0.25, 0.75, 0.25, 1.0]])
    rows = torch.zeros((7, 12))
    rows[:, 3:9] = torch.tensor([0.0, 0.0, 1.0] * 2)        # edges 1, 2 pass
    rows[0, :3] = torch.tensor([INF, 0.0, 0.0])   # inf * 0 at xmax = 0
    rows[1, :3] = torch.tensor([INF, -INF, 0.0])  # inf + -inf
    rows[2, :3] = torch.tensor([1.0, 1.0, -INF])  # -inf: skipped
    rows[3, :3] = torch.tensor([NAN, 1.0, 1.0])   # NaN coefficient
    rows[4, :3] = torch.tensor([-1.0, -1.0, -0.0])  # -0.0 at (0, 0)
    rows[5, :3] = torch.tensor([0.0, 0.0, -1.0])  # the filler: skipped
    rows[6, :3] = torch.tensor([1.0, 0.0, -0.75])  # exactly 0 at box 1
    kept = TR._sel_kept(rows, box)
    assert kept[:, 0].tolist() == [True, True]
    assert kept[1, 1].item()          # inf + -inf at (0.75, 0.25): NaN
    assert kept[:, 3].tolist() == [True, True]
    assert not kept[:, 2].any() and not kept[:, 5].any()
    # corners (xmin, ymin): box 0's (-1, -0.5) gives 1.5, box 1's -0.5
    assert kept[:, 4].tolist() == [True, False]
    assert kept[1, 6].item()          # 0.75 - 0.75 = 0 is kept
    # a -0.0 corner value is kept, and it is a hit there
    minus0 = torch.tensor([[0.0, 0.0, 0.0, 0.0]])
    assert TR._sel_kept(rows[4:5], minus0).item()
    assert _hits(rows[4:5], torch.zeros((1, 2))).item()
    # a NaN pixel gives its tile the whole plane: nothing is skipped but the
    # rows that are NaN at its corners, and those only hit nothing
    pix = torch.tensor([[0.1, 0.2], [NAN, 0.0]])
    whole = TR._soft_tile_boxes(pix, torch.tensor([[0, 1] + [-1] * 30]))
    assert TR._sel_kept(INPUTS["random"](), whole).all()


def _per_pixel(kept_t, tiles, P):
    """(..., T, F) kept per tile → (..., F, P) kept per pixel."""
    live = tiles >= 0
    lane_tile = torch.arange(tiles.shape[0])[:, None].expand_as(tiles)
    out = torch.zeros(kept_t.shape[:-2] + (kept_t.shape[-1], P),
                      dtype=torch.bool)
    out[..., tiles[live]] = kept_t[..., lane_tile[live], :].transpose(-1, -2)
    return out


def _winner(tab, px, py, kept, chunk=64):
    """The plain sweep's winner over rows tab (..., F, 12) at pixels px, py
    (..., 1, Pn), counting only the kept pairs (..., F, Pn): the highest z,
    the lowest row index on a tie, -1 for none; `chunk` rows at a time."""
    best_z = best_i = None
    for f0 in range(0, tab.shape[-2], chunk):
        t = tab[..., f0:f0 + chunk, :].unsqueeze(-1)

        def affine(i):
            return t[..., i, :] * px + t[..., i + 1, :] * py + t[..., i + 2, :]

        hit = (affine(0) >= 0.0) & (affine(3) >= 0.0) & (affine(6) >= 0.0)
        hit &= kept[..., f0:f0 + chunk, :]
        z = affine(9)
        z = torch.where(hit & (z == z), z, z.new_full((), -math.inf))
        zbest = z.max(dim=-2).values
        ids = torch.arange(f0, f0 + t.shape[-3], dtype=torch.int32)[:, None]
        first = torch.where(z == zbest.unsqueeze(-2), ids,
                            ids.new_full((), 2 ** 31 - 1)).min(dim=-2).values
        if best_z is None:
            best_z = torch.full_like(zbest, -math.inf)
            best_i = torch.full_like(first, -1)
        take = zbest > best_z          # strict: lower ids keep ties
        best_z = torch.where(take, zbest, best_z)
        best_i = torch.where(take, first, best_i)
    return best_i


def _culled_dense(rows, pix, width):
    P = pix.shape[0]
    w = TR._soft_tile_width(P, width, False)
    tiles = TR._soft_tile_pixels(P, w, False)
    kept_t = TR._sel_kept(rows, TR._sel_tile_boxes(pix, width))  # (B, T, F)
    kept = _per_pixel(kept_t, tiles, P)
    got = _winner(rows, pix[:, 0][None, None], pix[:, 1][None, None], kept)
    return got, 1.0 - kept.float().mean().item()


@pytest.mark.parametrize("size, width", [(32, 32), (40, 40), (30, 30),
                                         (32, 0)])
def test_culled_dense_sweep_equals_plain_and_jax(size, width):
    fv = np.stack([_sphere()[0], _sphere(theta=2.2, phi=0.3, r=1.1)[0]])
    z = np.stack([_sphere()[1], _sphere(theta=2.2, phi=0.3, r=1.1)[1]])
    valid = np.ones(z.shape[:2], bool)
    valid[0, 7] = False
    rows = TR._face_rows(_t(fv), _t(z), _t(valid))
    pix = TR.pixel_grid_ndc(size, size, CPU)
    got, skipped = _culled_dense(rows, pix, width)
    assert skipped > 0.5
    assert torch.equal(got, TR.select_faces_dense_plain(rows, pix))
    for b in range(2):
        ref = JR._select_faces_pallas(
            JR.pixel_grid_ndc(size, size), jnp.asarray(fv[b]),
            jnp.asarray(z[b]), jnp.asarray(valid[b]), interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ["edge and tie", "random", "large",
                                  "special"])
def test_culled_dense_sweep_equals_plain_on_hard_rows(name):
    rows = INPUTS[name]()[None]
    pix = TR.pixel_grid_ndc(32, 32, CPU)
    for width in (32, 0):
        got, _ = _culled_dense(rows, pix, width)
        assert torch.equal(got, TR.select_faces_dense_plain(rows, pix))


def _culled_binned(rows, ids, pix, width):
    """The plain binned sweep (slots) with the skipped (tile, slot) pairs
    left out; tiles as `select_faces_binned` numbers them, padded pixels at
    (2, 2) inside their tiles' boxes."""
    B, nb, K = ids.shape
    P = pix.shape[0]
    w = TR._soft_tile_width(P, width, True)
    local = TR._soft_tile_pixels(nb * 1024, w, True)[:32]      # band 0
    tile_of = torch.empty(1024, dtype=torch.long)
    tile_of[local.reshape(-1)] = torch.arange(32).repeat_interleave(32)
    tab = rows[torch.arange(B)[:, None, None], ids.long()]     # (B, nb, K, 12)
    boxes = TR._sel_tile_boxes(pix, width, True).reshape(nb, 32, 4)
    kept_t = TR._sel_kept(tab, boxes)                          # (B, nb, 32, K)
    kept = kept_t[:, :, tile_of, :].transpose(-1, -2)          # (B, nb, K, 1024)
    px, py = (a[None, :, None, :] for a in TR._band_pixels(pix, nb))
    return _winner(tab, px, py, kept), 1.0 - kept.float().mean().item()


@pytest.mark.parametrize("H, W", [(128, 128), (100, 164), (160, 128)])
def test_culled_binned_sweep_equals_plain_and_jax(H, W):
    fv = np.stack([_sphere(24, 32)[0], _sphere(24, 32, 0.6, 2.1, 1.5)[0]])
    z = np.stack([_sphere(24, 32)[1], _sphere(24, 32, 0.6, 2.1, 1.5)[1]])
    B, F = z.shape[:2]
    K = 512
    valid = np.ones((B, F), bool)
    pix = TR.pixel_grid_ndc(H, W, CPU)
    P = pix.shape[0]
    nb = -(-P // 1024)
    ylo, yhi = TR._band_ranges(H, W, nb, CPU)
    ids, maxc = TR._bin_faces(_t(fv), _t(valid), ylo, yhi, K)
    assert int(maxc) <= K
    rows = torch.cat([TR._face_rows(_t(fv), _t(z), _t(valid)),
                      TR._filler_row(CPU).expand(B, 1, 12)], dim=1)
    got, skipped = _culled_binned(rows, ids, pix, W)
    assert skipped > 0.5
    assert torch.equal(got, TR.select_faces_binned_plain(rows, ids, pix))
    if (H, W) == (128, 128):      # the slots to ids, against JAX's binned
        fid = torch.gather(ids, 2, got.clamp(min=0).long())
        fid = torch.where((got >= 0) & (fid < F), fid, -1).reshape(B, -1)
        ref = JR._select_faces_batched(
            JR.pixel_grid_ndc(H, W), jnp.asarray(fv), jnp.asarray(z),
            jnp.asarray(valid), H, W, K=K, interpret=True)
        np.testing.assert_array_equal(fid[:, :P].numpy(), np.asarray(ref))


def test_culled_binned_sweep_counts_padded_pixels():
    """A face over the padded pixels at (2, 2): the plain sweep's padded
    slots show it, and the cull, whose boxes hold those pixels, keeps it."""
    H, W = 100, 100                       # 10000 pixels: 240 padded
    big = np.array([[[-5.0, -5.0], [5.0, -5.0], [0.0, 10.0]]], np.float32)
    fv, z = _random(6, 40)
    fv = np.concatenate([fv, big])[None]
    z = np.concatenate([z, np.full((1, 3), -5.0, np.float32)])[None]
    rows = torch.cat([TR._face_rows(_t(fv), _t(z),
                                    torch.ones((1, 41), dtype=torch.bool)),
                      TR._filler_row(CPU).expand(1, 1, 12)], dim=1)
    ids = torch.arange(64, dtype=torch.int32).clamp(max=41)
    ids = ids.expand(1, 10, 64).contiguous()
    pix = TR.pixel_grid_ndc(H, W, CPU)
    ref = TR.select_faces_binned_plain(rows, ids, pix)
    assert (ref.reshape(-1)[10000:] == 40).all()
    got, _ = _culled_binned(rows, ids, pix, W)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("width", [64, 100, 512])
@pytest.mark.parametrize("banded", [False, True])
def test_selection_tilings_cover_every_pixel_once(width, banded):
    P = width * width
    pix = TR.pixel_grid_ndc(width, width, CPU)
    boxes = TR._sel_tile_boxes(pix, width, banded)
    if banded:
        nb = -(-P // 1024)
        w = TR._soft_tile_width(P, width, True)
        tiles = TR._soft_tile_pixels(nb * 1024, w, True)
        assert torch.equal(tiles.reshape(-1).sort().values,
                           torch.arange(nb * 1024))
        assert w == (width if width in (64, 512) else 0)
    else:
        tiles = TR._soft_tile_pixels(P, width, False)
        live = tiles[tiles >= 0]
        assert torch.equal(live.sort().values, torch.arange(P))
        assert TR._soft_tile_width(P, width, False) == (
            width if width % 8 == 0 else 0)
    assert boxes.shape == (tiles.shape[0], 4)
    # every tile's box holds its pixels
    xy = torch.cat([pix, pix.new_full((tiles.numel(), 2), 2.0)])[
        tiles.clamp(min=0).reshape(-1)].reshape(*tiles.shape, 2)
    ok = tiles >= 0
    assert ((xy[..., 0] >= boxes[:, None, 0]) | ~ok).all()
    assert ((xy[..., 0] <= boxes[:, None, 1]) | ~ok).all()
    assert ((xy[..., 1] >= boxes[:, None, 2]) | ~ok).all()
    assert ((xy[..., 1] <= boxes[:, None, 3]) | ~ok).all()
