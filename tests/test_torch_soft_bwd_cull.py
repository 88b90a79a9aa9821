"""Kernel #10's design, the culled band-binned soft backward, held in
PyTorch on the CPU.

The kernel skips a (warp tile, slot) pair when the box of the tile's live
pixels (g·prod ≠ 0) lies wholly outside the face's vertex box widened by
m = sqrt(27.7 sigma), and a tile with no live pixel altogether; it sums each
face's slot rows in band order. Its twins here (`_soft_bwd_kept`,
`_slots_to_faces_ordered`) make a culled plain version: the plain shares of
the skipped pairs zeroed. That version is held to the unculled plain one
within the tail bound the cull implies (each skipped share is at most
|g·prod|·2e^-27.7·m/sigma, checked in float64), to JAX's band-binned VJP
in interpret mode within the tolerance of
tests/test_torch_soft_silhouette.py, and to the plain version's NaN on
faces with a non-finite vertex, which are never skipped, nor are slivers
(needles of 1e-6 to 1e-5 rad, added to the spheres). Inputs are
projected spheres and seeded numpy arrays, float32."""
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
from tpunerf_torch.kernels import rasterize as TR

CPU = torch.device("cpu")
H = 128
K = 128
# the sums over pixels in another order, prod / (1 - p) near an edge: the
# tolerance tests/test_torch_soft_silhouette.py holds the binned VJP to
BWD_REL = 2e-5
# the large CPU maps of this file on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
    `slivers`), their bins (K, or wider where K overflows), rows with the
    filler, the
    plain forward's prod and a cotangent g, all (B, nb, 1024) maps:
    "random" N(0, 1) everywhere, "silhouette" d sum(mask²)/d mask = 2 mask,
    which with prod makes only the rim live."""
    fv = np.stack([_sphere(1.0, 0.7), _sphere(0.6, 2.1)])
    if slivers:
        fv = _with_slivers(fv, seed)
    fvt = torch.from_numpy(fv)
    ids, maxc = TR._soft_bins(fvt, H, H, sigma, K)
    if int(maxc) > K:                  # bins that hold, whatever sigma
        ids, maxc = TR._soft_bins(fvt, H, H, sigma, -(-int(maxc) // 128) * 128)
    rows = TR._with_filler(TR._soft_rows(fvt)).contiguous()
    pix = TR.pixel_grid_ndc(H, H, CPU)
    prod = TR.soft_prod_binned_plain(rows, ids, pix, sigma)
    if cotangent == "random":
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            size=prod.shape).astype(np.float32))
    else:
        g = 2.0 * (1.0 - prod)
    return fv, rows, ids, pix, g, prod


def _pixel_mask(kept, P, width):
    """(B, nb, 32, K) tile-slot pairs → (B, nb, K, 1024) slot-pixel pairs:
    each band pixel takes its warp tile's entry; pixels past the image none."""
    B, nb, _, Kb = kept.shape
    tiles = TR._soft_tile_pixels(P, width, True)          # (nb·32, 32)
    tile_of = torch.full((nb * 1024,), -1, dtype=torch.int64)
    t = (torch.arange(nb * 32) % 32)[:, None].expand_as(tiles)
    inside = tiles >= 0
    tile_of[tiles[inside]] = t[inside]
    tile_of = tile_of.reshape(nb, 1024)
    idx = tile_of.clamp(min=0)[None, :, None, :].expand(B, nb, Kb, 1024)
    return torch.gather(kept.transpose(2, 3), 3, idx) & (tile_of >= 0)[
        None, :, None, :]


def _slot_rows(rows, ids, pix, g, prod, sigma, mask=None,
               dtype=torch.float32, chunk=16):
    """The plain slot rows (B, nb, K, 6) in `dtype`, with g zeroed at the
    slot-pixel pairs where `mask` is False (the culled twin)."""
    rows, pix, g, prod = (a.to(dtype) for a in (rows, pix, g, prod))
    B, nb, Kb = ids.shape
    tab = TR._soft_stage(rows)
    px, py, g4, p4 = TR._band_operands(pix, nb, g, prod)
    bidx = torch.arange(B)[:, None, None]
    out = []
    for k0 in range(0, Kb, chunk):
        gk = g4 if mask is None else g4 * mask[:, :, k0:k0 + chunk]
        out.append(TR._soft_grad_rows_plain(
            tab[bidx, ids[:, :, k0:k0 + chunk].long()], px, py, sigma, gk,
            p4))
    return torch.cat(out, dim=2)


@pytest.mark.parametrize("slivers", [False, True],
                         ids=["sphere", "sphere+slivers"])
@pytest.mark.parametrize("cotangent", ["random", "silhouette"])
@pytest.mark.parametrize("sigma", [1e-4, 1e-3])
def test_skipped_shares_stay_within_the_tail_bound(sigma, cotangent,
                                                   slivers):
    _, rows, ids, pix, g, prod = _scene(sigma, cotangent, int(sigma * 1e5),
                                        slivers)
    kept = TR._soft_bwd_kept(rows, ids, pix, g, prod, sigma, H)
    mask = _pixel_mask(kept, pix.shape[0], H)
    F = rows.shape[1] - 1
    if slivers:
        # a needle's slots are kept at every tile of the bands that hold it
        held = (ids >= F - 12) & (ids < F)                  # (B, nb, K)
        assert held.any() and kept.permute(0, 1, 3, 2)[held].all()
    real = (ids < F)[..., None]                              # (B, nb, K, 1)
    live = ((g * prod) != 0)[:, :, None, :]                  # (B, nb, 1, 1024)
    pairs = (real & live).sum()
    skipped = (real & live & ~mask).sum()
    assert pairs > 0 and skipped > 0.5 * pairs
    full = _slot_rows(rows, ids, pix, g, prod, sigma, dtype=torch.float64)
    culled = _slot_rows(rows, ids, pix, g, prod, sigma, mask,
                        dtype=torch.float64)
    # a skipped pixel is farther than m from the face, up to an f32 step of
    # the box: p·d ≤ e^(−d²/σ)·d is falling there, so each share ≤
    # |g·prod|·2·m·e^(−27.7(1 − 3e-5))/σ
    m = TR._soft_margin(sigma)
    per = 2.0 * m * math.exp(-27.7 * (1 - 3e-5)) / sigma * 1.01
    gp = (g * prod).abs().double()[:, :, None, :]
    bound = per * (gp * (real & ~mask)).sum(-1, keepdim=True)
    diff = (culled - full).abs()
    assert diff.max() > 0                       # the cull does drop a tail
    assert (diff <= bound + 1e-12 * full.abs().max()).all(), \
        float((diff - bound).max())
    # and the tail is far below the tolerance the kernel is held to
    assert diff.max() <= 1e-6 * BWD_REL * full.abs().max()


def test_culled_twin_matches_jax_binned_vjp(interpret):
    sigma = 1e-4
    fv, rows, ids, pix, g, prod = _scene(sigma, "random", seed=3)
    F = rows.shape[1] - 1
    kept = TR._soft_bwd_kept(rows, ids, pix, g, prod, sigma, H)
    culled = _slot_rows(rows, ids, pix, g, prod, sigma,
                        _pixel_mask(kept, pix.shape[0], H))
    got = TR._slots_to_faces_ordered(culled, ids, F)
    gi = g.reshape(2, H, H).numpy()
    ref = np.asarray(jax.grad(lambda f: jnp.sum(
        JR._soft_batched_pallas(f, H, H, sigma, K) * gi))(jnp.asarray(fv)))
    ref = ref.reshape(2, F, 6)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=BWD_REL * scale)
    # the unculled plain rows summed by index_add_, as the CPU path does
    plain = TR.soft_grad_binned(rows, ids, pix, g, prod, sigma, H)
    np.testing.assert_allclose(got.numpy(), plain.numpy(),
                               atol=BWD_REL * scale)


@pytest.mark.parametrize("width", [H, 0])
def test_dead_tiles_and_bands_skip_every_finite_face(width):
    sigma = 1e-4
    _, rows, ids, pix, g, prod = _scene(sigma, "silhouette")
    g = g.clone()
    g[:, 3] = 0.0                                       # a band with no live
    kept = TR._soft_bwd_kept(rows, ids, pix, g, prod, sigma, width)
    tiles = TR._soft_tile_pixels(pix.shape[0], width, True)
    gp = (g * prod).reshape(2, -1)
    tile_live = ((gp[:, tiles.clamp(min=0)] != 0) & (tiles >= 0)).any(-1)
    tile_live = tile_live.reshape(2, -1, 32)
    assert not tile_live[:, 3].any() and tile_live.any()
    assert not kept[~tile_live].any()                   # finite faces only here
    # interior and far tiles are dead: the rim keeps a few pairs
    real = (ids < rows.shape[1] - 1)[:, :, None, :].expand_as(kept)
    assert 0 < kept.sum() < 0.2 * real.sum()
    # past the first filler nothing is kept
    assert not kept[~real].any()


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_faces_are_never_skipped(bad):
    """A face with a non-finite vertex: the plain rows are NaN in every band
    that holds it (their 0·NaN shares at every pixel, live or not), and the
    twin keeps it at every tile, dead ones included, so it gives the same."""
    sigma = 1e-4
    size = 64
    fv = _sphere(1.0, 0.7)[None]
    clean = TR._soft_rows(torch.from_numpy(fv))
    bad_fv = fv.copy()
    bad_fv[0, 40].reshape(-1)[3] = bad
    rows = TR._with_filler(TR._soft_rows(torch.from_numpy(bad_fv))).contiguous()
    F = rows.shape[1] - 1
    nb = size * size // 1024
    pix = TR.pixel_grid_ndc(size, size, CPU)
    ids = torch.cat([torch.arange(F, dtype=torch.int32),
                     torch.full((16,), F, dtype=torch.int32)]).expand(
        1, nb, -1).contiguous()
    # a finite prod (that of the faces without the bad one) and a dead band
    prod = TR._band_maps(TR.soft_prod_dense_plain(clean, pix, sigma), nb)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=prod.shape).astype(np.float32))
    g[:, 1] = 0.0
    kept = TR._soft_bwd_kept(rows, ids, pix, g, prod, sigma, size)
    assert kept[..., 40].all() and not kept[:, 1, :, :F].clone().index_fill_(
        -1, torch.tensor([40]), False).any()
    plain = _slot_rows(rows, ids, pix, g, prod, sigma)
    twin = _slot_rows(rows, ids, pix, g, prod, sigma,
                      _pixel_mask(kept, pix.shape[0], size))
    assert torch.isnan(plain[:, :, 40]).all() and torch.isnan(
        twin[:, :, 40]).all()
    others = torch.ones(F + 16, dtype=torch.bool)
    others[40] = False
    assert torch.isfinite(plain[:, :, others]).all()
    faces = TR._slots_to_faces_ordered(twin, ids, F)
    ref = TR._slots_to_faces(plain, ids, F)
    assert torch.isnan(faces[0, 40]).all() and torch.isnan(ref[0, 40]).all()
    keep = torch.arange(F) != 40
    scale = float(ref[0, keep].abs().max())
    assert (faces[0, keep] - ref[0, keep]).abs().max() <= BWD_REL * scale


def test_fixed_order_face_sum_matches_slots_to_faces():
    sigma = 1e-4
    _, rows, ids, _, _, _ = _scene(sigma, "random")
    F = rows.shape[1] - 1
    # face 7 of the first view in no band (each band's ids stay ascending)
    ids = ids.clone()
    ids[0] = torch.where(ids[0] == 7, F, ids[0]).sort(dim=-1).values
    B, nb, Kb = ids.shape
    slot = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, nb, Kb, 6)).astype(np.float32))
    filler = ids == F
    slot[filler] = 1e30                                 # the filler's rows
    got = TR._slots_to_faces_ordered(slot, ids, F)
    ref = TR._slots_to_faces(torch.where(filler[..., None], 0.0, slot),
                             ids, F)
    assert got.shape == (B, F, 6) and torch.isfinite(got).all()
    scale = float(ref.abs().max())
    assert (got - ref).abs().max() <= 1e-6 * scale
    # faces in no band get 0; a face's sum runs band by band from 0
    held = torch.zeros((B, F), dtype=torch.bool)
    for b in range(B):
        held[b, ids[b][~filler[b]].long()] = True
    assert not held[0, 7] and (got[~held] == 0).all()
    b, f = 1, int(torch.nonzero(held[1])[len(torch.nonzero(held[1])) // 2])
    acc = torch.zeros(6)
    for j in range(nb):
        k = torch.nonzero(ids[b, j] == f)
        if len(k):
            acc = acc + slot[b, j, int(k[0])]
    assert torch.equal(got[b, f], acc)
