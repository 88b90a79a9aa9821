"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one; whether there is
one is decided inside each test. The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX; the marker is
registered there.)
"""
import numpy as np
import pytest
import torch

from tpunerf_torch.fields.encoding import HashGridConfig
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import attention as at
from tpunerf_torch.kernels import hashgrid as hg
from tpunerf_torch.kernels import occgrid as og
from tpunerf_torch.kernels import rasterize as rz

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close_to_max(actual, expected, rel, what):
    err = (actual.float() - expected.float()).abs().max().item()
    tol = rel * expected.float().abs().max().item()
    assert err <= tol, f"{what}: max error {err:.3e} > {tol:.3e}"


def _launched(name, fn):
    before = _build.LAUNCHES.get(name, 0)
    out = fn()
    assert _build.LAUNCHES[name] == before + 1, name
    return out


@pytest.mark.parametrize("grid", ["tiny", "default"])
def test_hashgrid_kernels_match_plain(grid):
    dev = _card()
    cfg = (HashGridConfig(n_levels=4, log2_hashmap_size=12,
                          base_resolution=8, desired_resolution=64)
           if grid == "tiny" else HashGridConfig())
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((70001, 3), generator=gen, device=dev)
    x[:4] = torch.tensor([[0.0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1]])
    table = torch.rand((cfg.n_levels, cfg.table_size,
                        cfg.n_features_per_level), generator=gen,
                       device=dev) * 2 - 1
    g = torch.randn((x.shape[0], cfg.out_dim), generator=gen, device=dev)
    out = _launched(hg.FWD, lambda: hg.hash_encode_cuda(x, table, cfg))
    dt = _launched(hg.BWD, lambda: hg.hash_bwd_cuda(x, g, cfg))
    # f32 both; the forward sums 8 corners in another order, the backward
    # with atomics in run-dependent order
    _close_to_max(out, hg.hash_encode_plain(x, table, cfg), 1e-5, "forward")
    _close_to_max(dt, hg.hash_bwd_plain(x, g, cfg), 1e-5, "backward")


def test_hash_encode_autograd_runs_the_kernels():
    dev = _card()
    cfg = HashGridConfig()
    x = torch.rand((4096, 3), device=dev)
    table = torch.randn((12, 2048, 2), device=dev, requires_grad=True)
    before = dict(_build.LAUNCHES)
    hg.hash_encode_auto(x, table, cfg).square().sum().backward()
    assert _build.LAUNCHES[hg.FWD] == before.get(hg.FWD, 0) + 1
    assert _build.LAUNCHES[hg.BWD] == before.get(hg.BWD, 0) + 1
    assert table.grad is not None and torch.isfinite(table.grad).all()


def test_occupancy_lookup_matches_plain_exactly():
    dev = _card()
    G = 128
    gen = torch.Generator(device=dev).manual_seed(1)
    grid = torch.rand((G ** 3,), generator=gen, device=dev) * 0.02
    packed = og.pack_bits(grid > 0.01)
    x = torch.rand((1, 4096, 128, 3), generator=gen, device=dev) * 2 - 1
    x[0, :, 0] = (torch.randint(0, G + 1, (4096, 3), generator=gen,
                                device=dev).float() * (2.0 / G) - 1.0)
    out = _launched(og.LOOKUP,
                    lambda: og.occupancy_lookup_cuda(x, packed, G, 1.0))
    assert out.shape == x.shape[:-1] and out.dtype == torch.bool
    assert torch.equal(out, og.occupancy_lookup_plain(x, packed, G, 1.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(2)
    # (B, N, H, D) projections viewed as (B, H, N, D), as the UNet passes them
    q, k, v = (torch.randn((2, 4096, 8, 40), generator=gen, device=dev)
               .to(dt).permute(0, 2, 1, 3) for _ in range(3))
    out = _launched(at.ATTN, lambda: at.attention_cuda(q, k, v, 40 ** -0.5))
    assert out.dtype == dt and out.shape == q.shape
    # f32: another summation order; bf16: the plain path rounds P to bf16
    rel = 1e-5 if dtype == "float32" else 2e-2
    _close_to_max(out, at.attention_plain(q, k, v, 40 ** -0.5), rel,
                  "attention")


def _projected_sphere(dev, n_views, seed):
    from tpunerf_torch.core.views import ViewSamplerConfig, rand_poses
    from tpunerf_torch.meshrep import render as mrender
    from tpunerf_torch.meshrep import shapes
    mesh = shapes.uv_sphere().normalize(target_scale=0.6, dy=0.25).to(dev)
    views = rand_poses(n_views, ViewSamplerConfig(), dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    fv_cam, fv_img, _ = mrender._project(
        mesh.vertices, mesh.faces, views.theta, views.phi, views.radius,
        mrender.CameraSpec(look_at_height=0.25))
    valid = torch.ones(fv_img.shape[:2], dtype=torch.bool, device=dev)
    return fv_img, fv_cam[..., 2], valid


@pytest.mark.parametrize("size", [64, 100])
def test_dense_selection_kernel_matches_plain_exactly(size):
    dev = _card()
    fv_img, fv_z, valid = _projected_sphere(dev, 3, 3)
    # duplicate faces: exact z ties everywhere they are visible
    fv_img = torch.cat([fv_img, fv_img[:, :500]], dim=1)
    fv_z = torch.cat([fv_z, fv_z[:, :500]], dim=1)
    valid = torch.cat([valid, valid[:, :500]], dim=1)
    valid[:, 7] = valid[:, 3968 + 7] = False    # a face and its copy
    rows = rz._face_rows(fv_img, fv_z, valid)
    pix = rz.pixel_grid_ndc(size, size, dev)   # 100² is no multiple of 64
    out = _launched(rz.DENSE, lambda: rz.select_faces_dense(rows, pix))
    ref = rz.select_faces_dense_plain(rows, pix)
    assert out.dtype == torch.int32 and out.shape == (3, size * size)
    assert torch.equal(out, ref)               # 0 mismatches
    assert (ref >= 0).any() and (ref < 0).any() and not (ref == 7).any()
    assert not (ref >= 3968).any()             # a copy never beats its twin


def test_binned_selection_kernel_matches_plain_and_dense_exactly():
    dev = _card()
    fv_img, fv_z, valid = _projected_sphere(dev, 2, 4)
    H = W = 512     # 2-row bands: the sphere's bins stay under K = 256
    pix = rz.pixel_grid_ndc(H, W, dev)
    before = dict(_build.LAUNCHES)
    fid = rz._select_faces_batched(pix, fv_img, fv_z, valid, H, W)
    assert _build.LAUNCHES[rz.BINNED] == before.get(rz.BINNED, 0) + 1
    assert _build.LAUNCHES.get(rz.DENSE, 0) == before.get(rz.DENSE, 0)
    rows = rz._face_rows(fv_img, fv_z, valid)
    assert torch.equal(fid, rz.select_faces_dense_plain(rows, pix))
    assert torch.equal(fid, rz.select_faces_dense(rows, pix))


def _soft_inputs(dev, size, n_views, seed, wide=True):
    """Soft rows of the projected sphere (the wide camera sees its rim),
    with a degenerate face, a face outside the view and a padded row."""
    fv_img, _, _ = _projected_sphere(dev, n_views, seed)
    fv_img = fv_img.clone()
    fv_img[:, 5, 2] = fv_img[:, 5, 1]
    fv_img[:, 6] += 3.0
    rows = rz._soft_rows(fv_img).contiguous()
    rows[:, 9, 15] = 0.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    pix = rz.pixel_grid_ndc(size, size, dev)
    return fv_img, rows, pix, gen


@pytest.mark.parametrize("size", [64, 50])
def test_dense_soft_kernels_match_plain(size):
    dev = _card()
    _, rows, pix, gen = _soft_inputs(dev, size, 2, 5)
    P = pix.shape[0]                           # 50² is no multiple of 32
    prod = _launched(rz.SOFT_FWD_DENSE,
                     lambda: rz.soft_prod_dense(rows, pix, 1e-4))
    ref = rz.soft_prod_dense_plain(rows, pix, 1e-4)
    assert prod.shape == (2, P)
    # a product of the same factors in eight slices: rounding only
    assert (prod - ref).abs().max().item() <= 5e-6
    assert ((ref > 0.01) & (ref < 0.99)).any() and (ref == 0).any()
    g = torch.randn((2, P), generator=gen, device=dev)
    grad = _launched(rz.SOFT_BWD_DENSE,
                     lambda: rz.soft_grad_dense(rows, pix, g, prod, 1e-4))
    # each backward with its own forward's prod; sums in another order
    _close_to_max(grad, rz.soft_grad_dense_plain(rows, pix, g, ref, 1e-4),
                  2e-5, "dense soft backward")
    assert torch.isfinite(grad).all()
    assert grad[:, 6].abs().max() == 0 and grad[:, 9].abs().max() == 0
    # deterministic: no atomics
    assert torch.equal(grad, rz.soft_grad_dense(rows, pix, g, prod, 1e-4))


def test_binned_soft_kernels_match_plain_and_dense():
    dev = _card()
    H = W = 512
    fv_img, _, pix, gen = _soft_inputs(dev, H, 2, 6)
    B, F = fv_img.shape[:2]
    K = rz._SOFT_BIN_K
    ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    if int(maxc) > K:                          # bins that hold, whatever K
        K = -(-int(maxc) // 128) * 128
        ids, maxc = rz._soft_bins(fv_img, H, W, 1e-4, K)
    rows = rz._with_filler(rz._soft_rows(fv_img)).contiguous()
    prod = _launched(rz.SOFT_FWD_BINNED,
                     lambda: rz.soft_prod_binned(rows, ids, pix, 1e-4))
    ref = rz.soft_prod_binned_plain(rows, ids, pix, 1e-4)
    assert (prod - ref).abs().max().item() <= 5e-6
    g = torch.randn(prod.shape, generator=gen, device=dev)
    slots = _launched(rz.SOFT_BWD_BINNED, lambda: rz.soft_grad_binned(
        rows, ids, pix, g, prod, 1e-4))
    _close_to_max(slots,
                  rz.soft_grad_binned_plain(rows, ids, pix, g, ref, 1e-4),
                  2e-5, "binned soft backward rows")
    # against the dense kernels: the bins drop tails below 1e-12; the sum
    # back to faces (index_add_) runs in an order that varies
    dense_rows = rows[:, :F].contiguous()
    dense = rz.soft_prod_dense(dense_rows, pix, 1e-4)
    assert (prod.reshape(B, -1) - dense).abs().max().item() <= 1e-5
    _close_to_max(rz._slots_to_faces(slots, ids, F),
                  rz.soft_grad_dense(dense_rows, pix,
                                     g.reshape(B, -1).contiguous(), dense,
                                     1e-4), 1e-4, "binned vs dense backward")


def test_soft_silhouette_autograd_runs_the_kernels():
    dev = _card()
    fv_img, _, _, gen = _soft_inputs(dev, 64, 1, 7)
    before = dict(_build.LAUNCHES)
    v = fv_img.clone().requires_grad_()
    rz.soft_silhouette(64, 64, v).square().sum().backward()
    assert _build.LAUNCHES[rz.SOFT_FWD_DENSE] == \
        before.get(rz.SOFT_FWD_DENSE, 0) + 1
    assert _build.LAUNCHES[rz.SOFT_BWD_DENSE] == \
        before.get(rz.SOFT_BWD_DENSE, 0) + 1
    assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0
    # card against CPU, the whole pair
    c = fv_img.cpu().requires_grad_()
    rz.soft_silhouette(64, 64, c).square().sum().backward()
    _close_to_max(v.grad.cpu(), c.grad, 1e-4, "soft silhouette gradient")


def test_wrappers_raise_instead_of_falling_back():
    dev = _card()
    cfg = HashGridConfig()
    with pytest.raises(TypeError):
        hg.hash_encode_cuda(torch.rand((8, 3), device=dev, dtype=torch.float64),
                            torch.zeros((12, 2048, 2), device=dev), cfg)
    with pytest.raises(TypeError):
        q = torch.zeros((1, 1, 8, 40), device=dev, dtype=torch.float16)
        at.attention(q, q, q, 1.0)
    with pytest.raises(ValueError):
        q = torch.zeros((1, 1, 8, 160), device=dev)
        at.attention(q, q, q, 1.0)
    pix = rz.pixel_grid_ndc(8, 8, dev)
    with pytest.raises(TypeError):
        rz.select_faces_dense(torch.zeros((1, 4, 12), device=dev,
                                          dtype=torch.float64), pix)
    with pytest.raises(ValueError):
        rz.select_faces_dense(torch.zeros((1, 12, 4), device=dev)
                              .transpose(1, 2), pix)
    with pytest.raises(ValueError):
        rz.select_faces_binned(torch.zeros((1, 4, 12), device=dev),
                               torch.zeros((1, 1, 64), device=dev,
                                           dtype=torch.int64), pix)
    with pytest.raises(TypeError):
        rz.soft_prod_dense(torch.zeros((1, 4, 16), device=dev,
                                       dtype=torch.float64), pix, 1e-4)
    with pytest.raises(ValueError):
        rz.soft_grad_dense(torch.zeros((1, 4, 16), device=dev), pix,
                           torch.zeros((1, 63), device=dev),
                           torch.zeros((1, 64), device=dev), 1e-4)
    with pytest.raises(ValueError):      # a CPU map beside CUDA rows
        rz.soft_grad_dense(torch.zeros((1, 4, 16), device=dev), pix,
                           torch.zeros((1, 64)),
                           torch.zeros((1, 64), device=dev), 1e-4)


def test_tiny_app_step_goes_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--optim.iters", "2",
        "--render.train_grid_size", "16", "--log.exp_root", str(tmp_path),
        "--log.eval_size", "0", "--log.full_eval_size", "0",
        "--log.save_mesh", "false", "--log.log_images", "false",
        "--log.save_interval", "100"])
    app = LatentNeRFApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # two steps; the refresh at step 1 adds one forward encode
    assert _build.LAUNCHES[hg.FWD] == 3 and _build.LAUNCHES[hg.BWD] == 2
    assert _build.LAUNCHES[og.LOOKUP] == 2


def test_tiny_paint_step_and_eval_go_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint import LatentPaintApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.shape_path", "sphere",
        "--guide.texture_resolution", "32", "--optim.iters", "2",
        "--render.train_grid_size", "24", "--render.eval_grid_size", "512",
        "--log.exp_root", str(tmp_path), "--log.eval_size", "0",
        "--log.full_eval_size", "2", "--log.save_mesh", "true",
        "--log.log_images", "false", "--log.save_interval", "100"])
    app = LatentPaintApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # mesh and dome per step; the 512² eval render takes the band bins
    assert _build.LAUNCHES[rz.DENSE] == 4 and _build.LAUNCHES[rz.BINNED] == 1
    assert (tmp_path / "default" / "mesh" / "mesh.obj").exists()


def test_tiny_mesh_app_step_and_eval_go_through_the_kernels(tmp_path):
    dev = _card()
    from tpunerf_torch.core.config import parse
    from tpunerf_torch.training.config import TrainConfig
    from tpunerf_torch.training.latent_paint_mesh import LatentPaintMeshApp
    from tpunerf_torch.training.trainer import Trainer
    cfg = parse(TrainConfig, [
        "--guide.tiny_diffusion", "true", "--guide.shape_path", "sphere",
        "--guide.texture_resolution", "32", "--optim.iters", "2",
        "--render.train_grid_size", "24", "--render.eval_grid_size", "64",
        "--render.body_prob", "0.5", "--log.exp_root", str(tmp_path),
        "--log.eval_size", "0", "--log.full_eval_size", "2",
        "--log.save_mesh", "true", "--log.log_images", "false",
        "--log.save_interval", "100"])
    app = LatentPaintMeshApp.create(cfg, device=dev)
    trainer = Trainer(cfg, app, device=dev)
    _build.reset_launches()
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(loss.item()))
    assert np.isfinite(losses).all()
    # two cameras per step and per eval chunk; no loss reads the soft mask
    assert _build.LAUNCHES[rz.SOFT_FWD_DENSE] == 2 * 2 + 2
    assert _build.LAUNCHES.get(rz.SOFT_BWD_DENSE, 0) == 0
    assert app.scene.displacement.abs().max() > 0
    assert (tmp_path / "default" / "mesh" / "mesh.obj").exists()
