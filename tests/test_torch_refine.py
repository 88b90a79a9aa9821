"""The latent→RGB refine stage of the port against the JAX package's, on
tiny configs at f32: RGB-mode SDS (a bilinear resize to the VAE's image
size, a VAE encode with its posterior draw, SDS) with every draw made on the
JAX side; the 64→512 enlarging and 1024→128 shrinking bilinear resizes;
latent-NeRF's checkpoint migration (fresh colour and background heads, the
geometry kept) and latent-paint's (the latent texture decoded into the RGB
finetune texture), each through a checkpoint file and `Trainer` with
`optim.ckpt`; and one RGB refine step of each app. JAX's draws are made by
replaying its key splits (latent_nerf_app.py:92, stable_diffusion.py:
246-251, sds.py:57-60)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree, port_guidance
from tpunerf.core import views as jviews
from tpunerf.fields import occupancy as jocc
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_nerf_app import LatentNeRFApp as JNeRF
from tpunerf.training.latent_paint import LatentPaintApp as JPaint
from tpunerf_torch.core import views as tviews
from tpunerf_torch.fields.latent_nerf import LatentNeRFField
from tpunerf_torch.guidance import sds as tsds
from tpunerf_torch.kernels import texture as TT
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp as TNeRF
from tpunerf_torch.training.latent_nerf_app import \
    select_text_embeddings as tselect
from tpunerf_torch.training.latent_paint import LatentPaintApp as TPaint
from tpunerf_torch.training.trainer import Trainer
from tpunerf_torch.utils import make_generator
from tpunerf_torch.weights import load_flax_params, state_dict_from_flax

CPU = torch.device("cpu")
# The SDS loss Σ latents·w(ε̂ − ε) cancels: the magnitudes of its terms
# add up to tens of times its size, and the score gradient carries the
# UNet's ~4e-5-of-max agreement (×100 CFG), so the loss is held to 1e-5
# of Σ|l·g|, not of itself. Gradients
# (the score through the VAE encoder's backward) to 1e-4 of their maximum.
LOSS_REL = 1e-5
GRAD_REL = 1e-4


def _log(mod, tmp_path, name):
    return mod.LogConfig(exp_name=name, exp_root=tmp_path, eval_size=0,
                         full_eval_size=0, save_mesh=False, log_images=False,
                         save_interval=1000)


def _nerf_cfg(mod, tmp_path, name, nerf_type):
    return mod.TrainConfig(
        log=_log(mod, tmp_path, name),
        render=mod.RenderConfig(train_grid_size=16, num_samples_per_ray=32,
                                mlp_dtype="float32", nerf_type=nerf_type),
        optim=mod.OptimConfig(seed=0, lr=1e-2, iters=2),
        guide=mod.GuideConfig(text="a sand castle", tiny_diffusion=True,
                              unet_dtype="float32"))


def _paint_cfg(mod, tmp_path, name, nerf_type):
    return mod.TrainConfig(
        log=_log(mod, tmp_path, name),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                nerf_type=nerf_type),
        optim=mod.OptimConfig(iters=2, seed=0, lr=1e-2),
        guide=mod.GuideConfig(text="a red fish", shape_path="sphere",
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32"))


@pytest.fixture(scope="module")
def guidances(tiny_sd_guidance):
    """(JAX RGB guidance, port latent guidance, port RGB guidance), the
    port's holding the JAX weights, the VAE's too."""
    port = port_guidance(tiny_sd_guidance)
    load_flax_params(port.vae, np_tree(tiny_sd_guidance.vae_params), "vae")
    return (dataclasses.replace(tiny_sd_guidance, latent_mode=False), port,
            dataclasses.replace(port, latent_mode=False))


def _port_views(jv):
    tv = tviews.ViewBatch(*(torch.from_numpy(np.array(a)) for a in
                            (jv.theta, jv.phi, jv.radius, jv.dirs,
                             jv.is_body)))
    tv.dirs = tv.dirs.long()
    return tv


def _sds_draws(key, latent_shape, g):
    """What JAX's RGB `train_step_loss(key, …)` draws: the VAE posterior's
    normal from `key` itself, t and the noise from its split."""
    vae_noise = jax.random.normal(key, latent_shape)
    k_t, k_n = jax.random.split(key)
    t = jsds.sample_timestep(k_t, g.min_step, g.max_step)
    noise = jax.random.normal(k_n, latent_shape)
    return {"vae_noise": torch.from_numpy(np.array(vae_noise)),
            "t": torch.tensor(int(t)),
            "noise": torch.from_numpy(np.array(noise))}


def _assert_loss_close(loss_t, loss_j, tg, draws, text, render):
    """|Δloss| ≤ LOSS_REL · Σ|l·g|, the sum's terms (the latents of the
    RGB `train_step_loss(text, render)` and their score gradient) taken
    from the port's side with the same draws: they only scale the
    bound."""
    with torch.no_grad():
        rgb = TT.resize_bilinear(render, tg.image_size, tg.image_size)
        lat = tg.encode_imgs(rgb, noise=draws["vae_noise"])
        grad, _ = tsds.score_gradient(tg.unet_apply, tg.sched, lat, text,
                                      100.0, tg.min_step, tg.max_step,
                                      t=draws["t"], noise=draws["noise"])
    scale = float((lat * grad).abs().sum())
    assert abs(float(loss_t) - float(loss_j)) <= LOSS_REL * scale, (
        float(loss_t), float(loss_j), scale)


# ---------------------------------------------------------------------------
# the resize and RGB-mode SDS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size_in, size_out", [(64, 512), (1024, 128)],
                         ids=["enlarge_64_512", "shrink_1024_128"])
def test_bilinear_resize_matches_jax_image_resize(size_in, size_out):
    """The refine step's 64→512 resize and the paint migration's
    1024→128 one, against the jitted `jax.image.resize(…, 'bilinear')`
    (the weights' sample positions are rounded once, as its fused
    multiply-add rounds them): within 1e-6 of the maximum."""
    img = np.random.default_rng(size_in).random(
        (1, size_in, size_in, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (1, size_out, size_out, 3), "bilinear"))(jnp.asarray(img)))
    got = TT.resize_bilinear(torch.from_numpy(img), size_out, size_out)
    assert_close_to_max(got.numpy(), ref, 1e-6, "resize")
    if size_out > size_in:
        # enlarging: torch's own bilinear (edge pixels clamped) agrees
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(img).permute(0, 3, 1, 2), size=size_out,
            mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        assert_close_to_max(plain.numpy(), ref, 1e-6, "F.interpolate")


def test_rgb_train_step_loss_matches_jax(guidances):
    jg, _, tg = guidances
    rng = np.random.default_rng(7)
    render = rng.random((1, 24, 24, 3)).astype(np.float32)
    text = rng.standard_normal((2, 77, jg.text_encoder.config.hidden_size)
                               ).astype(np.float32) * 0.1
    key = jax.random.key(21)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: jg.train_step_loss(key, jnp.asarray(text), x, 100.0)))(
        jnp.asarray(render))
    lat = (1, jg.image_size // 4, jg.image_size // 4, 4)
    draws = _sds_draws(key, lat, jg)
    x = torch.from_numpy(render).requires_grad_(True)
    loss_t = tg.train_step_loss(torch.from_numpy(text), x, 100.0, **draws)
    loss_t.backward()
    _assert_loss_close(loss_t.item(), loss_j, tg, draws,
                       torch.from_numpy(text), torch.from_numpy(render))
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), GRAD_REL,
                        "gradient to the render")
    # a draw of its own from a generator: the same shapes, finite
    y = torch.from_numpy(render).requires_grad_(True)
    tg.train_step_loss(torch.from_numpy(text), y, 100.0,
                       generator=torch.Generator().manual_seed(0)).backward()
    assert torch.isfinite(y.grad).all() and y.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# latent-NeRF: the migration and an RGB step
# ---------------------------------------------------------------------------

def _latent_nerf_checkpoint(tmp_path, tiny_sd_guidance, port):
    """A port checkpoint file of a JAX-initialised latent field (with an
    occupancy blob); the JAX params."""
    japp = JNeRF.create(_nerf_cfg(jconfig, tmp_path, "jl", "latent"),
                        guidance=tiny_sd_guidance)
    params = jax.jit(japp.init_params)(jax.random.key(3))
    centers = np.asarray(jocc.cell_centers(japp.scene.occ_cfg))
    params["occ_grid"] = jnp.asarray(
        np.where(np.linalg.norm(centers, axis=-1) < 0.45, 1.0, 0.0),
        jnp.float32)
    cfg = _nerf_cfg(tconfig, tmp_path, "latent", "latent")
    app = TNeRF.create(cfg, guidance=port, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    load_flax_params(app.scene, np_tree(params), "scene")
    trainer.save_checkpoint(full=True)
    trainer.close()
    return trainer.ckpt_dir / "step_000000.ckpt", params


def test_latent_nerf_migration_keeps_geometry_and_redraws_heads(
        tmp_path, tiny_sd_guidance, guidances):
    jg, port, tg = guidances
    path, params = _latent_nerf_checkpoint(tmp_path, tiny_sd_guidance, port)
    cfg = _nerf_cfg(tconfig, tmp_path, "rgb", "rgb")
    cfg.optim.ckpt = path
    app = TNeRF.create(cfg, guidance=tg, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    trainer.close()
    got = app.scene.state_dict()
    latent = dict(state_dict_from_flax(np_tree(params["field"]), "field"))
    fresh = LatentNeRFField(app.scene.field.config, CPU,
                            make_generator(0, CPU)).state_dict()
    heads = {f"{h}.layers.{len(getattr(app.scene.field, h).layers) - 1}"
             f".weight" for h in ("color_mlp", "bg_mlp")}
    for name, v in latent.items():
        if name in heads:
            assert v.shape[0] == 4 and got["field." + name].shape[0] == 3
            assert torch.equal(got["field." + name], fresh[name]), name
        else:
            assert torch.equal(got["field." + name], v), name
    for buf in ("occ_grid", "occ_packed"):
        assert torch.equal(got[buf], app.scene.state_dict()[buf])
    np.testing.assert_array_equal(got["occ_grid"].numpy(),
                                  np.asarray(params["occ_grid"]))
    # the JAX migration keeps the same tensors
    jrgb = JNeRF.create(_nerf_cfg(jconfig, tmp_path, "jr", "rgb"),
                        guidance=jg)
    migrated = jrgb.migrate_params(jax.tree_util.tree_map(lambda a: a,
                                                          params))
    kept = state_dict_from_flax(np_tree(migrated["field"]), "field")
    for name, v in kept.items():
        if name not in heads:
            assert torch.equal(got["field." + name], v), name
        else:
            assert v.shape == got["field." + name].shape
    # Adam is fresh and the run starts at step 0
    assert trainer.train_step_idx == 0 and not trainer.optimizer.state


def test_rgb_nerf_refine_step_matches_jax(tmp_path, guidances):
    jg, _, tg = guidances
    japp = JNeRF.create(_nerf_cfg(jconfig, tmp_path, "j", "rgb"),
                        guidance=jg)
    params = jax.jit(japp.init_params)(jax.random.key(1))
    centers = np.asarray(jocc.cell_centers(japp.scene.occ_cfg))
    params["occ_grid"] = jnp.asarray(
        np.where(np.linalg.norm(centers, axis=-1) < 0.45, 1.0, 0.0),
        jnp.float32)
    tapp = TNeRF.create(_nerf_cfg(tconfig, tmp_path, "t", "rgb"),
                        guidance=tg, device="cpu")
    load_flax_params(tapp.scene, np_tree(params), "scene")
    key_view, key = jax.random.split(jax.random.key(11))
    jv = jviews.rand_poses(key_view, 1, jviews.ViewSamplerConfig())
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        japp.loss_fn, has_aux=True))(params, jv, key, jnp.asarray(1))
    k_render, k_sds = jax.random.split(key)
    u = jax.random.uniform(k_render, (1, 16 * 16, 32))
    draws = _sds_draws(k_sds, (1, 16, 16, 4), jg)
    loss_t, aux_t = tapp.loss_fn(_port_views(jv),
                                 u=torch.from_numpy(np.array(u)), **draws)
    loss_t.backward()
    assert aux_t["image"].shape == (1, 16, 16, 3)
    assert_close_to_max(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                        1e-5, "rendered RGB")
    _assert_loss_close(loss_t.item(), loss_j, tg, draws,
                       tselect(tapp.text_z, _port_views(jv).dirs),
                       aux_t["image"])
    ref = state_dict_from_flax(np_tree(grads_j["field"]), "field")
    for name, p in tapp.scene.field.named_parameters():
        assert_close_to_max(p.grad.numpy(), ref[name].numpy(), GRAD_REL,
                            name)


# ---------------------------------------------------------------------------
# latent-paint: the texture migration and an RGB step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paint(tiny_sd_guidance, guidances, tmp_path_factory):
    """The JAX latent and RGB paint apps, the latent params, and a port
    checkpoint file of them."""
    jg, port, _ = guidances
    tmp = tmp_path_factory.mktemp("paint_refine")
    jlat = JPaint.create(_paint_cfg(jconfig, tmp, "jl", "latent"),
                         guidance=tiny_sd_guidance)
    jrgb = JPaint.create(_paint_cfg(jconfig, tmp, "jr", "rgb"), guidance=jg)
    params = jlat.init_params(jax.random.key(1))
    cfg = _paint_cfg(tconfig, tmp, "latent", "latent")
    app = TPaint.create(cfg, guidance=port, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    load_flax_params(app.scene, np_tree(params), "paint_scene")
    trainer.save_checkpoint(full=True)
    trainer.close()
    return jrgb, params, trainer.ckpt_dir / "step_000000.ckpt", tmp


def test_paint_migration_decodes_the_latent_texture_like_jax(paint,
                                                             guidances):
    """The decoded, resized texture becomes the finetune texture of a
    Trainer loading the latent checkpoint in RGB mode (`optim.ckpt`). The
    tiny VAE decode agrees with JAX's to ~1e-6 of the maximum and the
    shrinking resize to 1.2e-7 (an f32 rounding of the positions): 1e-5
    of the maximum."""
    jrgb, params, path, tmp = paint
    _, _, tg = guidances
    ref = jrgb.migrate_params(dict(params))["texture_img_rgb_finetune"]
    cfg = _paint_cfg(tconfig, tmp, "rgb", "rgb")
    cfg.optim.ckpt = path
    app = TPaint.create(cfg, guidance=tg, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    trainer.close()
    got = app.scene.texture_img_rgb_finetune.detach()
    assert got.shape == (1, 32, 32, 3) and got.abs().max() > 0
    assert_close_to_max(got.numpy(), np.asarray(ref), 1e-5,
                        "texture_img_rgb_finetune")
    np.testing.assert_array_equal(app.scene.texture_img.detach().numpy(),
                                  np.asarray(params["texture_img"]))
    assert app.make_optimizer().param_groups[0]["params"][1] is \
        app.scene.texture_img_rgb_finetune


def test_paint_migration_returns_the_texture_in_params(paint, guidances):
    """ROADMAP §C.5: the migration is built from the checkpoint's
    `texture_img` and returned in the params that the trainer then loads;
    the scene's own state is not what it reads or writes."""
    _, params, path, tmp = paint
    _, _, tg = guidances
    app = TPaint.create(_paint_cfg(tconfig, tmp, "rgb2", "rgb"),
                        guidance=tg, device="cpu")
    app.init_params(torch.Generator().manual_seed(9))
    before = {k: v.clone() for k, v in app.state_dict().items()}
    ckpt = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    ckpt["texture_img_rgb_finetune"] = torch.zeros((1, 32, 32, 3))
    out = app.migrate_params(ckpt)
    assert all(torch.equal(before[k], v) for k, v in app.state_dict().items())
    expect = TT.resize_bilinear(tg.decode_latents(ckpt["texture_img"]),
                                32, 32)
    assert torch.equal(out["texture_img_rgb_finetune"], expect)
    # an RGB checkpoint with a finetune texture loads unchanged
    ckpt["texture_img_rgb_finetune"] = expect
    assert app.migrate_params(ckpt) is ckpt


def test_rgb_paint_refine_step_matches_jax(paint, guidances):
    jrgb, params, _, tmp = paint
    jg, _, tg = guidances
    migrated = jrgb.migrate_params(dict(params))
    tapp = TPaint.create(_paint_cfg(tconfig, tmp, "rgbstep", "rgb"),
                         guidance=tg, device="cpu")
    load_flax_params(tapp.scene, np_tree(migrated), "paint_scene")
    jv = jviews.rand_poses(jax.random.key(4), 2, jviews.ViewSamplerConfig())
    key = jax.random.key(13)
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        jrgb.loss_fn, has_aux=True)(migrated, jv, key, jnp.asarray(1))
    draws = _sds_draws(key, (2, 16, 16, 4), jg)
    loss_t, aux_t = tapp.loss_fn(_port_views(jv), **draws)
    loss_t.backward()
    assert aux_t["image"].shape == (2, 24, 24, 3)
    _assert_loss_close(loss_t.item(), loss_j, tg, draws,
                       tselect(tapp.text_z, _port_views(jv).dirs),
                       aux_t["image"])
    for k in tapp.scene.trainable_keys():
        assert_close_to_max(getattr(tapp.scene, k).grad.numpy(),
                            np.asarray(grads_j[k]), GRAD_REL, k)
    assert tapp.scene.texture_img.grad is None
