"""The latent-paint-mesh slice of the port as a whole against the JAX
package's, on the tiny config of tests/test_latent_paint_mesh_e2e.py
(`sphere`, 24² train grid, tiny guidance, 32² texture): the scene's five
parameters carried over from JAX, the training render with displacement,
normals, lighting, the soft mask and the two cameras, the loss of modes 0, 1
and 2 with JAX's draws (replayed from its key splits), every gradient, one
Adam step with the two learning rates, the eval render, and a short Trainer
run through the CLI that writes frames and a displaced OBJ."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, port_guidance)
from tpunerf.core import views as jviews
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint_mesh import LatentPaintMeshApp as JApp
from tpunerf_torch import train_latent_paint_mesh as cli
from tpunerf_torch.core import views as tviews
from tpunerf_torch.core.obj_io import load_obj
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_paint_mesh import \
    LatentPaintMeshApp as TApp
from tpunerf_torch.training.trainer import Trainer, unported_settings
from tpunerf_torch.weights import load_flax_params

# the renders' CPU maps on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")
PARAMS = ("background_sphere_colors", "texture_img",
          "texture_img_rgb_finetune", "displacement", "lights")


def _cfg(mod, tmp_path, mode=0, body_prob=0.5, **log):
    base = dict(exp_name="m", exp_root=tmp_path, save_interval=1000,
                eval_size=1, full_eval_size=2, eval_batch=2,
                log_images=False, save_mesh=False)
    base.update(log)
    return mod.TrainConfig(
        log=mod.LogConfig(**base),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                body_prob=body_prob),
        optim=mod.OptimConfig(iters=6, seed=0, lr=1e-2, mode=mode,
                              lambda_laplacian=10.0,
                              lambda_displacement=1.0),
        guide=mod.GuideConfig(text="a red car", shape_path="sphere",
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32"))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def guidances(tiny_sd_guidance):
    g = port_guidance(tiny_sd_guidance)
    load_flax_params(g.vae, np_tree(tiny_sd_guidance.vae_params), "vae")
    return tiny_sd_guidance, g


def _apps(guidances, tmp, mode, rng, body_prob=0.5):
    """Both apps in `mode`, with parameters that exercise every branch: a
    random displacement, lights off the default, a random RGB texture.
    `body_prob` < 1 gives the body and head cameras, whose narrow fields
    the sphere fills at the poses used here; 1 gives the one wide camera, which sees its rim and
    the background."""
    jg, tg = guidances
    japp = JApp.create(_cfg(jconfig, tmp, mode, body_prob),
                       guidance=dataclasses.replace(jg,
                                                    latent_mode=mode == 0))
    params = dict(japp.init_params(jax.random.key(1)))
    V = japp.scene.mesh.num_vertices
    params["displacement"] = jnp.asarray(
        0.01 * rng.normal(size=(V, 3)), jnp.float32)
    params["lights"] = params["lights"] + jnp.asarray(
        0.2 * rng.normal(size=(1, 9)), jnp.float32)
    params["texture_img_rgb_finetune"] = jnp.asarray(
        rng.uniform(size=(1, 32, 32, 3)), jnp.float32)
    tapp = TApp.create(_cfg(tconfig, tmp, mode, body_prob), guidance=tg,
                       device="cpu")
    load_flax_params(tapp.scene, np_tree(params), "paint_mesh_scene")
    return japp, params, tapp


def _views(is_body):
    n = len(is_body)
    jv = jviews.ViewBatch(
        theta=jnp.asarray([1.2, 0.9, 0.5][:n]),
        phi=jnp.asarray([0.4, 2.5, 4.0][:n]),
        radius=jnp.asarray([1.4, 1.3, 1.1][:n]),
        dirs=jnp.asarray([0, 2, 4][:n], jnp.int32),
        is_body=jnp.asarray(is_body))
    tv = tviews.ViewBatch(*(_t(a) for a in (jv.theta, jv.phi, jv.radius,
                                            jv.dirs, jv.is_body)))
    tv.dirs = tv.dirs.long()
    return jv, tv


def _sds_draws(key, g, shape):
    k_t, k_n = jax.random.split(key)
    return (torch.tensor(int(jsds.sample_timestep(k_t, g.min_step,
                                                  g.max_step))),
            _t(jax.random.normal(k_n, shape)))


def _draws(mode, key, japp):
    """JAX's draws for one loss_fn call, by replaying its key splits."""
    g = japp.guidance
    k_sds, _ = jax.random.split(key)
    lat = (1, g.latent_size, g.latent_size, 4)
    if mode == 0:
        t, noise = _sds_draws(k_sds, g, lat)
        return {"t": t, "noise": noise}
    enc = tuple(g.encode_imgs_mode(
        jnp.zeros((1, g.image_size, g.image_size, 3))).shape)
    if mode == 1:
        k1, k2, k3 = jax.random.split(k_sds, 3)
        t1, n1 = _sds_draws(k3, g, enc)
        t2, n2 = _sds_draws(jax.random.fold_in(k3, 1), g, enc)
        return {"vae_noise_img": _t(jax.random.normal(k1, enc)),
                "vae_noise_nrm": _t(jax.random.normal(k2, enc)),
                "t_img": t1, "noise_img": n1, "t_nrm": t2, "noise_nrm": n2}
    k1, k2 = jax.random.split(k_sds)
    return {"vae_noise": _t(jax.random.normal(k1, enc)),
            "noise": _t(jax.random.normal(k2, enc))}


def test_scene_and_prompt_banks_match_jax(guidances, tmp_path, rng):
    japp, params, tapp = _apps(guidances, tmp_path, 0, rng)
    ts, js = tapp.scene, japp.scene
    for a, b in ((ts.camera, js.camera), (ts.head_camera, js.head_camera)):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert ts.soft_mask_sigma == js.soft_mask_sigma == 1e-4
    assert ts.enable_displacement and ts.latent_size == js.latent_size == 16
    np.testing.assert_allclose(ts.verts0_lap.numpy(),
                               np.asarray(js.verts0_lap), atol=2e-6)
    np.testing.assert_allclose(tapp.text_z.numpy(), np.asarray(japp.text_z),
                               atol=2e-5)
    np.testing.assert_allclose(tapp.text_z_head.numpy(),
                               np.asarray(japp.text_z_head), atol=2e-5)
    assert sorted(n for n, _ in ts.named_parameters()) == sorted(PARAMS)
    # a fresh init: zero displacement, lights (3, 0, …, 0), as JAX's
    fresh = TApp.create(tapp.cfg, guidance=tapp.guidance, device="cpu")
    fresh.init_params(torch.Generator().manual_seed(0))
    ref = japp.init_params(jax.random.key(0))
    for k in ("displacement", "lights", "texture_img_rgb_finetune"):
        np.testing.assert_array_equal(
            getattr(fresh.scene, k).detach().numpy(), np.asarray(ref[k]))
    jv, tv = _views([True, False, False])
    np.testing.assert_allclose(tapp._select_text(tv).numpy(),
                               np.asarray(japp._select_text(jv)), atol=2e-5)


@pytest.mark.parametrize("with_lighting,body_prob", [(False, 1.0),
                                                     (True, 0.5)])
def test_render_train_matches_jax(guidances, tmp_path, rng, with_lighting,
                                  body_prob):
    japp, params, tapp = _apps(guidances, tmp_path, 0, rng, body_prob)
    assert (tapp.scene.head_camera is not None) == (body_prob < 1)
    jv, tv = _views([True, False])
    ref = japp.scene.render_train(params, jv, with_lighting=with_lighting)
    got = tapp.scene.render_train(tv, with_lighting=with_lighting)
    keys = ["image", "mask", "background", "foreground", "depth",
            "soft_mask", "normals"] + (["lighting"] if with_lighting else [])
    for k in keys:
        assert got[k].shape == tuple(ref[k].shape), k
        diff = np.abs(got[k].detach().numpy() - np.asarray(ref[k]))
        # bicubic resize of f32 renders, and the soft mask's ~2e-5 (another
        # formulation of the edge distance on the JAX side)
        assert diff.max() <= 5e-5 * max(1.0, np.abs(ref[k]).max()), \
            (k, diff.max())
    assert got["lighting"] is None or got["lighting"].shape == (2, 24, 24, 1)
    assert got["image"].shape == (2, 16, 16, 4)
    if body_prob < 1:    # the head camera gives another frame of the pose
        assert (got["depth"][0] - got["depth"][1]).abs().max() > 1e-2
    else:                # the wide camera sees the soft rim
        soft = got["soft_mask"].detach()
        assert ((soft > 0.01) & (soft < 0.99)).any()
    for k in ("laplacian_loss", "displacement_norm"):
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=2e-5)
    assert got["soft_mask"].requires_grad and not got["mask"].requires_grad


def _check_grads(tapp, grads_j, rel, keys):
    for k in keys:
        got = getattr(tapp.scene, k).grad
        assert got is not None, k
        assert_close_to_max(got.numpy(), np.asarray(grads_j[k]), rel, k)
        assert (got.abs().sum() > 0) == (np.abs(grads_j[k]).sum() > 0), k


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_loss_gradients_and_adam_step_match_jax(guidances, tmp_path, rng,
                                                mode):
    # mode 0 with the two cameras (they see no background: its gradient is
    # zero on both sides), modes 1 and 2 with the one wide camera
    japp, params, tapp = _apps(guidances, tmp_path, mode, rng,
                               body_prob=0.5 if mode == 0 else 1.0)
    jv, tv = _views([True, False] if mode == 0 else [True])
    key = jax.random.key(13)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: japp.loss_fn(p, jv, key, jnp.asarray(1)), has_aux=True))(
        params)
    draws = _draws(mode, key, japp)
    if mode == 0:
        draws["noise"] = _t(jax.random.normal(
            jax.random.split(jax.random.split(key)[0])[1], (2, 16, 16, 4)))
    opt = tapp.make_optimizer()
    opt.zero_grad()
    loss_t, aux_t = tapp.loss_fn(tv, draws=draws)
    loss_t.backward()
    # mode 0: the SDS term carries the UNet's ~1e-4-of-max agreement (×100
    # CFG); modes 1 and 2 add the VAE encoder (f32 convolutions in another
    # order) in front of it
    rel = 1e-4 if mode == 0 else 5e-4
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=rel)
    assert_close_to_max(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                        2e-5, "render")
    np.testing.assert_allclose(aux_t["laplacian_loss"].item(),
                               float(aux_j["laplacian_loss"]), rtol=2e-5)
    scene = tapp.scene
    tex = "texture_img" if mode == 0 else "texture_img_rgb_finetune"
    other = "texture_img_rgb_finetune" if mode == 0 else "texture_img"
    assert scene.trainable_keys() == ("background_sphere_colors", tex)
    trained = ["background_sphere_colors", tex, "displacement"]
    if mode != 0:
        trained.append("lights")
    # the displacement's gradient comes end to end through barycentrics,
    # normals, the resize and the projection
    _check_grads(tapp, grads_j, rel, trained)
    for k in trained[1 if mode == 0 else 0:]:
        assert getattr(scene, k).grad.abs().sum() > 0, k
    assert getattr(scene, other).grad is None
    assert np.abs(np.asarray(grads_j[other])).max() == 0
    if mode == 0:        # no lighting in mode 0: no gradient on either side
        assert scene.lights.grad is None
        assert np.abs(np.asarray(grads_j["lights"])).max() == 0

    # one Adam step: texture and dome at lr, displacement and lights at
    # disp_lr (optax multi_transform on the JAX side)
    tx = japp.make_optimizer()
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = optax.apply_updates(params, updates)
    opt.step()
    lrs = {"displacement": 1e-4, "lights": 1e-4}
    for k in trained:
        gj = np.asarray(grads_j[k])
        if not np.abs(gj).max() > 0:
            continue
        # with eps = 1e-15 the first update is lr·sign(g): compare where
        # |g| is well clear of zero
        big = np.abs(gj) > 1e-3 * np.abs(gj).max()
        got = getattr(scene, k).detach().numpy()
        np.testing.assert_allclose(got[big], np.asarray(new_j[k])[big],
                                   atol=1e-6, err_msg=k)
        step = np.abs(got - np.asarray(params[k]))[big]
        # the step read back as a difference of f32 values up to ~3
        np.testing.assert_allclose(step, lrs.get(k, 1e-2), rtol=1e-3,
                                   atol=5e-7, err_msg=k)
    np.testing.assert_array_equal(getattr(scene, other).detach().numpy(),
                                  np.asarray(new_j[other]))
    assert [g["lr"] for g in opt.param_groups] == [1e-2, 1e-4]


def test_draws_come_from_the_generator_when_not_given(guidances, tmp_path,
                                                      rng):
    _, _, tapp = _apps(guidances, tmp_path, 2, rng)
    _, tv = _views([True])
    a = tapp.loss_fn(tv, generator=torch.Generator().manual_seed(4))[0]
    b = tapp.loss_fn(tv, generator=torch.Generator().manual_seed(4))[0]
    c = tapp.loss_fn(tv, generator=torch.Generator().manual_seed(5))[0]
    assert a.item() == b.item() != c.item() and a.item() >= 0   # MSE form


@pytest.mark.parametrize("mode", [0, 1])
def test_eval_render_matches_jax(guidances, tmp_path, rng, mode):
    japp, params, tapp = _apps(guidances, tmp_path, mode, rng)
    jv = jviews.circle_poses(2, jviews.ViewSamplerConfig())
    tv = tviews.circle_poses(2, tviews.ViewSamplerConfig(),
                             torch.device("cpu"))
    ref = japp.eval_render(params, jv, (32, 32))
    got = tapp.eval_render(tv, (32, 32))
    assert got["image"].shape == (2, 32, 32, 3)
    assert not got["mask"].requires_grad         # the app's eval: no_grad
    np.testing.assert_allclose(got["texture_map"].detach().numpy(),
                               np.asarray(ref["texture_map"]), atol=1e-5)
    # the soft mask of the displaced mesh under the body camera
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(ref["mask"]),
                               atol=5e-5)
    diff = np.abs(got["image"].numpy() - np.asarray(ref["image"])).max(-1)
    assert (diff > 1e-4).sum() <= 3, "only pixels within rounding of an edge"
    if mode == 1:
        for k in ("normals", "lighting"):
            d = np.abs(got[k].numpy() - np.asarray(ref[k])).max(-1)
            assert (d > 1e-4).sum() <= 3, k
    else:
        assert got["normals"] is None and got["lighting"] is None


def test_render_test_mask_carries_a_gradient_to_the_displacement(
        guidances, tmp_path, rng):
    japp, params, tapp = _apps(guidances, tmp_path, 0, rng)
    jv = jviews.circle_poses(1, jviews.ViewSamplerConfig())
    tv = tviews.circle_poses(1, tviews.ViewSamplerConfig(),
                             torch.device("cpu"))
    decode = japp.guidance.decode_latents
    ref = jax.grad(lambda p: jnp.sum(japp.scene.render_test(
        p, jv, decode_fn=decode, dims=(32, 32))["mask"] ** 2))(params)
    out = tapp.scene.render_test(tv, decode_fn=tapp.guidance.decode_latents,
                                 dims=(32, 32))
    out["mask"].square().sum().backward()
    got = tapp.scene.displacement.grad.numpy()
    ref = np.asarray(ref["displacement"])
    # closed form here, autodiff of the scan there: equal but at ties
    scale = np.abs(ref).max()
    diff = np.abs(got - ref)
    assert scale > 0 and (diff > 2e-5 * scale).mean() < 5e-3
    assert diff.max() < 1e-3 * scale, (diff.max(), scale)


def test_cli_trains_evaluates_and_exports_a_displaced_mesh(tmp_path):
    cli.main(["--device", "cpu", "--guide.tiny_diffusion", "true",
              "--guide.unet_dtype", "float32", "--guide.text", "a red car",
              "--guide.shape_path", "sphere", "--guide.texture_resolution",
              "32", "--optim.iters", "6", "--optim.disp_lr", "1e-3",
              "--render.train_grid_size", "24", "--render.eval_grid_size",
              "32", "--render.body_prob", "0.5", "--log.exp_root",
              str(tmp_path), "--log.exp_name", "cli", "--log.eval_size", "2",
              "--log.full_eval_size", "2", "--log.eval_batch", "2",
              "--log.save_mesh", "true", "--log.log_images", "false",
              "--log.save_interval", "100"])
    exp = tmp_path / "cli"
    evals = sorted(p.name for p in (exp / "vis" / "eval").glob("*.png"))
    assert evals == ["step_000000_000_rgb.png", "step_000000_001_rgb.png",
                     "step_000000_texture.png"]
    results = [p.name for p in (exp / "results").iterdir()]
    assert "step_000006_texture.png" in results
    for name in ("mesh.obj", "mesh.mtl", "albedo.png"):
        assert (exp / "mesh" / name).exists(), name
    from tpunerf_torch.meshrep import shapes
    base = shapes.load_shape("sphere").normalize(0.6, 0.25)
    out = load_obj(exp / "mesh" / "mesh.obj")
    assert out.vertices.shape == tuple(base.vertices.shape)
    moved = np.abs(out.vertices - base.vertices.numpy()).max()
    assert 0 < moved <= 6 * 1e-3 + 1e-6       # six Adam steps at disp_lr


def test_trainer_steps_move_both_parameter_groups(guidances, tmp_path):
    _, tg = guidances
    cfg = _cfg(tconfig, tmp_path, mode=1, body_prob=1.0, eval_size=0,
               full_eval_size=0)
    cfg.optim.iters = 2
    app = TApp.create(cfg, guidance=tg, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    before = {k: v.detach().clone() for k, v in
              app.scene.named_parameters()}
    losses = []
    trainer.train(on_step=lambda s, loss: losses.append(float(loss)))
    assert len(losses) == 2 and np.isfinite(losses).all()
    for k in ("background_sphere_colors", "texture_img_rgb_finetune",
              "displacement", "lights"):
        assert not torch.equal(before[k], getattr(app.scene, k).detach()), k
    assert torch.equal(before["texture_img"], app.scene.texture_img.detach())


@pytest.mark.parametrize("setting,word", [
    (dict(guide=dict(use_sd=False)), "Paint-by-Example"),
    (dict(guide=dict(diffusion_name="sd-v2-depth")), "depth"),
    (dict(guide=dict(image="ref.png")), "guide.image"),
    (dict(optim=dict(use_clip=True)), "CLIP"),
    (dict(guide=dict(sampled_texture="tex.png")), "sampled_texture"),
    (dict(guide=dict(concept_name="cat-toy")), "concept_name"),
])
def test_slice_4_settings_are_refused_by_name(tmp_path, setting, word):
    """Everything slice 4 refused is ported: depth SD, Paint-by-Example,
    `guide.image`, the CLIP losses, `guide.sampled_texture` and
    `guide.concept_name` (a concept directory for the SD-v1 stack, held
    against JAX in test_torch_sd_sampling.py); what stays refused around
    them is refused by name, and a concept name that is no directory
    raises. With them, `guide.clip_model_dir` is read where the JAX
    package reads it: for the tower that `guide.image` builds."""
    cfg = _cfg(tconfig, tmp_path)
    for section, kv in setting.items():
        for k, v in kv.items():
            setattr(getattr(cfg, section), k, v)
    if word == "depth":
        # depth-conditioned SD is ported (mode 0); its modes 1 and 2, which
        # the JAX package lacks, are refused by name
        cfg.optim.mode = 1
        with pytest.raises(NotImplementedError, match="depth") as err:
            TApp.create(cfg, device="cpu")
        assert "no such path" in str(err.value)
    elif word == "Paint-by-Example":
        # mode 0 needs the exemplar; modes 1 and 2 have no such path
        with pytest.raises(ValueError, match=word):
            TApp.create(cfg, device="cpu")
        cfg.optim.mode = 1
        with pytest.raises(NotImplementedError, match=word) as err:
            TApp.create(cfg, device="cpu")
        assert "no such path" in str(err.value)
    elif word == "concept_name":
        # a hub name is no directory: nothing can be fetched, so it raises
        # where the JAX package would skip it
        with pytest.raises(ValueError, match="concept_name") as err:
            TApp.create(cfg, device="cpu")
        assert "not a directory" in str(err.value)
    elif word == "guide.image":
        # the tower of clip_loss is read from guide.clip_model_dir: one
        # that does not exist raises as in the JAX package
        from tpunerf_torch.utils import write_png
        cfg.guide.image = tmp_path / "ref.png"
        write_png(cfg.guide.image, np.full((64, 64, 3), 90, np.uint8))
        cfg.guide.clip_model_dir = tmp_path / "clip"
        with pytest.raises(FileNotFoundError, match="no model"):
            TApp.create(cfg, device="cpu")
    elif word == "CLIP":
        # optim.use_clip without Paint-by-Example and without guide.image
        # builds no tower, so guide.clip_model_dir is not read, as in JAX
        cfg.guide.clip_model_dir = tmp_path / "clip"
        app = TApp.create(cfg, device="cpu")
        assert app.clip is None and app.ref_image is None


def test_sampled_texture_seeds_both_textures_as_jax(guidances, tmp_path):
    """`guide.sampled_texture` with text-guided SD: a 100² PNG read at
    max(4·32, 64) = 128² (PIL's resize), its mode encode and the image
    itself resized bilinearly to the 32² latent and RGB textures."""
    from tpunerf_torch.utils import write_png
    jg, tg = guidances
    tex = tmp_path / "tex.png"
    write_png(tex, (np.random.default_rng(2).uniform(size=(100, 100, 3))
                    * 255).astype(np.uint8))
    jcfg, tcfg = _cfg(jconfig, tmp_path), _cfg(tconfig, tmp_path)
    jcfg.guide.sampled_texture = tcfg.guide.sampled_texture = tex
    japp = JApp.create(jcfg, guidance=jg)
    tapp = TApp.create(tcfg, guidance=tg, device="cpu")
    params = japp.init_params(jax.random.key(0))
    tapp.init_params(torch.Generator().manual_seed(0))
    scene = tapp.scene
    assert_close_to_max(scene.texture_img_rgb_finetune.detach().numpy(),
                        np.asarray(params["texture_img_rgb_finetune"]), 1e-6,
                        "RGB texture")
    assert_close_to_max(scene.texture_img.detach().numpy(),
                        np.asarray(params["texture_img"]), 1e-4,
                        "latent texture")


def test_clip_loss_text_token_opt_and_bad_mode_are_refused(guidances,
                                                           tmp_path, rng):
    _, _, tapp = _apps(guidances, tmp_path, 0, rng)
    # clip_loss is ported; without guide.image it has no reference
    with pytest.raises(ValueError, match="guide.image"):
        tapp.clip_loss(None)
    cfg = _cfg(tconfig, tmp_path)
    cfg.optim.use_opt_txt = True
    assert any("use_opt_txt" in s for s in unported_settings(cfg, tapp))
    cfg = _cfg(tconfig, tmp_path, mode=3)
    with pytest.raises(ValueError, match="optim.mode"):
        TApp.create(cfg, guidance=tapp.guidance, device="cpu")
