"""The latent-paint slice of the port as a whole against the JAX package's,
on the tiny config of tests/test_latent_paint_e2e.py (`sphere`, 24² train
grid, tiny guidance, 32² texture): the scene's parameters carried over from
JAX, the training render, the SDS loss with JAX's timestep and noise, both
gradients, one Adam step, the eval render, and a short Trainer run that
writes the eval frames, the texture and the exported mesh. JAX's draws are
made by replaying its key splits (textured_mesh.py:122, sds.py:57-60)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree, port_guidance
from tpunerf.core import views as jviews
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint import LatentPaintApp as JApp
from tpunerf_torch.core import views as tviews
from tpunerf_torch.kernels import rasterize as TR
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_paint import LatentPaintApp as TApp
from tpunerf_torch.training.trainer import Trainer
from tpunerf_torch.weights import load_flax_params


def _cfg(mod, tmp_path, shape="sphere", **log):
    base = dict(exp_name="t", exp_root=tmp_path, save_interval=1000,
                eval_size=2, full_eval_size=3, eval_batch=2,
                log_images=False)
    base.update(log)
    return mod.TrainConfig(
        log=mod.LogConfig(**base),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32),
        optim=mod.OptimConfig(iters=6, seed=0, lr=1e-2),
        guide=mod.GuideConfig(text="a red fish", shape_path=shape,
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32"))


def _port_views(jv):
    tv = tviews.ViewBatch(*(torch.from_numpy(np.array(a)) for a in
                            (jv.theta, jv.phi, jv.radius, jv.dirs,
                             jv.is_body)))
    tv.dirs = tv.dirs.long()
    return tv


@pytest.fixture(scope="module")
def apps(tiny_sd_guidance, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paint")
    japp = JApp.create(_cfg(jconfig, tmp), guidance=tiny_sd_guidance)
    params = japp.init_params(jax.random.key(1))
    guidance = port_guidance(tiny_sd_guidance)
    load_flax_params(guidance.vae, np_tree(tiny_sd_guidance.vae_params),
                     "vae")
    tapp = TApp.create(_cfg(tconfig, tmp), guidance=guidance, device="cpu")
    load_flax_params(tapp.scene, np_tree(params), "paint_scene")
    return japp, params, tapp


def _views(seed, n=2):
    jv = jviews.rand_poses(jax.random.key(seed), n,
                           jviews.ViewSamplerConfig())
    return jv, _port_views(jv)


def test_scene_geometry_and_text_embeddings_match(apps):
    japp, _, tapp = apps
    for name in ("vertices", "faces"):
        np.testing.assert_allclose(
            getattr(tapp.scene.mesh, name).numpy(),
            np.asarray(getattr(japp.scene.mesh, name)), atol=1e-7)
    np.testing.assert_array_equal(tapp.scene.face_uv_attr.numpy(),
                                  np.asarray(japp.scene.face_uv_attr))
    assert tapp.scene.latent_size == japp.scene.latent_size == 16
    assert tapp.scene.trainable_keys() == japp.scene.trainable_keys()
    np.testing.assert_allclose(tapp.text_z.numpy(), np.asarray(japp.text_z),
                               atol=2e-5)


def test_init_params_with_jax_draws_equals_jax(apps):
    japp, _, tapp = apps
    key = jax.random.key(5)
    ref = japp.init_params(key)
    k_bg, k_tex = jax.random.split(key)
    fresh = TApp.create(tapp.cfg, guidance=tapp.guidance, device="cpu")
    fresh.scene.init_params(
        background_u=torch.from_numpy(np.array(jax.random.uniform(
            k_bg, ref["background_sphere_colors"].shape))),
        texture_noise=torch.from_numpy(np.array(jax.random.normal(
            k_tex, ref["texture_img"].shape))))
    for k, v in ref.items():
        np.testing.assert_allclose(getattr(fresh.scene, k).detach().numpy(),
                                   np.asarray(v), atol=1e-6, err_msg=k)
    # from a generator: other numbers, the same law
    fresh.scene.init_params(torch.Generator().manual_seed(0))
    bg = fresh.scene.background_sphere_colors
    assert 0.0 <= bg.min() and bg.max() < 1.0 and bg.std() > 0.2
    assert fresh.scene.texture_img_rgb_finetune.abs().max() == 0


def test_render_train_matches_jax(apps):
    japp, params, tapp = apps
    jv, tv = _views(3)
    ref = japp.scene.render_train(params, jv)
    got = tapp.scene.render_train(tv)
    # the hard mask before the resize decides everything else: the two
    # selections may differ only at pixels within rounding of an edge
    for k in ("image", "mask", "background", "foreground", "depth"):
        assert got[k].shape == tuple(ref[k].shape), k
        diff = np.abs(got[k].detach().numpy() - np.asarray(ref[k]))
        # bicubic resize of f32 renders: rounding only, everywhere
        assert diff.max() <= 2e-5 * max(1.0, np.abs(ref[k]).max()), \
            (k, diff.max())
    assert got["image"].shape == (2, 16, 16, 4)
    assert (got["mask"] > 0.5).any() and (got["mask"] < 0.5).any()


def test_loss_gradients_and_adam_step_match_jax(apps):
    japp, params, tapp = apps
    jv, tv = _views(4, n=1)
    key = jax.random.key(13)
    (loss_j, aux_j), grads_j = jax.value_and_grad(
        japp.loss_fn, has_aux=True)(params, jv, key, jnp.asarray(1))
    k_t, k_n = jax.random.split(key)
    g = japp.guidance
    t = torch.tensor(int(jsds.sample_timestep(k_t, g.min_step, g.max_step)))
    noise = torch.from_numpy(np.array(jax.random.normal(k_n,
                                                        (1, 16, 16, 4))))

    opt = tapp.make_optimizer()
    opt.zero_grad()
    loss_t, aux_t = tapp.loss_fn(tv, t=t, noise=noise)
    loss_t.backward()
    # the SDS term carries the UNet's ~1e-4-of-max agreement (x100 CFG)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    assert_close_to_max(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                        1e-5, "rendered latents")
    scene = tapp.scene
    for k in scene.trainable_keys():
        assert_close_to_max(getattr(scene, k).grad.numpy(),
                            np.asarray(grads_j[k]), 1e-4, k)
        assert getattr(scene, k).grad.abs().sum() > 0
    assert scene.texture_img_rgb_finetune.grad is None

    # one Adam step (optax adam, b2 = 0.99, eps = 1e-15 on both sides)
    tx = japp.make_optimizer()
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = optax.apply_updates(params, updates)
    opt.step()
    for k in scene.trainable_keys():
        gj = np.asarray(grads_j[k])
        # with eps = 1e-15 the first update is lr·sign(g): compare where
        # |g| is well clear of zero, and demand "untouched" where g = 0
        big = np.abs(gj) > 1e-3 * np.abs(gj).max()
        got = getattr(scene, k).detach().numpy()
        np.testing.assert_allclose(got[big], np.asarray(new_j[k])[big],
                                   atol=1e-6, err_msg=k)
        zero = gj == 0
        np.testing.assert_array_equal(got[zero], np.asarray(params[k])[zero])
    # the frozen texture gets no update
    np.testing.assert_array_equal(
        scene.texture_img_rgb_finetune.detach().numpy(),
        np.asarray(new_j["texture_img_rgb_finetune"]))
    # put the parameters back for the tests that follow
    load_flax_params(scene, np_tree(params), "paint_scene")


def test_eval_render_matches_jax(apps):
    japp, params, tapp = apps
    jv = jviews.circle_poses(3, jviews.ViewSamplerConfig())
    tv = tviews.circle_poses(3, tviews.ViewSamplerConfig(),
                             torch.device("cpu"))
    for f in ("theta", "phi", "radius", "dirs", "is_body"):
        np.testing.assert_allclose(getattr(tv, f).numpy(),
                                   np.asarray(getattr(jv, f)), atol=1e-6)
    ref = japp.eval_render(params, jv, (32, 32))
    got = tapp.eval_render(tv, (32, 32))
    assert got["image"].shape == (3, 32, 32, 3)
    # VAE decode in f32 on both sides
    np.testing.assert_allclose(got["texture_map"].numpy(),
                               np.asarray(ref["texture_map"]), atol=1e-5)
    same = got["mask"].numpy() == np.asarray(ref["mask"])
    assert (~same).sum() <= 3, "only pixels within rounding of an edge"
    px = same[..., 0]
    np.testing.assert_allclose(got["image"].numpy()[px],
                               np.asarray(ref["image"])[px], atol=1e-4)
    assert float(got["image"].min()) >= 0.0


def test_trainer_run_writes_eval_frames_texture_and_mesh(apps, tmp_path):
    _, _, tapp = apps
    cfg = _cfg(tconfig, tmp_path, save_mesh=True)
    app = TApp.create(cfg, guidance=tapp.guidance, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    tex0 = app.scene.texture_img.detach().clone()
    bg0 = app.scene.background_sphere_colors.detach().clone()
    losses = []
    trainer.train(on_step=lambda step, loss: losses.append(float(loss)))
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert not torch.equal(tex0, app.scene.texture_img.detach())
    assert not torch.equal(bg0, app.scene.background_sphere_colors.detach())
    assert app.scene.texture_img_rgb_finetune.abs().max() == 0
    exp = cfg.log.exp_dir
    assert (exp / "config.yaml").exists()
    evals = sorted(p.name for p in (exp / "vis" / "eval").glob("*.png"))
    assert evals == ["step_000000_000_rgb.png", "step_000000_001_rgb.png",
                     "step_000000_texture.png"]
    from PIL import Image
    frame = np.asarray(Image.open(exp / "vis" / "eval" / evals[0]))
    assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8
    assert (frame == 255).any()               # the white background
    tex = np.asarray(Image.open(exp / "vis" / "eval" / evals[2]))
    assert tex.shape == (128, 128, 3)         # 32² latents decoded ×4
    # final orbit: a video where an encoder is installed, else the frames
    results = [p.name for p in (exp / "results").iterdir()]
    assert "step_000006_texture.png" in results
    assert any(n.endswith((".mp4", ".gif")) for n in results) or \
        sum(n.endswith("_rgb.png") for n in results) == 3
    for name in ("mesh.obj", "mesh.mtl", "albedo.png"):
        assert (exp / "mesh" / name).exists(), name
    from tpunerf_torch.core.obj_io import load_obj
    mesh = load_obj(exp / "mesh" / "mesh.obj")
    assert mesh.faces.shape == (app.scene.mesh.num_faces, 3)
    assert mesh.uvs.shape == (3 * app.scene.mesh.num_faces, 2)


def test_eval_tail_chunk_repeats_the_last_pose(apps, tmp_path):
    _, _, tapp = apps
    cfg = _cfg(tconfig, tmp_path, eval_batch=2)
    app = TApp.create(cfg, guidance=tapp.guidance, device="cpu")
    trainer = Trainer(cfg, app, device="cpu")
    seen = []
    render = app.eval_render

    def spy(views, dims):
        seen.append(views.phi.clone())
        return render(views, dims)

    app.eval_render = spy
    frames = trainer.evaluate(7, size=3)
    assert len(frames) == 3 and [len(p) for p in seen] == [2, 2]
    assert seen[1][0] == seen[1][1]           # the padded tail
    assert not np.array_equal(frames[0], frames[1])


def test_icosphere_goes_through_the_unwrap(tiny_sd_guidance, apps, tmp_path):
    _, _, tapp = apps
    japp = JApp.create(_cfg(jconfig, tmp_path / "j", shape="icosphere"),
                       guidance=tiny_sd_guidance)
    app = TApp.create(_cfg(tconfig, tmp_path / "t", shape="icosphere"),
                      guidance=tapp.guidance, device="cpu")
    assert (tmp_path / "t" / "t" / "vt.npy").exists()     # the atlas cache
    np.testing.assert_allclose(app.scene.face_uv_attr.numpy(),
                               np.asarray(japp.scene.face_uv_attr),
                               atol=1e-7)
    params = japp.init_params(jax.random.key(2))
    load_flax_params(app.scene, np_tree(params), "paint_scene")
    jv, tv = _views(6, n=1)
    ref = japp.scene.render_train(params, jv)
    got = app.scene.render_train(tv)
    assert_close_to_max(got["image"].detach().numpy(),
                        np.asarray(ref["image"]), 2e-5, "icosphere render")


def test_unported_options_are_refused_naming_their_slice(apps):
    from tpunerf_torch.meshrep.textured_mesh import TexturedMeshScene
    _, _, tapp = apps
    # the mesh-slice options are ported: each builds its part of the scene
    scene = TexturedMeshScene.create(
        "sphere", device="cpu", enable_displacement=True, dual_camera=True,
        soft_mask_sigma=1e-4)
    assert scene.displacement.shape == scene.mesh.vertices.shape
    assert scene.head_camera is not None and scene.soft_mask_sigma == 1e-4
    assert tapp.scene.head_camera is None and tapp.scene.laplacian is None
    # a latent-mode scene loads a checkpoint as it is; the latent→RGB
    # finetune (ROADMAP.md item A.2, landed) decodes the latent texture
    # into the params it returns (tests/test_torch_refine.py holds it to
    # JAX)
    params = tapp.state_dict()
    assert tapp.migrate_params(params) is params
    out = tapp.scene.migrate_latent_to_rgb(params,
                                           tapp.guidance.decode_latents)
    assert out["texture_img_rgb_finetune"].shape == \
        params["texture_img_rgb_finetune"].shape
    assert out["texture_img_rgb_finetune"].abs().max() > 0
    assert not TR.uses_bins(24, 24, tapp.scene.mesh.num_faces)
