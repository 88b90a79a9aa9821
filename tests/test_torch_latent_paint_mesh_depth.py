"""Latent-paint-mesh with depth-conditioned SD (eval config #5's path,
`demo_configs/latent_paint_mesh/nascar_depth.yaml`) in the port against the
JAX package's, on the tiny stack of tests/conftest.py
(`tiny_depth_guidance`) and the tiny scene of
tests/test_torch_latent_paint_mesh.py (`sphere`, 24² train grid resized to
the 16² latent, 32² texture): B = 2 views in mode 0 at `body_prob` 1.0 (the
one wide camera) and 0.7 (body and head), each view's depth range of
`normalize_depth` first, then the loss and every gradient with JAX's draws,
then one Adam step; the refusals of what config #5 cannot run yet; and the
CLI on the YAML (tiny, sphere, CPU) for 2 steps with its eval and
export."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, port_depth_guidance)
from tpunerf.core import views as jviews
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint_mesh import LatentPaintMeshApp as JApp
from tpunerf_torch import train_latent_paint_mesh as cli
from tpunerf_torch.core import views as tviews
from tpunerf_torch.guidance.depth import normalize_depth
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_paint_mesh import \
    LatentPaintMeshApp as TApp
from tpunerf_torch.weights import load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
YAML = "demo_configs/latent_paint_mesh/nascar_depth.yaml"
# the SDS term carries the tiny UNet's ~1e-4-of-max agreement (×100 CFG),
# as mode 0 of tests/test_torch_latent_paint_mesh.py
REL = 1e-4


def _cfg(mod, tmp_path, body_prob=1.0, mode=0, **log):
    base = dict(exp_name="d", exp_root=tmp_path, save_interval=1000,
                eval_size=1, full_eval_size=2, eval_batch=2,
                log_images=False, save_mesh=False)
    base.update(log)
    return mod.TrainConfig(
        log=mod.LogConfig(**base),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                body_prob=body_prob, batch_size=2),
        optim=mod.OptimConfig(iters=2, seed=0, lr=1e-2, mode=mode,
                              lambda_laplacian=10.0,
                              lambda_displacement=1.0),
        guide=mod.GuideConfig(text="a next gen nascar", shape_path="sphere",
                              diffusion_name="sd-depth", tiny_diffusion=True,
                              texture_resolution=32, unet_dtype="float32"))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def stacks(tiny_depth_guidance):
    return tiny_depth_guidance, port_depth_guidance(tiny_depth_guidance)


def _apps(stacks, tmp, body_prob, rng):
    jg, tg = stacks
    japp = JApp.create(_cfg(jconfig, tmp, body_prob), depth_guidance=jg)
    assert japp.guidance is None and japp.depth_guidance is jg
    params = dict(japp.init_params(jax.random.key(1)))
    V = japp.scene.mesh.num_vertices
    params["displacement"] = jnp.asarray(
        0.01 * rng.normal(size=(V, 3)), jnp.float32)
    params["lights"] = params["lights"] + jnp.asarray(
        0.2 * rng.normal(size=(1, 9)), jnp.float32)
    tapp = TApp.create(_cfg(tconfig, tmp, body_prob), depth_guidance=tg,
                       device="cpu")
    assert tapp.guidance is tg
    load_flax_params(tapp.scene, np_tree(params), "paint_mesh_scene")
    return japp, params, tapp


def _views(is_body):
    jv = jviews.ViewBatch(
        theta=jnp.asarray([1.2, 0.9]), phi=jnp.asarray([0.4, 2.5]),
        radius=jnp.asarray([1.4, 1.3]), dirs=jnp.asarray([0, 2], jnp.int32),
        is_body=jnp.asarray(is_body))
    tv = tviews.ViewBatch(*(_t(a) for a in (jv.theta, jv.phi, jv.radius,
                                            jv.dirs, jv.is_body)))
    tv.dirs = tv.dirs.long()
    return jv, tv


def _depth_range(depth, mask):
    d, m = np.asarray(depth, np.float64), np.asarray(mask) > 0
    return (np.array([d[b][m[b]].min() for b in range(len(d))]),
            np.array([d[b][m[b]].max() for b in range(len(d))]))


@pytest.mark.parametrize("body_prob", [1.0, 0.7])
def test_depth_mode0_loss_gradients_and_adam_step_match_jax(
        stacks, tmp_path, body_prob):
    rng = np.random.default_rng(0)
    japp, params, tapp = _apps(stacks, tmp_path, body_prob, rng)
    assert tapp.scene.latent_size == japp.scene.latent_size == 16
    np.testing.assert_allclose(tapp.text_z.numpy(), np.asarray(japp.text_z),
                               atol=2e-5)
    jv, tv = _views([True, False])

    # each view's depth range over the (resized) mask first: the mask > 0
    # set and the depths at its ends are the same on both sides
    ref = jax.jit(lambda p: japp.scene.render_train(p, jv))(params)
    got = tapp.scene.render_train(tv)
    assert got["depth"].shape == (2, 16, 16, 1)
    np.testing.assert_array_equal(got["mask"].numpy() > 0,
                                  np.asarray(ref["mask"]) > 0)
    lo_t, hi_t = _depth_range(got["depth"].detach(), got["mask"])
    lo_j, hi_j = _depth_range(ref["depth"], ref["mask"])
    np.testing.assert_allclose(lo_t, lo_j, rtol=5e-5)
    np.testing.assert_allclose(hi_t, hi_j, rtol=5e-5)
    assert (hi_t - lo_t > 0.05).all()
    from tpunerf.guidance.depth import normalize_depth as jnorm
    assert_close_to_max(
        normalize_depth(got["depth"].detach(), got["mask"]).numpy(),
        np.asarray(jnorm(ref["depth"], ref["mask"])), 1e-4, "depth")

    key = jax.random.key(13)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: japp.loss_fn(p, jv, key, jnp.asarray(1)), has_aux=True))(
        params)
    k_t, k_n = jax.random.split(jax.random.split(key)[0])
    g = japp.depth_guidance
    draws = {"t": torch.tensor(int(jsds.sample_timestep(k_t, g.min_step,
                                                        g.max_step))),
             "noise": _t(jax.random.normal(k_n, (2, 16, 16, 4)))}
    opt = tapp.make_optimizer()
    opt.zero_grad()
    loss_t, aux_t = tapp.loss_fn(tv, draws=draws)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=REL)
    assert_close_to_max(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                        2e-5, "render")
    scene = tapp.scene
    trained = ["background_sphere_colors", "texture_img", "displacement"]
    for k in trained:
        gt = getattr(scene, k).grad
        assert gt is not None, k
        assert_close_to_max(gt.numpy(), np.asarray(grads_j[k]), REL, k)
    for k in ("texture_img", "displacement"):
        assert getattr(scene, k).grad.abs().sum() > 0, k
    # mode 0: no lighting, and the RGB texture is in no group
    assert scene.lights.grad is None and \
        np.abs(np.asarray(grads_j["lights"])).max() == 0
    assert scene.texture_img_rgb_finetune.grad is None

    # one Adam step: texture and dome at lr, displacement at disp_lr
    tx = japp.make_optimizer()
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = optax.apply_updates(params, updates)
    opt.step()
    for k in trained:
        gj = np.asarray(grads_j[k])
        if not np.abs(gj).max() > 0:
            continue
        big = np.abs(gj) > 1e-3 * np.abs(gj).max()
        np.testing.assert_allclose(
            getattr(scene, k).detach().numpy()[big],
            np.asarray(new_j[k])[big], atol=1e-6, err_msg=k)


@pytest.mark.parametrize("setting,word", [
    (dict(optim=dict(mode=1)), "no such path"),
    (dict(optim=dict(mode=2)), "no such path"),
    (dict(guide=dict(model_dir="sd2-depth")), "no checkpoint"),
    (dict(guide=dict(clip_model_dir="clip")), None),
    (dict(guide=dict(use_sd=False)), "unused"),
    (dict(guide=dict(concept_name="cat-toy")), "A.6"),
])
def test_what_config_5_cannot_run_yet_is_refused_by_name(stacks, tmp_path,
                                                         setting, word):
    """What config #5 cannot run is refused by name; a `guide.model_dir`
    that does not exist raises FileNotFoundError, and `guide.clip_model_dir`
    without `guide.image` is not read (no CLIP tower is built), as in the
    JAX package."""
    cfg = _cfg(tconfig, tmp_path)
    for section, kv in setting.items():
        for k, v in kv.items():
            setattr(getattr(cfg, section), k, v)
    if word is None:
        app = TApp.create(cfg, depth_guidance=stacks[1], device="cpu")
        assert app.clip is None
        return
    exc = FileNotFoundError if word == "no checkpoint" else \
        NotImplementedError
    with pytest.raises(exc, match=word):
        TApp.create(cfg, device="cpu")


@pytest.mark.parametrize("setting", ["image", "use_clip",
                                     "sampled_texture"])
def test_config_5_takes_an_image_the_clip_flag_and_a_sampled_texture(
        stacks, tmp_path, setting):
    """As in the JAX package: `guide.image` gives `clip_loss` its reference
    (read at 512²) and tower; `optim.use_clip` changes nothing without
    Paint-by-Example; a sampled texture seeds the RGB texture only (the
    latent one is seeded from text-guided SD's encode alone)."""
    from tpunerf_torch.utils import write_png
    cfg = _cfg(tconfig, tmp_path)
    png = tmp_path / "img.png"
    write_png(png, np.full((64, 64, 3), 200, np.uint8))
    if setting == "use_clip":
        cfg.optim.use_clip = True
    else:
        setattr(cfg.guide, setting, png)
    app = TApp.create(cfg, depth_guidance=stacks[1], device="cpu")
    app.init_params(torch.Generator().manual_seed(0))
    assert (app.clip is not None) == (setting == "image")
    assert (app.ref_image is not None) == (setting == "image")
    if setting == "image":
        assert app.ref_image.shape == (1, 512, 512, 3)
        jv = tviews.ViewBatch(*(_t(a) for a in (
            [1.2, 0.9], [0.4, 2.5], [1.4, 1.3], [0, 2], [True, False])))
        assert torch.isfinite(app.clip_loss(jv))
    rgb = app.scene.texture_img_rgb_finetune.detach()
    if setting == "sampled_texture":
        np.testing.assert_allclose(rgb.numpy(), 200 / 255, atol=1e-6)
    else:
        assert not rgb.any()


def test_cli_trains_nascar_depth_evaluates_and_exports(tmp_path):
    cli.main(["--config_path", YAML, "--guide.shape_path", "sphere",
              "--device", "cpu", "--guide.tiny_diffusion", "true",
              "--optim.iters", "2", "--render.train_grid_size", "24",
              "--render.eval_grid_size", "32",
              "--guide.texture_resolution", "32",
              "--log.exp_root", str(tmp_path), "--log.eval_size", "1",
              "--log.full_eval_size", "2", "--log.eval_batch", "2",
              "--log.log_images", "false", "--log.save_interval", "2"])
    exp = tmp_path / "nascar_depth"
    evals = sorted(p.name for p in (exp / "vis" / "eval").glob("*.png"))
    assert "step_000000_000_rgb.png" in evals
    assert "step_000002_000_rgb.png" in evals
    assert (exp / "checkpoints" / "step_000002.ckpt").exists()
    assert "step_000002_texture.png" in [p.name for p in
                                         (exp / "results").iterdir()]
    for name in ("mesh.obj", "mesh.mtl", "albedo.png"):
        assert (exp / "mesh" / name).exists(), name
    cfg = (exp / "config.yaml").read_text()
    assert "sd-depth" in cfg and "batch_size: 2" in cfg
