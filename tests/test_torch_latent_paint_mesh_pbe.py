"""Latent-paint-mesh with Paint-by-Example guidance in the port against the
JAX package's, on the tiny stack drawn in the port and loaded into the JAX
package by its own diffusers-layout loader (`_torch_port.pbe_stacks`) and
the tiny scene of tests/test_torch_latent_paint_mesh.py (`sphere`, 24²
train grid resized to the latent grid — the scene's 64², set to 16² on
both sides for the steps —, 32² texture, body and head cameras): the exemplar read from an 80² PNG (resized as PIL resizes
it) and its embedding; a mode-0 step with `optim.use_clip` off (JAX's drawn
t) and on (t = 250, the CLIP branch, through the tiny CLIP tower), each
with the loss, every gradient and one Adam step; `clip_loss`; a sampled
texture (with text-guided SD: tests/test_torch_latent_paint_mesh.py); the
refusals; and
the CLI on the command of the Paint-by-Example cell (tiny, CPU) for a
step with its eval, checkpoint and export."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, pbe_stacks)
from tpunerf.core import views as jviews
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_paint_mesh import LatentPaintMeshApp as JApp
from tpunerf_torch import train_latent_paint_mesh as cli
from tpunerf_torch.core import views as tviews
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_paint_mesh import \
    LatentPaintMeshApp as TApp
from tpunerf_torch.utils import write_png
from tpunerf_torch.weights import load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# the SDS and CLIP terms carry the tiny UNet's ~1e-4-of-max agreement, as
# mode 0 of tests/test_torch_latent_paint_mesh.py
REL = 1e-4
TRAINED = ("background_sphere_colors", "texture_img", "displacement")


def _cfg(mod, tmp_path, use_clip=False, image=None, mode=0, **guide):
    return mod.TrainConfig(
        log=mod.LogConfig(exp_name="p", exp_root=tmp_path, save_interval=1000,
                          eval_size=1, full_eval_size=2, eval_batch=2,
                          log_images=False, save_mesh=False),
        render=mod.RenderConfig(train_grid_size=24, eval_grid_size=32,
                                body_prob=0.7),
        optim=mod.OptimConfig(iters=2, seed=0, lr=1e-2, mode=mode,
                              use_clip=use_clip, lambda_laplacian=10.0,
                              lambda_displacement=1.0),
        guide=mod.GuideConfig(text="a red car", shape_path="sphere",
                              tiny_diffusion=True, texture_resolution=32,
                              unet_dtype="float32", use_sd=False,
                              image=image, **guide))


def _t(a):
    return torch.from_numpy(np.array(a))


def _png(path, size, seed):
    write_png(path, (np.random.default_rng(seed).uniform(
        size=(size, size, 3)) * 255).astype(np.uint8))
    return path


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    return pbe_stacks(tmp_path_factory.mktemp("pbe_weights"))


@pytest.fixture(scope="module")
def built(stacks, tmp_path_factory):
    """The apps with `use_clip`, built once: `fresh(use_clip)` restores the
    port scene's parameters, clears its gradients and gives both apps with
    the CLIP tower (JAX's window the one step t = 250, the CLIP branch) or,
    without `use_clip`, the same apps with no tower and JAX's own
    window."""
    jg = stacks[0]
    japp, params, tapp = _apps(stacks, tmp_path_factory.mktemp("pbe"), True,
                               250)
    # both scenes keep the 64² latent grid with Paint-by-Example; the steps
    # here render 16² latents on both sides, which the tiny UNet and VAE
    # take at a sixteenth of the cost
    assert tapp.scene.latent_size == japp.scene.latent_size == 64
    tapp.scene.latent_size = japp.scene.latent_size = 16
    state = {k: v.clone() for k, v in tapp.scene.state_dict().items()}

    def fresh(use_clip):
        tapp.scene.load_state_dict(state)
        tapp.scene.zero_grad(set_to_none=True)
        if use_clip:
            return japp, params, tapp
        jcfg, tcfg = (dataclasses.replace(
            a.cfg, optim=dataclasses.replace(a.cfg.optim, use_clip=False))
            for a in (japp, tapp))
        return (dataclasses.replace(japp, cfg=jcfg, pbe=jg, clip=None),
                params, dataclasses.replace(tapp, cfg=tcfg, clip=None))
    return fresh


def _apps(stacks, tmp, use_clip, t=None):
    """Both apps on one 80² exemplar; with `t`, JAX's PbE window is that
    one step. The scene's parameters (a random displacement, lights off the
    default) and, with `use_clip`, the CLIP tower carried over from JAX."""
    jg, tg = stacks
    image = _png(tmp / "exemplar.png", 80, 1)
    if t is not None:
        jg = dataclasses.replace(jg, min_step=t, max_step=t)
    japp = JApp.create(_cfg(jconfig, tmp, use_clip, image), pbe=jg)
    rng = np.random.default_rng(0)
    params = dict(japp.init_params(jax.random.key(1)))
    V = japp.scene.mesh.num_vertices
    params["displacement"] = jnp.asarray(
        0.01 * rng.normal(size=(V, 3)), jnp.float32)
    params["lights"] = params["lights"] + jnp.asarray(
        0.2 * rng.normal(size=(1, 9)), jnp.float32)
    tapp = TApp.create(_cfg(tconfig, tmp, use_clip, image), pbe=tg,
                       device="cpu")
    assert tapp.guidance is tg
    load_flax_params(tapp.scene, np_tree(params), "paint_mesh_scene")
    if japp.clip is not None:
        load_flax_params(tapp.clip, np_tree(japp.clip[1]), "clip_vision")
    return japp, params, tapp


def _views():
    jv = jviews.ViewBatch(
        theta=jnp.asarray([1.2]), phi=jnp.asarray([0.4]),
        radius=jnp.asarray([1.4]), dirs=jnp.asarray([0], jnp.int32),
        is_body=jnp.asarray([True]))
    tv = tviews.ViewBatch(*(_t(a) for a in (jv.theta, jv.phi, jv.radius,
                                            jv.dirs, jv.is_body)))
    tv.dirs = tv.dirs.long()
    return jv, tv


@pytest.mark.parametrize("use_clip", [False, True])
def test_pbe_mode0_loss_gradients_and_adam_step_match_jax(built, use_clip):
    japp, params, tapp = built(use_clip)
    np.testing.assert_array_equal(tapp.ref_image.numpy(),
                                  np.asarray(japp.ref_image))
    assert_close_to_max(tapp.image_embeds.numpy(),
                        np.asarray(japp.image_embeds), 1e-5, "exemplar")
    assert (tapp.clip is not None) == (japp.clip is not None) == use_clip
    jv, tv = _views()
    key = jax.random.key(13)
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: japp.loss_fn(p, jv, key, jnp.asarray(1)), has_aux=True))(
        params)
    k_t, k_n = jax.random.split(jax.random.split(key)[0])
    g = japp.pbe
    draws = {"t": torch.tensor(int(jsds.sample_timestep(k_t, g.min_step,
                                                        g.max_step))),
             "noise": _t(jax.random.normal(k_n, (1, 16, 16, 4)))}
    opt = tapp.make_optimizer()
    opt.zero_grad()
    loss_t, aux_t = tapp.loss_fn(tv, draws=draws)
    loss_t.backward()
    if use_clip:
        assert int(draws["t"]) == 250 and bool(aux_t["clip_branch"])
    else:
        assert "clip_branch" not in aux_t
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=REL)
    scene = tapp.scene
    for k in TRAINED:
        gt = getattr(scene, k).grad
        assert gt is not None, k
        assert_close_to_max(gt.numpy(), np.asarray(grads_j[k]), REL, k)
    assert scene.texture_img.grad.abs().sum() > 0
    assert scene.texture_img_rgb_finetune.grad is None

    tx = japp.make_optimizer()
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = optax.apply_updates(params, updates)
    opt.step()
    for k in TRAINED:
        gj = np.asarray(grads_j[k])
        if not np.abs(gj).max() > 0:
            continue
        big = np.abs(gj) > 1e-3 * np.abs(gj).max()
        np.testing.assert_allclose(
            getattr(scene, k).detach().numpy()[big],
            np.asarray(new_j[k])[big], atol=1e-6, err_msg=k)


def test_clip_loss_matches_jax(built):
    japp, params, tapp = built(True)
    jv, tv = _views()
    ref, grads_j = jax.jit(jax.value_and_grad(
        lambda p: japp.clip_loss(p, jv)))(params)
    got = tapp.clip_loss(tv)
    got.backward()
    # −cos in [−1, 1], near 0 for a random tower: an absolute tolerance
    np.testing.assert_allclose(got.item(), float(ref), rtol=0, atol=2e-6)
    assert_close_to_max(tapp.scene.texture_img.grad.numpy(),
                        np.asarray(grads_j["texture_img"]), 1e-4,
                        "texture_img")


def test_sampled_texture_matches_jax(stacks, tmp_path):
    """A 100² image read at max(4·32, 64) = 128² (PIL's resize), then the
    RGB texture resized bilinearly to 32²; with Paint-by-Example the latent
    texture keeps its random draw (only text-guided SD encodes it, as in
    the JAX package)."""
    tex = _png(tmp_path / "tex.png", 100, 2)
    image = _png(tmp_path / "exemplar.png", 64, 3)
    japp = JApp.create(_cfg(jconfig, tmp_path, image=image,
                            sampled_texture=tex), pbe=stacks[0])
    tapp = TApp.create(_cfg(tconfig, tmp_path, image=image,
                            sampled_texture=tex), pbe=stacks[1],
                       device="cpu")
    params = japp.init_params(jax.random.key(0))
    tapp.init_params(torch.Generator().manual_seed(0))
    assert_close_to_max(
        tapp.scene.texture_img_rgb_finetune.detach().numpy(),
        np.asarray(params["texture_img_rgb_finetune"]), 1e-6, "RGB texture")
    # not the image's encode: the red init plus noise, as JAX's
    lat = tapp.scene.texture_img.detach()
    assert abs(float(lat.std()) - float(np.asarray(
        params["texture_img"]).std())) < 0.05


def test_pbe_without_an_exemplar_raises(tmp_path):
    for use_clip in (False, True):
        with pytest.raises(ValueError, match="guide.image") as err:
            TApp.create(_cfg(tconfig, tmp_path, use_clip), device="cpu")
        assert "optim.use_clip" in str(err.value)


@pytest.mark.parametrize("setting,word", [
    (dict(optim=dict(mode=1)), "no such path"),
    (dict(optim=dict(mode=2)), "no such path"),
    (dict(guide=dict(clip_model_dir="clip")), "no model"),
    (dict(guide=dict(model_dir="pbe")), "no checkpoint"),
    (dict(guide=dict(diffusion_name="sd-depth")), "unused"),
    (dict(guide=dict(concept_name="cat-toy")), "A.6"),
])
def test_what_paint_by_example_cannot_run_is_refused_by_name(
        stacks, tmp_path, setting, word):
    """What Paint-by-Example cannot run is refused by name. As in the JAX
    package, a `guide.model_dir` that does not exist raises
    FileNotFoundError; `guide.clip_model_dir` is read only for the tower of
    `optim.use_clip`, and one that does not exist then raises too."""
    cfg = _cfg(tconfig, tmp_path, True, _png(tmp_path / "e.png", 64, 4))
    for section, kv in setting.items():
        for k, v in kv.items():
            setattr(getattr(cfg, section), k, v)
    if word == "no model":
        cfg.optim.use_clip = False
        assert TApp.create(cfg, pbe=stacks[1], device="cpu").clip is None
        cfg.optim.use_clip = True
    exc = FileNotFoundError if word in ("no model", "no checkpoint") \
        else NotImplementedError
    with pytest.raises(exc, match=word):
        TApp.create(cfg, pbe=stacks[1] if word == "no model" else None,
                    device="cpu")


def test_cli_trains_paint_by_example_with_clip_evaluates_and_exports(
        tmp_path):
    image = _png(tmp_path / "exemplar.png", 64, 5)
    cli.main(["--guide.use_sd", "false", "--guide.image", str(image),
              "--optim.use_clip", "true", "--guide.shape_path", "sphere",
              "--device", "cpu", "--guide.tiny_diffusion", "true",
              "--optim.iters", "1", "--render.train_grid_size", "24",
              "--render.eval_grid_size", "32",
              "--guide.texture_resolution", "32",
              "--log.exp_root", str(tmp_path), "--log.exp_name", "pbe",
              "--log.eval_size", "1", "--log.full_eval_size", "1",
              "--log.eval_batch", "1", "--log.log_images", "false",
              "--log.save_interval", "1"])
    exp = tmp_path / "pbe"
    evals = sorted(p.name for p in (exp / "vis" / "eval").glob("*.png"))
    assert "step_000000_000_rgb.png" in evals
    assert "step_000001_000_rgb.png" in evals
    assert (exp / "checkpoints" / "step_000001.ckpt").exists()
    for name in ("mesh.obj", "mesh.mtl", "albedo.png"):
        assert (exp / "mesh" / name).exists(), name
    cfg = (exp / "config.yaml").read_text()
    assert "use_sd: false" in cfg and "use_clip: true" in cfg
