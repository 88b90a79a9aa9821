"""The latent-NeRF eval orbit of the port against the JAX package's, on the
CPU at the tiny config with f32 pinned: the resize (`resize_cubic_jax`
against `jax.image.resize(method="bicubic")`), `LatentNeRFApp.eval_render`
on the same weights and occupancy grid (bridged by `weights.py`) at the 64²
latent grid decoded by the tiny VAE to 256² (no resize), 128² and 320²,
an RGB field's `render_test`, and `max_eval_batch` for latent and RGB
fields."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree, port_guidance
from tpunerf.core import views as jviews
from tpunerf.fields.scene import LatentNeRFScene as JScene
from tpunerf.training import config as jconfig
from tpunerf.training.latent_nerf_app import LatentNeRFApp as JApp
from tpunerf_torch.core import views as tviews
from tpunerf_torch.fields.scene import LatentNeRFScene as TScene
from tpunerf_torch.kernels.texture import resize_cubic_jax
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp as TApp
from tpunerf_torch.weights import load_flax_params

CPU = torch.device("cpu")


@pytest.mark.parametrize("size, out", [
    ((64, 64), (96, 96)), ((256, 256), (320, 320)), ((256, 256), (128, 128)),
    ((256, 256), (100, 100)), ((48, 48), (48, 48)), ((40, 64), (64, 30))],
    ids=["up64-96", "up256-320", "down256-128", "down256-100", "equal",
         "mixed"])
def test_resize_matches_jax_bicubic(size, out):
    x = np.random.default_rng(size[0] + out[1]).uniform(
        -0.3, 1.3, (2, *size, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *out, 3),
                                      method="bicubic"))
    got = resize_cubic_jax(torch.from_numpy(x), *out)
    assert got.dtype == torch.float32
    assert_close_to_max(got.numpy(), ref, 1e-6, f"resize {size} → {out}")


def _cfg(mod, tmp_path):
    # S = 32 samples: unjittered, a ray from one face of the box to the
    # opposite one samples at odd multiples of 1/32 there, never on a wall
    # of the 32³ grid (S = 16 would put them all on walls, where rays that
    # agree to 1e-7 change cells: ROADMAP.md §C, "occupancy at cell walls")
    return mod.TrainConfig(
        log=mod.LogConfig(exp_root=tmp_path),
        render=mod.RenderConfig(train_grid_size=16, num_samples_per_ray=32,
                                mlp_dtype="float32"),
        guide=mod.GuideConfig(text="a sand castle", tiny_diffusion=True,
                              unet_dtype="float32"))


@pytest.fixture(scope="module")
def apps(tiny_sd_guidance, tmp_path_factory):
    """Both apps on the same field, occupancy grid (about half its cells
    empty) and VAE, rendering at the 64² latent grid."""
    tmp = tmp_path_factory.mktemp("nerf_eval")
    japp = JApp.create(_cfg(jconfig, tmp), guidance=tiny_sd_guidance)
    params = jax.jit(japp.init_params)(jax.random.key(3))
    G = japp.scene.occ_cfg.resolution
    grid = np.random.default_rng(0).uniform(size=(G ** 3,)) * 0.02
    params["occ_grid"] = jnp.asarray(grid, jnp.float32)
    guidance = port_guidance(tiny_sd_guidance)
    load_flax_params(guidance.vae, np_tree(tiny_sd_guidance.vae_params),
                     "vae")
    tapp = TApp.create(_cfg(tconfig, tmp), guidance=guidance, device=CPU)
    load_flax_params(tapp.scene, np_tree(params), "scene")
    japp.scene.latent_size = tapp.scene.latent_size = 64
    return japp, params, tapp


def _orbit(n):
    jv = jviews.circle_poses(n, jviews.ViewSamplerConfig())
    tv = tviews.ViewBatch(*(torch.from_numpy(np.array(a)) for a in
                            (jv.theta, jv.phi, jv.radius, jv.dirs,
                             jv.is_body)))
    return jv, tv


@pytest.mark.parametrize("dims", [256, 128, 320],
                         ids=["no-resize", "down", "up"])
def test_eval_render_matches_jax(apps, dims):
    japp, params, tapp = apps
    jv, tv = _orbit(2)
    ref = jax.jit(lambda p, v: japp.eval_render(p, v, (dims, dims)))(
        params, jv)
    out = tapp.eval_render(tv, (dims, dims))
    assert out["image"].shape == (2, dims, dims, 3)
    assert out["texture_map"] is None
    assert_close_to_max(out["image"].numpy(), np.asarray(ref["image"]), 1e-4,
                        f"eval frames at {dims}²")
    assert_close_to_max(out["mask"].numpy(), np.asarray(ref["mask"]), 1e-4,
                        "eval mask")
    if dims != 256:
        assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0


def test_rgb_field_eval_render_matches_jax(tmp_path):
    js = JScene.create(nerf_type="rgb", tiny=True, num_samples=32,
                       mlp_dtype="float32")
    params = jax.jit(js.init_params)(jax.random.key(5))
    ts = TScene.create(nerf_type="rgb", tiny=True, num_samples=32,
                       mlp_dtype="float32", device=CPU)
    load_flax_params(ts, np_tree(params), "scene")
    jv, tv = _orbit(2)
    ref = jax.jit(lambda p, v: js.render_test(p, v, None, (24, 24)))(
        params, jv)
    out = ts.render_test(tv, None, (24, 24))
    assert_close_to_max(out["image"].numpy(), np.asarray(ref["image"]), 1e-4,
                        "RGB eval frames")


@pytest.mark.parametrize("nerf_type", ["latent", "rgb"])
@pytest.mark.parametrize("dims", [(64, 64), (512, 512), (1024, 1024)])
def test_max_eval_batch_matches_jax(nerf_type, dims):
    jscene = JScene.create(nerf_type=nerf_type, tiny=True)
    tscene = TScene.create(nerf_type=nerf_type, tiny=True, device=CPU)
    want = JApp.max_eval_batch(types.SimpleNamespace(scene=jscene), dims)
    got = TApp.max_eval_batch(types.SimpleNamespace(scene=tscene), dims)
    assert got == want
