"""The whole tiny latent-NeRF train step of the port against the JAX
package's, on the same weights and draws: loss, every gradient leaf, the
parameters after one Adam step, and an occupancy refresh. The JAX draws are
made by replaying its key splits (latent_nerf_app.py:92,
volume_render.py:144, sds.py:57-60) and injected into the port."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import assert_close_to_max, np_tree, port_guidance
from tpunerf.core import views as jviews
from tpunerf.fields import occupancy as jocc
from tpunerf.guidance import sds as jsds
from tpunerf.training import config as jconfig
from tpunerf.training.latent_nerf_app import LatentNeRFApp as JApp
from tpunerf_torch.core import views as tviews
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp as TApp
from tpunerf_torch.training.trainer import Trainer
from tpunerf_torch.weights import load_flax_params, state_dict_from_flax


def _cfg(mod, tmp_path):
    return mod.TrainConfig(
        log=mod.LogConfig(exp_root=tmp_path, eval_size=0, full_eval_size=0,
                          save_mesh=False, log_images=False,
                          save_interval=1000),
        render=mod.RenderConfig(train_grid_size=16, num_samples_per_ray=32,
                                mlp_dtype="float32"),
        optim=mod.OptimConfig(seed=0, lr=1e-2, iters=17),
        guide=mod.GuideConfig(text="a sand castle", tiny_diffusion=True,
                              unet_dtype="float32"))


@pytest.fixture(scope="module")
def apps(tiny_sd_guidance, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_step")
    japp = JApp.create(_cfg(jconfig, tmp), guidance=tiny_sd_guidance)
    params = jax.jit(japp.init_params)(jax.random.key(1))
    # a blob of occupied cells, so that compaction drops samples
    centers = np.asarray(jocc.cell_centers(japp.scene.occ_cfg))
    grid = np.where(np.linalg.norm(centers, axis=-1) < 0.45, 1.0, 0.0)
    params["occ_grid"] = jnp.asarray(grid, jnp.float32)
    tapp = TApp.create(_cfg(tconfig, tmp),
                       guidance=port_guidance(tiny_sd_guidance),
                       device="cpu")
    load_flax_params(tapp.scene, np_tree(params), "scene")
    return japp, params, tapp


def _jax_step_draws(japp, key, views):
    """The draws JAX's loss_fn makes from `key`, by its own splits."""
    k_render, k_sds = jax.random.split(key)
    P = japp.scene.train_grid_size ** 2
    u = jax.random.uniform(k_render, (views.batch_size, P,
                                      japp.scene.march.num_samples))
    k_t, k_n = jax.random.split(k_sds)
    g = japp.guidance
    t = jsds.sample_timestep(k_t, g.min_step, g.max_step)
    H = japp.scene.train_grid_size
    noise = jax.random.normal(k_n, (views.batch_size, H, H, 4))
    return (torch.from_numpy(np.array(u)), torch.tensor(int(t)),
            torch.from_numpy(np.array(noise)))


def test_text_embeddings_match(apps):
    japp, _, tapp = apps
    np.testing.assert_allclose(tapp.text_z.numpy(), np.asarray(japp.text_z),
                               atol=2e-5)


def test_loss_gradients_and_adam_step_match_jax(apps):
    japp, params, tapp = apps
    key_view, key = jax.random.split(jax.random.key(11))
    jv = jviews.rand_poses(key_view, 1, jviews.ViewSamplerConfig())
    tv = tviews.ViewBatch(*(torch.from_numpy(np.array(a)) for a in
                            (jv.theta, jv.phi, jv.radius, jv.dirs,
                             jv.is_body)))
    tv.dirs = tv.dirs.long()

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(
        japp.loss_fn, has_aux=True))(params, jv, key, jnp.asarray(1))
    u, t, noise = _jax_step_draws(japp, key, jv)

    opt = tapp.make_optimizer()
    opt.zero_grad()
    loss_t, aux_t = tapp.loss_fn(tv, u=u, t=t, noise=noise)
    loss_t.backward()

    # the SDS term carries the UNet's ~1e-4-of-max agreement (x100 CFG)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    assert_close_to_max(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                        1e-5, "rendered latents")
    ref_grads = state_dict_from_flax(np_tree(grads_j["field"]), "field")
    got = {k: p.grad for k, p in tapp.scene.field.named_parameters()}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        assert_close_to_max(g.numpy(), ref_grads[name].numpy(), 1e-4, name)

    # one Adam step (optax adam, b2 = 0.99, eps = 1e-15 on both sides)
    tx = japp.make_optimizer()
    updates, _ = tx.update(grads_j, tx.init(params), params)
    new_j = state_dict_from_flax(
        np_tree(optax.apply_updates(params, updates)["field"]), "field")
    opt.step()
    for name, p in tapp.scene.field.named_parameters():
        g = ref_grads[name].numpy()
        # with eps = 1e-15 the first update is lr·sign(g): compare only
        # where |g| is well clear of zero, since the sign of a near-zero
        # slot may differ between the frameworks
        big = np.abs(g) > 1e-3 * np.abs(g).max()
        assert big.any()
        np.testing.assert_allclose(p.detach().numpy()[big],
                                   new_j[name].numpy()[big], atol=1e-6,
                                   err_msg=name)


def test_occupancy_refresh_matches_jax(apps):
    japp, params, tapp = apps
    fresh = TApp.create(tapp.cfg, guidance=tapp.guidance, device="cpu")
    load_flax_params(fresh.scene, np_tree(params), "scene")
    key = jax.random.key(12)
    ref = np.asarray(japp.scene.update_occupancy(params, key)["occ_grid"])
    G = fresh.scene.occ_cfg.resolution
    u = torch.from_numpy(np.array(jax.random.uniform(key, (G ** 3, 3))))
    fresh.scene.update_occupancy(u=u)
    assert_close_to_max(fresh.scene.occ_grid.numpy(), ref, 1e-5, "occ grid")
    from tpunerf_torch.fields.occupancy import packed_bitfield
    assert torch.equal(fresh.scene.occ_packed,
                       packed_bitfield(fresh.scene.occ_grid,
                                       fresh.scene.occ_cfg))


def test_port_trainer_refreshes_at_steps_1_and_16(apps, tmp_path):
    _, _, tapp = apps
    cfg = _cfg(tconfig, tmp_path)
    app = TApp.create(cfg, guidance=tapp.guidance, device="cpu")
    refreshed, losses = [], []
    update = app.scene.update_occupancy

    def spy(**kw):
        refreshed.append(trainer.train_step_idx)
        return update(**kw)

    app.scene.update_occupancy = spy
    trainer = Trainer(cfg, app, device="cpu")
    table = app.scene.field.hash_table.detach().clone()
    trainer.train(on_step=lambda step, loss: losses.append(float(loss)))
    assert refreshed == [1, 16]
    assert len(losses) == 17 and np.isfinite(losses).all()
    assert not torch.equal(table, app.scene.field.hash_table.detach())
    assert (tmp_path / "default" / "config.yaml").exists()


# --------------------------------------------------------------------------
# the sketch-guided step (eval config #3's loss): lambda_shape 1 on the
# procedural sphere


def _shape_cfg(mod, tmp_path):
    cfg = _cfg(mod, tmp_path)
    cfg.optim.lambda_shape = 1.0
    cfg.guide.shape_path = "sphere"
    cfg.guide.proximal_surface = 0.3
    return cfg


@pytest.fixture(scope="module")
def shape_apps(apps, tmp_path_factory):
    """Both apps with the sphere's 48³ SDF, the stage-1 parameters and
    occupancy grid of `apps`."""
    japp, params, tapp = apps
    tmp = tmp_path_factory.mktemp("shape_step")
    jshape = JApp.create(_shape_cfg(jconfig, tmp), guidance=japp.guidance)
    tshape = TApp.create(_shape_cfg(tconfig, tmp), guidance=tapp.guidance,
                         device="cpu")
    load_flax_params(tshape.scene, np_tree(params), "scene")
    return jshape, params, tshape


def test_sketch_guided_scene_builds_the_jax_grid(shape_apps):
    japp, _, tapp = shape_apps
    assert tapp.scene.sdf.resolution == japp.scene.sdf.resolution == 48
    # the sphere normalised by each package (f32 means and norms), then
    # the same C++ source
    np.testing.assert_allclose(tapp.scene.sdf.values.numpy(),
                               np.asarray(japp.scene.sdf.values), rtol=0,
                               atol=1e-6)
    assert tapp.scene.proximal_surface == japp.scene.proximal_surface == 0.3


def test_sketch_guided_step_matches_jax(shape_apps):
    japp, params, tapp = shape_apps
    key_view, key = jax.random.split(jax.random.key(13))
    jv = jviews.rand_poses(key_view, 1, jviews.ViewSamplerConfig())
    tv = tviews.ViewBatch(*(torch.from_numpy(np.array(a)) for a in
                            (jv.theta, jv.phi, jv.radius, jv.dirs,
                             jv.is_body)))
    tv.dirs = tv.dirs.long()
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        japp.loss_fn, has_aux=True))(params, jv, key, jnp.asarray(1))
    u, t, noise = _jax_step_draws(japp, key, jv)
    # the shape term alone, on the same render
    ref_shape = japp.scene.render_train(params, jv, jax.random.split(key)[0],
                                        jnp.asarray(1))["shape_loss"]

    tapp.scene.field.zero_grad(set_to_none=True)
    loss_t, aux_t = tapp.loss_fn(tv, u=u, t=t, noise=noise)
    loss_t.backward()
    assert float(ref_shape) > 0
    np.testing.assert_allclose(aux_t["shape_loss"].item(), float(ref_shape),
                               rtol=1e-5)
    # the tolerances of test_loss_gradients_and_adam_step_match_jax
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    ref_grads = state_dict_from_flax(np_tree(grads_j["field"]), "field")
    got = {k: p.grad for k, p in tapp.scene.field.named_parameters()}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        assert_close_to_max(g.numpy(), ref_grads[name].numpy(), 1e-4, name)


def test_the_shape_term_reaches_the_hash_table(shape_apps):
    """The same step at lambda_shape 1 and 0 (the same draws) gives other
    hash-table gradients: the shape loss is in the backward pass."""
    _, _, tapp = shape_apps
    views = tviews.rand_poses(1, tviews.ViewSamplerConfig(), torch.device(
        "cpu"), generator=torch.Generator().manual_seed(0))
    u = torch.rand((1, 256, 32), generator=torch.Generator().manual_seed(1))
    grads = []
    for lam in (1.0, 0.0):
        tapp.cfg.optim.lambda_shape = lam
        tapp.scene.field.zero_grad(set_to_none=True)
        loss, _ = tapp.loss_fn(views, u=u, t=torch.tensor(500),
                               noise=torch.zeros((1, 16, 16, 4)))
        loss.backward()
        grads.append(tapp.scene.field.hash_table.grad.clone())
    tapp.cfg.optim.lambda_shape = 1.0
    assert not torch.equal(grads[0], grads[1])
