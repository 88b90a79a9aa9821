"""The SD-v1 backend's sampling, inversion, DDS and concept paths of the port
(guidance/stable_diffusion.py, schedulers.py, sds.py) against the JAX
package's on the tiny stack with the same weights: the DDIM inverse step,
`produce_latents` with `start`, `invert`, `null_optimization` (2 steps of 2
inner steps), `prompt_to_img`, `dds_loss`, textual-inversion concepts from
a `learned_embeds.bin` the test writes, and a latent-NeRF app built with
`guide.concept_name`. JAX's draws are passed in to the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, port_guidance)
from tpunerf.guidance import schedulers as jsched
from tpunerf.guidance import sds as jsds
from tpunerf.guidance.clip_text import make_tokenizer as jmake_tokenizer
from tpunerf.training import config as jconfig
from tpunerf.training.latent_nerf_app import LatentNeRFApp as JApp
from tpunerf_torch.guidance import schedulers as tsched
from tpunerf_torch.guidance.stable_diffusion import StableDiffusionGuidance
from tpunerf_torch.training import config as tconfig
from tpunerf_torch.training.latent_nerf_app import LatentNeRFApp as TApp
from tpunerf_torch.weights import load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# f32 both sides, the tiny UNet's sums in another order (as
# test_torch_guidance.py holds its ε: 1e-4 of the largest)
REL = 1e-4
STEPS = 4


@pytest.fixture(scope="module")
def pair(tiny_sd_guidance):
    jg = tiny_sd_guidance
    tg = port_guidance(jg)
    load_flax_params(tg.vae, np_tree(jg.vae_params), "vae")
    emb = np.array(jg.get_text_embeds(["a castle"]))
    return jg, tg, emb


def _latents(seed, shape=(1, 16, 16, 4)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("t", [1, 481, 961, 999])
def test_ddim_inverse_step_matches_jax(t):
    js = jsched.NoiseSchedule.scaled_linear()
    ts = tsched.NoiseSchedule.scaled_linear(device="cpu")
    x, eps = _latents(t), _latents(t + 1)
    ref = jsched.ddim_inverse_step(js, jnp.asarray(eps), jnp.asarray(t),
                                   jnp.asarray(x), 50)
    got = tsched.ddim_inverse_step(ts, torch.from_numpy(eps),
                                   torch.tensor(t), torch.from_numpy(x), 50)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("start", [0, 2])
def test_produce_latents_with_start_matches_jax(pair, start):
    jg, tg, emb = pair
    lat = _latents(3)
    ref = jg.produce_latents(jax.random.key(0), jnp.asarray(emb), STEPS,
                             7.5, latents=jnp.asarray(lat), start=start)
    with torch.no_grad():
        got = tg.produce_latents(torch.from_numpy(emb), STEPS, 7.5,
                                 latents=torch.from_numpy(lat), start=start)
    assert_close_to_max(got.numpy(), np.asarray(ref), REL, "latents")


def test_invert_matches_jax(pair):
    jg, tg, emb = pair
    lat = _latents(4)
    ref = jg.invert(jnp.asarray(lat), jnp.asarray(emb), STEPS)
    with torch.no_grad():
        got = tg.invert(torch.from_numpy(lat), torch.from_numpy(emb), STEPS)
    assert got.shape == (STEPS, 1, 16, 16, 4)
    assert_close_to_max(got.numpy(), np.asarray(ref), REL, "trajectory")


def test_null_optimization_matches_jax(pair):
    """2 DDIM steps of 2 inner Adam steps (lr 1e-2) from JAX's inversion
    trajectory: the fitted uncond embeddings' change from the start within
    1e-3 of its largest entry (Adam's steps from gradients that agree to
    ~1e-4)."""
    jg, tg, emb = pair
    traj = np.array(jg.invert(jnp.asarray(_latents(5)), jnp.asarray(emb), 2))
    ref = np.asarray(jg.null_optimization(jnp.asarray(traj),
                                          jnp.asarray(emb), 2, 2))
    got = tg.null_optimization(torch.from_numpy(traj), torch.from_numpy(emb),
                               2, 2)
    assert got.shape == ref.shape == (2, 1, 16, 32)
    u0 = emb[:1][None]
    assert np.abs(ref - u0).max() > 1e-3
    assert_close_to_max(got.numpy() - u0, ref - u0, 1e-3, "uncond change")


def test_prompt_to_img_matches_jax(pair):
    jg, tg, _ = pair
    key = jax.random.key(2)
    ref = jg.prompt_to_img(key, ["a castle"], 3)
    draw = np.array(jax.random.normal(key, (1, 16, 16, 4)))
    got = tg.prompt_to_img(["a castle"], 3, latents=torch.from_numpy(draw))
    assert got.dtype == np.uint8 and got.shape == ref.shape == (1, 64, 64, 3)
    # a value on a rounding boundary may round the other way
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_dds_loss_matches_jax_with_its_draws(pair):
    jg, tg, emb = pair
    ref_emb = np.array(jg.get_text_embeds(["a tower"]))
    lat, ref_lat = _latents(6), _latents(7)
    key = jax.random.key(9)

    def jloss(x):
        return jsds.dds_loss(jg.unet_apply, jg.sched, key, x,
                             jnp.asarray(ref_lat), jnp.asarray(emb),
                             jnp.asarray(ref_emb), 7.5, jg.min_step,
                             jg.max_step)

    want_loss, want_grad = jax.jit(jax.value_and_grad(jloss))(
        jnp.asarray(lat))
    # replay JAX's key splits (sds.py:90-94) and inject the draws
    k_t, k_n = jax.random.split(key)
    t = int(jsds.sample_timestep(k_t, jg.min_step, jg.max_step))
    noise = np.array(jax.random.normal(k_n, lat.shape))
    x = torch.from_numpy(lat).requires_grad_(True)
    loss = tg.train_step_delta_loss(
        torch.from_numpy(emb), x, torch.from_numpy(ref_lat),
        torch.from_numpy(ref_emb), 7.5, t=torch.tensor(t),
        noise=torch.from_numpy(noise))
    loss.backward()
    assert_close_to_max(x.grad.numpy(), np.asarray(want_grad), REL,
                        "DDS gradient")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-3)


def _concept(tmp_path, token="cattoy", seed=0):
    """An sd-concepts-library directory: `learned_embeds.bin` ({trained
    token: (D,)}, written by torch.save) and `token_identifier.txt`."""
    d = tmp_path / "concept"
    d.mkdir()
    row = torch.from_numpy(np.random.default_rng(seed).standard_normal(32)
                           .astype(np.float32))
    torch.save({"<cat-toy>": row}, d / "learned_embeds.bin")
    (d / "token_identifier.txt").write_text(token + "\n")
    return d, row.numpy()


def _fresh_jax(jg):
    """The session's JAX stack with a tokenizer of its own, so that a
    concept loaded into it leaves the shared fixture as it was
    (`load_concept` copies the text params itself)."""
    cfg = jg.text_encoder.config
    return dataclasses.replace(jg, tokenizer=jmake_tokenizer(
        None, vocab_size=cfg.vocab_size, max_length=cfg.max_length))


def test_load_concept_dir_matches_jax(pair, tmp_path):
    jg, tg, _ = pair
    d, row = _concept(tmp_path)
    jc = _fresh_jax(jg)
    tc = port_guidance(jg)
    assert jc.load_concept_dir(d) == tc.load_concept_dir(d) == "cattoy"
    prompts = ["a cattoy on a castle", "a castle"]
    ids = tc.tokenizer(prompts)
    np.testing.assert_array_equal(ids, jc.tokenizer(prompts))
    assert ids[0, 2] == 1000 == tc.text_encoder.config.vocab_size - 1
    table = tc.text_encoder.embeddings.token_embedding.weight
    assert table.shape == (1001, 32) and not table.requires_grad
    np.testing.assert_array_equal(table[-1].numpy(), row)
    np.testing.assert_allclose(tc.get_text_embeds(prompts).numpy(),
                               np.asarray(jc.get_text_embeds(prompts)),
                               atol=2e-5)
    with pytest.raises(ValueError, match="already"):
        tc.load_concept("cattoy", row)
    assert tc.maybe_load_concept(None) is None
    with pytest.raises(ValueError, match="not a directory"):
        tc.maybe_load_concept(str(tmp_path / "missing"))


def test_app_with_concept_name_matches_jax(pair, tmp_path, monkeypatch):
    """`guide.concept_name` with the stack the app builds itself: its
    directional text embeddings hold the concept's row, as JAX's app's."""
    jg, _, _ = pair
    d, _ = _concept(tmp_path)

    def cfg(mod):
        return mod.TrainConfig(
            log=mod.LogConfig(exp_root=tmp_path, eval_size=0,
                              full_eval_size=0, save_mesh=False,
                              log_images=False),
            render=mod.RenderConfig(train_grid_size=16,
                                    num_samples_per_ray=32,
                                    mlp_dtype="float32"),
            guide=mod.GuideConfig(text="a cattoy castle", tiny_diffusion=True,
                                  unet_dtype="float32", concept_name=str(d)))

    jc = _fresh_jax(jg)
    jc.load_concept_dir(d)
    japp = JApp.create(cfg(jconfig), guidance=jc)
    tg = port_guidance(jg)
    monkeypatch.setattr(StableDiffusionGuidance, "create",
                        classmethod(lambda cls, **kw: tg))
    tapp = TApp.create(cfg(tconfig), device="cpu")
    assert tapp.guidance is tg
    assert tg.tokenizer(["cattoy"])[0, 1] == 1000
    np.testing.assert_allclose(tapp.text_z.numpy(), np.asarray(japp.text_z),
                               atol=2e-5)
