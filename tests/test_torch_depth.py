"""The port's depth-conditioned SD guidance against the JAX package's, on
the tiny stack of tests/conftest.py (`tiny_depth_guidance`: 5-channel UNet,
9-channel inpainting UNet, tiny text tower and VAE, f32), its weights
carried over once per module: the schedule additions (`sds_weight` in both
forms, `pred_x0_from_eps`, five PNDM steps, `strength_timesteps`),
`normalize_depth` with and without a mask, both CFG passes, the SDS loss
and its gradient, single-step and masked iterative img2img (with the
inpaint window), txt2img and the masked encode, each with JAX's draws; and
the weights bridge at full width (keys and shapes of the 5- and 9-channel
UNets with a 1024-wide context and of the 1024-wide, 23-layer text tower,
from shapes alone)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, one_torch_thread,  # noqa: F401
                         port_depth_guidance)
from tpunerf.guidance import depth as jdepth
from tpunerf.guidance import schedulers as jsched
from tpunerf.guidance import sds as jsds
from tpunerf.guidance.clip_text import CLIPTextConfig as JTextConfig
from tpunerf.guidance.clip_text import CLIPTextModel as JText
from tpunerf.guidance.unet import UNet2DCondition as JUNet
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf_torch.guidance import depth as tdepth
from tpunerf_torch.guidance import schedulers as tsched
from tpunerf_torch.guidance.clip_text import CLIPTextModel
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.kernels import texture as texk
from tpunerf_torch.weights import flax_entries

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = torch.device("cpu")
# ε̂ of the tiny f32 UNets, port against JAX: convolutions and attention
# in another order, ×7.5 by CFG
EPS_REL = 1e-4
# a walk of 3 to 8 DDIM steps, each step's ε̂ error carried on
WALK_REL = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def stacks(tiny_depth_guidance):
    return tiny_depth_guidance, port_depth_guidance(tiny_depth_guidance)


def _inputs(seed=0, size=16):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    depth = rng.uniform(-1, 1, size=(1, size, size, 1)).astype(np.float32)
    return lat, depth


def test_schedule_additions_match_jax():
    js = jsched.NoiseSchedule.scaled_linear()
    ts = tsched.NoiseSchedule.scaled_linear(device=CPU)
    t = np.array([0, 1, 20, 500, 980, 999])
    for form in ("sqrt", "sigma2"):
        np.testing.assert_allclose(
            ts.sds_weight(_t(t), form=form).numpy(),
            np.asarray(js.sds_weight(jnp.asarray(t), form=form)), rtol=1e-6,
            err_msg=form)
    with pytest.raises(ValueError):
        ts.sds_weight(_t(t), form="linear")
    rng = np.random.default_rng(1)
    x, eps = rng.normal(size=(2, 2, 8, 8, 4)).astype(np.float32)
    for tt in (1, 500, 981):
        np.testing.assert_allclose(
            ts.pred_x0_from_eps(_t(x), _t(eps), torch.tensor(tt)).numpy(),
            np.asarray(js.pred_x0_from_eps(x, eps, jnp.asarray(tt))),
            rtol=1e-5, atol=1e-5)
    # five PLMS steps: counters 0, 1, 2 and 3+ take the four combinations
    steps = 5
    grid = jsched.ddim_timesteps(steps)
    np.testing.assert_array_equal(
        tsched.ddim_timesteps(steps, device=CPU).numpy(), np.asarray(grid))
    js_state = jsched.pndm_init(x.shape)
    ts_state = tsched.pndm_init(x.shape, device=CPU)
    xj, xt = jnp.asarray(x), _t(x)
    for i in range(steps):
        e = rng.normal(size=x.shape).astype(np.float32)
        xj, js_state = jsched.pndm_step(js, js_state, jnp.asarray(e),
                                        grid[i], xj, steps)
        xt, ts_state = tsched.pndm_step(ts, ts_state, _t(e),
                                        torch.tensor(int(grid[i])), xt, steps)
        assert int(ts_state.counter) == int(js_state.counter) == i + 1
        np.testing.assert_allclose(ts_state.ets.numpy(),
                                   np.asarray(js_state.ets), rtol=0, atol=0)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {i}")
    for n, s in ((50, 0.8), (8, 1.0), (10, 0.35), (4, 0.0)):
        got, start = tsched.strength_timesteps(n, s, device=CPU)
        ref, ref_start = jsched.strength_timesteps(n, s)
        assert start == ref_start
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_normalize_depth_matches_jax_with_an_empty_view():
    rng = np.random.default_rng(2)
    depth = rng.uniform(2.0, 5.0, size=(3, 8, 8, 1)).astype(np.float32)
    mask = (rng.uniform(size=depth.shape) > 0.4).astype(np.float32)
    mask[2] = 0.0                          # a view the mesh misses
    ref = np.asarray(jdepth.normalize_depth(jnp.asarray(depth)))
    got = tdepth.normalize_depth(_t(depth)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got.min() == -1.0 and got.max() == pytest.approx(1.0, abs=1e-6)
    ref = np.asarray(jdepth.normalize_depth(jnp.asarray(depth),
                                            jnp.asarray(mask)))
    got = tdepth.normalize_depth(_t(depth), _t(mask)).numpy()
    # the empty view: lo = +inf, hi = −inf, every pixel −inf on both sides
    assert np.isneginf(ref[2]).all() and np.isneginf(got[2]).all()
    np.testing.assert_allclose(got[:2], ref[:2], atol=1e-6)
    inside = got[:2][mask[:2] > 0]
    assert inside.min() == -1.0 and inside.max() == pytest.approx(1.0,
                                                                  abs=1e-6)


def test_cfg_passes_and_single_step_match_jax(stacks):
    jg, tg = stacks
    lat, depth = _inputs(3)
    mask = np.zeros((1, 16, 16, 1), np.float32)
    mask[:, :8] = 1.0
    masked = np.random.default_rng(4).normal(size=lat.shape).astype(
        np.float32)
    emb_j = jg.get_text_embeds(["a red car"])
    emb_t = tg.get_text_embeds(["a red car"])
    assert emb_t.shape == (2, 16, 32)
    assert_close_to_max(emb_t.numpy(), np.asarray(emb_j), 2e-5, "text")
    t = 500
    # (jitted: JAX's eager UNet compiles each of its operations)
    ref = jax.jit(lambda *a: jg._cfg_eps_depth(*a, 7.5))(
        lat, depth, jnp.asarray(t), emb_j)
    got = tg._cfg_eps_depth(_t(lat), _t(depth), torch.tensor(t), emb_t, 7.5)
    assert_close_to_max(got.numpy(), np.asarray(ref), EPS_REL, "depth CFG")
    ref = jax.jit(lambda *a: jg._cfg_eps_inpaint(*a, 7.5))(
        lat, mask, masked, jnp.asarray(t), emb_j)
    got = tg._cfg_eps_inpaint(_t(lat), _t(mask), _t(masked),
                              torch.tensor(t), emb_t, 7.5)
    assert_close_to_max(got.numpy(), np.asarray(ref), EPS_REL,
                        "inpaint CFG")
    key = jax.random.key(5)
    prev_j, x0_j = jax.jit(lambda k: jg.img2img_single_step(
        k, emb_j, lat, depth, step=3, num_inference_steps=10))(key)
    prev_t, x0_t = tg.img2img_single_step(
        emb_t, _t(lat), _t(depth), step=3, num_inference_steps=10,
        noise=_t(jax.random.normal(key, lat.shape)))
    assert_close_to_max(prev_t.numpy(), np.asarray(prev_j), EPS_REL, "prev")
    assert_close_to_max(x0_t.numpy(), np.asarray(x0_j), EPS_REL, "x0")


def test_train_step_loss_and_gradient_match_jax(stacks):
    jg, tg = stacks
    lat, _ = _inputs(6)
    # a 64² depth, shrunk (antialiased) to the 16² latent grid
    depth = np.random.default_rng(7).uniform(
        -1, 1, size=(1, 64, 64, 1)).astype(np.float32)
    emb_j = jg.get_text_embeds(["a nascar"])
    emb_t = tg.get_text_embeds(["a nascar"])
    key = jax.random.key(8)
    loss_j, grad_j = jax.jit(jax.value_and_grad(
        lambda x: jg.train_step_loss(key, emb_j, x, jnp.asarray(depth))))(
        jnp.asarray(lat))
    k_t, k_n = jax.random.split(key)
    t = int(jsds.sample_timestep(k_t, jg.min_step, jg.max_step))
    noise = _t(jax.random.normal(k_n, lat.shape))
    x = _t(lat).requires_grad_(True)
    loss_t = tg.train_step_loss(emb_t, x, _t(depth), t=torch.tensor(t),
                                noise=noise)
    loss_t.backward()
    # the gradient w·(ε̂ − ε) carries ε̂'s agreement ×100 (CFG)
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), EPS_REL, "grad")
    scale = float(np.sum(np.abs(lat * np.asarray(grad_j))))
    assert abs(loss_t.item() - float(loss_j)) <= EPS_REL * scale
    # w = 1 − ᾱ_t: the gradient at w = 1 would be larger
    a = float(tg.sched.alphas_cumprod[t])
    np.testing.assert_allclose(
        float(tg.sched.sds_weight(torch.tensor(t), "sigma2")), 1 - a,
        rtol=1e-6)
    # without draws: finite, reproducible from the generator
    g1 = tg.train_step_loss(emb_t, _t(lat), _t(depth),
                            generator=torch.Generator().manual_seed(1))
    g2 = tg.train_step_loss(emb_t, _t(lat), _t(depth),
                            generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(g1) and g1.item() == g2.item()


def test_nan_guard_is_nan_to_num():
    from tpunerf_torch.guidance import sds as tsds
    x = np.array([np.nan, np.inf, -np.inf, 1.5], np.float32)
    np.testing.assert_array_equal(tsds.nan_guard(_t(x)).numpy(),
                                  np.asarray(jsds.nan_guard(jnp.asarray(x))))


@pytest.mark.parametrize("variant", ["plain", "inpaint"])
def test_img2img_step_matches_jax(stacks, variant):
    """Without a mask: strength 0.8 of 5 steps from the noised latents.
    With one, as JAX's test_depth_inpaint_unet_variant: 8 steps at strength
    1.0 from pure noise, the check mask for the first 4, and the inpaint
    window 2 < i < 5 (steps 3 and 4 on the 9-channel UNet)."""
    jg, tg = stacks
    lat, depth = _inputs(9)
    emb_j = jg.get_text_embeds(["x"])
    emb_t = tg.get_text_embeds(["x"])
    key = jax.random.key(10)
    draws = {"noise": _t(jax.random.normal(key, lat.shape))}
    if variant == "plain":
        kw = dict(num_inference_steps=5, strength=0.8)
        tkw = jkw = kw
    else:
        upd = np.zeros((1, 16, 16, 1), np.float32)
        upd[:, :8] = 1.0
        chk = np.zeros_like(upd)
        chk[:, :4] = 1.0
        ml = np.random.default_rng(11).normal(size=lat.shape).astype(
            np.float32)
        kw = dict(num_inference_steps=8, strength=1.0, inpaint_lo=2,
                  inpaint_hi=5)
        jkw = dict(kw, update_mask=jnp.asarray(upd),
                   check_mask=jnp.asarray(chk), masked_latents=jnp.asarray(ml))
        tkw = dict(kw, update_mask=_t(upd), check_mask=_t(chk),
                   masked_latents=_t(ml))
        draws["start"] = _t(jax.random.normal(jax.random.fold_in(key, 1),
                                              lat.shape))
    ref = np.asarray(jax.jit(lambda k, x, d: jg.img2img_step(
        k, emb_j, x, d, **jkw))(key, jnp.asarray(lat), jnp.asarray(depth)))
    got = tg.img2img_step(emb_t, _t(lat), _t(depth), **tkw, **draws)
    assert got.shape == lat.shape and torch.isfinite(got).all()
    assert_close_to_max(got.numpy(), ref, WALK_REL, variant)
    if variant == "inpaint":
        # the masked latents reach the walk only through the window's UNet
        other = tg.img2img_step(emb_t, _t(lat), _t(depth),
                                **dict(tkw, masked_latents=_t(ml) + 1.0),
                                **draws)
        assert (other - got).abs().max() > 1e-6
        closed = tg.img2img_step(
            emb_t, _t(lat), _t(depth),
            **dict(tkw, inpaint_lo=4, inpaint_hi=4), **draws)
        closed2 = tg.img2img_step(
            emb_t, _t(lat), _t(depth),
            **dict(tkw, inpaint_lo=4, inpaint_hi=4,
                   masked_latents=_t(ml) + 1.0), **draws)
        assert torch.equal(closed, closed2)


def test_prompt_to_img_and_masked_encode_match_jax(stacks):
    jg, tg = stacks
    depth = np.random.default_rng(12).uniform(
        -1, 1, size=(1, 64, 64, 1)).astype(np.float32)
    key = jax.random.key(13)
    ref = np.asarray(jax.jit(lambda k, d: jg.prompt_to_img(
        k, ["a castle"], d, num_inference_steps=3))(key, jnp.asarray(depth)))
    got = tg.prompt_to_img(["a castle"], _t(depth), num_inference_steps=3,
                           latents=_t(jax.random.normal(key, (1, 16, 16, 4))))
    assert got.shape == (1, 64, 64, 3)
    # three steps, then the tiny VAE decode
    assert_close_to_max(got.numpy(), ref, WALK_REL, "txt2img")

    img = np.asarray(jax.random.uniform(jax.random.key(14), (1, 64, 64, 3)))
    upd = np.zeros((1, 16, 16, 1), np.float32)
    upd[:, 4:12, 5:11] = 1.0
    key = jax.random.key(15)
    ref = np.asarray(jax.jit(jg.encode_masked_inputs)(
        jnp.asarray(img), jnp.asarray(upd), key))
    got = tg.encode_masked_inputs(_t(img), _t(upd),
                                  noise=_t(jax.random.normal(key,
                                                             (1, 16, 16, 4))))
    assert_close_to_max(got.numpy(), ref, 2e-5, "masked encode")
    # the nearest resize of the mask, JAX's half-pixel rule, both ways
    for src, dst in ((16, 64), (64, 16), (16, 24), (24, 16), (7, 5)):
        m = np.random.default_rng(src * dst).uniform(
            size=(2, src, src + 1, 3)).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(m), (2, dst, dst + 2, 3),
                               "nearest")
        np.testing.assert_array_equal(
            texk.resize_nearest(_t(m), dst, dst + 2).numpy(),
            np.asarray(ref))


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@pytest.mark.parametrize("what", ["unet5", "unet9", "text"])
def test_full_width_trees_map_onto_the_port_key_for_key(what):
    """Every key and shape of the full-width depth stack's trees, from
    `jax.eval_shape` (nothing is allocated), against the port's modules
    built on the meta device."""
    key = jax.random.key(0)
    if what == "text":
        jcfg = JTextConfig(hidden_size=1024, num_heads=16,
                           intermediate_size=4096, num_layers=23)
        tree = jax.eval_shape(JText(jcfg).init, key,
                              jnp.zeros((1, jcfg.max_length), jnp.int32))
        kind, tcfg = "clip_text", tdepth.TEXT_WIDE
        assert (tcfg.hidden_size, tcfg.num_heads, tcfg.intermediate_size,
                tcfg.num_layers) == (1024, 16, 4096, 23)
        with torch.device("meta"):
            module = CLIPTextModel(tcfg)
    else:
        cin = 5 if what == "unet5" else 9
        jcfg = dataclasses.replace(JUNetConfig.sd_v1(in_channels=cin),
                                   cross_attention_dim=1024)
        tree = jax.eval_shape(
            JUNet(jcfg).init, key, jnp.zeros((1, 8, 8, cin)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 1024)))
        kind = "unet"
        with torch.device("meta"):
            module = UNet2DCondition(dataclasses.replace(
                UNetConfig.sd_v1(in_channels=cin), cross_attention_dim=1024))
    got = {k: tuple(v.shape) for k, v in flax_entries(_shapes(tree), kind)}
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == own
    if what != "text":
        assert own["conv_in.weight"] == (320, 5 if what == "unet5" else 9,
                                         3, 3)
        assert own["conv_out.weight"][0] == 4
        assert own["down_blocks.0.attentions.0.transformer_blocks.0.attn2"
                   ".to_k.weight"] == (320, 1024)
