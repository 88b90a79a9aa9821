"""The port's guidance stack (tpunerf_torch.guidance) against the JAX
package's on the same weights and inputs: noise schedule, CLIP text tower,
tiny UNet ε, SDS gradient, and the attention kernel's plain version (the
kernel itself is held against it on the card, test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_close_to_max, port_guidance
from tpunerf.guidance import sds as jsds
from tpunerf.guidance.schedulers import NoiseSchedule as JNoiseSchedule
from tpunerf_torch.guidance import sds as tsds
from tpunerf_torch.guidance.schedulers import NoiseSchedule
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import attention as at


@pytest.fixture(scope="module")
def pair(tiny_sd_guidance):
    return tiny_sd_guidance, port_guidance(tiny_sd_guidance)


@pytest.fixture(scope="module")
def jax_unet(tiny_sd_guidance):
    return jax.jit(tiny_sd_guidance.unet_apply)


def test_noise_schedule_tables():
    j = JNoiseSchedule.scaled_linear()
    t = NoiseSchedule.scaled_linear(device="cpu")
    # linspace and cumprod in f32 in both frameworks: rounding differs in
    # the last bits only
    np.testing.assert_allclose(t.alphas_cumprod.numpy(),
                               np.asarray(j.alphas_cumprod), rtol=1e-5)
    ts = np.array([20, 500, 980])
    np.testing.assert_allclose(
        t.sds_weight(torch.from_numpy(ts)).numpy(),
        np.asarray(j.sds_weight(jnp.asarray(ts))), rtol=1e-5)


def test_clip_text_matches_jax(pair):
    jg, tg = pair
    ids = jg.tokenizer(["a highly detailed sandcastle, front view", ""])
    ref = np.asarray(jg.encode_text_ids(jnp.asarray(ids)))
    out = tg.encode_text_ids(ids).numpy()
    # as tests/test_torch_parity.py holds the CLIP tower: 2e-5 absolute
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_tokenizers_are_the_same_host_code(pair):
    jg, tg = pair
    prompts = ["a lego man, side view", "A Sand-castle!", ""]
    np.testing.assert_array_equal(tg.tokenizer(prompts),
                                  jg.tokenizer(prompts))


def test_text_embeds_cfg_pair(pair):
    jg, tg = pair
    ref = np.asarray(jg.get_text_embeds(["a castle"], "ugly"))
    out = tg.get_text_embeds(["a castle"], "ugly").numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("t", [20, 500, 980])
def test_tiny_unet_eps_matches_jax(pair, jax_unet, t):
    jg, tg = pair
    rng = np.random.default_rng(t)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ref = np.asarray(jax_unet(jnp.asarray(lat), jnp.asarray(t),
                              jnp.asarray(ctx)))
    with torch.no_grad():
        out = tg.unet_apply(torch.from_numpy(lat), torch.tensor(t),
                            torch.from_numpy(ctx)).numpy()
    # f32 both sides; convolution and norm sums in another order
    assert_close_to_max(out, ref, 1e-4, "tiny UNet eps")


def test_sds_gradient_with_injected_draws(pair):
    jg, tg = pair
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    emb = np.array(jg.get_text_embeds(["a castle"]))
    key = jax.random.key(7)
    ref, t_ref = jax.jit(lambda k, x, e: jsds.score_gradient(
        jg.unet_apply, jg.sched, k, x, e, 100.0, jg.min_step,
        jg.max_step))(key, jnp.asarray(lat), jnp.asarray(emb))
    # replay the JAX key splits (sds.py:57-60) and inject the draws
    k_t, k_n = jax.random.split(key)
    t = int(jsds.sample_timestep(k_t, jg.min_step, jg.max_step))
    noise = np.array(jax.random.normal(k_n, lat.shape))
    assert t == int(t_ref)
    out, t_out = tsds.score_gradient(
        tg.unet_apply, tg.sched, torch.from_numpy(lat),
        torch.from_numpy(emb), 100.0, tg.min_step, tg.max_step,
        t=torch.tensor(t), noise=torch.from_numpy(noise))
    assert int(t_out) == t
    assert_close_to_max(out.numpy(), np.asarray(ref), 1e-4, "SDS gradient")

    # the loss is Σ latents·grad, and its gradient is exactly grad
    x = torch.from_numpy(lat).requires_grad_(True)
    loss = tg.train_step_loss(torch.from_numpy(emb), x, 100.0,
                              t=torch.tensor(t),
                              noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), out.numpy(), rtol=0, atol=0)


def test_attention_plain_matches_jax_formula():
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 4, 64, 40)).astype(np.float32)
               for _ in range(3))
    scale = 40 ** -0.5
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    ref = np.asarray(jnp.einsum("bhqk,bhkd->bhqd",
                                jax.nn.softmax(logits, axis=-1), v))
    out = at.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             scale).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unet_routes_long_self_attention_to_the_kernel_wrapper(monkeypatch):
    """Self-attention with N ≥ 2048 and N % 1024 == 0 goes through
    `attention` (the kernel on CUDA); shorter or cross-attention stays
    plain, as the JAX package gates its flash kernel (unet.py:199-201)."""
    from tpunerf_torch.guidance import unet as tunet
    calls = []
    monkeypatch.setattr(tunet, "attention",
                        lambda *a: calls.append(a[0].shape) or
                        at.attention_plain(*a))
    self_attn = tunet.Attention(16, 16, 2)
    cross_attn = tunet.Attention(16, 8, 2)
    for n in (2048, 1024, 3072, 2560):
        self_attn(torch.zeros(1, n, 16))
    cross_attn(torch.zeros(1, 2048, 16), torch.zeros(1, 5, 8))
    assert calls == [(1, 2, 2048, 8), (1, 2, 3072, 8)]


def test_attention_wrapper_takes_plain_path_on_cpu():
    _build.reset_launches()
    q = torch.randn(1, 2, 2048, 40)
    out = at.attention(q, q, q, 0.1)
    torch.testing.assert_close(out, at.attention_plain(q, q, q, 0.1))
    assert _build.LAUNCHES.get(at.ATTN, 0) == 0


def test_attention_kernel_refuses_bf16_it_cannot_copy():
    """The bf16 kernel copies 16-byte chunks: it refuses a head dim that is
    not a multiple of 8 and a misaligned input, before it asks for a card."""
    q = torch.randn(1, 2, 2048, 12).bfloat16()
    with pytest.raises(ValueError, match="multiple of 8"):
        at.attention_cuda(q, q, q, 0.1)
    off = torch.zeros(2 * 2048 * 40 + 1, dtype=torch.bfloat16)[1:].view(
        1, 2, 2048, 40)
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.attention_cuda(off, off, off, 0.1)
    with pytest.raises(ValueError, match="scale > 0"):
        at.attention_cuda(q[..., :8], q[..., :8], q[..., :8], -0.1)

