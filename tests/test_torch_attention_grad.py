"""The attention backward of the port (kernels/attention.py) against the JAX
package's: `attention_bwd_plain`, the plain version the card holds kernels
#12 and #13 to, against JAX's `mha_reference_bwd` (the backward of its
flash attention, the scale folded into q as `_flash_sdpa` folds it) and
against autograd of `attention_plain`; the log-sum-exp residual; and the
tiny UNet's gradient with respect to its context against `jax.grad`
through the JAX package's UNet, with the long self-attention routed through
the `attention` wrapper (the kernels' own checks are card tests,
test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from _torch_port import assert_close_to_max, port_guidance
from tpunerf_torch.kernels import _build
from tpunerf_torch.kernels import attention as at

# f32 on both sides: the products and sums in another order
TOL = 1e-5
SHAPES = [(2, 3, 256, 40), (1, 2, 130, 64), (1, 1, 64, 128), (1, 2, 77, 8)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax_reference(q, k, v, do, scale):
    """(out, lse, dq, dk, dv) of JAX's reference attention and its flash
    backward's reference, q scaled before the call as `_flash_sdpa` does;
    dq is taken back through the scale."""
    qs = jnp.asarray(q) * scale
    out, l, m = jfa.mha_reference_no_custom_vjp(
        qs, jnp.asarray(k), jnp.asarray(v), save_residuals=True)
    dq, dk, dv, _ = jfa.mha_reference_bwd(
        qs, jnp.asarray(k), jnp.asarray(v), None, None, out, l, m,
        jnp.asarray(do))
    return (np.asarray(out), np.asarray(m + jnp.log(l)),
            np.asarray(dq) * scale, np.asarray(dk), np.asarray(dv))


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bwd_plain_matches_jax_mha_reference_bwd(shape):
    q, k, v, do = _inputs(shape, sum(shape))
    scale = shape[-1] ** -0.5
    _, _, *want = _jax_reference(q, k, v, do, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = at.attention_plain(tq, tk, tv, scale)
    lse = at.attention_lse_plain(tq, tk, scale)
    got = at.attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close_to_max(g.numpy(), w, TOL, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_bwd_plain_equals_autograd_of_attention_plain(shape):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, 7))
    scale = shape[-1] ** -0.5
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = at.attention_plain(*qkv, scale)
    want = torch.autograd.grad(out, qkv, do)
    got = at.attention_bwd_plain(q, k, v, out.detach(),
                                 at.attention_lse_plain(q, k, scale), do,
                                 scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close_to_max(g.numpy(), w.numpy(), TOL, name)


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_is_the_log_sum_exp_of_jax_reference(shape):
    """The residual the forward kernel keeps: logsumexp of the scaled f32
    logits, equal to JAX's m + log l and to torch's logsumexp."""
    q, k, v, do = _inputs(shape, 3)
    scale = shape[-1] ** -0.5
    _, want, *_ = _jax_reference(q, k, v, do, scale)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    got = at.attention_lse_plain(tq, tk, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    logits = torch.einsum("bhqd,bhkd->bhqk", tq.double(), tk.double())
    np.testing.assert_allclose(
        got.numpy(), torch.logsumexp(logits * scale, -1).numpy(),
        rtol=1e-6, atol=1e-6)


def test_bf16_plain_backward_rounds_p_and_ds_and_stays_near_f32():
    """In bf16 the plain backward rounds P and dS before the products, as
    JAX's flash kernels do; its gradients stay within 2e-2 of the largest
    f32 gradient on the same (bf16-representable) inputs."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs((1, 2, 256, 40), 5))
    scale = 40 ** -0.5
    o = at.attention_plain(q, k, v, scale)
    lse = at.attention_lse_plain(q, k, scale)
    got = at.attention_bwd_plain(q, k, v, o, lse, do, scale)
    f = [t.float() for t in (q, k, v, do)]
    want = at.attention_bwd_plain(f[0], f[1], f[2],
                                  at.attention_plain(*f[:3], scale),
                                  lse, f[3], scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert_close_to_max(g.float().numpy(), w.numpy(), 2e-2, name)


def test_wrapper_differentiates_the_plain_path_on_cpu():
    """On CPU tensors that need a gradient, `attention` is autograd of
    `attention_plain` and launches nothing."""
    _build.reset_launches()
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 2, 2048, 8), 9))
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(at.attention(*qkv, 0.3), qkv, do)
    want = at.attention_bwd_plain(q, k, v, at.attention_plain(q, k, v, 0.3),
                                  at.attention_lse_plain(q, k, 0.3), do, 0.3)
    for g, w in zip(got, want):
        assert_close_to_max(g.numpy(), w.numpy(), TOL)
    assert not any(_build.LAUNCHES.get(n, 0)
                   for n in (at.ATTN, at.ATTN_DKV, at.ATTN_DQ))


def test_tiny_unet_context_gradient_matches_jax(tiny_sd_guidance,
                                                monkeypatch):
    """d(Σ w·ε)/d(context) of the tiny UNet on a 32 × 64 latent: its first
    level's self-attention has N = 2048 tokens, which the port sends
    through the `attention` wrapper (the kernels on a card)."""
    from tpunerf_torch.guidance import unet as tunet
    jg = tiny_sd_guidance
    tg = port_guidance(jg)
    calls = []
    monkeypatch.setattr(tunet, "attention", lambda *a: calls.append(
        a[0].shape) or at.attention(*a))
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, 32, 64, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 16, 32)).astype(np.float32)
    w = rng.standard_normal((1, 32, 64, 4)).astype(np.float32)

    def jloss(c):
        return jnp.sum(jg.unet_apply(jnp.asarray(lat), jnp.asarray(500), c)
                       * jnp.asarray(w))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(ctx)))
    c = torch.from_numpy(ctx).requires_grad_(True)
    loss = torch.sum(tg.unet_apply(torch.from_numpy(lat), torch.tensor(500),
                                   c) * torch.from_numpy(w))
    (got,) = torch.autograd.grad(loss, c)
    # the down block's transformer and the up block's two
    assert calls == [(1, 4, 2048, 8)] * 3
    # f32 both sides; convolution and norm sums in another order
    assert_close_to_max(got.numpy(), want, 1e-4, "context gradient")
