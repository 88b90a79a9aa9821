"""Text-token optimisation of the port (training/text_token_opt.py) against
the JAX package's (tpunerf/training/text_token_opt.py) on the tiny SD stack
and the tiny CLIP image tower, with the same weights: the text tower's
`input_embeddings` path, the prompt's initial token rows, and
`optimize_text_token` (2 Adam steps, through a 2-step DDIM chain and the
VAE decode, and the cheap proxy), the port fed JAX's per-step draws
normal(fold_in(key, i), (1, h, h, 4))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, port_guidance)
from tpunerf.guidance import clip_vision as jclip
from tpunerf.training import text_token_opt as jtto
from tpunerf_torch.guidance import clip_vision as tclip
from tpunerf_torch.training import text_token_opt as tto
from tpunerf_torch.weights import load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
PROMPT = "a goldfish, front view"


@pytest.fixture(scope="module")
def stacks(tiny_sd_guidance):
    """(JAX guidance, JAX embed fn, port guidance with JAX's UNet, text
    tower and VAE, port embedder with JAX's tiny CLIP tower)."""
    jg = tiny_sd_guidance
    tg = port_guidance(jg)
    load_flax_params(tg.vae, np_tree(jg.vae_params), "vae")
    jcfg = jclip.CLIPVisionConfig.tiny()
    probe = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    params = jclip.CLIPImageEmbedder(jcfg).init(jax.random.key(3), probe)
    emb = tclip.CLIPImageEmbedder(tclip.CLIPVisionConfig.tiny()).eval()
    load_flax_params(emb, np_tree(params), "clip_vision")
    emb.requires_grad_(False)

    def jembed(x):
        return jclip.CLIPImageEmbedder(jcfg).apply(params, x)

    return jg, jembed, tg, emb


def test_input_embeddings_path_matches_jax(stacks):
    jg, _, tg, _ = stacks
    rng = np.random.default_rng(0)
    tok = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ref = np.asarray(jtto.encode_text_embedding(jg, jnp.asarray(tok)))
    t = torch.from_numpy(tok).requires_grad_(True)
    out = tto.encode_text_embedding(tg, t)
    # as test_torch_guidance.py holds the CLIP text tower: 2e-5 absolute
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=2e-5)
    # differentiable to the embeddings, and the ids' own path is the same
    # tower on the table's rows
    (g,) = torch.autograd.grad(out.sum(), t)
    assert torch.isfinite(g).all() and g.abs().max() > 0
    ids = tg.tokenizer([PROMPT])
    rows = tto.initial_token_embeddings(tg, PROMPT)
    with torch.no_grad():
        torch.testing.assert_close(tto.encode_text_embedding(tg, rows),
                                   tg.encode_text_ids(ids), rtol=0, atol=0)


def test_initial_token_embeddings_equal_jax(stacks):
    jg, _, tg, _ = stacks
    ref = np.asarray(jtto.initial_token_embeddings(jg, PROMPT))
    got = tto.initial_token_embeddings(tg, PROMPT)
    assert got.shape == (1, 16, 32) and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("through_sampling", [True, False])
def test_optimize_text_token_matches_jax(stacks, through_sampling):
    jg, jembed, tg, emb = stacks
    rng = np.random.default_rng(5)
    ref = rng.uniform(size=(1, 64, 64, 3)).astype(np.float32)
    key = jax.random.key(11)
    steps, size = 2, 32
    jtok, jctx = jtto.optimize_text_token(
        jg, jembed, jnp.asarray(ref), PROMPT, key, num_steps=steps,
        num_sample_steps=2, through_sampling=through_sampling,
        clip_size=size)
    h = jg.latent_size
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (1, h, h, 4))) for i in range(steps)])
    losses = []
    tok, ctx = tto.optimize_text_token(
        tg, emb, torch.from_numpy(ref), PROMPT, num_steps=steps,
        num_sample_steps=2, through_sampling=through_sampling,
        clip_size=size, latents=torch.from_numpy(draws),
        on_step=lambda i, loss: losses.append(float(loss)))
    assert len(losses) == steps and np.isfinite(losses).all()
    tok0 = np.asarray(jtto.initial_token_embeddings(jg, PROMPT))
    # Adam's steps (lr 1e-3) from gradients that agree to ~1e-4: the change
    # of the tokens within 1e-3 of its largest entry
    assert np.abs(np.asarray(jtok) - tok0).max() > 1e-4
    assert_close_to_max(tok.numpy() - tok0, np.asarray(jtok) - tok0, 1e-3,
                        "token change")
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=2e-5)
