"""The port's VAE against the JAX package's at the tiny config, with the
weights carried over by tpunerf_torch/weights.py; f32 on the CPU."""
import jax
import numpy as np
import pytest
import torch

from _torch_port import np_tree, port_guidance
from tpunerf.guidance import vae as JV
from tpunerf_torch.guidance import stable_diffusion as TSD
from tpunerf_torch.guidance import vae as TV
from tpunerf_torch.weights import load_flax_params, state_dict_from_flax


@pytest.fixture(scope="module")
def pair(tiny_sd_guidance):
    g = port_guidance(tiny_sd_guidance)
    load_flax_params(g.vae, np_tree(tiny_sd_guidance.vae_params), "vae")
    return tiny_sd_guidance, g


def test_vae_configs_match():
    for name in ("sd_v1", "tiny"):
        j, t = getattr(JV.VAEConfig, name)(), getattr(TV.VAEConfig, name)()
        for f in ("in_channels", "out_channels", "latent_channels",
                  "block_out_channels", "layers_per_block",
                  "norm_num_groups", "downscale"):
            assert getattr(j, f) == getattr(t, f), (name, f)
    assert TV.LATENT_SCALE == JV.LATENT_SCALE


def test_state_dict_has_diffusers_names(pair):
    jg, g = pair
    names = set(state_dict_from_flax(np_tree(jg.vae_params), "vae"))
    assert names == set(g.vae.state_dict())
    for want in ("decoder.up_blocks.0.resnets.1.conv1.weight",
                 "decoder.up_blocks.0.upsamplers.0.conv.weight",
                 "encoder.down_blocks.0.downsamplers.0.conv.bias",
                 "encoder.mid_block.attentions.0.to_out.0.weight",
                 "decoder.mid_block.attentions.0.group_norm.weight",
                 "encoder.down_blocks.1.resnets.0.conv_shortcut.weight",
                 "quant_conv.weight", "post_quant_conv.bias"):
        assert want in names, want
    assert not any(p.requires_grad for p in g.vae.parameters())
    assert next(g.vae.parameters()).dtype == torch.float32


def test_decode_latents_matches_jax(pair, rng):
    jg, g = pair
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ref = np.asarray(jg.decode_latents(lat))
    got = g.decode_latents(torch.from_numpy(lat)).numpy()
    assert got.shape == (2, 32, 32, 3) and got.min() >= 0 and got.max() <= 1
    # f32 convolutions and group norms summed in another order
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_encode_imgs_mode_matches_jax(pair, rng):
    jg, g = pair
    img = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jg.encode_imgs_mode(img))
    got = g.encode_imgs_mode(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 8, 8, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_encode_imgs_with_the_noise_passed_in_matches_jax(pair, rng):
    jg, g = pair
    img = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(3)
    ref = np.asarray(jg.encode_imgs(img, key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (1, 8, 8, 4))))
    got = g.encode_imgs(torch.from_numpy(img), noise=noise).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # from a generator the draw differs, the posterior does not
    drawn = g.encode_imgs(torch.from_numpy(img),
                          generator=torch.Generator().manual_seed(0)).numpy()
    assert np.abs(drawn - got).max() > 1e-3
    assert np.abs(drawn - got).max() < 5.0


def test_encoder_carries_the_gradient_to_the_image(pair, rng):
    _, g = pair
    img = torch.from_numpy(rng.uniform(size=(1, 16, 16, 3))
                           .astype(np.float32)).requires_grad_()
    TV.encode_imgs_mode(g.vae, img).square().sum().backward()
    assert img.grad is not None and img.grad.abs().sum() > 0


def test_wide_latents_take_the_attention_wrapper(pair, monkeypatch, rng):
    """N ≥ 2048 tokens at a head width ≤ 128 goes through the port's
    attention wrapper (its plain version on the CPU), other shapes through
    the plain product; both are the same function."""
    _, g = pair
    calls = []
    real = TV.attention
    monkeypatch.setattr(TV, "attention",
                        lambda q, k, v, s: calls.append(q.shape) or
                        real(q, k, v, s))
    lat = torch.from_numpy(rng.normal(size=(1, 64, 32, 4))
                           .astype(np.float32))
    out = TV.decode_latents(g.vae, lat)
    assert calls == [(1, 1, 2048, 32)] and out.shape == (1, 256, 128, 3)
    TV.decode_latents(g.vae, lat[:, :8, :8])
    assert len(calls) == 1


def test_preview_matrix_and_constants_match_jax(rng):
    from tpunerf.guidance import stable_diffusion as JSD
    np.testing.assert_array_equal(TSD.LINEAR_RGB_ESTIMATOR.numpy(),
                                  JSD.LINEAR_RGB_ESTIMATOR)
    np.testing.assert_array_equal(TSD.LATENT_GRAY.numpy(), JSD.LATENT_GRAY)
    lat = rng.normal(size=(3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TSD.latent_to_rgb_preview(torch.from_numpy(lat)).numpy(),
        np.asarray(JSD.latent_to_rgb_preview(lat)), atol=1e-6)
    rgb = np.array([[1.0, 0.0, 0.0], [0.2, 0.5, 0.9]], np.float32)
    np.testing.assert_allclose(
        TSD.rgb_to_latent_init(torch.from_numpy(rgb)).numpy(),
        np.asarray(JSD.rgb_to_latent_init(rgb)), atol=1e-5)


def test_guidance_sizes_and_rgb_mode_refusal(pair):
    jg, g = pair
    assert (g.latent_size, g.image_size) == (jg.latent_size, jg.image_size)
    import dataclasses
    rgb = dataclasses.replace(g, latent_mode=False)
    # RGB mode, refused until ROADMAP.md item A.2 landed: the render goes
    # through the VAE encoder (tests/test_torch_refine.py holds it to JAX)
    render = torch.zeros((1, 16, 16, 3), requires_grad=True)
    loss = rgb.train_step_loss(torch.zeros((2, 4, 32)), render,
                               generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and render.grad.shape == render.shape
