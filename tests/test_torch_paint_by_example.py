"""The port's Paint-by-Example guidance against the JAX package's, on the
tiny stack (9-channel tiny UNet with a 32-wide context, tiny VAE, tiny CLIP
tower with one mapper block, f32), drawn once per module in the port and
loaded into the JAX package by its own diffusers-layout loader
(`_torch_port.pbe_stacks`): the mapper rule, the
exemplar encoder and `encode_exemplar`, `train_step_loss` with the loss and
the latents' gradient at an injected t in each branch (the SDS branch and,
with `use_clip`, the CLIP branch through the DDIM step, the VAE decode and
a tiny CLIP embedder), `latent_forward` at strength 1.0 and 0.6 (one draw
for the start and the renoising), `forward` and `approx_latent2rgb`, each
with JAX's draws; and the weights bridge at full width (the ViT-L/14
exemplar encoder with its 5 mapper blocks and the 9-channel UNet with a
768-wide context, key for key, from shapes alone; the encoder's names back
through the JAX package's converter of diffusers checkpoints)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread, pbe_stacks)
from tpunerf.guidance import clip_vision as jclip
from tpunerf.guidance import paint_by_example as jpbe
from tpunerf.guidance.unet import UNet2DCondition as JUNet
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf_torch.guidance import clip_vision as tclip
from tpunerf_torch.guidance import paint_by_example as tpbe
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.weights import flax_entries, load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# the encoder: f32, the same operations in another order
ENC_REL = 1e-5
# a loss or gradient through the tiny UNet's ε̂ (×7.5 by CFG): the depth
# step's tolerance
STEP_REL = 1e-4
# a walk of 3 to 5 DDIM steps, each step's ε̂ error carried on
WALK_REL = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    return pbe_stacks(tmp_path_factory.mktemp("pbe_weights"))


@pytest.fixture(scope="module")
def clip_towers():
    """The tiny CLIP embedder of the use_clip branch, in both packages."""
    jcfg = jclip.CLIPVisionConfig.tiny()
    jemb = jclip.CLIPImageEmbedder(jcfg)
    params = jemb.init(jax.random.key(7), jnp.zeros((1, 32, 32, 3)))
    temb = tclip.CLIPImageEmbedder(tclip.CLIPVisionConfig.tiny()).eval()
    load_flax_params(temb, np_tree(params), "clip_vision")
    return (lambda p: jemb.apply(params, p)), temb


def _inputs(seed=0, n=16):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(1, n, n, 4)).astype(np.float32)
    mask = np.zeros((1, n, n, 1), np.float32)
    mask[:, n // 4: 3 * n // 4, n // 4: 3 * n // 4] = 1.0
    img = rng.uniform(size=(1, 4 * n, 4 * n, 3)).astype(np.float32)
    return lat, mask, img


def test_mapper_depth_rule_matches_jax():
    for name in ("vit_l_14", "vit_b_32", "tiny"):
        jcfg = getattr(jclip.CLIPVisionConfig, name)()
        tcfg = getattr(tclip.CLIPVisionConfig, name)()
        assert tpbe.pbe_num_mapper_blocks(tcfg) == \
            jpbe.pbe_num_mapper_blocks(jcfg)
    assert tpbe.pbe_num_mapper_blocks(
        tclip.CLIPVisionConfig.vit_l_14()) == 5
    assert tpbe.pbe_num_mapper_blocks(tclip.CLIPVisionConfig.tiny()) == 1


def test_encoder_and_encode_exemplar_match_jax(stacks):
    jg, tg = stacks
    rng = np.random.default_rng(1)
    px = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(jg.image_encoder.apply)(jg.image_encoder_params, px)
    with torch.no_grad():
        got = tg.image_encoder(torch.from_numpy(px))
    assert got.shape == (2, 1, 32)
    assert_close_to_max(got.numpy(), np.asarray(ref), ENC_REL, "encoder")
    _, _, img = _inputs(2)
    ref = np.asarray(jax.jit(jg.encode_exemplar)(img))
    got = tg.encode_exemplar(torch.from_numpy(img))
    assert got.shape == (2, 1, 32)
    np.testing.assert_array_equal(
        got[0].numpy(), np.asarray(
            jg.image_encoder_params["params"]["uncond_vector"])[0])
    assert_close_to_max(got.numpy(), ref, ENC_REL, "encode_exemplar")


@pytest.fixture(scope="module")
def jax_steps(stacks, clip_towers):
    """JAX's loss and latents' gradient at (latents, t), with and without
    `use_clip`, each compiled once: t enters as the one-step window [t, t]
    of the drawn timestep, so both branches share one executable."""
    jg, _ = stacks
    jfn, _ = clip_towers
    lat, mask, ref_img = _inputs(3)
    emb = jg.encode_exemplar(ref_img)
    key = jax.random.key(11)

    def step(use_clip):
        kw = dict(use_clip=use_clip, clip_embed_fn=jfn, ref_image01=ref_img,
                  clip_image_size=32)
        return jax.jit(jax.value_and_grad(
            lambda x, t: dataclasses.replace(jg, min_step=t, max_step=t)
            .train_step_loss(key, x, mask, emb, **kw)))
    return {u: step(u) for u in (True, False)}, key


@pytest.mark.parametrize("t,use_clip", [(250, True), (500, True),
                                        (250, False)])
def test_train_step_loss_and_gradient_match_jax(stacks, clip_towers,
                                                jax_steps, t, use_clip):
    """t injected by a one-step window; t = 250 ≤ 0.4·T takes the CLIP
    branch with `use_clip`, t = 500 the SDS branch."""
    _, tg = stacks
    _, temb = clip_towers
    steps, key = jax_steps
    lat, mask, ref_img = _inputs(3)
    loss_j, grad_j = steps[use_clip](lat, jnp.asarray(t))
    _, k_n = jax.random.split(key)
    noise = _t(jax.random.normal(k_n, lat.shape))
    x = _t(lat).requires_grad_(True)
    loss_t = tg.train_step_loss(
        x, _t(mask), tg.encode_exemplar(_t(ref_img)), use_clip=use_clip,
        clip_embed_fn=temb, ref_image01=_t(ref_img), clip_image_size=32,
        t=torch.tensor(t), noise=noise)
    loss_t.backward()
    assert tg.takes_clip_branch(torch.tensor(t)) == (t <= 400)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=STEP_REL)
    assert float(np.abs(np.asarray(grad_j)).max()) > 0
    assert_close_to_max(x.grad.numpy(), np.asarray(grad_j), STEP_REL,
                        f"d loss / d latents at t = {t}")


def test_use_clip_without_its_tower_is_refused(stacks):
    _, tg = stacks
    lat, mask, img = _inputs(4)
    with pytest.raises(ValueError, match="clip_embed_fn"):
        tg.train_step_loss(_t(lat), _t(mask), tg.encode_exemplar(_t(img)),
                           use_clip=True, t=torch.tensor(300))


@pytest.mark.parametrize("strength", [1.0, 0.6])
def test_latent_forward_matches_jax(stacks, strength):
    jg, tg = stacks
    lat, mask, img = _inputs(5)
    emb = jg.encode_exemplar(img)
    key = jax.random.key(2)
    ref = jg.latent_forward(key, lat, mask, emb, num_inference_steps=5,
                            strength=strength)
    got = tg.latent_forward(_t(lat), _t(mask), _t(emb),
                            num_inference_steps=5, strength=strength,
                            noise=_t(jax.random.normal(key, lat.shape)))
    assert got.shape == lat.shape
    assert_close_to_max(got.numpy(), np.asarray(ref), WALK_REL,
                        f"latent_forward at strength {strength}")


def test_forward_matches_jax(stacks):
    jg, tg = stacks
    _, _, img = _inputs(6)
    _, _, exemplar = _inputs(7)
    mask = np.zeros((1, 64, 64, 1), np.float32)
    mask[:, 10:40, 20:50] = 1.0
    key = jax.random.key(4)
    ref = jg.forward(key, img, mask, exemplar, num_inference_steps=3)
    got = tg.forward(_t(img), _t(mask), _t(exemplar), num_inference_steps=3,
                     noise=_t(jax.random.normal(key, (1, 16, 16, 4))))
    assert got.shape == (1, 64, 64, 3)
    assert_close_to_max(got.numpy(), np.asarray(ref), WALK_REL, "forward")


def test_approx_latent2rgb_matches_jax():
    rng = np.random.default_rng(8)
    lat = rng.normal(size=(200, 4)).astype(np.float32)
    rgb = (lat @ rng.normal(size=(4, 3)) + 0.01 * rng.normal(
        size=(200, 3))).astype(np.float32)
    ref = np.asarray(jpbe.approx_latent2rgb(lat, rgb))
    got = tpbe.approx_latent2rgb(_t(lat), _t(rgb)).numpy()
    assert got.shape == (4, 3)
    assert_close_to_max(got, ref, 1e-4, "latent→RGB matrix")


def test_names_are_what_the_jax_converter_reads(stacks):
    """The port's encoder state dict, fed to the JAX package's
    `convert_pbe_image_encoder` (diffusers' names: the tower under
    `model.`, `mapper.blocks.{i}`, `final_layer_norm`, `proj_out`,
    `uncond_vector`), gives back the JAX tree, leaf for leaf."""
    from tpunerf.guidance.weights import convert_pbe_image_encoder
    jg, tg = stacks
    sd = {k: v.numpy() for k, v in tg.image_encoder.state_dict().items()}
    vcfg = jg.image_encoder.vision_config
    back = convert_pbe_image_encoder(sd, vcfg,
                                     jpbe.pbe_num_mapper_blocks(vcfg))
    ref = np_tree(jg.image_encoder_params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("what", ["encoder", "unet9"])
def test_full_width_trees_map_onto_the_port_key_for_key(what):
    """The ViT-L/14 exemplar encoder (5 mapper blocks, 768-wide
    projection) and the 9-channel UNet with a 768-wide context, from
    `jax.eval_shape` (nothing is allocated), against the port's modules
    built on the meta device."""
    key = jax.random.key(0)
    if what == "encoder":
        tree = jax.eval_shape(
            jpbe.PaintByExampleImageEncoder(
                jclip.CLIPVisionConfig.vit_l_14(), proj_dim=768).init,
            key, jnp.zeros((1, 224, 224, 3)))
        kind = "pbe_image_encoder"
        with torch.device("meta"):
            module = tpbe.PaintByExampleImageEncoder(
                tclip.CLIPVisionConfig.vit_l_14(), proj_dim=768)
    else:
        tree = jax.eval_shape(
            JUNet(JUNetConfig.sd_v1(in_channels=9)).init, key,
            jnp.zeros((1, 8, 8, 9)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 1, 768)))
        kind = "unet"
        with torch.device("meta"):
            module = UNet2DCondition(UNetConfig.sd_v1(in_channels=9))
    got = {k: tuple(v.shape) for k, v in flax_entries(_shapes(tree), kind)}
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == own
    if what == "encoder":
        assert own["uncond_vector"] == (1, 1, 768)
        assert own["proj_out.weight"] == (768, 1024)
        assert own["mapper.blocks.4.ff.net.0.proj.weight"] == (4096, 1024)
        assert own["mapper.blocks.4.attn1.to_q.bias"] == (1024,)
        assert "model.vision_model.pre_layrnorm.weight" in own
        assert not any(k.startswith("mapper.blocks.5") for k in own)
    else:
        assert own["conv_in.weight"] == (320, 9, 3, 3)
        assert own["down_blocks.0.attentions.0.transformer_blocks.0.attn2"
                   ".to_k.weight"] == (320, 768)
