"""The port's CLIP vision tower against the JAX package's: the tiny tower
(`CLIPVisionConfig.tiny`) with JAX's weights carried over, pooled, as a
sequence and through the projection (`CLIPImageEmbedder`); `clip_preprocess`
from 64² and 512² (shrinking, JAX's antialiased bilinear weights) to 32²
and 224²; both losses and the image loss's gradient to its image; and the
weights bridge at full width (ViT-L/14's tree from shapes alone, key for
key) and back through the JAX package's converter of transformers'
`CLIPVisionModelWithProjection` checkpoints."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_close_to_max, np_tree,  # noqa: F401
                         one_torch_thread)
from tpunerf.guidance import clip_vision as jclip
from tpunerf_torch.guidance import clip_vision as tclip
from tpunerf_torch.weights import flax_entries, load_flax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")
# f32 towers, the same operations in another order: 1e-5 of the largest
REL = 1e-5


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@pytest.fixture(scope="module")
def towers():
    """The tiny JAX embedder's params and the port's embedder and tower
    holding them."""
    jcfg = jclip.CLIPVisionConfig.tiny()
    tcfg = tclip.CLIPVisionConfig.tiny()
    probe = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3))
    params = jclip.CLIPImageEmbedder(jcfg).init(jax.random.key(3), probe)
    emb = tclip.CLIPImageEmbedder(tcfg).eval()
    load_flax_params(emb, np_tree(params), "clip_vision")
    tower = tclip.CLIPVisionModel(tcfg).eval()
    load_flax_params(tower, {"vision": np_tree(params)["params"]["vision"]},
                     "clip_vision")
    return jcfg, params, emb, tower


def _pixels(n=2, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, size, size, 3)).astype(np.float32)


def test_embedder_and_tower_match_jax(towers):
    jcfg, params, emb, tower = towers
    px = _pixels()
    ref = jax.jit(jclip.CLIPImageEmbedder(jcfg).apply)(params, px)
    with torch.no_grad():
        got = emb(torch.from_numpy(px))
    assert got.shape == (2, jcfg.projection_dim)
    assert_close_to_max(got.numpy(), np.asarray(ref), REL, "embedder")
    vparams = {"params": params["params"]["vision"]}
    jtower = jclip.CLIPVisionModel(jcfg)
    for seq in (False, True):
        ref = jax.jit(jtower.apply, static_argnames="return_sequence")(
            vparams, px, return_sequence=seq)
        with torch.no_grad():
            got = tower(torch.from_numpy(px), return_sequence=seq)
        want = (2, 17, 32) if seq else (2, 32)
        assert got.shape == want and got.dtype == torch.float32
        assert_close_to_max(got.numpy(), np.asarray(ref), REL,
                            f"tower, sequence {seq}")


@pytest.mark.parametrize("src,size", [(64, 32), (512, 224), (224, 224)])
def test_clip_preprocess_matches_jax(src, size):
    img = np.random.default_rng(src).uniform(
        size=(1, src, src, 3)).astype(np.float32)
    ref = np.asarray(jclip.clip_preprocess(jnp.asarray(img), size))
    got = tclip.clip_preprocess(torch.from_numpy(img), size)
    assert got.shape == (1, size, size, 3)
    assert_close_to_max(got.numpy(), ref, 1e-6, f"{src} -> {size}")


def test_losses_and_the_image_gradient_match_jax(towers):
    jcfg, params, emb, _ = towers
    rng = np.random.default_rng(5)
    a, b = rng.uniform(size=(2, 2, 64, 64, 3)).astype(np.float32)
    text_z = rng.normal(size=(2, jcfg.projection_dim)).astype(np.float32)
    jfn = lambda p: jclip.CLIPImageEmbedder(jcfg).apply(params, p)  # noqa
    ref, ref_grad = jax.jit(jax.value_and_grad(
        lambda x: jclip.img_clip_loss(jfn, x, b, size=32)))(a)
    ta = torch.from_numpy(a).requires_grad_(True)
    got = tclip.img_clip_loss(emb, ta, torch.from_numpy(b), size=32)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    assert_close_to_max(ta.grad.numpy(), np.asarray(ref_grad), 1e-4,
                        "d loss / d image")
    ref = jclip.img_text_clip_loss(jfn, a, text_z, size=32)
    with torch.no_grad():
        got = tclip.img_text_clip_loss(emb, torch.from_numpy(a),
                                       torch.from_numpy(text_z), size=32)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_full_width_tree_maps_onto_the_port_key_for_key():
    """ViT-L/14's embedder tree from `jax.eval_shape` (nothing allocated)
    against the port's embedder built on the meta device."""
    jcfg = jclip.CLIPVisionConfig.vit_l_14()
    tree = jax.eval_shape(jclip.CLIPImageEmbedder(jcfg).init,
                          jax.random.key(0), jnp.zeros((1, 224, 224, 3)))
    with torch.device("meta"):
        module = tclip.CLIPImageEmbedder(tclip.CLIPVisionConfig.vit_l_14())
    got = {k: tuple(v.shape)
           for k, v in flax_entries(_shapes(tree), "clip_vision")}
    own = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert got == own
    assert own["vision_model.embeddings.position_embedding.weight"] == \
        (257, 1024)
    assert own["vision_model.embeddings.patch_embedding.weight"] == \
        (1024, 3, 14, 14)
    assert own["visual_projection.weight"] == (768, 1024)
    assert len([k for k in own if k.endswith("self_attn.q_proj.weight")]) \
        == 24


def test_names_are_what_the_jax_converter_reads(towers):
    """The port's state dict, fed to the JAX package's
    `convert_clip_vision` (which reads transformers'
    `CLIPVisionModelWithProjection` names, `pre_layrnorm` included), gives
    back the JAX tree it was loaded from, leaf for leaf."""
    from tpunerf.guidance.weights import convert_clip_vision
    jcfg, params, emb, _ = towers
    sd = {k: v.numpy() for k, v in emb.state_dict().items()}
    assert "vision_model.pre_layrnorm.weight" in sd
    back = convert_clip_vision(sd, jcfg)
    ref = np_tree(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
