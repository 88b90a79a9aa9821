"""The full-width layouts the pretrained-weight loaders take, without
memory: each module of the port built on the meta device, its state-dict
names with zero-stride arrays of their shapes handed to the JAX package's
converters (tpunerf/guidance/weights.py) and checked as its `_check_tree`
checks them against `jax.eval_shape` of the JAX module's init (less the
final `jnp.asarray`, which would allocate the weights), and the same names
handed to the port's loader (`tpunerf_torch.guidance.weights.convert`).

SD v1 (UNet, VAE, ViT-L/14 text tower), the depth UNet at a 1024-wide
context and its 1024-wide text tower, the 9-channel inpainting and
Paint-by-Example UNets, the Paint-by-Example encoder and the ViT-L/14 image
tower."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from tpunerf.guidance import weights as jw
from tpunerf.guidance.clip_text import CLIPTextConfig as JTextConfig
from tpunerf.guidance.clip_text import CLIPTextModel as JText
from tpunerf.guidance.clip_vision import CLIPImageEmbedder as JEmbedder
from tpunerf.guidance.clip_vision import CLIPVisionConfig as JVisionConfig
from tpunerf.guidance.paint_by_example import \
    PaintByExampleImageEncoder as JEncoder
from tpunerf.guidance.paint_by_example import pbe_num_mapper_blocks
from tpunerf.guidance.unet import UNet2DCondition as JUNet
from tpunerf.guidance.unet import UNetConfig as JUNetConfig
from tpunerf.guidance.vae import AutoencoderKL as JVAE
from tpunerf.guidance.vae import VAEConfig as JVAEConfig
from tpunerf_torch.guidance import weights as tw
from tpunerf_torch.guidance.clip_text import CLIPTextConfig, CLIPTextModel
from tpunerf_torch.guidance.clip_vision import (CLIPImageEmbedder,
                                                CLIPVisionConfig)
from tpunerf_torch.guidance.depth import TEXT_WIDE
from tpunerf_torch.guidance.paint_by_example import \
    PaintByExampleImageEncoder
from tpunerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from tpunerf_torch.guidance.vae import AutoencoderKL, VAEConfig

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_KEY = jax.random.key(0)
_JTEXT_WIDE = dataclasses.replace(JTextConfig.vit_l_14(), hidden_size=1024,
                                  num_heads=16, intermediate_size=4096,
                                  num_layers=23)


def _unet(cin, ctx):
    """(port module, JAX shapes, JAX converter) of an SD-v1 UNet with `cin`
    input channels and a `ctx`-wide context."""
    jcfg = dataclasses.replace(JUNetConfig.sd_v1(in_channels=cin),
                               cross_attention_dim=ctx)
    shapes = jax.eval_shape(JUNet(jcfg).init, _KEY, jnp.zeros((1, 8, 8, cin)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1, 77, ctx)))
    module = UNet2DCondition(dataclasses.replace(
        UNetConfig.sd_v1(in_channels=cin), cross_attention_dim=ctx))
    return module, shapes, lambda sd: jw.convert_unet(sd, jcfg), "unet"


def _text(jcfg, tcfg):
    shapes = jax.eval_shape(JText(jcfg).init, _KEY,
                            jnp.zeros((1, jcfg.max_length), jnp.int32))
    return (CLIPTextModel(tcfg), shapes,
            lambda sd: jw.convert_clip_text(sd, jcfg), "clip_text")


def _vae():
    jcfg = JVAEConfig.sd_v1()
    shapes = jax.eval_shape(JVAE(jcfg).init, _KEY, jnp.zeros((1, 64, 64, 3)),
                            _KEY)
    return (AutoencoderKL(VAEConfig.sd_v1()), shapes,
            lambda sd: jw.convert_vae(sd, jcfg), "vae")


def _vision():
    jcfg = JVisionConfig.vit_l_14()
    shapes = jax.eval_shape(JEmbedder(jcfg).init, _KEY,
                            jnp.zeros((1, 224, 224, 3)))
    return (CLIPImageEmbedder(CLIPVisionConfig.vit_l_14()), shapes,
            lambda sd: jw.convert_clip_vision(sd, jcfg), "clip_vision")


def _encoder():
    jcfg = JVisionConfig.vit_l_14()
    shapes = jax.eval_shape(JEncoder(jcfg, proj_dim=768).init, _KEY,
                            jnp.zeros((1, 224, 224, 3)))
    return (PaintByExampleImageEncoder(CLIPVisionConfig.vit_l_14(), 768),
            shapes, lambda sd: jw.convert_pbe_image_encoder(
                sd, jcfg, pbe_num_mapper_blocks(jcfg)), "pbe_image_encoder")


MODULES = {
    "sd_v1_unet": lambda: _unet(4, 768),
    "sd_v1_vae": _vae,
    "sd_v1_text": lambda: _text(JTextConfig.vit_l_14(),
                                CLIPTextConfig.vit_l_14()),
    "depth_unet_1024": lambda: _unet(5, 1024),
    "depth_text_1024": lambda: _text(_JTEXT_WIDE, TEXT_WIDE),
    "inpaint_unet_9ch_1024": lambda: _unet(9, 1024),
    "pbe_unet_9ch_768": lambda: _unet(9, 768),
    "pbe_encoder": _encoder,
    "vit_l_14": _vision,
}


def _keyed(tree):
    return {jax.tree_util.keystr(k): v
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("what", sorted(MODULES))
def test_full_width_names_and_shapes_agree(what):
    with torch.device("meta"):
        module, shapes, convert, kind = MODULES[what]()
    own = {n: tuple(p.shape) for n, p in module.named_parameters()}
    zeros = {n: np.broadcast_to(np.zeros((), np.float32), s)
             for n, s in own.items()}
    # the JAX converter on the port's names, checked as `_check_tree` does
    got, want = _keyed(convert(zeros)), _keyed(shapes)
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    # the port's loader on the same names, on the meta module
    tensors = tw.convert(module, {n: torch.zeros(()).expand(s)
                                  for n, s in own.items()}, kind, what)
    assert {n: tuple(t.shape) for n, t in tensors.items()} == own
    tw.fill_(module, tensors)
    assert all(p.is_meta for p in module.parameters())
    if kind == "unet":
        # the head count is no part of a checkpoint: after loading, the 64²
        # level's attention (kernel #4) runs at 320 / 8 = 40 wide heads
        cfg = module.config
        assert cfg.attention_num_heads == 8 and \
            cfg.block_out_channels[0] // cfg.attention_num_heads == 40
        assert own["conv_in.weight"][1] == module.config.in_channels
