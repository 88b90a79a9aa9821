"""Tiny diffusers- and transformers-layout state dicts and their files,
shared by the tests of the port's pretrained-weight loaders
(tests/test_torch_weights_*.py): the layouts that the JAX tests
(tests/test_weights_converter.py) make, written as .bin or as F32, F16 or BF16
safetensors, and a check of a loaded module against a JAX tree."""
from __future__ import annotations

import jax
import numpy as np
import safetensors.torch
import torch

from _torch_port import np_tree
from test_weights_converter import (_make_clip_vision_sd, _make_pbe_encoder_sd,
                                    _make_vae_sd)
from tpunerf.guidance.clip_text import CLIPTextConfig as JTextConfig
from tpunerf.guidance.clip_vision import CLIPVisionConfig as JVisionConfig
from tpunerf.guidance.paint_by_example import pbe_num_mapper_blocks
from tpunerf.guidance.vae import VAEConfig as JVAEConfig
from tpunerf_torch.weights import state_dict_from_flax

FORMS = ["bin", "F32", "F16", "BF16"]
_SAFE_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                "BF16": torch.bfloat16}
_VAE_OLD = {"group_norm": "norm", "to_q": "query", "to_k": "key",
            "to_v": "value", "to_out.0": "proj_attn"}


def save(base, sd, form):
    """A state dict of numpy arrays at `base` (no suffix): `.bin` by
    torch.save, else `.safetensors` by the `safetensors` package with its
    floats in `form`'s dtype. Returns what the file holds, as torch."""
    base.parent.mkdir(parents=True, exist_ok=True)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    if form == "bin":
        torch.save(tensors, base.with_suffix(".bin"))
        return tensors
    tensors = {k: v.to(_SAFE_DTYPES[form]) if v.is_floating_point() else v
               for k, v in tensors.items()}
    safetensors.torch.save_file(tensors, base.with_suffix(".safetensors"),
                                metadata={"format": "pt"})
    return tensors


def text_sd(prefixed=True):
    """A transformers-layout CLIP text tower's state dict for the tiny
    config (the layout of the JAX tests' `_make_text_sd`, without building
    a transformers model), with a `position_ids` no converter reads, as
    older files carry it."""
    cfg = JTextConfig.tiny()
    rng = np.random.default_rng(1)
    D, F = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"embeddings.token_embedding.weight": w(cfg.vocab_size, D),
          "embeddings.position_embedding.weight": w(cfg.max_length, D),
          "embeddings.position_ids": np.arange(cfg.max_length)[None],
          "final_layer_norm.weight": w(D), "final_layer_norm.bias": w(D)}
    for i in range(cfg.num_layers):
        b = f"encoder.layers.{i}"
        for name, shape in (("layer_norm1", (D,)), ("layer_norm2", (D,)),
                            ("self_attn.q_proj", (D, D)),
                            ("self_attn.k_proj", (D, D)),
                            ("self_attn.v_proj", (D, D)),
                            ("self_attn.out_proj", (D, D)),
                            ("mlp.fc1", (F, D)), ("mlp.fc2", (D, F))):
            sd[f"{b}.{name}.weight"] = w(*shape)
            sd[f"{b}.{name}.bias"] = w(shape[0])
    pre = "text_model." if prefixed else ""
    return {pre + k: v for k, v in sd.items()}


def vision_sd(prefix="vision_model.", pre_ln="pre_layrnorm",
              projection=True):
    vis = JVisionConfig.tiny()
    sd = {k.replace("pre_layrnorm", pre_ln): v
          for k, v in _make_clip_vision_sd(vis, prefix).items()}
    if projection:
        sd["visual_projection.weight"] = np.random.default_rng(3) \
            .standard_normal((vis.projection_dim, vis.hidden_size)) \
            .astype(np.float32)
    return sd


def vae_sd(old_names=False):
    sd = _make_vae_sd(JVAEConfig.tiny())
    if not old_names:
        return sd
    out = {}
    for k, v in sd.items():
        if ".mid_block.attentions.0." in k:
            head, leaf = k.split(".mid_block.attentions.0.")
            part, last = leaf.rsplit(".", 1)
            k = f"{head}.mid_block.attentions.0.{_VAE_OLD[part]}.{last}"
        out[k] = v
    return out


def pbe_sd(prefix="vision_model."):
    vis = JVisionConfig.tiny()
    sd = _make_pbe_encoder_sd(vis, 32, pbe_num_mapper_blocks(vis))
    if prefix == "":
        sd = {k.replace("model.vision_model.", "model."): v
              for k, v in sd.items()}
    return sd



def as_f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  np_tree(tree))


def assert_same(module, tree, kind):
    """`module`'s state dict equals the JAX tree's (a flax-bridge `kind`),
    bit for bit (the JAX leaves in f32: F16 and BF16 widen exactly)."""
    ref = state_dict_from_flax(as_f32(tree), kind)
    own = module.state_dict()
    assert own.keys() == ref.keys(), kind
    for k, v in own.items():
        assert torch.equal(v.float(), ref[k]), f"{kind}: {k}"


