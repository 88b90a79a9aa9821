"""The JAX package's parameter trees → the port's state dicts.

The trees come as nested dicts of numpy arrays (flax's layout). Leaves
convert as

* Dense kernel (in, out)      → Linear weight (out, in);
* Conv kernel HWIO            → Conv2d weight OIHW;
* norm `scale`                → `weight`;
* Embed `embedding`           → `weight`;
* biases, the hash table and the occupancy grid as they are;

and module paths are renamed onto the port's (diffusers- and
transformers-style) names. The textured-mesh scene's parameters (`background_sphere_colors`,
`texture_img`, `texture_img_rgb_finetune` and, for latent-paint-mesh,
`displacement` and `lights`) keep their layout: the port holds textures
NHWC, dome colours (1, F, 3, C) and displacements (V, 3), exactly as the JAX
package does, so nothing is transposed.

`flax_leaves` is the inverse for a UNet, a VAE and a CLIP text tower: the
JAX package's tree paths and layouts of a port module's parameters (what
`scripts/convert_sd_weights.py` writes).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

_RENAMES = {
    "field": [(r"^dense_(\d+)$", r"layers.\1")],
    "unet": [
        (r"^down_(\d+)_res_(\d+)$", r"down_blocks.\1.resnets.\2"),
        (r"^down_(\d+)_attn_(\d+)$", r"down_blocks.\1.attentions.\2"),
        (r"^down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0"),
        (r"^up_(\d+)_res_(\d+)$", r"up_blocks.\1.resnets.\2"),
        (r"^up_(\d+)_attn_(\d+)$", r"up_blocks.\1.attentions.\2"),
        (r"^up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0"),
        (r"^mid_res_(\d+)$", r"mid_block.resnets.\1"),
        (r"^mid_attn$", r"mid_block.attentions.0"),
        (r"^block_(\d+)$", r"transformer_blocks.\1"),
        (r"^to_out$", r"to_out.0"),
    ],
    "vae": [
        (r"^down_(\d+)_res_(\d+)$", r"down_blocks.\1.resnets.\2"),
        (r"^down_(\d+)_downsample$", r"down_blocks.\1.downsamplers.0.conv"),
        (r"^up_(\d+)_res_(\d+)$", r"up_blocks.\1.resnets.\2"),
        (r"^up_(\d+)_upsample$", r"up_blocks.\1.upsamplers.0.conv"),
        (r"^mid_res_(\d+)$", r"mid_block.resnets.\1"),
        (r"^mid_attn$", r"mid_block.attentions.0"),
        (r"^to_out$", r"to_out.0"),
    ],
    "displacement_mlp": [
        (r"^norm_(\d+)$", r"norms.\1"),
        (r"^dense_(\d+)$", r"denses.\1"),
    ],
    "clip_text": [
        (r"^layer_(\d+)$", r"encoder.layers.\1"),
        (r"^fc(\d)$", r"mlp.fc\1"),
        (r"^token_embedding$", r"embeddings.token_embedding"),
    ],
}
# the CLIP vision tower's flat flax names → transformers' (both kinds)
_VISION = [
    (r"^patch_embedding$", r"embeddings.patch_embedding"),
    (r"^pre_layernorm$", r"pre_layrnorm"),
    (r"^layer_(\d+)_ln(\d)$", r"encoder.layers.\1.layer_norm\2"),
    (r"^layer_(\d+)_attn$", r"encoder.layers.\1.self_attn"),
    (r"^layer_(\d+)_fc(\d)$", r"encoder.layers.\1.mlp.fc\2"),
]
_RENAMES["clip_vision"] = [(r"^vision$", r"vision_model")] + _VISION
_RENAMES["pbe_image_encoder"] = [
    (r"^model$", r"model.vision_model"),
    (r"^block_(\d+)_norm(\d)$", r"mapper.blocks.\1.norm\2"),
    (r"^block_(\d+)_([qkv])$", r"mapper.blocks.\1.attn1.to_\2"),
    (r"^block_(\d+)_out$", r"mapper.blocks.\1.attn1.to_out.0"),
    (r"^block_(\d+)_fc1$", r"mapper.blocks.\1.ff.net.0.proj"),
    (r"^block_(\d+)_fc2$", r"mapper.blocks.\1.ff.net.2"),
] + _VISION
# the tower's bare leaves, under its embeddings
_VISION_LEAVES = {"class_embedding": "embeddings.class_embedding",
                  "position_embedding": "embeddings.position_embedding.weight"}
# GEGLU feed-forward: flax ff.proj / ff.out ↔ diffusers ff.net.0.proj / .2
_UNET_FF = ((".ff.proj.", ".ff.net.0.proj."), (".ff.out.", ".ff.net.2."))


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {value.ndim}")
    if name in ("scale", "embedding"):
        return "weight", value
    return name, value


def state_dict_from_flax(tree: Mapping[str, Any], kind: str
                         ) -> Dict[str, torch.Tensor]:
    """One of the JAX package's parameter trees → the port's state dict.

    kind "field": a `LatentNeRFField`'s params; "scene": the scene params
    {"field": …, "occ_grid": …} (→ `LatentNeRFScene`, whose packed bitfield
    is derived from the grid); "paint_scene" / "paint_mesh_scene": a
    `TexturedMeshScene`'s three / five params; "displacement_mlp":
    `DisplacementMLP`; "unet": `UNet2DCondition`; "vae": `AutoencoderKL`; "clip_text":
    `CLIPTextModel`; "clip_vision": `CLIPImageEmbedder`;
    "pbe_image_encoder": `PaintByExampleImageEncoder`. A leading "params"
    collection is unwrapped."""
    if kind in ("paint_scene", "paint_mesh_scene"):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in tree.items()}
    if kind == "scene":
        from tpunerf_torch.fields.occupancy import (OccupancyGridConfig,
                                                    packed_bitfield)
        out = {f"field.{k}": v for k, v in
               state_dict_from_flax(tree["field"], "field").items()}
        grid = torch.from_numpy(np.array(tree["occ_grid"], np.float32))
        out["occ_grid"] = grid
        out["occ_packed"] = packed_bitfield(grid, OccupancyGridConfig())
        return out
    return {name: torch.from_numpy(np.array(value))     # writable copies
            for name, value in flax_entries(tree, kind)}


def flax_entries(tree: Mapping[str, Any], kind: str
                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """The (port name, numpy view in the port's layout) of each leaf of a
    module's parameter tree (kinds as `state_dict_from_flax`'s, the scenes
    excepted), copying nothing: a tree of shapes alone (`jax.eval_shape`
    leaves as broadcast zeros) is mapped at any width."""
    if kind not in _RENAMES:
        raise ValueError(f"unknown parameter tree kind {kind!r}")
    if set(tree) == {"params"}:
        tree = tree["params"]
    for path, value in _leaves(tree):
        parts: List[str] = []
        for p in path[:-1]:
            for pat, rep in _RENAMES[kind]:
                p = re.sub(pat, rep, p)
            parts.append(p)
        leaf, value = _leaf(path[-1], value)
        if kind == "clip_text" and path == ("position_embedding",):
            parts, leaf = [], "embeddings.position_embedding.weight"
        elif kind in ("clip_vision", "pbe_image_encoder") and \
                len(path) == 2 and path[-1] in _VISION_LEAVES:
            leaf = _VISION_LEAVES[path[-1]]
        name = ".".join(parts + [leaf])
        if kind == "unet":
            for old, new in _UNET_FF:
                name = name.replace(old, new)
        yield name, value


# the inverse renames of the module kinds `flax_leaves` takes: applied to a
# port name without its leaf, in this order, before it splits on dots
_INVERSE = {
    "unet": [
        (r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)", r"\1_\2_res_\3"),
        (r"(down|up)_blocks\.(\d+)\.attentions\.(\d+)", r"\1_\2_attn_\3"),
        (r"down_blocks\.(\d+)\.downsamplers\.0", r"down_\1_downsample"),
        (r"up_blocks\.(\d+)\.upsamplers\.0", r"up_\1_upsample"),
        (r"mid_block\.resnets\.(\d+)", r"mid_res_\1"),
        (r"mid_block\.attentions\.0", r"mid_attn"),
        (r"transformer_blocks\.(\d+)", r"block_\1"),
        (r"to_out\.0", r"to_out"),
        (r"ff\.net\.0\.proj", r"ff.proj"),
        (r"ff\.net\.2", r"ff.out"),
    ],
    "vae": [
        (r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)", r"\1_\2_res_\3"),
        (r"down_blocks\.(\d+)\.downsamplers\.0\.conv", r"down_\1_downsample"),
        (r"up_blocks\.(\d+)\.upsamplers\.0\.conv", r"up_\1_upsample"),
        (r"mid_block\.resnets\.(\d+)", r"mid_res_\1"),
        (r"mid_block\.attentions\.0", r"mid_attn"),
        (r"to_out\.0", r"to_out"),
    ],
    "clip_text": [
        (r"encoder\.layers\.(\d+)", r"layer_\1"),
        (r"mlp\.fc(\d)", r"fc\1"),
        (r"embeddings\.token_embedding", r"token_embedding"),
    ],
}


def flax_leaves(module: torch.nn.Module, kind: str
                ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """The inverse of `flax_entries` for a UNet ("unet"), a VAE ("vae") or
    a CLIP text tower ("clip_text"): each parameter's path in the JAX
    package's tree (under "params") and its value in flax's layout — a
    Linear weight as the (in, out) kernel, a Conv2d weight as HWIO, a norm
    weight as `scale`, an Embedding's as `embedding` — as views, copying
    nothing."""
    if kind not in _INVERSE:
        raise ValueError(f"no inverse for module kind {kind!r}")
    owners = dict(module.named_modules())
    for name, p in module.named_parameters():
        prefix, leaf = name.rsplit(".", 1)
        owner = owners[prefix]
        if kind == "clip_text" and name == \
                "embeddings.position_embedding.weight":
            yield ("params", "position_embedding"), p.detach()
            continue
        for pat, rep in _INVERSE[kind]:
            prefix = re.sub(pat, rep, prefix)
        value = p.detach()
        if leaf == "weight":
            if isinstance(owner, torch.nn.Linear):
                leaf, value = "kernel", value.T
            elif isinstance(owner, torch.nn.Conv2d):
                leaf, value = "kernel", value.permute(2, 3, 1, 0)
            elif isinstance(owner, torch.nn.Embedding):
                leaf = "embedding"
            else:
                leaf = "scale"
        yield ("params", *prefix.split("."), leaf), value


def load_flax_params(module: torch.nn.Module, tree: Mapping[str, Any],
                     kind: str) -> torch.nn.Module:
    """Copy a JAX parameter tree into `module` (every key must match),
    keeping each tensor's device and dtype."""
    state = state_dict_from_flax(tree, kind)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the module: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}")
    for k, v in state.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict({k: v.to(own[k]) for k, v in state.items()})
    return module
