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
    `CLIPTextModel`. A leading "params" collection is unwrapped."""
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
    if kind not in _RENAMES:
        raise ValueError(f"unknown parameter tree kind {kind!r}")
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, value in _leaves(tree):
        parts: List[str] = []
        for p in path[:-1]:
            for pat, rep in _RENAMES[kind]:
                p = re.sub(pat, rep, p)
            parts.append(p)
        leaf, value = _leaf(path[-1], value)
        if kind == "clip_text" and path == ("position_embedding",):
            parts, leaf = [], "embeddings.position_embedding.weight"
        name = ".".join(parts + [leaf])
        if kind == "unet":
            for old, new in _UNET_FF:
                name = name.replace(old, new)
        out[name] = torch.from_numpy(np.array(value))   # a writable copy
    return out


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
