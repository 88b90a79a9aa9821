"""Pretrained weights from a diffusers- or transformers-layout directory.

    model_dir/
      unet/diffusion_pytorch_model.safetensors   (or .bin)
      vae/diffusion_pytorch_model.safetensors
      text_encoder/model.safetensors             (or pytorch_model.*)
      image_encoder/model.safetensors            (Paint-by-Example)
      tokenizer/vocab.json, merges.txt           (clip_text.make_tokenizer)

and a CLIP tower's directory (`CLIPVisionModelWithProjection`: model.* or
pytorch_model.*) are read onto the port's modules in place: SD v1.x, the
5-channel depth UNet, the 9-channel inpainting and Paint-by-Example UNets,
the VAE, the CLIP text and vision towers and the Paint-by-Example exemplar
encoder. The modules carry diffusers' and transformers' names, so a file's
keys map onto them by name; the aliases the JAX package's converters take
are taken here too: the VAE attention's two namings (`group_norm`, `to_q`
… `to_out.0`, or `norm`, `query`, `key`, `value`, `proj_attn`), the
optional `text_model.` and `vision_model.` prefixes, `pre_layrnorm` or
`pre_layernorm`, and the encoder's tower under `model.`.

The checks are the JAX package's: a key the module needs and the file
lacks raises KeyError; a resnet shortcut or a `visual_projection` on one
side only raises ValueError ("param-tree mismatch"), as does a leaf of
another shape (a 2-D `proj_in` of an SD-2 snapshot where the UNet has a
1×1 convolution among them). Keys no module reads (`position_ids`, …) are
ignored. Values are cast to each parameter's dtype as they are copied (F16
or BF16 into f32 exactly, f32 into the bf16 UNet rounded to nearest even),
so a loaded module equals the JAX package's loaded tree.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from tpunerf_torch.safetensors_io import read_safetensors

StateDict = Dict[str, torch.Tensor]

# the older diffusers names of the VAE's attention leaves
_VAE_ATTN_OLD = {"group_norm": "norm", "to_q": "query", "to_k": "key",
                 "to_v": "value", "to_out.0": "proj_attn"}
_VAE_ATTN = re.compile(r"^((?:en|de)coder\.mid_block\.attentions\.\d+)\."
                       r"(group_norm|to_q|to_k|to_v|to_out\.0)\.(\w+)$")
_RESNET = re.compile(r"^(.*resnets\.\d+)\.norm1\.weight$")


def _load_state_dict(path_base: Path) -> StateDict:
    """`path_base`.safetensors, else `path_base`.bin."""
    st = path_base.with_suffix(".safetensors")
    if st.exists():
        return read_safetensors(st)
    bin_path = path_base.with_suffix(".bin")
    if bin_path.exists():
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no checkpoint at {path_base}(.safetensors/.bin)")


def _load_model_or_pytorch_model(directory: Path) -> StateDict:
    """transformers' two file names: `model` first, then `pytorch_model`."""
    try:
        return _load_state_dict(directory / "model")
    except FileNotFoundError:
        return _load_state_dict(directory / "pytorch_model")


def _vision_key(sd: Mapping[str, torch.Tensor], tower: str
                ) -> Callable[[str], str]:
    """A CLIP vision tower's file key of a leaf name under `vision_model.`,
    where the file's tower keys start with `tower` (with or without the
    `vision_model.` prefix, `pre_layrnorm` or `pre_layernorm`)."""
    pre = tower + ("vision_model." if any(
        k.startswith(tower + "vision_model.") for k in sd) else "")
    pre_ln = ("pre_layrnorm" if f"{pre}pre_layrnorm.weight" in sd
              else "pre_layernorm")

    def key(leaf: str) -> str:
        if leaf.startswith("pre_layrnorm."):
            leaf = pre_ln + leaf[len("pre_layrnorm"):]
        return pre + leaf
    return key


def _file_key(kind: str, sd: Mapping[str, torch.Tensor]
              ) -> Callable[[str], str]:
    """The file key a module's parameter name is read from."""
    if kind == "unet":
        return lambda name: name
    if kind == "vae":
        def vae_key(name: str) -> str:
            m = _VAE_ATTN.match(name)
            if m is None or f"{m.group(1)}.to_q.weight" in sd:
                return name
            return (f"{m.group(1)}.{_VAE_ATTN_OLD[m.group(2)]}."
                    f"{m.group(3)}")
        return vae_key
    if kind == "clip_text":
        pre = ("text_model." if any(k.startswith("text_model.") for k in sd)
               else "")
        return lambda name: pre + name
    if kind in ("clip_vision", "pbe_image_encoder"):
        outer = "vision_model." if kind == "clip_vision" else \
            "model.vision_model."
        vision = _vision_key(sd, "" if kind == "clip_vision" else "model.")
        return lambda name: (vision(name[len(outer):])
                             if name.startswith(outer) else name)
    raise ValueError(f"unknown module kind {kind!r}")


def _optional_groups(kind: str, names) -> Dict[str, Tuple[str, ...]]:
    """The leaves the JAX converters take only where the file has them:
    each resnet's `conv_shortcut` and the tower's `visual_projection`,
    {module prefix: its leaves}."""
    if kind in ("unet", "vae"):
        return {f"{m.group(1)}.conv_shortcut": ("weight", "bias")
                for m in map(_RESNET.match, names) if m}
    if kind == "clip_vision":
        return {"visual_projection": ("weight",)}
    return {}


def convert(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
            kind: str, what: str) -> StateDict:
    """The file's tensors for every parameter of `module`, by the port's
    names, checked as the JAX package's converters and `_check_tree` check
    them (see the module's docstring); kinds as the flax bridge's
    (`tpunerf_torch.weights`): "unet", "vae", "clip_text", "clip_vision",
    "pbe_image_encoder". Reads shapes only, so a module on the meta device
    and zero-stride tensors check a full-width layout in no memory."""
    own = {n: tuple(p.shape) for n, p in module.named_parameters()}
    key = _file_key(kind, sd)
    groups = _optional_groups(kind, own)
    out: StateDict = {}
    for name in own:
        if name.rsplit(".", 1)[0] not in groups:
            out[name] = sd[key(name)]
    for prefix, leaves in groups.items():
        if key(f"{prefix}.weight") in sd:
            for leaf in leaves:
                out[f"{prefix}.{leaf}"] = sd[key(f"{prefix}.{leaf}")]
    missing, extra = sorted(set(own) - set(out)), sorted(set(out) - set(own))
    if missing or extra:
        raise ValueError(f"{what}: param-tree mismatch; missing="
                         f"{missing[:5]} extra={extra[:5]}")
    for name, t in out.items():
        if tuple(t.shape) != own[name]:
            raise ValueError(f"{what}: shape mismatch at {name}: "
                             f"{tuple(t.shape)} vs expected {own[name]}")
    return out


def fill_(module: torch.nn.Module, tensors: Mapping[str, torch.Tensor],
          device: Optional[torch.device] = None) -> torch.nn.Module:
    """Copy `convert`'s tensors into `module`, cast to each parameter's
    dtype; a module on the meta device is first given storage on
    `device`. Frozen and in eval mode after."""
    if device is not None and any(p.is_meta for p in module.parameters()):
        module.to_empty(device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if not p.is_meta:
                p.copy_(tensors[name])
    return module.requires_grad_(False).eval()


def load_unet_params(model_dir: Path, unet: torch.nn.Module,
                     device: Optional[torch.device] = None
                     ) -> torch.nn.Module:
    """Just a UNet from a diffusers-layout directory (the depth backend's
    9-channel inpainting UNet)."""
    sd = _load_state_dict(Path(model_dir) / "unet" / "diffusion_pytorch_model")
    return fill_(unet, convert(unet, sd, "unet", "inpaint_unet"), device)


def load_clip_vision_params(model_dir: Path, embedder: torch.nn.Module,
                            device: Optional[torch.device] = None
                            ) -> torch.nn.Module:
    """A transformers `CLIPVisionModelWithProjection` directory onto a
    `CLIPImageEmbedder` (the tower of the CLIP losses)."""
    model_dir = Path(model_dir)
    try:
        sd = _load_model_or_pytorch_model(model_dir)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no model(.safetensors/.bin) under {model_dir}") from None
    return fill_(embedder, convert(embedder, sd, "clip_vision",
                                   "clip_vision"), device)


def load_pbe_params(model_dir: Path, unet: torch.nn.Module,
                    vae: torch.nn.Module, image_encoder: torch.nn.Module,
                    device: Optional[torch.device] = None
                    ) -> Tuple[torch.nn.Module, ...]:
    """A diffusers-layout Paint-by-Example directory (unet/, vae/,
    image_encoder/): every file is read and checked before any module is
    given storage."""
    model_dir = Path(model_dir)
    unet_sd = _load_state_dict(model_dir / "unet" / "diffusion_pytorch_model")
    vae_sd = _load_state_dict(model_dir / "vae" / "diffusion_pytorch_model")
    enc_sd = _load_model_or_pytorch_model(model_dir / "image_encoder")
    parts = [(unet, convert(unet, unet_sd, "unet", "unet")),
             (vae, convert(vae, vae_sd, "vae", "vae")),
             (image_encoder, convert(image_encoder, enc_sd,
                                     "pbe_image_encoder", "image_encoder"))]
    return tuple(fill_(m, t, device) for m, t in parts)


def load_sd_params(model_dir: Path, unet: torch.nn.Module,
                   vae: torch.nn.Module, text: torch.nn.Module,
                   device: Optional[torch.device] = None
                   ) -> Tuple[torch.nn.Module, ...]:
    """A diffusers-layout SD directory (unet/, vae/, text_encoder/): every
    file is read and checked before any module is given storage."""
    model_dir = Path(model_dir)
    unet_sd = _load_state_dict(model_dir / "unet" / "diffusion_pytorch_model")
    vae_sd = _load_state_dict(model_dir / "vae" / "diffusion_pytorch_model")
    text_sd = _load_model_or_pytorch_model(model_dir / "text_encoder")
    parts = [(unet, convert(unet, unet_sd, "unet", "unet")),
             (vae, convert(vae, vae_sd, "vae", "vae")),
             (text, convert(text, text_sd, "clip_text", "text_encoder"))]
    return tuple(fill_(m, t, device) for m, t in parts)
