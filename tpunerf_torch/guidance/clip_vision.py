"""CLIP vision tower and the image/text similarity losses.

The ViT of CLIP's `encode_image` (ViT-L/14 or ViT-B/32) and the vision
backbone of Paint-by-Example's exemplar encoder: patch convolution without
bias, class token, learned positions, pre-LN transformer with quick-GELU,
post-LN on the class token and, in `CLIPImageEmbedder`, a linear projection
to the shared embedding space. The layers are the text tower's
(`clip_text.CLIPLayer`) without the causal mask. Plain PyTorch throughout:
257 tokens at ViT-L/14, and the JAX package calls no kernel here either.

Module names follow transformers' `CLIPVisionModelWithProjection`
(`vision_model.embeddings.patch_embedding`, `vision_model.pre_layrnorm` —
upstream's spelling —, `vision_model.encoder.layers.{i}.self_attn.q_proj`,
`visual_projection`), so its state dict maps onto the port by name.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from tpunerf_torch.guidance.clip_text import CLIPEncoder
from tpunerf_torch.kernels import texture as texk

# CLIP's preprocessing constants
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768

    @classmethod
    def vit_l_14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def vit_b_32(cls) -> "CLIPVisionConfig":
        return cls(patch_size=32, hidden_size=768, num_layers=12,
                   num_heads=12, intermediate_size=3072, projection_dim=512)

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64, projection_dim=16)

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        D, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.patch_embedding = nn.Conv2d(3, D, p, stride=p, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, D)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) → (B, 1 + patches, D): the class token, then the
        patches in row order, plus the positions."""
        x = self.patch_embedding(pixel_values.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.position_embedding.weight[None].to(x.dtype)


class CLIPVisionTransformer(nn.Module):
    """transformers' `vision_model`: embeddings, pre-LN, layers, post-LN."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, pixel_values: torch.Tensor,
                return_sequence: bool = False) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x)
        if return_sequence:
            return x.float()
        return self.post_layernorm(x[:, 0]).float()


class CLIPVisionModel(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)

    def forward(self, pixel_values: torch.Tensor,
                return_sequence: bool = False) -> torch.Tensor:
        """pixel_values (B, H, W, 3), CLIP-normalised → the pooled class
        embedding (B, D) after the post-LN, or with `return_sequence` the
        whole (B, N, D) sequence before it, f32."""
        return self.vision_model(pixel_values, return_sequence)


class CLIPImageEmbedder(nn.Module):
    """The vision tower and the projection to the shared space
    (`encode_image`)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixel_values)).float()


def init_vision_embeddings_(vision: CLIPVisionTransformer,
                            generator: Optional[torch.Generator]
                            ) -> CLIPVisionTransformer:
    """flax's N(0, 0.02²) class token and position table, drawn after the
    rest (as `init_like_flax_` leaves them)."""
    emb = vision.embeddings
    with torch.no_grad():
        emb.class_embedding.normal_(0.0, 0.02, generator=generator)
        emb.position_embedding.weight.normal_(0.0, 0.02, generator=generator)
    return vision


def clip_preprocess(images01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[0, 1] NHWC → resized (JAX's bilinear, antialiased when shrinking)
    and CLIP-normalised."""
    if images01.shape[1:3] != (size, size):
        images01 = texk.resize_bilinear(images01, size, size)
    mean, std = _clip_norm(images01.device, images01.dtype)
    return (images01 - mean) / std


@functools.lru_cache(maxsize=8)
def _clip_norm(device: torch.device, dtype: torch.dtype):
    """CLIP's mean and std on `device` in `dtype`, copied once: a copy from
    the host inside a training step is what a CUDA graph's capture
    refuses."""
    return (torch.from_numpy(CLIP_IMAGE_MEAN).to(device, dtype),
            torch.from_numpy(CLIP_IMAGE_STD).to(device, dtype))


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def img_clip_loss(embed_fn: Callable, rgb1: torch.Tensor, rgb2: torch.Tensor,
                  size: int = 224) -> torch.Tensor:
    """−cos(E(rgb1), E(rgb2)), averaged over the batch."""
    z1 = _unit(embed_fn(clip_preprocess(rgb1, size)))
    z2 = _unit(embed_fn(clip_preprocess(rgb2, size)))
    return -torch.mean(torch.sum(z1 * z2, dim=-1))


def img_text_clip_loss(embed_fn: Callable, rgb: torch.Tensor,
                       text_z: torch.Tensor, size: int = 224
                       ) -> torch.Tensor:
    """−cos(E(rgb), text_z), averaged over the batch."""
    z = _unit(embed_fn(clip_preprocess(rgb, size)))
    return -torch.mean(torch.sum(z * _unit(text_z), dim=-1))
