"""UV texture sampling (nearest / bilinear / bicubic) and image resizes.

The JAX package's module is XLA gathers, not a TPU kernel, written to be
`grid_sample(align_corners=False, padding_mode='zeros')` after the uv → grid
conversion and `F.interpolate(mode='bicubic')` (Keys' cubic convolution,
a = −0.75); the port calls those two directly. Textures and images are
NHWC; uv ∈ [0,1]² with v flipped (texture row 0 is v = 1). The gradient
flows to the texture (and, except in nearest mode, to the uv coordinates).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = ("nearest", "bilinear", "bicubic")


def texture_mapping(texture_coordinates: torch.Tensor,
                    texture_maps: torch.Tensor, mode: str = "nearest"
                    ) -> torch.Tensor:
    """Batched UV sampling: texture_coordinates (B, ..., 2) uv in [0, 1],
    texture_maps (B, H, W, C) → (B, ..., C); zeros out of range."""
    if mode not in _MODES:
        raise ValueError(f"no interpolation mode {mode}")
    uv = texture_coordinates
    B, C = texture_maps.shape[0], texture_maps.shape[-1]
    # grid x = 2u − 1, grid y = 1 − 2v: texture row 0 is v = 1
    grid = torch.stack([uv[..., 0] * 2.0 - 1.0, 1.0 - uv[..., 1] * 2.0],
                       dim=-1).reshape(B, 1, -1, 2)
    out = F.grid_sample(texture_maps.permute(0, 3, 1, 2), grid, mode=mode,
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, C, -1).transpose(1, 2).reshape(*uv.shape[:-1], C)


def resize_bicubic(image: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """NHWC bicubic resize: the Keys a = −0.75 kernel with half-pixel
    centres and replicated edges, not antialiased."""
    out = F.interpolate(image.permute(0, 3, 1, 2), size=(height, width),
                        mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1)


def resize_bilinear(image: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres; a triangle filter
    widened by the scale when shrinking (antialiased), as the JAX package's
    `jax.image.resize(method='bilinear')` is."""
    out = F.interpolate(image.permute(0, 3, 1, 2), size=(height, width),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)
