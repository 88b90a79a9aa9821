"""UV texture sampling (nearest / bilinear / bicubic) and image resizes.

The JAX package's module is XLA gathers, not a TPU kernel, written to be
`grid_sample(align_corners=False, padding_mode='zeros')` after the uv → grid
conversion and `F.interpolate(mode='bicubic')` (Keys' cubic convolution,
a = −0.75); the port calls those two directly. The latent-NeRF eval render
resizes with `jax.image.resize(method='bicubic')` instead, which is another
filter: `resize_cubic_jax` builds its weights, and `resize_bilinear` the
weights of `jax.image.resize(method='bilinear')`. Both resize by two
matrix products, whose backward (unlike `F.interpolate`'s on the card,
which adds with atomics) is deterministic. Textures and images are
NHWC; uv ∈ [0,1]² with v flipped (texture row 0 is v = 1). The gradient
flows to the texture (and, except in nearest mode, to the uv coordinates).
"""
from __future__ import annotations

import numpy as np
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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = −0.5 at |offsets| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """The linear (tent) kernel max(0, 1 − x) at |offsets| x."""
    return torch.clamp(1.0 - x, min=0.0)


def _resize_weights(n_in: int, n_out: int, kernel, device: torch.device
                    ) -> torch.Tensor:
    """(n_in, n_out) f32 weights of one axis of `jax.image.resize` (its
    `compute_weight_mat` with `kernel`, Keys' cubic or the tent): half-pixel
    centres, the kernel widened by n_in/n_out when shrinking (antialiased),
    each column renormalised over the taps inside the image, and columns
    whose sample lies outside the image zeroed.

    The sample positions (i + 0.5)·inv − 0.5 are rounded to f32 once, as
    the fused multiply-add of JAX's compiled resize rounds them (an f32
    product and difference move a position near 256 by an ulp, 3e-5, and a
    weight by as much); offsets are f32 as JAX's, the kernel and its
    normalisation float64, rounded to f32 at the end."""
    f32, f64 = torch.float32, torch.float64
    inv = float(np.float32(1.0 / (n_out / n_in)))
    sample = ((torch.arange(n_out, dtype=f64, device=device) + 0.5) * inv
              - 0.5).to(f32)
    x = (sample[None, :] - torch.arange(n_in, dtype=f32, device=device)[
        :, None]).abs() / max(inv, 1.0)
    w = kernel(x.to(f64))
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(f32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(f32)


def _resize_jax(image: torch.Tensor, height: int, width: int, kernel
                ) -> torch.Tensor:
    """out = W_yᵀ · image · W_x per channel, each product only on an axis
    that changes size."""
    B, H, W, C = image.shape
    out = image
    if H != height:
        wy = _resize_weights(H, height, kernel, image.device).to(image.dtype)
        out = torch.einsum("bhwc,hy->bywc", out, wy)
    if W != width:
        wx = _resize_weights(W, width, kernel, image.device).to(image.dtype)
        out = torch.einsum("bhwc,wx->bhxc", out, wx)
    return out


def resize_cubic_jax(image: torch.Tensor, height: int, width: int
                     ) -> torch.Tensor:
    """NHWC resize equal to `jax.image.resize(image, (B, height, width, C),
    method='bicubic')`: Keys' kernel with a = −0.5, antialiased when
    shrinking, the weights renormalised at the borders (not
    `resize_bicubic`'s a = −0.75 with clamped indices)."""
    return _resize_jax(image, height, width, _keys_cubic)


def resize_bilinear(image: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """NHWC resize equal to `jax.image.resize(image, (B, height, width, C),
    method='bilinear')`: the tent with half-pixel centres, widened by the
    scale when shrinking (antialiased), renormalised at the borders (which
    replicates the edge pixel when enlarging, as `F.interpolate` clamps)."""
    return _resize_jax(image, height, width, _triangle)
