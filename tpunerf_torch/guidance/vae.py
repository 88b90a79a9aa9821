"""AutoencoderKL — Stable Diffusion's VAE.

Called with NHWC images and latents, as the JAX package's VAE is; it runs
NCHW inside. Module names follow diffusers' `AutoencoderKL`
(`decoder.up_blocks.0.resnets.1.conv1`, `encoder.mid_block.attentions.0
.to_q`, …), so a diffusers state dict maps onto it by name. Encode returns
the diagonal-Gaussian moments so callers can sample (`encode_imgs`) or take
the mode. The VAE stays f32.

The mid-block's single-head attention: at head widths ≤ 128 and N ≥ 2048
tokens it goes through the port's attention kernel (kernels/attention.py),
as the JAX package sends that case to its flash kernel; the SD-v1 width
(C = 512) stays a plain matmul + softmax, which at a 128² latent is a
16384² f32 score matrix (1 GiB).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpunerf_torch.kernels.attention import attention, attention_plain

LATENT_SCALE = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32

    @classmethod
    def sd_v1(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(16, 32, 32), layers_per_block=1,
                   norm_num_groups=4)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the pixels of the mid block."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        N = H * W
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, N, C)
        q, k, v = (proj(h)[:, None] for proj in
                   (self.to_q, self.to_k, self.to_v))       # (B, 1, N, C)
        if N >= 2048 and N % 1024 == 0 and C <= 128:
            h = attention(q, k, v, C ** -0.5)
        else:
            h = attention_plain(q, k, v, C ** -0.5)
        h = self.to_out[0](h[:, 0])
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _Level(nn.Module):
    """One resolution level (diffusers' `down_blocks.i` / `up_blocks.i` /
    `mid_block`): resnets, optional attentions, optional resampling conv."""

    def __init__(self, resnets, attentions=(), sampler_name: str = "",
                 sampler: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _Conv(nn.Module):
    """A resampling conv under diffusers' `….0.conv` name."""

    def __init__(self, channels: int, **kw):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, **kw)


def _mid(channels: int, groups: int) -> _Level:
    return _Level([VAEResnet(channels, channels, groups),
                   VAEResnet(channels, channels, groups)],
                  [VAEAttention(channels, groups)])


def _run_mid(mid: _Level, h: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg, g = config, config.norm_num_groups
        chans = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        blocks, ch = [], chans[0]
        for i, out_ch in enumerate(chans):
            res = []
            for _ in range(cfg.layers_per_block):
                res.append(VAEResnet(ch, out_ch, g))
                ch = out_ch
            blocks.append(_Level(
                res, (), "downsamplers",
                _Conv(ch, stride=2) if i < len(chans) - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(ch, g)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                # pad (0, 1) × (0, 1), then stride 2
                h = block.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg, g = config, config.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0], g)
        blocks, ch = [], rev[0]
        for i, out_ch in enumerate(rev):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(VAEResnet(ch, out_ch, g))
                ch = out_ch
            blocks.append(_Level(
                res, (), "upsamplers",
                _Conv(ch, padding=1) if i < len(rev) - 1 else None))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def encode_moments(self, images: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) in [−1, 1] → (mean, logvar) of the latent
        posterior, each (B, H/8, W/8, 4)."""
        moments = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, h, w, 4) → images (B, 8h, 8w, 3) in [−1, 1]
        (before the caller's /2 + .5)."""
        z = (latents / LATENT_SCALE).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


def _sample(mean: torch.Tensor, logvar: torch.Tensor,
            noise: Optional[torch.Tensor],
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
    return mean + torch.exp(0.5 * logvar) * noise.to(mean)


def encode_imgs(vae: AutoencoderKL, images01: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[0, 1] images → scaled latents, sampling the posterior. The standard
    normal `noise` (B, H/8, W/8, 4) is drawn from `generator` unless
    given."""
    mean, logvar = vae.encode_moments(images01 * 2.0 - 1.0)
    return _sample(mean, logvar, noise, generator) * LATENT_SCALE


def encode_imgs_mode(vae: AutoencoderKL, images01: torch.Tensor
                     ) -> torch.Tensor:
    """Deterministic (posterior-mode) encode, for texture init."""
    mean, _ = vae.encode_moments(images01 * 2.0 - 1.0)
    return mean * LATENT_SCALE


def decode_latents(vae: AutoencoderKL, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents → [0, 1] images."""
    return (vae.decode(latents) / 2.0 + 0.5).clamp(0.0, 1.0)
