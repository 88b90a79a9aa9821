"""UNet2DCondition — the Stable-Diffusion ε-prediction backbone.

Called with NHWC latents, as the JAX package's UNet is; it runs NCHW
inside. Module names follow diffusers' `UNet2DConditionModel`
(`down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q`, …), so a
diffusers state dict maps onto it by name. The long self-attention of the
64² level (N ≥ 2048 tokens) goes through the hand-written attention kernel
(kernels/attention.py); other attention stays plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpunerf_torch.kernels.attention import attention, attention_plain


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_num_heads: int = 8
    norm_num_groups: int = 32
    # which down/up blocks carry cross-attention transformers; SD v1:
    # down (T, T, T, F), up (F, T, T, T)
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    up_block_has_attn: Tuple[bool, ...] = (False, True, True, True)

    @classmethod
    def sd_v1(cls, in_channels: int = 4, out_channels: int = 4
              ) -> "UNetConfig":
        """in_channels 4: SD v1; 5: depth-conditioned ([latent, depth]); 9:
        inpainting ([latent, mask, masked latent])."""
        return cls(in_channels=in_channels, out_channels=out_channels)

    @classmethod
    def tiny(cls, in_channels: int = 4, out_channels: int = 4
             ) -> "UNetConfig":
        """A structurally identical miniature for tests."""
        return cls(in_channels=in_channels, out_channels=out_channels,
                   block_out_channels=(32, 64), layers_per_block=1,
                   cross_attention_dim=32,
                   attention_num_heads=4, norm_num_groups=8,
                   down_block_has_attn=(True, False),
                   up_block_has_attn=(False, True))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, diffusers convention (flip_sin_to_cos=True,
    downscale_freq_shift=0) → [cos | sin], f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, temb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(temb)))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


# the kernel takes the long self-attention of the 64² level, as the JAX
# package sends N ≥ 2048 (and N % 1024 == 0) to its flash kernel
_FLASH_MIN_SEQ = 2048


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        is_self = context is None
        context = x if context is None else context
        B, N, inner = x.shape
        head_dim = inner // self.num_heads

        def split(t):   # (B, M, inner) → (B, H, M, D) view
            return t.view(B, t.shape[1], self.num_heads,
                          head_dim).transpose(1, 2)

        q = split(self.to_q(x))
        k = split(self.to_k(context))
        v = split(self.to_v(context))
        if is_self and N >= _FLASH_MIN_SEQ and N % 1024 == 0:
            out = attention(q, k, v, head_dim ** -0.5)
        else:
            out = attention_plain(q, k, v, head_dim ** -0.5)
        return self.to_out[0](out.transpose(1, 2).reshape(B, N, inner))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax's gelu is the tanh approximation
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, context_dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, num_heads: int,
                 groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, num_heads)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers pads (0, 1) × (0, 1), then strides 2
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """A resolution level: resnets, optional transformers, optional
    down/upsampler (diffusers' `down_blocks.i` / `up_blocks.i`)."""

    def __init__(self, resnets, attentions, sampler_name: str, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        self.sampler_name = sampler_name
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def sampler(self) -> Optional[nn.Module]:
        samplers = getattr(self, self.sampler_name, None)
        return None if samplers is None else samplers[0]


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        g, heads, ctx = (cfg.norm_num_groups, cfg.attention_num_heads,
                         cfg.cross_attention_dim)
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim)

        skips = [ch0]
        down, ch = [], ch0
        for i, out_ch in enumerate(cfg.block_out_channels):
            res, att = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ResnetBlock(ch, out_ch, temb_dim, g))
                if cfg.down_block_has_attn[i]:
                    att.append(Transformer2D(out_ch, ctx, heads, g))
                ch = out_ch
                skips.append(ch)
            sampler = Downsample(out_ch) if i < n - 1 else None
            if sampler is not None:
                skips.append(ch)
            down.append(_Block(res, att, "downsamplers", sampler))
        self.down_blocks = nn.ModuleList(down)

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock(mid, mid, temb_dim, g),
             ResnetBlock(mid, mid, temb_dim, g)],
            [Transformer2D(mid, ctx, heads, g)], "upsamplers", None)

        up = []
        for i, out_ch in enumerate(reversed(cfg.block_out_channels)):
            res, att = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ResnetBlock(ch + skips.pop(), out_ch, temb_dim, g))
                if cfg.up_block_has_attn[i]:
                    att.append(Transformer2D(out_ch, ctx, heads, g))
                ch = out_ch
            up.append(_Block(res, att, "upsamplers",
                             Upsample(out_ch) if i < n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """sample (B, H, W, C_in), timesteps (B,) or scalar,
        encoder_hidden_states (B, L, D_ctx) → ε (B, H, W, C_out), f32."""
        dtype = self.conv_in.weight.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        ch0 = self.config.block_out_channels[0]
        temb = self.time_embedding(timestep_embedding(timesteps, ch0)
                                   .to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx)
                skips.append(h)
            if block.sampler() is not None:
                h = block.sampler()(h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, ctx)
        h = mid.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    h = block.attentions[j](h, ctx)
            if block.sampler() is not None:
                h = block.sampler()(h)

        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1).float()
