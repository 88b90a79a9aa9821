"""Plain PyTorch SD-v1 guidance: the UNet, CLIP ViT-L/14's text tower, the
VAE, the offline hash tokenizer, the DDPM schedule and the SDS loss.

A frozen copy of the published SD-v1 layer equations (CompVis
`stable-diffusion`, `configs/stable-diffusion/v1-inference.yaml`; module
names as diffusers' `UNet2DConditionModel`, `AutoencoderKL` and
transformers' `CLIPTextModel`, so that one set of named weights serves the
program and this reference). Images and latents are NHWC at the
interfaces, NCHW inside. Everything computes in float32; every product goes
through `precision.Linear` / `precision.Conv2d`, so the control can round
its operands. Attention is softmax(q·kᵀ·scale)·v in full.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.precision import Conv2d, Linear, matmul

LATENT_SCALE = 0.18215


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, kind: Optional[str] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, N, D) softmax attention in float32."""
    s = matmul(q, k.transpose(-1, -2), kind) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e9))
    return matmul(torch.softmax(s, dim=-1), v, kind)


# --------------------------------------------------------------------------
# UNet
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos | sin] of t·10000^(−i/half) (flip_sin_to_cos, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-5)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-5)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(context_dim, dim, bias=False)
        self.to_v = Linear(context_dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        B, N, C = x.shape
        d = C // self.heads

        def split(t):
            return t.view(B, t.shape[1], self.heads, d).transpose(1, 2)

        out = attention(split(self.to_q(x)), split(self.to_k(context)),
                        split(self.to_v(context)), d ** -0.5,
                        self.to_q.kind)
        return self.to_out[0](out.transpose(1, 2).reshape(B, N, C))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, context_dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.proj_in = Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, context_dim, heads)])
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(
            B, H * W, C)
        h = self.transformer_blocks[0](h, context)
        return self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2)) + x


class Level(nn.Module):
    """diffusers' down_blocks.i / up_blocks.i / mid_block."""

    def __init__(self, resnets, attentions, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self.sampler_name = sampler_name
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))

    def sampler(self):
        s = getattr(self, self.sampler_name, None) if self.sampler_name \
            else None
        return None if s is None else s[0]


class Down(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Up(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet(nn.Module):
    """ε-prediction UNet of `widths` (block_out_channels), `layers`
    resnets a level, cross-attention transformers where `down_attn` /
    `up_attn` say."""

    def __init__(self, in_channels: int, out_channels: int,
                 widths: Sequence[int], layers: int, context_dim: int,
                 heads: int, groups: int, down_attn: Sequence[bool],
                 up_attn: Sequence[bool]):
        super().__init__()
        ch0, temb = widths[0], widths[0] * 4
        self.ch0 = ch0
        self.conv_in = Conv2d(in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        skips, down, ch = [ch0], [], ch0
        for i, out in enumerate(widths):
            res, att = [], []
            for _ in range(layers):
                res.append(ResnetBlock(ch, out, temb, groups))
                if down_attn[i]:
                    att.append(Transformer2D(out, context_dim, heads, groups))
                ch = out
                skips.append(ch)
            last = i == len(widths) - 1
            if not last:
                skips.append(ch)
            down.append(Level(res, att, "downsamplers",
                              None if last else Down(out)))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Level(
            [ResnetBlock(ch, ch, temb, groups),
             ResnetBlock(ch, ch, temb, groups)],
            [Transformer2D(ch, context_dim, heads, groups)])
        up = []
        for i, out in enumerate(reversed(widths)):
            res, att = [], []
            for _ in range(layers + 1):
                res.append(ResnetBlock(ch + skips.pop(), out, temb, groups))
                if up_attn[i]:
                    att.append(Transformer2D(out, context_dim, heads, groups))
                ch = out
            last = i == len(widths) - 1
            up.append(Level(res, att, "upsamplers", None if last else Up(out)))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(groups, ch0, eps=1e-5)
        self.conv_out = Conv2d(ch0, out_channels, 3, padding=1)

    def forward(self, sample, t, context):
        """sample (B, H, W, C), t (B,), context (B, L, D) → ε (B, H, W, C)."""
        temb = self.time_embedding(timestep_embedding(t, self.ch0))
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, context)
                skips.append(h)
            if block.sampler() is not None:
                h = block.sampler()(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h, temb),
                                             context), temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    h = block.attentions[j](h, context)
            if block.sampler() is not None:
                h = block.sampler()(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.permute(0, 2, 3, 1)


def unet_from(cfg: dict) -> UNet:
    """The UNet of a configuration file's "unet" group."""
    return UNet(cfg["in_channels"], cfg["out_channels"],
                cfg["block_out_channels"], cfg["layers_per_block"],
                cfg["cross_attention_dim"], cfg["attention_num_heads"],
                cfg["norm_num_groups"], cfg["down_block_has_attn"],
                cfg["up_block_has_attn"])


# --------------------------------------------------------------------------
# CLIP text tower and the offline tokenizer
# --------------------------------------------------------------------------

class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x, mask):
        B, N, D = x.shape
        d = D // self.heads

        def split(t):
            return t.reshape(B, N, self.heads, d).transpose(1, 2)

        out = attention(split(self.q_proj(x)), split(self.k_proj(x)),
                        split(self.v_proj(x)), d ** -0.5, self.q_proj.kind,
                        mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = Linear(dim, inner)
        self.fc2 = Linear(inner, dim)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, heads: int, inner: int):
        super().__init__()
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, inner)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPText(nn.Module):
    def __init__(self, vocab: int, dim: int, layers: int, heads: int,
                 max_length: int, inner: int):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(vocab, dim)
        self.embeddings.position_embedding = nn.Embedding(max_length, dim)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPLayer(dim, heads, inner)
                                            for _ in range(layers))
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embeddings.token_embedding(ids)
        L = x.shape[1]
        x = x + self.embeddings.position_embedding.weight[None, :L]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=x.device))[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


def clip_from(cfg: dict) -> CLIPText:
    return CLIPText(cfg["vocab_size"], cfg["hidden_size"], cfg["num_layers"],
                    cfg["num_heads"], cfg["max_length"],
                    cfg["intermediate_size"])


def tokenize(prompts: Sequence[str], vocab: int, max_length: int
             ) -> np.ndarray:
    """The offline tokenizer with no vocabulary on disk: BOS, FNV-1a
    hashes of the words modulo vocab − 2, EOS, padded with EOS."""
    bos, eos = vocab - 2, vocab - 1
    out = np.full((len(prompts), max_length), eos, np.int64)
    for i, p in enumerate(prompts):
        ids = [bos]
        for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", p.lower()):
            h = 2166136261
            for ch in w.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(h % (vocab - 2))
        ids = ids[:max_length - 1] + [eos]
        out[i, :len(ids)] = ids
    return out


DIRECTIONS = ("front view", "side view", "back view", "side view",
              "overhead view", "bottom view")


def direction_embeddings(clip: CLIPText, cfg: dict, text: str
                         ) -> torch.Tensor:
    """(6, 2, L, D): for each view direction, the [uncond ("" ), cond
    ("<text>, <direction>")] pair."""
    prompts = [f"{text}, {d}" for d in DIRECTIONS]
    dev = clip.final_layer_norm.weight.device
    ids = torch.as_tensor(tokenize(prompts + [""] * len(prompts),
                                   cfg["vocab_size"], cfg["max_length"]),
                          device=dev)
    with torch.no_grad():
        emb = clip(ids)
    n = len(prompts)
    return torch.stack([emb[n:], emb[:n]], dim=1)


def select_text(bank: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(2B, L, D), the uncond half first, of each view's direction."""
    sel = bank[dirs]
    return torch.cat([sel[:, 0], sel[:, 1]], dim=0)


# --------------------------------------------------------------------------
# VAE
# --------------------------------------------------------------------------

class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = Linear(ch, ch)
        self.to_k = Linear(ch, ch)
        self.to_v = Linear(ch, ch)
        self.to_out = nn.ModuleList([Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = attention(self.to_q(h)[:, None], self.to_k(h)[:, None],
                        self.to_v(h)[:, None], C ** -0.5, self.to_q.kind)
        out = self.to_out[0](out[:, 0])
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Resample(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, **kw)


def _mid(ch: int, groups: int) -> Level:
    return Level([VAEResnet(ch, ch, groups), VAEResnet(ch, ch, groups)],
                 [VAEAttention(ch, groups)])


class Encoder(nn.Module):
    def __init__(self, widths, layers: int, groups: int, latent: int):
        super().__init__()
        self.conv_in = Conv2d(3, widths[0], 3, padding=1)
        blocks, ch = [], widths[0]
        for i, out in enumerate(widths):
            res = []
            for _ in range(layers):
                res.append(VAEResnet(ch, out, groups))
                ch = out
            last = i == len(widths) - 1
            blocks.append(Level(res, (), "downsamplers",
                                None if last else Resample(ch, stride=2)))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _mid(ch, groups)
        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 2 * latent, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if block.sampler() is not None:
                h = block.sampler().conv(F.pad(h, (0, 1, 0, 1)))
        mid = self.mid_block
        h = mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    """Held for its weights' names and shapes only: no cell decodes."""

    def __init__(self, widths, layers: int, groups: int, latent: int):
        super().__init__()
        rev = list(reversed(widths))
        self.conv_in = Conv2d(latent, rev[0], 3, padding=1)
        self.mid_block = _mid(rev[0], groups)
        blocks, ch = [], rev[0]
        for i, out in enumerate(rev):
            res = []
            for _ in range(layers + 1):
                res.append(VAEResnet(ch, out, groups))
                ch = out
            last = i == len(rev) - 1
            blocks.append(Level(res, (), "upsamplers",
                                None if last else Resample(ch, padding=1)))
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-6)
        self.conv_out = Conv2d(ch, 3, 3, padding=1)


class VAE(nn.Module):
    def __init__(self, widths, layers: int, groups: int, latent: int = 4):
        super().__init__()
        self.encoder = Encoder(widths, layers, groups, latent)
        self.decoder = Decoder(widths, layers, groups, latent)
        self.quant_conv = Conv2d(2 * latent, 2 * latent, 1)
        self.post_quant_conv = Conv2d(latent, latent, 1)

    def encode(self, images01: torch.Tensor, noise: torch.Tensor
               ) -> torch.Tensor:
        """[0, 1] images (B, H, W, 3) → scaled latents sampled from the
        posterior with the standard normal `noise` (B, H/8, W/8, 4)."""
        x = (images01 * 2.0 - 1.0).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(x)).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = logvar.clamp(-30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * noise) * LATENT_SCALE


def vae_from(cfg: dict) -> VAE:
    return VAE(cfg["block_out_channels"], cfg["layers_per_block"],
               cfg["norm_num_groups"], cfg["latent_channels"])


# --------------------------------------------------------------------------
# schedule and SDS
# --------------------------------------------------------------------------

def alphas_cumprod(device, steps: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012) -> torch.Tensor:
    """SD's scaled-linear DDPM ᾱ table."""
    betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, steps,
                           dtype=torch.float32, device=device) ** 2
    return torch.cumprod(1.0 - betas, dim=0)


def sds_grad(unet: UNet, abar: torch.Tensor, latents: torch.Tensor,
             context: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             scale: float) -> torch.Tensor:
    """w(t)·(ε̂ − ε), ε̂ classifier-free guided from one [uncond; cond]
    pass, w(t) = √ᾱ_t·(1 − ᾱ_t). The SDS loss is Σ latents · sg(this)."""
    with torch.no_grad():
        a = abar[t]
        noisy = torch.sqrt(a) * latents.detach() + torch.sqrt(1.0 - a) * noise
        B = latents.shape[0]
        eps = unet(torch.cat([noisy, noisy]), t.reshape(1).expand(2 * B),
                   context)
        guided = eps[:B] + scale * (eps[B:] - eps[:B])
        return torch.sqrt(a) * (1.0 - a) * (guided - noise)
