"""CLIP text encoder + tokenizer front-end.

The 12-layer causal transformer of CLIP ViT-L/14's text tower (hidden 768,
quick-gelu, final layer norm); the output is the full (B, 77, 768) sequence
used as UNet cross-attention context. Module names follow the transformers
`CLIPTextModel` (without its `text_model.` prefix).

Tokenization: with a CLIP vocab (vocab.json + merges.txt) on disk a real
BPE tokenizer is used (`BPETokenizer`); otherwise the deterministic
`HashTokenizer` keeps the pipeline runnable offline.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072

    @classmethod
    def vit_l_14(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                   max_length=16, intermediate_size=64)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    """Multi-head self-attention: q scaled before the product, the softmax
    in f32 (over the keys `mask` allows, every key without one), the
    probabilities cast back to v's dtype. `cfg` is the text or the vision
    tower's config: it reads `hidden_size` and `num_heads`."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.num_heads
        q = self.q_proj(x) * (hd ** -0.5)
        k = self.k_proj(x)
        v = self.v_proj(x)

        def split(t):
            return t.reshape(B, N, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        if mask is not None:
            attn = torch.where(mask, attn, torch.full_like(attn, -1e9))
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    """A pre-LN quick-GELU layer of either tower (the text's is causal)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class CLIPEncoder(nn.Module):
    """`cfg.num_layers` layers, under transformers' `encoder.layers` name
    in both towers."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg)
                                    for _ in range(cfg.num_layers))


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = CLIPEmbeddings(config)
        self.encoder = CLIPEncoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size, eps=1e-5)

    def forward(self, input_ids: Optional[torch.Tensor],
                input_embeddings: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """(B, L) token ids → (B, L, D) final hidden states (post final LN),
        f32. `input_embeddings` (B, L, D) bypasses the token table (the ids
        are then not read): the path that is differentiable to the token
        embeddings, which text-token optimisation trains."""
        emb = self.embeddings
        if input_embeddings is None:
            x = emb.token_embedding(input_ids)
        else:
            x = input_embeddings.to(emb.token_embedding.weight.dtype)
        L = x.shape[1]
        x = x + emb.position_embedding.weight[None, :L]
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=x.device))[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x).float()


# ---------------------------------------------------------------------------
# Tokenizers (the JAX package's host code)
# ---------------------------------------------------------------------------

class HashTokenizer:
    """Deterministic offline stand-in for the CLIP BPE tokenizer.

    Same interface and special-token layout (BOS/EOS/pad-with-EOS,
    max_length truncation); ids are FNV-hashed words — NOT
    weight-compatible. `add_token` gives a textual-inversion concept the
    next id past the table; a word equal to it takes that id."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1
        self._extra: dict = {}

    def add_token(self, token: str) -> int:
        tid = self.vocab_size + len(self._extra)
        if token in self._extra:
            raise ValueError(f"tokenizer already contains token {token!r}")
        self._extra[token] = tid
        return tid

    def _word_id(self, word: str) -> int:
        if word in self._extra:
            return self._extra[word]
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h % (self.vocab_size - 2)

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        out = np.full((len(prompts), self.max_length), self.eos_id, np.int32)
        for i, p in enumerate(prompts):
            words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", p.lower())
            ids = [self.bos_id] + [self._word_id(w) for w in words]
            ids = ids[: self.max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


class BPETokenizer:
    """CLIP byte-pair-encoding tokenizer from on-disk vocab.json/merges.txt
    (the data files of openai/clip-vit-large-patch14)."""

    def __init__(self, vocab_path: Path, merges_path: Path,
                 max_length: int = 77):
        self.max_length = max_length
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        merges = Path(merges_path).read_text().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.cache = {}
        self.pat = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        out = np.full((len(prompts), self.max_length), self.eos_id, np.int32)
        for i, p in enumerate(prompts):
            text = re.sub(r"\s+", " ", p.lower().strip())
            ids: List[int] = [self.bos_id]
            for tok in self.pat.findall(text):
                for piece in self._bpe(tok):
                    ids.append(self.encoder.get(
                        piece, self.encoder.get("</w>", self.eos_id)))
            ids = ids[: self.max_length - 1] + [self.eos_id]
            out[i, : len(ids)] = ids
        return out


def make_tokenizer(model_dir: Optional[Path] = None,
                   vocab_size: int = 49408,
                   max_length: int = 77):
    """Real BPE if vocab files exist under `model_dir/tokenizer`, else hash."""
    if model_dir is not None:
        tok_dir = Path(model_dir) / "tokenizer"
        v, m = tok_dir / "vocab.json", tok_dir / "merges.txt"
        if v.exists() and m.exists():
            return BPETokenizer(v, m, max_length)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
