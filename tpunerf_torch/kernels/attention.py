"""Non-causal attention forward: the CUDA kernel (csrc/attention.cu) and its
plain PyTorch version.

The UNet's long self-attention calls `attention`. On CUDA tensors it
launches the kernel; on CPU tensors it runs `attention_plain`, the
softmax(q·kᵀ·scale)·v of the JAX package's XLA path (guidance/unet.py:
209-212): f32 logits, f32 softmax, probabilities cast to v's dtype.
Forward only: the UNet sits under a stop-gradient in SDS, and the kernel
refuses inputs that need a gradient while grad mode is on (its output would
carry no history, and the gradient would be lost without a word).
"""
from __future__ import annotations

import torch

from tpunerf_torch.kernels import _build

ATTN = "attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q, k, v (B, H, N, D) → (B, H, N, D) in v's dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    attn = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)


def _strides(t: torch.Tensor):
    """(batch, head, token) element strides; 0 for a dimension of size 1,
    whose stride nothing reads."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def _check_bf16(q, k, v, scale: float) -> None:
    """What the bf16 kernel's 16-byte copies and its online max need."""
    D = q.shape[-1]
    if D % 8:
        raise ValueError(f"bf16 attention kernel takes a head dim that is a "
                         f"multiple of 8 (16-byte copies), got {D}")
    if not scale > 0:
        raise ValueError(f"bf16 attention kernel takes scale > 0, got "
                         f"{scale}")
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(s % 8 for s in _strides(t)):
            raise ValueError("bf16 attention kernel needs 16-byte aligned "
                             "q, k, v with (batch, head, token) strides that "
                             f"are multiples of 8, got {t.stride()}")


_fn = None


def _entry():
    """The library's `attention_fwd`, its ctypes signature set once, at
    load."""
    global _fn
    if _fn is None:
        fn = _build.load("attention").attention_fwd
        fn.argtypes = ([_build.INT] + [_build.VOIDP] * 4 + [_build.INT] * 4
                       + [_build.LONG] * 12 + [_build.FLOAT, _build.VOIDP])
        fn.restype = _build.INT
        _fn = fn
    return _fn


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Kernel forward. q, k, v are (B, H, N, D) views of one dtype (f32 or
    bf16) with a contiguous head dim and any (batch, head, token) strides,
    so the (B, N, H·D) projections pass without a transpose copy. The
    output is a (B, H, N, D) view of a (B, N, H, D) buffer: the caller's
    merge of the heads back to (B, N, H·D) is then free. bf16 runs on the
    tensor cores and takes D % 8 == 0, 16-byte aligned inputs and scale > 0;
    f32 takes any D <= 128."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the attention kernel (csrc/attention.cu) has no backward: its "
            "output would carry no autograd history and the gradient to q, "
            "k and v would be dropped; call it under torch.no_grad() or on "
            "inputs that need no gradient")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(f"attention kernel takes equal (B, H, N, D) shapes, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous head dim")
    B, H, N, D = q.shape
    if D > 128:
        raise ValueError(f"attention kernel takes head dim <= 128, got {D}")
    if q.dtype == torch.bfloat16:
        _check_bf16(q, k, v, scale)
    _build.check_cuda(q, k, v)
    out = torch.empty((B, N, H, D), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    strides = []
    for t in (q, k, v, out):
        strides += _strides(t)
    err = _entry()(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), B, H, N, D, *strides,
                   float(scale), _build.stream_ptr(q.device))
    _build.check(err, ATTN)
    _build.count_launch(ATTN)
    return out


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Kernel on CUDA tensors, plain version on CPU tensors."""
    if q.is_cuda:
        return attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)
