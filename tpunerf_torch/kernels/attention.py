"""Non-causal attention: the CUDA kernels (the forward #4 in
csrc/attention.cu, the backward #12/#13 in csrc/attention_bwd.cu) and their
plain PyTorch versions.

The UNet's long self-attention calls `attention`. On CPU tensors it runs
`attention_plain`, the softmax(q·kᵀ·scale)·v of the JAX package's XLA path
(guidance/unet.py:209-212): f32 logits from a product in the operands'
dtype (`attention_logits`), f32 softmax, probabilities cast to v's dtype;
autograd differentiates it. On CUDA tensors it launches the
forward kernel; where grad mode is on and an input needs a gradient, it
does so through `AttentionFunction`, whose forward also keeps each query
row's log-sum-exp and whose backward is JAX's two-kernel flash backward:
Δ = rowsum(dO ∘ O) in torch, then #12 (`attention_bwd_dkv`: dK, dV, a
block per tile of keys) and #13 (`attention_bwd_dq`: dQ, a block per tile
of queries), both recomputing P = exp(s·q·kᵀ − lse). `attention_bwd_plain`
is that backward's math in plain PyTorch, for the tests and the card's
checks. The earlier bf16 design of #12/#13 (mma.sync) stays as
`attention_bwd_dkv_mma_cuda` and `attention_bwd_dq_mma_cuda`, with launch
counters of their own, for timing only: no path calls them. A kernel that
cannot build or launch raises: nothing gives way to the plain versions on
a card.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from tpunerf_torch.kernels import _build

ATTN = "attention_fwd"
ATTN_DKV = "attention_bwd_dkv"
ATTN_DQ = "attention_bwd_dq"
# #12/#13's earlier bf16 design (mma.sync), timed beside them only
ATTN_DKV_MMA = "attention_bwd_dkv_mma"
ATTN_DQ_MMA = "attention_bwd_dq_mma"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class _Bf16Logits(torch.autograd.Function):
    """q·kᵀ in f32 from bf16 operands of the same (B, H): the forward on
    the tensor cores (`bmm` with an f32 output, which has no derivative in
    PyTorch); the backward multiplies the f32 gradient by the other operand
    widened to f32 and rounds to bf16, as autograd did through the widened
    product."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        B, H, N, D = q.shape
        M = k.shape[2]
        logits = torch.bmm(q.reshape(B * H, N, D),
                           k.reshape(B * H, M, D).transpose(1, 2),
                           out_dtype=torch.float32)
        return logits.view(B, H, N, M)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        dq = torch.einsum("bhqk,bhkd->bhqd", g, k.float()).to(q.dtype)
        dk = torch.einsum("bhqk,bhqd->bhkd", g, q.float()).to(k.dtype)
        return dq, dk


def attention_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q·kᵀ (B, H, N, M) in f32, the product taken in the operands' dtype
    as the JAX package's `einsum(..., preferred_element_type=f32)`: bf16
    operands on the card go to the tensor cores with f32 accumulation and
    output (`_Bf16Logits`). The CPU has no such product: there the
    operands are widened first (the same products, exact in f32, summed in
    another order)."""
    if (q.is_cuda and q.dtype == k.dtype == torch.bfloat16
            and q.shape[:2] == k.shape[:2]):
        return _Bf16Logits.apply(q, k)
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q, k, v (B, H, N, D) → (B, H, N, D) in v's dtype."""
    attn = torch.softmax(attention_logits(q, k) * scale, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", attn.to(v.dtype), v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, scale: float
                        ) -> torch.Tensor:
    """Each query row's log-sum-exp of the scaled f32 logits, (B, H, N)
    f32: what the forward kernel keeps for the backward."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return torch.logsumexp(logits * scale, dim=-1)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        scale: float):
    """(dq, dk, dv) of `attention` for the output gradient `do`, step by
    step as JAX's `mha_reference_bwd` (flash_attention.py:1615-1675), with
    the scale applied to the logits and to dS instead of folded into q, and
    P = exp(logits − lse). P and dS are cast to the inputs' dtype before
    their products, as JAX's flash kernels cast them (a no-op in f32); the
    products accumulate in f32, the gradients come back in q's, k's and v's
    dtypes."""
    dt = q.dtype
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(logits - lse.float()[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    di = torch.sum(o.float() * dof, dim=-1)[..., None]
    ds = ((dp - di) * p * scale).to(dt).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor):
    """(batch, head, token) element strides; 0 for a dimension of size 1,
    whose stride nothing reads."""
    return [0 if t.shape[i] == 1 else t.stride(i) for i in range(3)]


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and not any(s % 8 for s in _strides(t))


def _check_bf16(q, k, v, scale: float) -> None:
    """What the bf16 kernels' 16-byte copies and the forward's online max
    need."""
    D = q.shape[-1]
    if D % 8:
        raise ValueError(f"bf16 attention kernel takes a head dim that is a "
                         f"multiple of 8 (16-byte copies), got {D}")
    if not scale > 0:
        raise ValueError(f"bf16 attention kernel takes scale > 0, got "
                         f"{scale}")
    for t in (q, k, v):
        if not _aligned16(t):
            raise ValueError("bf16 attention kernel needs 16-byte aligned "
                             "q, k, v with (batch, head, token) strides that "
                             f"are multiples of 8, got {t.stride()}")


_fns = {}


def _entry(lib: str, name: str, argtypes):
    """The library's entry `name`, its ctypes signature set once, at
    load."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = _build.INT
        _fns[name] = fn
    return fn


_FWD_ARGS = ([_build.INT] + [_build.VOIDP] * 5 + [_build.INT] * 4
             + [_build.LONG] * 12 + [_build.FLOAT, _build.VOIDP])
# dtype, q, k, v, do, lse, delta, the gradients (dk, dv or dq), B, H, N,
# D, the strides (3 a tensor), scale, stream
_BWD_TAIL = ([_build.INT] * 4 + [ctypes.POINTER(_build.LONG), _build.FLOAT,
                                 _build.VOIDP])
_DKV_ARGS = [_build.INT] + [_build.VOIDP] * 8 + _BWD_TAIL
_DQ_ARGS = [_build.INT] + [_build.VOIDP] * 7 + _BWD_TAIL


def _check_qkv(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(f"attention kernel takes equal (B, H, N, D) shapes, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("attention kernel needs a contiguous head dim")
    if q.shape[-1] > 128:
        raise ValueError(f"attention kernel takes head dim <= 128, got "
                         f"{q.shape[-1]}")


def _like_heads(q: torch.Tensor) -> torch.Tensor:
    """A (B, H, N, D) view of a new (B, N, H, D) buffer: the caller's merge
    of the heads back to (B, N, H·D), or the projections' backward, is then
    free."""
    B, H, N, D = q.shape
    return torch.empty((B, N, H, D), dtype=q.dtype,
                       device=q.device).permute(0, 2, 1, 3)


def attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, with_lse: bool = False):
    """Kernel forward #4, without autograd. q, k, v are (B, H, N, D) views
    of one dtype (f32 or bf16) with a contiguous head dim and any (batch,
    head, token) strides, so the (B, N, H·D) projections pass without a
    transpose copy. The output is a (B, H, N, D) view of a (B, N, H, D)
    buffer; `with_lse` also returns each query row's log-sum-exp (B, H, N)
    f32, the backward's residual. bf16 runs on the tensor cores and takes
    D % 8 == 0, 16-byte aligned inputs and scale > 0; f32 takes any
    D <= 128. Raises on inputs that need a gradient while grad mode is on
    (its output has no history): `attention_cuda` differentiates."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "attention_fwd_cuda has no autograd history: call "
            "attention_cuda (or attention), whose AttentionFunction runs "
            "the backward kernels")
    _check_qkv(q, k, v)
    B, H, N, D = q.shape
    if q.dtype == torch.bfloat16:
        _check_bf16(q, k, v, scale)
    _build.check_cuda(q, k, v)
    out = _like_heads(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = []
    for t in (q, k, v, out):
        strides += _strides(t)
    err = _entry("attention", "attention_fwd", _FWD_ARGS)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr() if with_lse else None, B, H, N, D,
        *strides, float(scale), _build.stream_ptr(q.device))
    _build.check(err, ATTN)
    _build.count_launch(ATTN)
    return (out, lse) if with_lse else out


def _long_array(values):
    return (_build.LONG * len(values))(*values)


def _bwd_common(q, k, v, do, lse, delta, scale):
    """Checks and the leading arguments both backward kernels take."""
    _check_qkv(q, k, v)
    B, H, N, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"attention backward takes do of q's shape and "
                         f"dtype with a contiguous head dim, got "
                         f"{tuple(do.shape)} {do.dtype} {do.stride()}")
    if q.dtype == torch.bfloat16:
        _check_bf16(q, k, v, scale)
        if not _aligned16(do):
            raise ValueError("bf16 attention backward needs a 16-byte "
                             "aligned do with (batch, head, token) strides "
                             f"that are multiples of 8, got {do.stride()}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B, H, N) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"attention backward takes {name} (B, H, N) "
                             f"f32 contiguous, got {tuple(t.shape)} "
                             f"{t.dtype}")
    _build.check_cuda(q, k, v, do, lse, delta)
    return (_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())


def _dkv_call(name: str, q, k, v, do, lse, delta, scale: float):
    common = _bwd_common(q, k, v, do, lse, delta, scale)
    B, H, N, D = q.shape
    dk, dv = _like_heads(k), _like_heads(v)
    strides = []
    for t in (q, k, v, do, dk, dv):
        strides += _strides(t)
    err = _entry("attention_bwd", name, _DKV_ARGS)(
        *common, dk.data_ptr(), dv.data_ptr(), B, H, N, D,
        _long_array(strides), float(scale), _build.stream_ptr(q.device))
    _build.check(err, name)
    _build.count_launch(name)
    return dk, dv


def _dq_call(name: str, q, k, v, do, lse, delta, scale: float):
    common = _bwd_common(q, k, v, do, lse, delta, scale)
    B, H, N, D = q.shape
    dq = _like_heads(q)
    strides = []
    for t in (q, k, v, do, dq):
        strides += _strides(t)
    err = _entry("attention_bwd", name, _DQ_ARGS)(
        *common, dq.data_ptr(), B, H, N, D, _long_array(strides),
        float(scale), _build.stream_ptr(q.device))
    _build.check(err, name)
    _build.count_launch(name)
    return dq


def attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale: float):
    """Kernel #12: (dk, dv) from the forward's `lse` and Δ =
    rowsum(dO ∘ O) (`delta`), both (B, H, N) f32 contiguous. q, k, v as
    `attention_fwd_cuda` takes them, do of q's shape and dtype (in bf16
    16-byte aligned with strides that are multiples of 8, as q); each
    gradient a (B, H, N, D) view of a (B, N, H, D) buffer in its input's
    dtype. bf16 runs on the tensor cores (wgmma at D <= 64, mma.sync
    above), f32 on the CUDA cores."""
    return _dkv_call(ATTN_DKV, q, k, v, do, lse, delta, scale)


def attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale: float):
    """Kernel #13: dq, on the inputs `attention_bwd_dkv_cuda` takes."""
    return _dq_call(ATTN_DQ, q, k, v, do, lse, delta, scale)


def _check_mma(q) -> None:
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the mma.sync design of #12/#13 is bf16 only, got "
                        f"{q.dtype}")


def attention_bwd_dkv_mma_cuda(q, k, v, do, lse, delta, scale: float):
    """#12's earlier bf16 design (mma.sync m16n8k16 at every head dim), with
    #12's contract; only `chip_smoke.py` and the card tests call it."""
    _check_mma(q)
    return _dkv_call(ATTN_DKV_MMA, q, k, v, do, lse, delta, scale)


def attention_bwd_dq_mma_cuda(q, k, v, do, lse, delta, scale: float):
    """#13's earlier bf16 design, as `attention_bwd_dkv_mma_cuda`."""
    _check_mma(q)
    return _dq_call(ATTN_DQ_MMA, q, k, v, do, lse, delta, scale)


def attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       scale: float):
    """(dq, dk, dv) by the backward kernels: Δ = rowsum(dO ∘ O) in f32 (a
    torch reduction, as JAX leaves it to XLA), then #12 (dK, dV) and #13
    (dQ). do is cast to q's dtype and made contiguous where the kernels
    cannot read it as it is (a strided head dim; in bf16, rows that are not
    16-byte aligned)."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"attention backward takes o of q's shape and "
                         f"dtype, got {tuple(o.shape)} {o.dtype}")
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16
                              and not _aligned16(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    delta = torch.sum(o.float() * do.float(), dim=-1)
    lse = lse.contiguous()
    dk, dv = attention_bwd_dkv_cuda(q, k, v, do, lse, delta, scale)
    dq = attention_bwd_dq_cuda(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


def _backward(q, k, v, o, lse, do, scale):
    """What `AttentionFunction.backward` runs: the kernels. A module-level
    name, so that a check on the card can hold a whole training step
    against the same step through `attention_bwd_plain`."""
    return attention_bwd_cuda(q, k, v, o, lse, do, scale)


class AttentionFunction(torch.autograd.Function):
    """The kernel forward with its log-sum-exp, and the backward kernels.
    Differentiable once, as JAX's flash attention: the backward kernels'
    outputs carry no history, so a second derivative raises."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attention_fwd_cuda(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """The kernels: through `AttentionFunction` where grad mode is on and
    an input needs a gradient, else the forward kernel alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return AttentionFunction.apply(q, k, v, scale)
    return attention_fwd_cuda(q, k, v, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Kernels on CUDA tensors, plain version on CPU tensors."""
    if q.is_cuda:
        return attention_cuda(q, k, v, scale)
    return attention_plain(q, k, v, scale)
