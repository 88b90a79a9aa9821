"""Rounding of a product's operands to a lower precision, for the control.

The reference computes in float32 with TF32 off. Its control runs the same
code with the operands of every matrix product and convolution of a module
rounded first: "tf32" to float32 with a 10-bit mantissa, "bf16" to
bfloat16, "fp8" to float8 e4m3 with one scale per tensor (its largest
magnitude to 448, the format's largest value). The sums stay float32, as on
the tensor cores, and so do the gradients that flow back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

KINDS = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0


def round_to(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """`x` (float32) rounded to `kind` and returned as float32; its
    gradient passes through unrounded."""
    if kind in (None, "f32"):
        return x
    return x + (_rounded(x.detach(), kind) - x.detach())


def _rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "tf32":
        bits = x.float().contiguous().view(torch.int32)
        # round half away on the 13 bits dropped (TF32 keeps 10 of 23)
        rounded = (bits + (1 << 12)) & ~((1 << 13) - 1)
        return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)
    if kind == "fp8":
        amax = x.detach().abs().amax()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {kind!r}")


class Linear(nn.Linear):
    """nn.Linear whose operands are rounded to `self.kind` first."""
    kind: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(round_to(x, self.kind),
                        round_to(self.weight, self.kind), self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose operands are rounded to `self.kind` first."""
    kind: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(round_to(x, self.kind),
                                  round_to(self.weight, self.kind),
                                  self.bias)


def set_kind(module: nn.Module, kind: Optional[str]) -> nn.Module:
    """Every product of `module` in `kind` (None or "f32": float32)."""
    if kind not in (None,) + KINDS:
        raise ValueError(f"unknown precision {kind!r}")
    for m in module.modules():
        if isinstance(m, (Linear, Conv2d)):
            m.kind = kind
    return module


def matmul(a: torch.Tensor, b: torch.Tensor, kind: Optional[str]
           ) -> torch.Tensor:
    """a @ b with both operands rounded to `kind`."""
    return round_to(a, kind) @ round_to(b, kind)
