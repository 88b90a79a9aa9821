"""The weights of a cell, made from its seed: the same function of the seed
gives the program and the reference the same values.

For a module's named tensors, sorted by name, one normal draw on the
module's device fills one flat buffer in the dtype the tensors are served
in, and each tensor is a view of it: a weight of fan-in n (the product of
its shape past the first axis) is N(0, 1/n); a one-dimensional `weight` (a
norm's scale) is 1; a bias is 0; rules by name override (the hash table,
the position table). Nothing is drawn leaf by leaf. Each view starts on a
multiple of `ALIGN` elements, as a tensor of its own would: cuDNN and
cuBLAS choose slower kernels for operands that start off a 16-byte
boundary.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch
from torch import nn

ALIGN = 128
# name suffix → the standard deviation of its normal draw
STD_BY_SUFFIX = {"hash_table": 1e-4, "position_embedding.weight": 0.01}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one named stream of a run's seed."""
    digest = hashlib.sha256(f"{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def named_shapes(module: nn.Module) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of each parameter, sorted by name."""
    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())


def _std(name: str, shape: Tuple[int, ...]) -> float:
    for suffix, std in STD_BY_SUFFIX.items():
        if name.endswith(suffix):
            return std
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def draw(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         stream: str, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """{name: tensor}, views of one buffer drawn from (`seed`, `stream`)."""
    shapes = sorted(shapes)
    sizes = [-(-math.prod(s) // ALIGN) * ALIGN for _, s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device),
                       dtype=dtype, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        t = flat[at:at + math.prod(shape)].view(shape)
        at += size
        if name.endswith("bias"):
            t.zero_()
        elif len(shape) == 1 and name.endswith("weight"):
            t.fill_(1.0)
        else:
            t.mul_(_std(name, shape))
        out[name] = t
    return out


def install(module: nn.Module, tensors: Mapping[str, torch.Tensor],
            trainable: bool = False) -> nn.Module:
    """Make `tensors` the parameters of `module` (a module built on the
    meta device, or anywhere): no copy is kept beside them. Raises where a
    name or a shape does not match."""
    own = dict(module.named_parameters())
    if set(own) != set(tensors):
        raise ValueError(f"weights for {sorted(set(tensors) ^ set(own))[:5]} "
                         "do not match the module")
    for name, t in tensors.items():
        if tuple(own[name].shape) != tuple(t.shape):
            raise ValueError(f"{name}: {tuple(t.shape)} for "
                             f"{tuple(own[name].shape)}")
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub._parameters[leaf] = nn.Parameter(t, requires_grad=trainable)
    return module


def named_shapes_of(tensors: Mapping[str, torch.Tensor]
                    ) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    return sorted((n, tuple(t.shape)) for n, t in tensors.items())


def mesh_init(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
              device) -> Dict[str, torch.Tensor]:
    """The painted mesh's starting state: the dome's per-face-vertex
    colours U[0, 1) and the latent texture N(0, 0.4²), each one draw;
    zero displacement; SH lights (3, 0, …, 0)."""
    gen = generator(seed, "mesh", device)
    out = {}
    for name, shape in sorted(shapes):
        if name == "background_sphere_colors":
            out[name] = torch.rand(shape, generator=gen, device=device)
        elif name == "texture_img":
            out[name] = 0.4 * torch.randn(shape, generator=gen, device=device)
        elif name == "lights":
            out[name] = torch.zeros(shape, device=device)
            out[name][..., 0] = 3.0
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
