"""NaN/Inf guards (the JAX package's `utils/debug.py`).

A tree-wide sanitizer for production steps (`nan_to_num_tree`), an
assertion that every leaf is finite (`assert_all_finite`), and `checked`,
which turns a silent NaN or a division by zero inside a function into an
exception at the operation that made it: the counterpart of
`checkify.checkify(fn, errors=checkify.float_checks)`. A tree is a tensor,
or a dict (its keys sorted, as JAX orders a dict's leaves), list or tuple of
trees.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten
_DIVISIONS = {aten.div.Tensor, aten.div.Scalar, aten.div.Tensor_mode,
              aten.div_.Tensor, aten.div_.Scalar, aten.reciprocal.default,
              aten.reciprocal_.default}


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return type(tree)((k, _map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def nan_to_num_tree(tree: Any) -> Any:
    """`nan_to_num` every float leaf (NaN → 0, ±inf → the dtype's largest
    finite values); other leaves as they are."""
    return _map(lambda x: torch.nan_to_num(x) if torch.is_tensor(x)
                and x.is_floating_point() else x, tree)


def assert_all_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming the first float leaf with a
    non-finite value, by its index among the tree's leaves."""
    for i, leaf in enumerate(_leaves(tree)):
        if (torch.is_tensor(leaf) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise FloatingPointError(f"non-finite values in {name} leaf {i}")


class _FloatChecks(TorchDispatchMode):
    """Raise at the first operation whose float output holds a NaN, or
    that divides by zero (JAX's `nan_checks` and `div_checks`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _DIVISIONS:
            divisor = (args[0] if func.overloadpacket in
                       (aten.reciprocal, aten.reciprocal_) else args[1])
            if (torch.is_tensor(divisor) and bool((divisor == 0).any())) \
                    or (not torch.is_tensor(divisor) and divisor == 0):
                raise FloatingPointError("division by zero")
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if (torch.is_tensor(t) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"nan generated by operation: {func.overloadpacket}")
        return out


def checked(fn: Callable) -> Callable:
    """`fn` run under the float checks (a debug mode): a NaN made by an
    operation, or a division by zero, raises FloatingPointError there;
    otherwise `fn`'s result: `out = checked(step)(args)`."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)
    return wrapper
