"""Logical operations (counterpart of heat_tpu/core/logical.py). ``all``/``any`` over the
split axis reduce locally and across ranks; ``allclose`` is one verdict on every rank."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def all(x: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:  # noqa: A001
    """Whether all elements are True: local, then a MIN across ranks over the split axis."""
    return _operations.reduce_op("all", x, axis, out, keepdims)


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """Whether every element of ``x`` is close to ``y``'s: one bool on every rank."""
    return bool(all(isclose(x, y, rtol, atol, equal_nan)).item())


def any(x: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:  # noqa: A001
    """Whether any element is True: local, then a MAX across ranks over the split axis."""
    return _operations.reduce_op("any", x, axis, out, keepdims)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Element-wise closeness."""
    return _operations.binary_op(torch.isclose, x, y, fn_kwargs=dict(rtol=rtol, atol=atol, equal_nan=equal_nan))


def isfinite(x, out=None) -> DNDarray:
    return _operations.local_op(torch.isfinite, x, out)


def isinf(x, out=None) -> DNDarray:
    return _operations.local_op(torch.isinf, x, out)


def isnan(x, out=None) -> DNDarray:
    return _operations.local_op(torch.isnan, x, out)


def isneginf(x, out=None) -> DNDarray:
    return _operations.local_op(torch.isneginf, x, out)


def isposinf(x, out=None) -> DNDarray:
    return _operations.local_op(torch.isposinf, x, out)


def logical_and(x, y) -> DNDarray:
    return _operations.binary_op(torch.logical_and, x, y)


def logical_not(x, out=None) -> DNDarray:
    return _operations.local_op(torch.logical_not, x, out)


def logical_or(x, y) -> DNDarray:
    return _operations.binary_op(torch.logical_or, x, y)


def logical_xor(x, y) -> DNDarray:
    return _operations.binary_op(torch.logical_xor, x, y)


def _signbit(v: torch.Tensor) -> torch.Tensor:
    return torch.signbit(v) if v.dtype != torch.bool else torch.zeros_like(v)


def signbit(x, out=None) -> DNDarray:
    return _operations.local_op(_signbit, x, out)
