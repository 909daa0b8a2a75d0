"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py): thin wrappers over
the dispatch layer in :mod:`._operations`, which owns split propagation and the
cross-rank reductions."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["add", "div", "divide", "mul", "multiply", "neg", "negative", "pow", "power", "prod", "sub", "subtract", "sum"]


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise addition."""
    return _operations.binary_op(torch.add, t1, t2, out, where)


def div(t1, t2, out=None, where=None) -> DNDarray:
    """True division."""
    return _operations.binary_op(torch.true_divide, t1, t2, out, where)


divide = div


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise multiplication."""
    return _operations.binary_op(torch.mul, t1, t2, out, where)


multiply = mul


def neg(a: DNDarray, out=None) -> DNDarray:
    """Element-wise negation."""
    return _operations.local_op(torch.neg, a, out)


negative = neg


def pow(t1, t2, out=None, where=None) -> DNDarray:  # noqa: A001
    """Element-wise power."""
    return _operations.binary_op(torch.pow, t1, t2, out, where)


power = pow


def prod(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product reduction; over the split axis, local products and one all_reduce."""
    return _operations.reduce_op("prod", a, axis, out, keepdims)


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise subtraction."""
    return _operations.binary_op(torch.sub, t1, t2, out, where)


subtract = sub


def sum(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:  # noqa: A001
    """Sum reduction; over the split axis, local sums and one all_reduce."""
    return _operations.reduce_op("sum", a, axis, out, keepdims)
