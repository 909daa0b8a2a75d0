"""Element-wise comparisons behind the DNDarray comparison operators (the part of
heat_tpu/core/relational.py the operators need)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["eq", "ge", "gt", "le", "lt", "ne"]


def eq(x, y) -> DNDarray:
    return _operations.binary_op(torch.eq, x, y)


def ne(x, y) -> DNDarray:
    return _operations.binary_op(torch.ne, x, y)


def lt(x, y) -> DNDarray:
    return _operations.binary_op(torch.lt, x, y)


def le(x, y) -> DNDarray:
    return _operations.binary_op(torch.le, x, y)


def gt(x, y) -> DNDarray:
    return _operations.binary_op(torch.gt, x, y)


def ge(x, y) -> DNDarray:
    return _operations.binary_op(torch.ge, x, y)
