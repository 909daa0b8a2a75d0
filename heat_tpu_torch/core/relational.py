"""Element-wise comparisons (counterpart of heat_tpu/core/relational.py)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["eq", "equal", "ge", "greater", "greater_equal", "gt", "le", "less", "less_equal", "lt", "ne", "not_equal"]


def eq(x, y) -> DNDarray:
    return _operations.binary_op(torch.eq, x, y)


def equal(x, y) -> bool:
    """True iff the shapes broadcast and every element is equal: one verdict on every
    rank (local comparisons, then a MIN across ranks)."""
    try:
        verdict = eq(x, y)
    except (TypeError, ValueError):
        return False
    from . import logical

    return bool(logical.all(verdict).item())


def ge(x, y) -> DNDarray:
    return _operations.binary_op(torch.ge, x, y)


greater_equal = ge


def gt(x, y) -> DNDarray:
    return _operations.binary_op(torch.gt, x, y)


greater = gt


def le(x, y) -> DNDarray:
    return _operations.binary_op(torch.le, x, y)


less_equal = le


def lt(x, y) -> DNDarray:
    return _operations.binary_op(torch.lt, x, y)


less = lt


def ne(x, y) -> DNDarray:
    return _operations.binary_op(torch.ne, x, y)


not_equal = ne
