"""Exponential and logarithmic functions (counterpart of heat_tpu/core/exponential.py):
elementwise on each rank's chunk. Exact inputs turn into floats as in heat_tpu (float32;
float64 from int64)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "logaddexp", "logaddexp2", "sqrt", "square"]


def exp(x, out=None) -> DNDarray:
    return _operations.local_op(torch.exp, x, out, no_cast=False)


def expm1(x, out=None) -> DNDarray:
    return _operations.local_op(torch.expm1, x, out, no_cast=False)


def exp2(x, out=None) -> DNDarray:
    return _operations.local_op(torch.exp2, x, out, no_cast=False)


def log(x, out=None) -> DNDarray:
    return _operations.local_op(torch.log, x, out, no_cast=False)


def log2(x, out=None) -> DNDarray:
    return _operations.local_op(torch.log2, x, out, no_cast=False)


def log10(x, out=None) -> DNDarray:
    return _operations.local_op(torch.log10, x, out, no_cast=False)


def log1p(x, out=None) -> DNDarray:
    return _operations.local_op(torch.log1p, x, out, no_cast=False)


def logaddexp(x1, x2, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.logaddexp, x1, x2, out, where)


def logaddexp2(x1, x2, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.logaddexp2, x1, x2, out, where)


def sqrt(x, out=None) -> DNDarray:
    return _operations.local_op(torch.sqrt, x, out, no_cast=False)


def _square(v: torch.Tensor) -> torch.Tensor:
    # jnp squares a bool in int32
    return torch.square(v.to(torch.int32) if v.dtype == torch.bool else v)


def square(x, out=None) -> DNDarray:
    return _operations.local_op(_square, x, out)
