"""Rounding operations (counterpart of heat_tpu/core/rounding.py): elementwise on each
rank's chunk, with heat_tpu's result types (exact inputs keep their type)."""

from __future__ import annotations

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "modf", "round", "sgn", "sign", "trunc"]


def _exact_kept(fn):
    """``fn`` on float tensors; an exact tensor is its own result (floor(int) is int)."""

    def op(v: torch.Tensor) -> torch.Tensor:
        return fn(v) if v.is_floating_point() or v.is_complex() else v.clone()

    return op


_abs, _ceil, _floor, _trunc = (_exact_kept(f) for f in (torch.abs, torch.ceil, torch.floor, torch.trunc))


def _abs_any(v: torch.Tensor) -> torch.Tensor:
    return v.clone() if v.dtype == torch.bool else torch.abs(v)


def abs(x, out=None, dtype=None) -> DNDarray:  # noqa: A001
    """Element-wise absolute value."""
    if dtype is not None and not issubclass(types.canonical_heat_type(dtype), types.number):
        raise TypeError("dtype must be a heat data type")
    res = _operations.local_op(_abs_any, x, out)
    if dtype is not None:
        res = res.astype(dtype, copy=False)
    return res


absolute = abs


def ceil(x, out=None) -> DNDarray:
    return _operations.local_op(_ceil, x, out)


def clip(x: DNDarray, min=None, max=None, out=None) -> DNDarray:  # noqa: A002
    """Clip values to [min, max]: ``minimum(maximum(x, min), max)`` with heat_tpu's
    promotion of the bounds."""
    if min is None and max is None:
        raise ValueError("either min or max must be set")
    res = x
    if min is not None:
        res = _operations.binary_op(torch.maximum, res, min)
    if max is not None:
        res = _operations.binary_op(torch.minimum, res, max)
    return _operations.handle_out(res, out)


def fabs(x, out=None) -> DNDarray:
    """Float absolute value (exact inputs become floats)."""
    return _operations.local_op(torch.abs, x, out, no_cast=False)


def floor(x, out=None) -> DNDarray:
    return _operations.local_op(_floor, x, out)


def _modf_frac(v: torch.Tensor) -> torch.Tensor:
    return v - torch.trunc(v)


def modf(x: DNDarray, out=None):
    """Fractional and integral parts, both with the sign of x."""
    frac = _operations.local_op(_modf_frac, x, out[0] if out else None, no_cast=False)
    intg = _operations.local_op(torch.trunc, x, out[1] if out else None, no_cast=False)
    return frac, intg


def _round(v: torch.Tensor, decimals: int = 0) -> torch.Tensor:
    if v.dtype == torch.bool:
        raise ValueError("round is not defined for bool arrays")
    if v.is_complex():  # numpy's: each part rounded
        return torch.complex(torch.round(v.real, decimals=decimals), torch.round(v.imag, decimals=decimals))
    if not v.is_floating_point():
        return v.clone() if decimals >= 0 else (torch.round(v.double(), decimals=decimals)).to(v.dtype)
    return torch.round(v, decimals=decimals)


def round(x: DNDarray, decimals: int = 0, out=None, dtype=None) -> DNDarray:  # noqa: A001
    """Round half to even, to ``decimals`` places (complex: the real and imaginary parts)."""
    res = _operations.local_op(_round, x, out, decimals=decimals)
    if dtype is not None:
        res = res.astype(dtype, copy=False)
    return res


def _sign(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.bool:
        raise TypeError("sign is not defined for bool arrays")
    if v.is_complex():
        return torch.sgn(v)
    if v.is_floating_point():
        return torch.where(torch.isnan(v), v, torch.sign(v))  # torch.sign maps NaN to 0
    return torch.sign(v)


def sgn(x, out=None) -> DNDarray:
    """Sign (complex: x/|x|)."""
    return _operations.local_op(_sign, x, out)


def _sign_real(v: torch.Tensor) -> torch.Tensor:
    return _sign(v.real).to(v.dtype)


def sign(x, out=None) -> DNDarray:
    """Sign; complex inputs take the sign of the real part."""
    if isinstance(x, DNDarray) and types.heat_type_is_complexfloating(x.dtype):
        return _operations.local_op(_sign_real, x, out)
    return _operations.local_op(_sign, x, out)


def trunc(x, out=None) -> DNDarray:
    return _operations.local_op(_trunc, x, out)
