"""Complex number operations (counterpart of heat_tpu/core/complex_math.py)."""

from __future__ import annotations

import torch

from . import _operations, types
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(v: torch.Tensor, deg: bool = False) -> torch.Tensor:
    # jnp.angle of a real array is float64 for exact inputs, the float type otherwise
    if not (v.is_floating_point() or v.is_complex()):
        v = v.to(torch.float64)
    res = torch.angle(v)
    return torch.rad2deg(res) if deg else res


def angle(x: DNDarray, deg: bool = False, out=None) -> DNDarray:
    """Argument of the complex values."""
    return _operations.local_op(_angle, x, out, deg=deg)


def _conj(v: torch.Tensor) -> torch.Tensor:
    return torch.conj(v).resolve_conj() if v.is_complex() else v.clone()


def conjugate(x: DNDarray, out=None) -> DNDarray:
    """Complex conjugate."""
    return _operations.local_op(_conj, x, out)


conj = conjugate


def _imag(v: torch.Tensor) -> torch.Tensor:
    return v.imag.clone() if v.is_complex() else torch.zeros_like(v)


def imag(x: DNDarray, out=None) -> DNDarray:
    """Imaginary part (zeros for real inputs)."""
    return _operations.local_op(_imag, x, out)


def real(x: DNDarray, out=None) -> DNDarray:
    """Real part (the array itself for real inputs)."""
    if isinstance(x, DNDarray) and not types.heat_type_is_complexfloating(x.dtype):
        return x
    return _operations.local_op(lambda v: v.real.clone(), x, out)
