"""Trigonometric and hyperbolic functions (counterpart of heat_tpu/core/trigonometrics.py):
elementwise on each rank's chunk. Exact inputs turn into floats as in heat_tpu (float32;
float64 from int64)."""

from __future__ import annotations

import torch

from . import _operations
from .dndarray import DNDarray

__all__ = [
    "arccos",
    "acos",
    "arccosh",
    "acosh",
    "arcsin",
    "asin",
    "arcsinh",
    "asinh",
    "arctan",
    "atan",
    "arctanh",
    "atanh",
    "arctan2",
    "atan2",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinh",
    "tan",
    "tanh",
]


def arccos(x, out=None) -> DNDarray:
    return _operations.local_op(torch.acos, x, out, no_cast=False)


acos = arccos


def arccosh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.acosh, x, out, no_cast=False)


acosh = arccosh


def arcsin(x, out=None) -> DNDarray:
    return _operations.local_op(torch.asin, x, out, no_cast=False)


asin = arcsin


def arcsinh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.asinh, x, out, no_cast=False)


asinh = arcsinh


def arctan(x, out=None) -> DNDarray:
    return _operations.local_op(torch.atan, x, out, no_cast=False)


atan = arctan


def arctanh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.atanh, x, out, no_cast=False)


atanh = arctanh


def arctan2(x1, x2, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.atan2, x1, x2, out, where)


atan2 = arctan2


def cos(x, out=None) -> DNDarray:
    return _operations.local_op(torch.cos, x, out, no_cast=False)


def cosh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.cosh, x, out, no_cast=False)


def deg2rad(x, out=None) -> DNDarray:
    return _operations.local_op(torch.deg2rad, x, out, no_cast=False)


radians = deg2rad


def rad2deg(x, out=None) -> DNDarray:
    return _operations.local_op(torch.rad2deg, x, out, no_cast=False)


degrees = rad2deg


def sin(x, out=None) -> DNDarray:
    return _operations.local_op(torch.sin, x, out, no_cast=False)


def sinh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.sinh, x, out, no_cast=False)


def tan(x, out=None) -> DNDarray:
    return _operations.local_op(torch.tan, x, out, no_cast=False)


def tanh(x, out=None) -> DNDarray:
    return _operations.local_op(torch.tanh, x, out, no_cast=False)
