"""Test matrices with known properties (counterpart of
heat_tpu/utils/data/matrixgallery.py): Hermitian, Parter, and random matrices of known
singular values or rank, built from random orthonormal factors drawn from the port's
random streams (heat_tpu's draws; normal draws within 4 ulp in float32 and 32 in
float64)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ... import core as ht
from ...core import types

__all__ = ["hermitian", "parter", "random_known_singularvalues", "random_known_rank"]


def hermitian(n: int, dtype=None, split: Optional[int] = None, positive_definite: bool = False):
    """A random n × n Hermitian matrix (complex64 by default); with
    ``positive_definite`` x·xᴴ + n·I."""
    dtype = types.canonical_heat_type(dtype or ht.complex64)
    if types.heat_type_is_complexfloating(dtype):
        real = ht.random.randn(n, n, split=split, dtype=ht.float64)
        imag = ht.random.randn(n, n, split=split, dtype=ht.float64)
        x = (real + 1j * imag).astype(dtype)
    else:
        x = ht.random.randn(n, n, split=split, dtype=dtype)
    if positive_definite:
        return ht.matmul(x, ht.conj(x).T.resplit(x.split)) + float(n) * ht.eye(n, split=split, dtype=dtype)
    return 0.5 * (x + ht.conj(x).T.resplit(x.split))


def parter(n: int, split: Optional[int] = None, device=None, comm=None):
    """The Parter matrix, 1 / (i - j + 0.5)."""
    i = ht.arange(n, dtype=ht.float32, split=split, device=device, comm=comm).expand_dims(1)
    j = ht.arange(n, dtype=ht.float32, device=device, comm=comm).expand_dims(0)
    return 1.0 / (i - j + 0.5)


def random_known_singularvalues(
    m: int, n: int, singular_values, split: Optional[int] = None, device=None, comm=None
) -> Tuple:
    """A random m × n matrix with the given singular values: (A, (U, s, V)) with
    A = U·diag(s)·Vᵀ and U, V of orthonormal columns."""
    if not isinstance(singular_values, ht.DNDarray):
        singular_values = ht.array(np.asarray(singular_values), device=device, comm=comm)
    k = singular_values.gshape[0]
    if k > min(m, n):
        raise ValueError(f"too many singular values ({k}) for shape ({m}, {n})")
    q_u, _ = ht.linalg.qr(ht.random.randn(m, k, dtype=singular_values.dtype, split=split, device=device, comm=comm))
    q_v, _ = ht.linalg.qr(ht.random.randn(n, k, dtype=singular_values.dtype, split=split, device=device, comm=comm))
    a = ht.matmul(ht.matmul(q_u, ht.diag(singular_values).resplit(None)), q_v.T.resplit(None))
    return a, (q_u, singular_values, q_v)


def random_known_rank(m: int, n: int, r: int, split: Optional[int] = None, device=None, comm=None) -> Tuple:
    """A random m × n matrix of rank r, its singular values r/r, (r-1)/r, ..., 1/r."""
    singular_values = ht.array((np.arange(r, 0, -1) / r).astype(np.float32), device=device, comm=comm)
    return random_known_singularvalues(m, n, singular_values, split=split, device=device, comm=comm)
