"""Sparse conversions (counterpart of heat_tpu/sparse/manipulations.py)."""

from __future__ import annotations

from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix
from .factories import sparse_csr_matrix

__all__ = ["to_dense", "to_sparse"]


def to_dense(sparse_matrix: DCSR_matrix, order: str = "C", out=None) -> DNDarray:
    """The dense DNDarray of a DCSR_matrix, split as it (each rank densifies its rows)."""
    m = sparse_matrix
    dense = DNDarray(m.larray.to_dense(), m.gshape, m.dtype, m.split, m.device, m.comm, True)
    if out is not None:
        out.larray = dense._relayout(out.split).to(out.dtype.torch_type())
        return out
    return dense


def to_sparse(array: DNDarray) -> DCSR_matrix:
    """The DCSR_matrix of a dense DNDarray, split as it."""
    return sparse_csr_matrix(array, split=array.split)
