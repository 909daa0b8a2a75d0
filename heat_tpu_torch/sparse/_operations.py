"""Sparse dispatch (counterpart of heat_tpu/sparse/_operations.py)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core import _operations, types
from .dcsr_matrix import DCSR_matrix, csr_tensor
from .factories import csr_rows, keys_to_csr, sparse_csr_matrix, wrap_rows

__all__ = ["binary_op_csr"]


def _keys(a: torch.Tensor) -> torch.Tensor:
    """The int64 keys ``row·ncols + col`` of a CSR tensor's stored values, in order."""
    return csr_rows(a) * a.shape[1] + a.col_indices()


def binary_op_csr(operation: Callable, t1: DCSR_matrix, t2) -> DCSR_matrix:
    """An elementwise ``operation`` of sparse operands. Of two matrices the result holds
    the union of their patterns, stored zeros included (so its count of stored values
    is the union's, even where a sum or product is 0), merged on the device: each
    rank's int64 keys sorted, each operand's values scattered onto the union's
    positions (duplicates summed). A scalar acts on the stored values only."""
    if not isinstance(t1, DCSR_matrix):
        raise TypeError(f"first operand must be a DCSR_matrix, got {type(t1)}")
    a = t1.larray
    if isinstance(t2, DCSR_matrix):
        if t1.shape != t2.shape:
            raise ValueError(f"shapes {t1.shape} and {t2.shape} do not match")
        if t2.split != t1.split:
            t2 = sparse_csr_matrix(t2, split=t1.split, device=t1.device, comm=t1.comm)
        b = t2.larray
        ct = types.promote_types(t1.dtype, t2.dtype).torch_type()
        k1, k2 = _keys(a), _keys(b)
        union, inverse = torch.unique(torch.cat([k1, k2]), sorted=True, return_inverse=True)
        va = torch.zeros(union.numel(), dtype=ct, device=a.device).index_add_(0, inverse[: k1.numel()], a.values().to(ct))
        vb = torch.zeros(union.numel(), dtype=ct, device=a.device).index_add_(0, inverse[k1.numel():], b.values().to(ct))
        local = keys_to_csr(union, operation(va, vb), a.shape[0], a.shape[1])
    elif np.isscalar(t2):
        _, result = _operations._binary_types(t1, t2, operation)
        values = operation(a.values().to(result.torch_type()), t2).to(result.torch_type())
        local = csr_tensor(a.crow_indices(), a.col_indices(), values, a.shape)
    else:
        raise TypeError(f"unsupported operand type {type(t2)}")
    return wrap_rows(local, t1.shape, t1.split, t1.device, t1.comm)
