"""Distributed CSR matrix (counterpart of heat_tpu/sparse/dcsr_matrix.py).

As in Heat, each rank holds its rows as a ``torch.sparse_csr_tensor`` (split 0, the
ceil-division chunks of every DNDarray) or the whole matrix (split None). heat_tpu holds
one global BCOO value instead and derives the CSR views from it; the port's views are
the same values: the global ones (``indptr``, ``indices``, ``data``) come from
variable-length all-gathers of the ranks' parts, the local ones (``lindptr``,
``lindices``, ``ldata``) are the local tensor's. The stored values' counts are the
ranks' local counts, all-gathered once when asked for.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core.communication import TorchCommunication
from ..core.devices import Device

__all__ = ["DCSR_matrix"]


def csr_tensor(crow: torch.Tensor, col: torch.Tensor, values: torch.Tensor, shape) -> torch.Tensor:
    """A sparse CSR tensor of ``shape`` from its three parts (invariants not checked:
    every caller builds them sorted)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # torch's notice that sparse CSR is in beta
        return torch.sparse_csr_tensor(crow, col, values, size=tuple(shape), check_invariants=False)


class DCSR_matrix:
    """Distributed compressed-sparse-row matrix: row-split (``split=0``) or whole on
    every rank (``split=None``)."""

    def __init__(
        self,
        array: torch.Tensor,
        gnnz: int,
        gshape: Tuple[int, int],
        dtype,
        split: Optional[int],
        device: Device,
        comm: TorchCommunication,
        balanced: bool = True,
    ):
        self.__array = array
        self.__gnnz = int(gnnz)
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = balanced

    # ------------------------------------------------------------------ payload
    @property
    def larray(self) -> torch.Tensor:
        """This rank's rows as a sparse CSR tensor."""
        return self.__array

    @property
    def balanced(self) -> bool:
        return self.__balanced

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def ndim(self) -> int:
        return 2

    @property
    def shape(self) -> Tuple[int, int]:
        return self.__gshape

    gshape = shape

    @property
    def lshape(self) -> Tuple[int, int]:
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        return lshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def nnz(self) -> int:
        """Stored values in the whole matrix."""
        return self.__gnnz

    gnnz = nnz

    @property
    def lnnz(self) -> int:
        """Stored values in this rank's rows."""
        return int(self.__array.values().numel())

    def is_distributed(self) -> bool:
        """True when the rows are split over more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    def counts_displs_nnz(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Every rank's stored-value count and offset (one all-gather of the counts)."""
        if self.__split is None:
            raise ValueError("Non-distributed DCSR_matrix. Cannot calculate counts and displacements.")
        counts = tuple(self.__comm.all_gather_counts(self.lnnz, self.__array.device))
        displs = tuple(int(v) for v in np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64))
        return counts, displs

    # ------------------------------------------------------------------ CSR views
    def _gathered(self, local: torch.Tensor) -> torch.Tensor:
        """``local`` of every rank joined in rank order (this rank's alone when the
        matrix is not split)."""
        return self.__comm.all_gather_v(local) if self.is_distributed() else local

    @property
    def lindptr(self) -> torch.Tensor:
        """The row pointer of this rank's rows."""
        return self.__array.crow_indices()

    @property
    def indptr(self) -> torch.Tensor:
        """The global row pointer (the ranks' row counts gathered and summed up)."""
        per_row = torch.diff(self.lindptr)
        return torch.cat([per_row.new_zeros(1), torch.cumsum(self._gathered(per_row), 0)])

    gindptr = indptr
    global_indptr = indptr

    @property
    def lindices(self) -> torch.Tensor:
        """Column indices of this rank's stored values."""
        return self.__array.col_indices()

    @property
    def indices(self) -> torch.Tensor:
        """Column indices of every stored value, rows in order."""
        return self._gathered(self.lindices)

    gindices = indices

    @property
    def ldata(self) -> torch.Tensor:
        """This rank's stored values."""
        return self.__array.values()

    @property
    def data(self) -> torch.Tensor:
        """Every stored value, rows in order."""
        return self._gathered(self.ldata)

    gdata = data

    # ------------------------------------------------------------------ conversion
    def todense(self):
        """The dense DNDarray, split as this matrix."""
        from .manipulations import to_dense

        return to_dense(self)

    def numpy(self) -> np.ndarray:
        """The whole matrix, dense, as numpy on every rank."""
        return self.todense().numpy()

    def astype(self, dtype, copy: bool = True) -> "DCSR_matrix":
        """The matrix with its values cast to ``dtype``; with ``copy`` False, itself when
        the type matches."""
        dtype = types.canonical_heat_type(dtype)
        if not copy and dtype is self.__dtype:
            return self
        a = self.__array
        cast = csr_tensor(a.crow_indices(), a.col_indices(), a.values().to(dtype.torch_type()), a.shape)
        return DCSR_matrix(cast, self.__gnnz, self.__gshape, dtype, self.__split, self.__device, self.__comm,
                           self.__balanced)

    # ------------------------------------------------------------------ arithmetic
    def __add__(self, other):
        from .arithmetics import add

        return add(self, other)

    def __mul__(self, other):
        from .arithmetics import mul

        return mul(self, other)

    def __repr__(self) -> str:
        return (f"DCSR_matrix(shape={self.__gshape}, nnz={self.__gnnz}, dtype={self.__dtype.__name__}, "
                f"split={self.__split})")
