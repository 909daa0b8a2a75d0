"""Sparse factories (counterpart of heat_tpu/sparse/factories.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import types
from ..core.communication import sanitize_comm
from ..core.devices import sanitize_device
from ..core.dndarray import DNDarray
from .dcsr_matrix import DCSR_matrix, csr_tensor

__all__ = ["sparse_csr_matrix"]


def csr_rows(a: torch.Tensor) -> torch.Tensor:
    """The row of each stored value of a CSR tensor, in order."""
    crow = a.crow_indices()
    return torch.repeat_interleave(torch.arange(a.shape[0], device=crow.device), torch.diff(crow))


def _triples_of(obj) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """(rows, columns, values, shape) of a sparse input: a torch sparse tensor (CSR or
    COO) or a scipy sparse matrix; never made dense."""
    if isinstance(obj, torch.Tensor):
        if obj.layout == torch.sparse_csr:
            return csr_rows(obj), obj.col_indices(), obj.values(), tuple(obj.shape)
        coo = obj.coalesce()
        return coo.indices()[0], coo.indices()[1], coo.values(), tuple(obj.shape)
    coo = obj.tocoo()
    as_tensor = lambda a: torch.from_numpy(np.array(a, copy=True))  # noqa: E731
    return as_tensor(coo.row).long(), as_tensor(coo.col).long(), as_tensor(coo.data), tuple(coo.shape)


def _is_sparse(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return obj.layout in (torch.sparse_csr, torch.sparse_coo)
    return hasattr(obj, "tocoo")


def rows_to_csr(rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, nrows: int, ncols: int,
                drop_zeros: bool) -> torch.Tensor:
    """A sparse CSR tensor of (``nrows``, ``ncols``) from entries in any order: the keys
    ``row·ncols + col`` sorted on the tensors' device, duplicates summed, zeros dropped
    with ``drop_zeros`` (as a dense-to-sparse conversion keeps only non-zeros)."""
    keys = rows.to(torch.int64) * ncols + cols.to(torch.int64)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    summed = values.new_zeros(uniq.numel()).index_add_(0, inverse, values)
    if drop_zeros:
        keep = summed != 0
        uniq, summed = uniq[keep], summed[keep]
    return keys_to_csr(uniq, summed, nrows, ncols)


def keys_to_csr(keys: torch.Tensor, values: torch.Tensor, nrows: int, ncols: int) -> torch.Tensor:
    """A sparse CSR tensor of (``nrows``, ``ncols``) from sorted distinct keys
    ``row·ncols + col`` and their values."""
    r = keys // max(ncols, 1)
    crow = torch.cat([r.new_zeros(1), torch.cumsum(torch.bincount(r, minlength=nrows), 0)])
    return csr_tensor(crow, keys - r * ncols, values, (nrows, ncols))


def wrap_rows(local: torch.Tensor, gshape, split, device, comm) -> DCSR_matrix:
    """A DCSR_matrix of this rank's rows ``local``; the global count of stored values is
    one all-reduce of the local counts."""
    nnz = torch.tensor(local.values().numel(), dtype=torch.int64, device=local.device)
    if split is not None and comm.size > 1:
        comm.all_reduce(nnz, "sum")
    return DCSR_matrix(local, int(nnz.item()), gshape, types.canonical_heat_type(local.dtype), split, device, comm,
                       True)


def sparse_csr_matrix(
    obj,
    dtype=None,
    copy: bool = True,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm=None,
) -> DCSR_matrix:
    """A DCSR_matrix of a dense array (numpy data, a tensor, a DNDarray), a sparse one (a
    torch CSR or COO tensor, a scipy sparse matrix: never made dense) or another
    DCSR_matrix. Only row-split (``split=0``) or whole layouts exist. Stored zeros are
    dropped and duplicates summed (but a DCSR_matrix's pattern is kept), as heat_tpu's
    dense conversion does. With ``is_split=0`` ``obj`` holds this rank's rows; chunks
    other than the canonical ones reach their ranks through an all-gather of the stored
    entries."""
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    if split not in (None, 0) or is_split not in (None, 0):
        raise ValueError("DCSR matrices support split=0 or None only")
    target = split if split is not None else is_split
    # the stored entries with global row indices; ``scope`` says which rows they cover:
    # "all", "mine" (this rank's canonical chunk) or "local" (is_split rows, not yet offset)
    if isinstance(obj, DCSR_matrix):
        rows, cols, values, _ = _triples_of(obj.larray)
        gshape = obj.gshape
        scope = "mine" if obj.is_distributed() else "all"
        rows = rows + (comm.chunk(gshape, 0)[0] if scope == "mine" else 0)
    elif _is_sparse(obj):
        rows, cols, values, gshape = _triples_of(obj)
        scope = "all" if is_split is None else "local"
    else:
        if isinstance(obj, DNDarray):
            dense = obj.larray if is_split is not None else obj._relayout(target)
            gshape = obj.gshape
        else:
            dense = obj if isinstance(obj, torch.Tensor) else torch.from_numpy(np.array(obj, copy=True))
            gshape = tuple(dense.shape)
        if dense.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got {dense.ndim}-D")
        scope = "local" if is_split is not None else ("mine" if isinstance(obj, DNDarray) and target == 0 else "all")
        gshape = tuple(dense.shape) if scope == "local" else gshape
        rows, cols = torch.nonzero(dense, as_tuple=True)
        values = dense[rows, cols]
        rows = rows + (comm.chunk(gshape, 0)[0] if scope == "mine" else 0)
    if len(gshape) != 2:
        raise ValueError(f"expected a 2-D matrix, got {len(gshape)}-D")
    on = device.torch_device
    rows, cols, values = rows.to(on), cols.to(on), values.to(on)
    ncols = int(gshape[1])
    if scope == "local":
        counts = comm.all_gather_counts(int(gshape[0]), on)  # this rank's rows so far
        gshape = (sum(counts), ncols)
        rows = rows + sum(counts[: comm.rank])
        scope = "mine" if list(counts) == comm.lshape_map(gshape, 0)[:, 0].tolist() else "local"
    if scope == "local" or (scope == "mine" and target is None):
        rows, cols, values = (comm.all_gather_v(t) for t in (rows, cols, values))
        scope = "all"
    lo, (n, _), _ = comm.chunk(gshape, target)
    if scope == "all" and target == 0:
        mine = (rows >= lo) & (rows < lo + n)
        rows, cols, values = rows[mine], cols[mine], values[mine]
    local = rows_to_csr(rows - lo, cols, values, n, ncols, drop_zeros=not isinstance(obj, DCSR_matrix))
    if dtype is not None:  # cast after the pattern is made: a value that casts to 0 stays stored
        local = csr_tensor(local.crow_indices(), local.col_indices(),
                           local.values().to(types.canonical_heat_type(dtype).torch_type()), local.shape)
    return wrap_rows(local, tuple(int(s) for s in gshape), target, device, comm)
