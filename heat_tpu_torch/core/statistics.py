"""Statistical reductions (counterpart of heat_tpu/core/statistics.py: ``argmin``,
``argmax``, ``min``, ``max`` and ``mean``).

An arg-reduction over the split axis takes each rank's local extreme and its global
index, gathers those few candidates on every rank and keeps numpy's rule: the extreme
value wins, and among equal values the lowest global index (a NaN counts as the extreme,
as in numpy). Indices are int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _operations, sanitation, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = ["argmax", "argmin", "max", "mean", "min"]


def _pick(values: torch.Tensor, indices: torch.Tensor, kind: str) -> torch.Tensor:
    """Per position over the leading (rank) axis: the index of the extreme value, the
    lowest index among ties, the lowest index of a NaN if there is one."""
    if values.dtype == torch.bool:
        values = values.to(torch.uint8)
    best = values.amin(0) if kind == "min" else values.amax(0)
    cand = values == best
    if values.is_floating_point():
        nan = torch.isnan(values)
        cand = torch.where(nan.any(0), nan, cand)
    sentinel = torch.iinfo(torch.int64).max
    return torch.where(cand, indices, torch.full_like(indices, sentinel)).amin(0)


def _arg_reduce(kind: str, x: DNDarray, axis, out, keepdims: bool) -> DNDarray:
    sanitation.sanitize_in(x)
    argf = torch.argmin if kind == "min" else torch.argmax
    neutral = _operations._neutral("highest" if kind == "min" else "lowest", x.larray.dtype)
    local, comm, split = x.larray, x.comm, x.split
    if axis is None:
        if not x.is_distributed():
            result = argf(local.reshape(-1))
        else:
            offset, _, _ = comm.chunk(x.gshape, split)
            flat = local.reshape(-1)
            if flat.numel() == 0:
                value, gidx = flat.new_full((), neutral), x.size
            else:
                li = int(argf(flat))
                multi = list(np.unravel_index(li, local.shape))
                multi[split] += offset
                value, gidx = flat[li], int(np.ravel_multi_index(tuple(multi), x.gshape))
            values = comm.all_gather_stacked(value.reshape(()))
            indices = comm.all_gather_stacked(torch.tensor(gidx, dtype=torch.int64, device=local.device))
            result = _pick(values, indices, kind)
        if keepdims:
            result = result.reshape((1,) * x.ndim)
        return _operations.handle_out(_operations.wrap_result(result.to(torch.int64), x, None), out)

    axis = sanitize_axis(x.gshape, axis)
    gshape = tuple(1 if i == axis else s for i, s in enumerate(x.gshape))
    if not keepdims:
        gshape = gshape[:axis] + gshape[axis + 1 :]
    out_split = _operations._out_split_reduce(x, axis, keepdims)
    if axis != split or not x.is_distributed():
        result = argf(local, dim=axis, keepdim=keepdims)
    else:
        offset, _, _ = comm.chunk(x.gshape, split)
        if local.shape[axis] == 0:
            shape = list(local.shape)
            shape[axis] = 1
            values = local.new_full(shape, neutral)
            indices = torch.full(shape, x.gshape[axis], dtype=torch.int64, device=local.device)
        else:
            values = local.amin(axis, keepdim=True) if kind == "min" else local.amax(axis, keepdim=True)
            indices = argf(local, dim=axis, keepdim=True) + offset
        result = _pick(comm.all_gather_stacked(values), comm.all_gather_stacked(indices), kind)
        if not keepdims:
            result = result.squeeze(axis)
    if out_split is not None and out_split >= len(gshape):
        out_split = None
    res = DNDarray(result.to(torch.int64), gshape, types.int64, out_split, x.device, x.comm, True)
    return _operations.handle_out(res, out)


def argmax(x: DNDarray, axis: Optional[int] = None, out: Optional[DNDarray] = None, keepdims: bool = False) -> DNDarray:
    """Indices of maximum values."""
    return _arg_reduce("max", x, axis, out, keepdims)


def argmin(x: DNDarray, axis: Optional[int] = None, out: Optional[DNDarray] = None, keepdims: bool = False) -> DNDarray:
    """Indices of minimum values."""
    return _arg_reduce("min", x, axis, out, keepdims)


def max(x: DNDarray, axis=None, out=None, keepdims=None) -> DNDarray:  # noqa: A001
    """Maximum along axis."""
    return _operations.reduce_op("max", x, axis, out, bool(keepdims))


def min(x: DNDarray, axis=None, out=None, keepdims=None) -> DNDarray:  # noqa: A001
    """Minimum along axis."""
    return _operations.reduce_op("min", x, axis, out, bool(keepdims))


def mean(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean: a sum (local, then one all_reduce over the split axis) over
    the global count."""
    return _operations.reduce_op("mean", x, axis, None, keepdims)
