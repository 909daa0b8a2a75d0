"""Printing of distributed arrays (counterpart of heat_tpu/core/printing.py).

A small array is gathered and printed whole. A large one (more elements than the
``threshold`` print option) is summarised: only its edge items leave their ranks, the
``edgeitems`` first and last slices of every axis (and one filler slice that the summary
hides), fetched along the split axis from the ranks that hold them
(``TorchCommunication.take``), so what moves is O(edgeitems ** ndim), never the array.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_printoptions", "global_printing", "local_printing", "print0", "set_printoptions"]

__PRINT_OPTIONS = dict(precision=4, threshold=1000, edgeitems=3, linewidth=120, sci_mode=None)
__LOCAL_PRINTING = False


def get_printoptions() -> dict:
    """The current print options."""
    return dict(__PRINT_OPTIONS)


def global_printing() -> None:
    """Print the global array (the default)."""
    global __LOCAL_PRINTING
    __LOCAL_PRINTING = False


def local_printing() -> None:
    """Print each rank's chunk."""
    global __LOCAL_PRINTING
    __LOCAL_PRINTING = True


def print0(*args, **kwargs) -> None:
    """Print on rank 0 only."""
    from .communication import get_comm

    if get_comm().rank == 0:
        print(*args, **kwargs)


def set_printoptions(precision=None, threshold=None, edgeitems=None, linewidth=None, profile=None, sci_mode=None):
    """Configure printing (profiles "default", "short" and "full", then the options given)."""
    if profile == "default":
        __PRINT_OPTIONS.update(precision=4, threshold=1000, edgeitems=3, linewidth=120)
    elif profile == "short":
        __PRINT_OPTIONS.update(precision=2, threshold=1000, edgeitems=2, linewidth=120)
    elif profile == "full":
        __PRINT_OPTIONS.update(precision=4, threshold=np.inf, edgeitems=3, linewidth=120)
    for k, v in dict(precision=precision, threshold=threshold, edgeitems=edgeitems, linewidth=linewidth,
                     sci_mode=sci_mode).items():
        if v is not None:
            __PRINT_OPTIONS[k] = v


def _edge_data(x, edgeitems: int) -> np.ndarray:
    """The edge slices of every axis longer than ``2·edgeitems + 1`` (with one filler
    slice, so numpy still summarises it), on every rank."""
    value = x.larray
    for d, s in enumerate(x.gshape):
        if s <= 2 * edgeitems + 1:
            continue
        idx = torch.cat([torch.arange(edgeitems + 1), torch.arange(s - edgeitems, s)]).to(value.device)
        if d == x.split and x.is_distributed():
            counts = x.comm.counts_displs_shape(x.gshape, d)[0]
            value = x.comm.take(value, d, counts, idx, replicate=True)
        else:
            value = value.index_select(d, idx)
    if x.split is not None and x.is_distributed() and x.gshape[x.split] <= 2 * edgeitems + 1:
        counts = x.comm.counts_displs_shape(x.gshape, x.split)[0]
        value = x.comm.take(value, x.split, counts, torch.arange(x.gshape[x.split], device=value.device), replicate=True)
    return value.detach().cpu().numpy()


def __str__(x) -> str:
    """Render a DNDarray; a large one from its edge items alone."""
    opts = __PRINT_OPTIONS
    if __LOCAL_PRINTING:
        body = np.array2string(x.larray.detach().cpu().numpy(), precision=opts["precision"], separator=", ")
        return f"DNDarray(local chunk of rank {x.comm.rank}, gshape={x.gshape}, split={x.split}):\n{body}"
    summarize = x.size > opts["threshold"] and x.ndim > 0
    value = _edge_data(x, opts["edgeitems"]) if summarize else x.numpy()
    body = np.array2string(value, precision=opts["precision"], threshold=0 if summarize else opts["threshold"],
                           edgeitems=opts["edgeitems"], max_line_width=opts["linewidth"], separator=", ")
    return f"DNDarray({body}, dtype=ht.{x.dtype}, device={x.device}, split={x.split})"
