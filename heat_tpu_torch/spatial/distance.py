"""Pairwise distances (counterpart of heat_tpu/spatial/distance.py: ``cdist``,
``manhattan`` and ``rbf``).

Euclidean distances by the quadratic expansion |x-y|² = |x|² + |y|² - 2x·y, whose cross
term is one ``torch.matmul`` in full fp32: TF32 is switched off around it, because the
expansion cancels for near points (heat_tpu/spatial/distance.py:36-38).

Distribution: a row-split X with Y whole on every rank is local work (the case
``KMeans.predict`` runs). When both are row-split, Y's chunks travel the ring
(heat_tpu's ``_ring_pairwise``, heat_tpu/spatial/distance.py:45): each rank keeps its X
rows and, at each of ``P`` steps, fills the columns of the Y chunk in hand while the next
one travels (:meth:`TorchCommunication.ring_blocks`), so no rank holds more than two Y
chunks; chunks may be ragged or empty (heat_tpu rings only over even chunks). Other
layouts gather what is split. Output split: row-split X → 0; else row-split Y → 1; else
None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import types
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in

__all__ = ["cdist", "manhattan", "rbf"]


def _pairwise(x: torch.Tensor, y: torch.Tensor, metric: str = "euclidean", xx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distance matrix of two local tensors: ``"euclidean"`` by the quadratic expansion
    (``xx``: x's squared row norms, when the caller keeps them), or ``"manhattan"``, the
    city-block distance. heat_tpu broadcasts manhattan to an (n, m, d) array
    (heat_tpu/spatial/distance.py:40-41), which at 10M × 8 × 64 would be 20 GB;
    ``torch.cdist(p=1)`` computes the same sums without it."""
    if metric == "euclidean":
        xx = (torch.sum(x * x, dim=1) if xx is None else xx)[:, None]
        yy = torch.sum(y * y, dim=1)[None, :]
        with full_fp32_matmul():
            xy = torch.matmul(x, y.T)
        return torch.sqrt(torch.clamp_min(xx + yy - 2.0 * xy, 0.0))
    if metric == "manhattan":
        if x.shape[0] == 0 or y.shape[0] == 0:
            return x.new_zeros((x.shape[0], y.shape[0]))
        return torch.cdist(x, y, p=1.0)
    raise ValueError(f"unknown metric {metric}")


def _dist(X: DNDarray, Y: Optional[DNDarray], metric: str) -> DNDarray:
    """The distance matrix of the rows of X and Y (Y defaults to X) under ``metric``,
    with the split rules of the module docstring."""
    sanitize_in(X)
    if X.ndim != 2:
        raise NotImplementedError(f"X should be 2D, but is {X.ndim}D")
    if Y is None:
        Y = X
    sanitize_in(Y)
    if Y.ndim != 2:
        raise NotImplementedError(f"Y should be 2D, but is {Y.ndim}D")
    promoted = types.promote_types(
        types.promote_types(X.dtype, types.float32), types.promote_types(Y.dtype, types.float32)
    )
    out_split = 0 if X.split == 0 else (1 if Y.split == 0 else None)
    tt = promoted.torch_type()
    if X.split == 0 and Y.split == 0 and X.is_distributed():
        result = _ring_pairwise(X.comm, X.larray.to(tt), Y.larray.to(tt), Y.gshape[0], metric)
    else:
        xv = X.larray if out_split == 0 else X._relayout(None)
        yv = Y.larray if out_split == 1 else Y._relayout(None)
        result = _pairwise(xv.to(tt), yv.to(tt), metric)
    return DNDarray(result, (X.gshape[0], Y.gshape[0]), promoted, out_split, X.device, X.comm, True)


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Euclidean distance matrix between the rows of X and Y (Y defaults to X). The
    quadratic expansion is always used, as in heat_tpu. Both row-split: the ring; else the
    operand whose rows are not the result's split is gathered whole."""
    return _dist(X, Y, "euclidean")


def _ring_pairwise(comm, x: torch.Tensor, y: torch.Tensor, ny: int, metric: str = "euclidean") -> torch.Tensor:
    """This rank's rows of the distance matrix, with the row-split Y's chunks rotating
    around the ring: at step ``i`` this rank holds the chunk of rank ``(rank − i) % P``
    and sends it on while it fills that chunk's columns; the last chunk is consumed
    without a hop."""
    counts, displs, _ = comm.counts_displs_shape((ny,), 0)
    out = x.new_empty((x.shape[0], ny))
    for src, blk in comm.ring_blocks(y, lambda r: (counts[r], y.shape[1])):
        out[:, displs[src] : displs[src] + counts[src]] = _pairwise(x, blk, metric)
    return out


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """City-block distance matrix between the rows of X and Y (Y defaults to X), with
    cdist's split rules."""
    return _dist(X, Y, "manhattan")


def rbf(X: DNDarray, Y: Optional[DNDarray] = None, sigma: float = 1.0, quadratic_expansion: bool = False) -> DNDarray:
    """Gaussian kernel matrix exp(-d²/(2σ²)) of the Euclidean distances d, with cdist's
    split rules. The dtype follows heat_tpu's promotion: a Python ``sigma`` keeps the
    distances' type, a NumPy float64 ``sigma`` (as Spectral passes) makes the result
    float64."""
    d = _dist(X, Y, "euclidean")
    dtype = d.dtype
    if isinstance(sigma, (np.floating, np.ndarray)):
        dtype = types.promote_types(dtype, types.canonical_heat_type(np.asarray(sigma).dtype))
    tt = dtype.torch_type()
    neg = (-(d.larray**2)).to(tt)
    # the divisor as a tensor on the data's device: CUDA divides by a Python scalar
    # through its reciprocal
    s2 = torch.full((), 2.0 * sigma * sigma, dtype=tt, device=neg.device)
    return DNDarray(torch.exp(neg / s2), d.gshape, dtype, d.split, d.device, d.comm, True)
