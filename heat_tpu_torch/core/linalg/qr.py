"""QR decomposition (counterpart of heat_tpu/core/linalg/qr.py).

A tall-skinny split=0 array takes the two-level TSQR: each rank factors its own row
panels (the row cuts of :class:`~..tiling.SquareDiagTiles`: ``tiles_per_proc`` panels of
its chunk), the small R factors are gathered, every rank factors the same R-stack, and
each rank's rows of Q are its panels' Q times its rows of the second level's Q. Only the
R factors cross ranks. Any other layout factors the gathered matrix with
``torch.linalg.qr``.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import torch

from .. import types
from ..dndarray import DNDarray
from . import comm_plan

__all__ = ["qr"]

QR_t = collections.namedtuple("QR", "Q, R")


def qr(a: DNDarray, tiles_per_proc: int = 2, calc_q: bool = True, overwrite_a: bool = False):
    """QR decomposition of a 2-D DNDarray; returns ``QR(Q, R)`` (heat_tpu qr.py:31).

    Q keeps ``a``'s split; R is whole on every rank, except for a split=1 input, whose R
    is split 1 as in heat_tpu. ``tiles_per_proc`` is the number of TSQR panels a rank
    factors (when ``m >= n`` times the number of panels; else one a rank)."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"'a' must be a DNDarray, got {type(a)}")
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    if not isinstance(tiles_per_proc, int) or tiles_per_proc < 1:
        raise ValueError(f"tiles_per_proc must be a positive int, got {tiles_per_proc}")
    if not issubclass(a.dtype, types.floating):
        a = a.astype(types.promote_types(a.dtype, types.float32))

    m, n = a.gshape
    nproc = a.comm.size
    if a.split == 0 and a.is_distributed() and m >= n * nproc:
        from ..tiling import SquareDiagTiles

        tiles = SquareDiagTiles(a, tiles_per_proc=tiles_per_proc)
        counts = a.comm.lshape_map(a.gshape, 0)[:, 0]
        if m >= n * tiles.tile_rows:
            heights = [_cut(int(c), tiles_per_proc) for c in counts]  # the tile rows of each rank
        else:
            heights = [[int(c)] if c else [] for c in counts]
        q_val, r_val = _tsqr(a, heights, calc_q)
        r_split, q_gshape = None, (m, r_val.shape[0])
    else:
        full = a._relayout(None)
        if calc_q:
            q_val, r_val = torch.linalg.qr(full, mode="reduced")
        else:
            q_val, r_val = None, torch.linalg.qr(full, mode="r")[1]
        r_split = 1 if a.split == 1 else None
        if q_val is not None:
            q_gshape = tuple(q_val.shape)
            if a.split is not None:
                _, _, sl = a.comm.chunk(q_gshape, a.split)
                q_val = q_val[sl].contiguous()
    r_gshape = tuple(r_val.shape)
    if r_split is not None:
        _, _, sl = a.comm.chunk(r_gshape, r_split)
        r_val = r_val[sl].contiguous()
    r = DNDarray(r_val, r_gshape, types.canonical_heat_type(r_val.dtype), r_split, a.device, a.comm, True)
    if overwrite_a:
        a._rebind(r)
    if not calc_q:
        return QR_t(None, r)
    q = DNDarray(q_val, q_gshape, types.canonical_heat_type(q_val.dtype), a.split, a.device, a.comm, True)
    return QR_t(q, r)


def _cut(extent: int, pieces: int) -> List[int]:
    """``extent`` rows cut into ``pieces`` panels as SquareDiagTiles cuts a chunk (the
    first ``extent % pieces`` one row taller), empty panels dropped."""
    base, rem = divmod(extent, pieces)
    return [h for h in (base + (1 if t < rem else 0) for t in range(pieces)) if h]


def _tsqr(a: DNDarray, heights: List[List[int]], calc_q: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Two-level TSQR of the tall-skinny split=0 ``a`` (heat_tpu qr.py:90), with
    ``heights[r]`` the panel heights of rank ``r``'s chunk.

    Level 1: each rank factors its panels. Level 2: every rank factors the gathered
    R-stack (the same bits on every rank). Returns this rank's rows of Q (None without
    ``calc_q``) and R."""
    comm = a.comm
    n = a.gshape[1]
    x = a.larray
    mine = heights[comm.rank]
    panels = list(x.split(mine, dim=0)) if mine else []
    factors = [torch.linalg.qr(p, mode="reduced" if calc_q else "r") for p in panels]
    rs = [f[1] for f in factors]
    k_of = [[min(h, n) for h in hs] for hs in heights]  # rows of each panel's R
    rows = [sum(ks) for ks in k_of]
    stack = torch.cat(rs, dim=0) if rs else x.new_zeros((0, n))
    # every rank's R factors, padded to the longest stack for one gather, then trimmed
    pad = max(rows) - stack.shape[0]
    if pad:
        stack = torch.cat([stack, stack.new_zeros((pad, n))], dim=0)
    gathered = comm.all_gather_stacked(stack)
    r_stack = torch.cat([gathered[r, : rows[r]] for r in range(comm.size)], dim=0)
    if not calc_q:
        return None, torch.linalg.qr(r_stack, mode="r")[1]
    q2, r = torch.linalg.qr(r_stack, mode="reduced")
    offset = sum(rows[: comm.rank])
    parts = []
    for (q1, _), k in zip(factors, k_of[comm.rank]):
        parts.append(comm_plan._mm(q1, q2[offset : offset + k]))
        offset += k
    q = torch.cat(parts, dim=0) if parts else x.new_zeros((0, q2.shape[1]))
    return q, r
