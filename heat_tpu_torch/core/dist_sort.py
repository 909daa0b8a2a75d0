"""Distributed sort along the split axis with O(n/P) memory a rank (counterpart of
heat_tpu/core/dist_sort.py).

Each rank keeps its block of ``c = ceil(n/P)`` elements locally sorted. A block
compare-exchange with a partner rank is one send/recv pair (``TorchCommunication.exchange``)
and a merge that keeps the lower or the upper half. Any sorting network run with this
compare-exchange leaves the blocks globally sorted in rank order (Knuth 5.3.4): Batcher's
bitonic network (log²P rounds) when P is a power of two, odd-even transposition (P
rounds, neighbours only) otherwise (``_network_rounds``, heat_tpu/core/dist_sort.py:47).

The order is total, so the result equals ``torch.sort(stable=True)`` of the whole
array, NaN placement included: elements compare by (value, global index), the value in
the requested direction and the index ascending, by two stable sorts (first by index,
then by value; a complex value by its imaginary and then its real part, as jnp
orders it). Ragged chunks are padded to ``c`` with a sentinel that sorts after every element
(heat_tpu's ``_pad_sentinel``, :93) and a pad index past ``n``; with the ceil-division
chunk rule the sorted pads land exactly in the slots past each rank's canonical chunk,
so slicing them off leaves the canonical layout. At one rank it is one
``torch.sort(stable=True)``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from . import _complex_order

__all__ = ["distributed_sort"]


def _network_rounds(nproc: int) -> List[Tuple[List[int], List[bool]]]:
    """Per-round (partner, keep_lower) tables: Batcher's bitonic network for a power of
    two, odd-even transposition otherwise (a rank without a partner is its own)."""
    rounds: List[Tuple[List[int], List[bool]]] = []
    if nproc & (nproc - 1) == 0:
        k = 2
        while k <= nproc:
            j = k // 2
            while j >= 1:
                partner = [i ^ j for i in range(nproc)]
                keep_lower = [(i < (i ^ j)) == ((i & k) == 0) for i in range(nproc)]
                rounds.append((partner, keep_lower))
                j //= 2
            k *= 2
    else:
        for t in range(nproc):
            partner = list(range(nproc))
            for i in range(t % 2, nproc - 1, 2):
                partner[i], partner[i + 1] = i + 1, i
            rounds.append((partner, [i <= partner[i] for i in range(nproc)]))
    return rounds


def _pad_sentinel(dtype: torch.dtype, descending: bool):
    """A value that sorts after every element in the requested direction (ties with real
    elements lose on the pad's larger index)."""
    if dtype.is_complex:  # jnp's order: both parts NaN is last, -inf - inf·j first
        return complex(float("-inf"), float("-inf")) if descending else complex(float("nan"), float("nan"))
    if dtype.is_floating_point:
        return float("-inf") if descending else float("nan")
    if dtype == torch.bool:
        return not descending
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


def _lexsort(values: torch.Tensor, index: torch.Tensor, axis: int, descending: bool):
    """Sort by (value, index) along ``axis``: the value in the given direction, the index
    ascending; two stable sorts (complex values: the index, then the imaginary and the
    real part, :mod:`._complex_order`)."""
    if values.is_complex():
        order = _complex_order.lexsort_with_index(values, index, axis, descending)
        return values.take_along_dim(order, axis), index.take_along_dim(order, axis)
    order = torch.argsort(index, dim=axis, stable=True)
    values, index = values.take_along_dim(order, axis), index.take_along_dim(order, axis)
    order = torch.sort(values, dim=axis, descending=descending, stable=True).indices
    return values.take_along_dim(order, axis), index.take_along_dim(order, axis)


def distributed_sort(comm, local: torch.Tensor, n: int, axis: int, descending: bool = False):
    """Sort a split array along its split ``axis`` of global extent ``n``: returns this
    rank's canonical chunk of the sorted values and of their int64 global indices, the
    order of a stable sort of the whole array."""
    if not comm.is_distributed():
        if local.is_complex():
            indices = _complex_order.argsort(local, axis, descending)
            return local.take_along_dim(indices, axis), indices
        values, indices = torch.sort(local, dim=axis, descending=descending, stable=True)
        return values, indices.to(torch.int64)
    P, rank = comm.size, comm.rank
    c = -(-n // P) if n else 0
    mine = local.shape[axis]
    if c == 0:
        return local, torch.zeros(local.shape, dtype=torch.int64, device=local.device)
    offset = min(rank * c, n)
    shape = [1] * local.ndim
    shape[axis] = c
    index = torch.arange(offset, offset + c, dtype=torch.int64, device=local.device).view(shape).expand(
        *[c if d == axis else s for d, s in enumerate(local.shape)]
    ).contiguous()
    values = local
    if mine < c:
        pad_shape = list(local.shape)
        pad_shape[axis] = c - mine
        pad = torch.full(pad_shape, _pad_sentinel(local.dtype, descending), dtype=local.dtype, device=local.device)
        values = torch.cat([local, pad], dim=axis)
        index = index.clone()
        index.narrow(axis, mine, c - mine).add_(n)  # pads carry indices past n
    values, index = _lexsort(values, index, axis, descending)
    for partner, keep_lower in _network_rounds(P):
        peer = partner[rank]
        if peer == rank:  # ht: ignore[spmd-divergent-collective] -- pairwise compare-exchange: a rank that sits out a round of the network is its own partner, so no peer waits on it, and every other pair meets in its own exchange
            continue
        other_v = comm.exchange(values.contiguous(), peer)
        other_i = comm.exchange(index.contiguous(), peer)
        mv, mi = _lexsort(torch.cat([values, other_v], dim=axis), torch.cat([index, other_i], dim=axis), axis, descending)
        start = 0 if keep_lower[rank] else c
        values, index = mv.narrow(axis, start, c), mi.narrow(axis, start, c)
    keep = max(0, min(c, n - rank * c))
    return values.narrow(axis, 0, keep).contiguous(), index.narrow(axis, 0, keep).contiguous()
