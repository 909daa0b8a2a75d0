"""Indexing (counterpart of heat_tpu/core/indexing.py and of heat_tpu's
``DNDarray.__getitem__``/``__setitem__``, heat_tpu/core/dndarray.py:680-706).

A split array is indexed where its chunks lie:

- a key of ints and slices (with ``None`` and ``Ellipsis``) cuts each rank's chunk
  locally; when it slices the split axis, the pieces are rebalanced to the canonical
  chunks by ``TorchCommunication.redistribute`` (a negative step reverses each piece and
  the order of the ranks);
- an integer on the split axis is answered by the rank that holds it, which broadcasts
  the result;
- a boolean mask of the array's shape selects on each rank; heat_tpu's result of a mask
  is not split, so the selected elements are gathered in order (a variable-length
  all-gather of the selection, not of the array);
- integer arrays (and masks of another shape) beside or on the split axis: every rank
  computes the coordinates the key reads (:func:`_coords`, as many integers as the result
  has elements), each result element is fetched from the rank holding it
  (``TorchCommunication.take`` over the ranks' chunks in rank order), and each rank receives
  its chunk of the result (all of it where heat_tpu's result is unsplit), never the array.

``__setitem__`` writes only the local elements the key hits, with the value cut to them; for
integer arrays each rank writes the coordinates that fall in its chunk, in the key's order,
so duplicate keys end as they would on the whole array.
"""

from __future__ import annotations

import builtins
from typing import List

import numpy as np
import torch

from . import _operations, sanitation, types
from .dndarray import DNDarray

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """Indices of the non-zero elements as an (n, ndim) int64 array (torch.nonzero
    layout). A split array's indices are found locally, offset by the rank's
    displacement and rebalanced along axis 0 (heat_tpu's result split is 0)."""
    sanitation.sanitize_in(x)
    idx = torch.nonzero(x.larray)
    if x.split is None:
        return DNDarray(idx, tuple(idx.shape), types.int64, None, x.device, x.comm, True)
    offset, _, _ = x.comm.chunk(x.gshape, x.split)
    idx[:, x.split] += offset
    if x.split != 0 and x.is_distributed():
        # row-major order interleaves the ranks: order the indices by flat index (the
        # whole index list on every rank), then keep this rank's chunk
        flat = x.comm.all_gather_v((idx * _strides(x.gshape, idx.device)).sum(1))
        full = x.comm.all_gather_v(idx)[torch.argsort(flat)]
        _, _, slices = x.comm.chunk(tuple(full.shape), 0)
        return DNDarray(full[slices].contiguous(), tuple(full.shape), types.int64, 0, x.device, x.comm, True)
    return _operations.rebalance(idx, 0, x)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """Elements of ``x`` where ``cond`` holds, else of ``y``; with neither, :func:`nonzero`.
    The result takes x's and y's type and the dominant split of the three."""
    from . import factories
    from .stride_tricks import broadcast_shapes

    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    if not isinstance(cond, DNDarray):
        cond = factories.array(cond)
    if not isinstance(x, DNDarray) and not isinstance(y, DNDarray):
        x = factories.array(x, device=cond.device, comm=cond.comm)
    dtype = _operations._binary_types(x, y, torch.add)[0]
    out_shape = broadcast_shapes(*[t.gshape for t in (cond, x, y) if isinstance(t, DNDarray)])
    split = _operations._out_split_binary(out_shape, cond, x, y)
    ct = dtype.torch_type()

    def operand(t):
        if isinstance(t, DNDarray):
            return _operations._local_operand(t, out_shape, split).to(ct)
        return torch.as_tensor(t, dtype=ct, device=cond.larray.device)

    c = _operations._local_operand(cond, out_shape, split).to(torch.bool)
    _, lshape, _ = cond.comm.chunk(out_shape, split)
    value = torch.where(c, operand(x), operand(y)).expand(lshape).contiguous()
    return DNDarray(value, out_shape, dtype, split, cond.device, cond.comm, True)


def _strides(gshape, device) -> torch.Tensor:
    """Row-major element strides of ``gshape``."""
    return torch.tensor(np.cumprod((tuple(gshape[1:]) + (1,))[::-1])[::-1].copy(), dtype=torch.int64, device=device)


# --------------------------------------------------------------------------- keys
def _expand_key(x: DNDarray, key) -> List:
    """``key`` as a list with one entry per axis it consumes or adds: Ellipsis expanded,
    missing trailing axes filled with full slices; lists and numpy arrays as tensors."""
    if not isinstance(key, tuple):
        key = (key,)
    out = []
    for k in key:
        if isinstance(k, (list, np.ndarray)):
            k = torch.as_tensor(np.asarray(k))
        out.append(k)
    consumed = sum(_width(k) for k in out if k is not Ellipsis and k is not None)
    if any(k is Ellipsis for k in out):
        i = next(i for i, k in enumerate(out) if k is Ellipsis)
        out = out[:i] + [slice(None)] * (x.ndim - consumed) + [k for k in out[i + 1 :] if k is not Ellipsis]
    else:
        out += [slice(None)] * (x.ndim - consumed)
    return out


def _width(k) -> int:
    """How many axes of the array a key entry consumes (a bool mask its ndim)."""
    if isinstance(k, DNDarray):
        return k.ndim if k.dtype is types.bool else 1
    if isinstance(k, torch.Tensor):
        return k.ndim if k.dtype == torch.bool else 1
    return 1


def _index(t: torch.Tensor, keys) -> torch.Tensor:
    """``t[keys]`` with numpy's negative slice steps, which torch lacks: the axis is
    reversed and the slice taken forward over the same elements."""
    keys, dim, flips = list(keys), 0, []
    for i, k in enumerate(keys):
        if k is None:
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[dim]
            r = range(*k.indices(n))
            flips.append(dim)
            keys[i] = slice(n - 1 - r[0], n - r[-1], -k.step) if len(r) else slice(0, 0)
        dim += _width(k)
    return (torch.flip(t, flips) if flips else t)[tuple(keys)]


def _assign(t: torch.Tensor, keys, value: torch.Tensor) -> None:
    """``t[keys] = value`` with numpy's negative slice steps: the slice is taken forward
    over the same elements and the value reversed along its output axis."""
    keys, dim, flips = list(keys), 0, []
    if not all(_is_basic(e) for e in keys) and any(
            isinstance(k, slice) and k.step is not None and k.step < 0 for k in keys):
        # beside array indices: the flat positions the key reads (numpy's layout, which
        # _index gives), written in one put
        where = _index(torch.arange(t.numel(), device=t.device).view(t.shape), keys)
        dense = t if t.is_contiguous() else t.contiguous()
        dense.view(-1)[where.reshape(-1)] = torch.broadcast_to(value, where.shape).reshape(-1)
        if dense is not t:
            t.copy_(dense)
        return
    for i, k in enumerate(keys):
        if k is None:
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            r = range(*k.indices(t.shape[dim]))
            flips.append(_out_dim(keys, i))
            keys[i] = slice(r[-1], r[0] + 1, -k.step) if len(r) else slice(0, 0)
        dim += _width(k)
    if flips:
        target = t[tuple(keys)]
        value = torch.flip(value.expand(target.shape) if value.ndim <= target.ndim else value.reshape(target.shape), flips)
    t[tuple(keys)] = value


def _is_basic(k) -> bool:
    return k is None or isinstance(k, (slice, int, np.integer)) or (
        isinstance(k, (torch.Tensor, DNDarray)) and k.ndim == 0 and k.dtype not in (torch.bool, types.bool)
    )


def _scalar(k) -> int:
    return int(k.item()) if isinstance(k, (torch.Tensor, DNDarray)) else int(k)


def _global_key(x: DNDarray, key: list) -> tuple:
    """The key with DNDarray entries made whole tensors on x's device."""
    dev = x.larray.device
    return tuple(k._relayout(None).to(dev) if isinstance(k, DNDarray) else
                 (k.to(dev) if isinstance(k, torch.Tensor) else k) for k in key)


def _split_entry(x: DNDarray, key: list) -> int:
    """The position in ``key`` of the entry that indexes the split axis."""
    dim = 0
    for i, k in enumerate(key):
        if k is None:
            continue
        if dim <= x.split < dim + _width(k):
            return i
        dim += _width(k)
    raise IndexError("key does not reach the split axis")


def _out_dim(key: list, pos: int) -> int:
    """The output axis of the (slice) entry at ``pos`` in a basic key."""
    return sum(1 for k in key[:pos] if k is None or isinstance(k, slice))


def _local_slice(sl: slice, n: int, offset: int, count: int):
    """The part of the global slice ``sl`` (over extent ``n``) that falls in the chunk
    ``[offset, offset + count)``: the local slice, how many it selects and where the
    first of them stands in the result."""
    start, stop, step = sl.indices(n)
    sel = range(start, stop, step)
    if step > 0:
        first = max(0, -(-(offset - start) // step))
        last = min(len(sel), -(-(offset + count - start) // step))
    else:
        first = max(0, -(-(start - (offset + count - 1)) // -step))
        last = min(len(sel), (start - offset) // -step + 1) if start >= offset else 0
    k = max(0, last - first)
    if k == 0:
        return slice(0, 0), 0, 0, len(sel)
    lo = sel[first] - offset
    hi = sel[first + k - 1] - offset
    local = slice(lo, hi + 1, step) if step > 0 else slice(lo, (hi - 1) if hi > 0 else None, step)
    return local, k, first, len(sel)


def _getitem(x: DNDarray, key) -> DNDarray:
    new_split = x._index_split(key)
    keys = _expand_key(x, key)
    if x.split is None or not x.is_distributed():
        local = x._relayout(None) if x.split is not None else x.larray
        result = _index(local, _global_key(x, keys))
        return _operations.wrap_global(result, x, new_split)
    pos = _split_entry(x, keys)
    entry = keys[pos]
    offset, lshape, _ = x.comm.chunk(x.gshape, x.split)
    basic = all(_is_basic(k) for k in keys)
    if basic and isinstance(entry, slice):
        local_sl, k, first, total = _local_slice(entry, x.gshape[x.split], offset, lshape[x.split])
        lkeys = list(keys)
        lkeys[pos] = local_sl
        piece = _index(x.larray, lkeys)
        ax = _out_dim(keys, pos)
        counts = x.comm.all_gather_counts(k, piece.device)
        firsts = x.comm.all_gather_counts(first, piece.device)
        gshape = list(piece.shape)
        gshape[ax] = total
        dst = x.comm.counts_displs_shape(gshape, ax)[0]
        moved = x.comm.redistribute(piece, gshape, ax, counts, dst, src_displs=firsts)
        return DNDarray(moved, tuple(gshape), x.dtype, ax, x.device, x.comm, True)
    if basic and entry is not None:
        # an integer on the split axis: the rank holding it answers and broadcasts
        i = _scalar(entry)
        n = x.gshape[x.split]
        i = i + n if i < 0 else i
        if not 0 <= i < n:
            raise IndexError(f"index {_scalar(entry)} is out of bounds for axis {x.split} with size {n}")
        owner = i // -(-n // x.comm.size)  # the ceil-division chunk rule
        lkeys = list(keys)
        lkeys[pos] = i - offset if x.comm.rank == owner else 0
        probe = _index(torch.empty(x.gshape, device="meta"), lkeys[:pos] + [0] + lkeys[pos + 1 :])
        if x.comm.rank == owner:
            result = _index(x.larray, lkeys).contiguous()
        else:
            result = torch.empty(probe.shape, dtype=x.larray.dtype, device=x.larray.device)
        result = x.comm.bcast(result, root=owner)
        return _operations.wrap_global(result, x, new_split)
    mask = keys[pos]
    if (isinstance(mask, DNDarray) and mask.dtype is types.bool and mask.gshape == x.gshape
            and len([k for k in keys if k is not None]) == 1):
        # a mask of the array's shape: select on each rank, gather the selections in order
        m = mask._relayout(x.split).to(torch.bool)
        picked = x.larray[m]
        if x.split == 0:
            result = x.comm.all_gather_v(picked)
        else:  # row-major order interleaves the ranks: order the hits by flat index
            hits = torch.nonzero(m)
            hits[:, x.split] += offset
            flat = x.comm.all_gather_v((hits * _strides(x.gshape, hits.device)).sum(1))
            result = x.comm.all_gather_v(picked)[torch.argsort(flat)]
        return _operations.wrap_global(result, x, new_split)
    if isinstance(mask, (torch.Tensor, DNDarray)) and mask.ndim == 1 and mask.dtype not in (torch.bool, types.bool) \
            and all(isinstance(k, slice) and k == slice(None) for i, k in enumerate(keys) if i != pos):
        # one integer array on the split axis: the rows asked for come from their ranks
        # (a selection, not the array); the result is unsplit, as heat_tpu's
        idx = mask._relayout(None) if isinstance(mask, DNDarray) else mask
        idx = torch.where(idx < 0, idx + x.gshape[x.split], idx)
        counts = x.comm.counts_displs_shape(x.gshape, x.split)[0]
        return _operations.wrap_global(x.comm.take(x.larray, x.split, counts, idx, replicate=True), x, new_split)
    # other integer arrays (or a mask of another shape): each result element from its rank
    coords = _coords(x.gshape, _global_key(x, keys), x.larray.device)
    shape = tuple(coords[0].shape)
    flat = _chunk_positions(x, coords).reshape(-1)
    numels = [int(np.prod(ls)) for ls in x.comm.lshape_map(x.gshape, x.split).tolist()]
    split = new_split if new_split is not None and new_split < len(shape) else None
    if split is None:
        value = x.comm.take(x.larray.reshape(-1), 0, numels, flat, replicate=True).view(shape)
        return DNDarray(value, shape, x.dtype, None, x.device, x.comm, True)
    # this rank's chunk of the result along its split: positions in the result moved so
    # that the split axis leads, whose chunks are then ranges of the flat order
    order = torch.arange(flat.numel(), device=flat.device).view(shape).movedim(split, 0).reshape(-1)
    counts, displs, lshape = x.comm.counts_displs_shape(shape, split)
    inner = int(np.prod(shape)) // builtins.max(shape[split], 1) if shape[split] else 0
    ranges = [(d * inner, (d + c) * inner) for c, d in zip(counts, displs)]
    value = x.comm.take(x.larray.reshape(-1), 0, numels, flat[order], ranges=ranges)
    moved = (lshape[split],) + tuple(sz for d, sz in enumerate(shape) if d != split)
    return DNDarray(value.view(moved).movedim(0, split).contiguous(), shape, x.dtype, split, x.device, x.comm, True)


def _coords(gshape, keys, device) -> List[torch.Tensor]:
    """For each axis of an array of ``gshape``, the coordinate along that axis of each
    element that ``_index(array, keys)`` reads, in the result's shape: the key applied to
    each axis's ``arange`` broadcast over the array (a view, never the array's size; a
    negative step reverses the axis's ``arange`` and takes the slice forward, as ``_index``
    does)."""
    keys, dim, bases = list(keys), 0, [torch.arange(n, device=device) for n in gshape]
    for i, k in enumerate(keys):
        if k is None:
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = gshape[dim]
            r = range(*k.indices(n))
            bases[dim] = bases[dim].flip(0)
            keys[i] = slice(n - 1 - r[0], n - r[-1], -k.step) if len(r) else slice(0, 0)
        dim += _width(k)
    out = []
    for d, b in enumerate(bases):
        view = [1] * len(gshape)
        view[d] = gshape[d]
        out.append(b.view(view).expand(tuple(gshape))[tuple(keys)])
    return out


def _chunk_positions(x: DNDarray, coords: List[torch.Tensor]) -> torch.Tensor:
    """The positions of the elements at ``coords`` in the ranks' chunks of ``x`` laid end to
    end in rank order (each chunk in C order): where ``take`` over the flat chunks finds them."""
    counts, displs, _ = x.comm.counts_displs_shape(x.gshape, x.split)
    dev = coords[0].device
    c = -(-x.gshape[x.split] // x.comm.size) if x.gshape[x.split] else 1
    owner = torch.div(coords[x.split], c, rounding_mode="floor")
    count = torch.tensor(counts, dtype=torch.int64, device=dev)[owner]
    inner = int(np.prod(x.gshape[x.split + 1:]))
    before = int(np.prod(x.gshape[:x.split]))
    base = torch.tensor(np.cumsum([0] + [n * before * inner for n in counts[:-1]]), dtype=torch.int64, device=dev)
    pos = base[owner] + (coords[x.split] - torch.tensor(displs, dtype=torch.int64, device=dev)[owner]) * inner
    for d in range(x.split + 1, x.ndim):
        pos = pos + coords[d] * int(np.prod(x.gshape[d + 1:]))
    for d in range(x.split):
        pos = pos + coords[d] * int(np.prod(x.gshape[d + 1:x.split])) * count * inner
    return pos


def _take_rows(x: DNDarray, rows: torch.Tensor) -> DNDarray:
    """``x[rows]`` for a whole int64 tensor of as many row indices as x has rows, split
    as x: split 0 fetches each rank's chunk of the result from the ranks holding the rows
    (``TorchCommunication.take``); another split takes rows locally."""
    if x.split == 0:
        counts = x.comm.counts_displs_shape(x.gshape, 0)[0]
        value = x.comm.take(x.larray, 0, counts, rows)
    else:
        value = x.larray.index_select(0, rows.to(x.larray.device))
    return DNDarray(value, x.gshape, x.dtype, x.split, x.device, x.comm, True)


def _mask_positions(x: DNDarray, m: torch.Tensor) -> torch.Tensor:
    """The positions in the global C order of ``x``'s selection of this rank's hits of the
    mask chunk ``m`` (along x's split axis), in local C order. The leading axes before the
    split interleave the ranks' hits, so each rank counts its hits in every row of the
    leading axes, and one all-gather of those counts gives, by an exclusive scan in
    (row, rank) order, where each rank's run of a row starts."""
    s = x.split
    rows = int(np.prod(m.shape[:s])) if s else 1
    per_row = m.reshape(rows, -1).sum(1)
    counts = x.comm.all_gather_stacked(per_row)  # (ranks, rows)
    starts = torch.cumsum(counts.t().reshape(-1), 0) - counts.t().reshape(-1)  # (row, rank) order
    start = starts.view(rows, -1)[:, x.comm.rank]
    row_of = torch.nonzero(m.reshape(rows, -1))[:, 0]  # the row of each hit, in C order
    first = torch.cumsum(per_row, 0) - per_row
    return start[row_of] + torch.arange(row_of.numel(), device=m.device) - first[row_of]


def _set_mask(x: DNDarray, mask: DNDarray, value) -> None:
    """``x[mask] = value`` for a bool mask of a split ``x``'s shape: each rank writes its own
    hits, whose places in the selection's global order :func:`_mask_positions` gives. A
    split 1-D value is fetched element by element from the ranks holding it, never whole."""
    dev, dt = x.larray.device, x.larray.dtype
    m = mask._relayout(x.split).to(torch.bool)
    pos = _mask_positions(x, m)
    fetched = isinstance(value, DNDarray) and value.split == 0 and value.ndim == 1 and value.is_distributed()
    if fetched:  # ht: ignore[spmd-divergent-collective] -- the value's split and shape are global metadata, the same on every rank, so every rank takes the same branch
        hits = int(x.comm.all_reduce(torch.tensor(pos.numel(), device=dev), "sum"))
        if hits != value.gshape[0]:
            raise ValueError(f"shape mismatch: {value.gshape[0]} values for the mask's selection of {hits}")
        x.larray[m] = x.comm.fetch(value.larray, x.comm.counts_displs_shape(value.gshape, 0)[0], pos).to(dt)
        return
    if isinstance(value, DNDarray):
        value = value._relayout(None)
    value = torch.as_tensor(value, device=dev).to(dt) if not isinstance(value, torch.Tensor) else value.to(dev, dt)
    x.larray[m] = value.reshape(()) if value.numel() <= 1 else value.reshape(-1)[pos]


def _setitem(x: DNDarray, key, value) -> None:
    """Write ``value`` where ``key`` hits x: each rank its own elements."""
    keys = _expand_key(x, key)
    if x.split is not None and x.is_distributed():
        mask = keys[_split_entry(x, keys)]
        if (isinstance(mask, DNDarray) and mask.dtype is types.bool and mask.gshape == x.gshape
                and len([k for k in keys if k is not None]) == 1):
            _set_mask(x, mask, value)
            return
    dev, dt = x.larray.device, x.larray.dtype
    if isinstance(value, DNDarray):
        value = value._relayout(None)
    value = torch.as_tensor(value, device=dev).to(dt) if not isinstance(value, torch.Tensor) else value.to(dev, dt)
    if x.split is None or not x.is_distributed():
        _assign(x.larray, _global_key(x, keys), value)
        return
    pos = _split_entry(x, keys)
    entry = keys[pos]
    offset, lshape, _ = x.comm.chunk(x.gshape, x.split)
    n = x.gshape[x.split]
    if all(_is_basic(k) for k in keys) and isinstance(entry, slice):
        local_sl, k, first, _ = _local_slice(entry, n, offset, lshape[x.split])
        target = _index(torch.empty(x.gshape, device="meta"), _global_key(x, keys))
        v = value.expand(target.shape) if value.ndim <= target.ndim else value.reshape(target.shape)
        ax = _out_dim(keys, pos)
        lkeys = list(keys)
        lkeys[pos] = local_sl
        if k:
            _assign(x.larray, lkeys, v.narrow(ax, first, k))
        return
    if all(_is_basic(k) for k in keys) and entry is not None:
        i = _scalar(entry)
        i = i + n if i < 0 else i
        if offset <= i < offset + lshape[x.split]:
            lkeys = list(keys)
            lkeys[pos] = i - offset
            _assign(x.larray, lkeys, value)
        return
    # integer arrays (or a mask of another shape): each rank writes the coordinates in its
    # chunk with the matching elements of the broadcast value, in the key's order
    coords = _coords(x.gshape, _global_key(x, keys), dev)
    shape = tuple(coords[0].shape)
    v = value.reshape(shape) if value.ndim > len(shape) else value
    mine = (coords[x.split] >= offset) & (coords[x.split] < offset + lshape[x.split])
    local = [c[mine] for c in coords]
    local[x.split] = local[x.split] - offset
    x.larray[tuple(local)] = torch.broadcast_to(v, shape)[mine]
