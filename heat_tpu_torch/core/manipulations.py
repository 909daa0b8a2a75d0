"""Array manipulations (counterpart of heat_tpu/core/manipulations.py).

heat_tpu's manipulations are one jnp call on the global array, XLA emitting the relayout.
Here each rank holds its chunk, so each manipulation moves what it must:

1. it computes its rank-local piece;
2. it learns the global extents from one small all-gather of counts;
3. it rebalances to the canonical ceil-division chunks with
   ``TorchCommunication.redistribute``, so lshape maps equal heat_tpu's.

On ``reshape(new_split=...)``, ``concatenate``, ``resplit``, ``sort`` and ``topk`` along the
split axis, ``unique``, ``flip``, ``roll``, ``tile``, ``pad`` and ``diag`` no rank gathers
the array: each moves and holds O(n/P) (``unique`` and ``topk`` gather only their per-rank
candidates, ``diagonal`` of the split axis the diagonal, ``pad``'s computed modes a plane of
totals or the two edge planes). Splitting along the split axis gathers the array: heat_tpu's
parts are unsplit, so together they are the array.
"""

from __future__ import annotations

import builtins
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _complex_order, _operations, sanitation, stride_tricks, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "collect",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unique",
    "vsplit",
    "vstack",
]


def _ensure(x) -> DNDarray:
    from . import factories

    return x if isinstance(x, DNDarray) else factories.array(x)


def _wrap(local: torch.Tensor, gshape, proto: DNDarray, split: Optional[int]) -> DNDarray:
    return _operations.wrap_result(local, proto, split, tuple(gshape))


def _range_overlaps(start: int, n: int, counts: Sequence[int]) -> List[int]:
    """How much of ``[start, start + n)`` falls in each rank's range of consecutive
    ``counts``."""
    out, lo = [], 0
    for c in counts:
        out.append(builtins.max(0, builtins.min(lo + c, start + n) - builtins.max(lo, start)))
        lo += c
    return out


# --------------------------------------------------------------------------- distribution
def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """Out-of-place balance: the chunks are canonical already."""
    sanitation.sanitize_in(array)
    if copy:
        from . import memory

        return memory.copy(array)
    return array.balance_()


def collect(arr: DNDarray, target_rank: int = 0) -> DNDarray:
    """The array whole on every rank (split None)."""
    sanitation.sanitize_in(arr)
    return arr.resplit(None)


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """Out-of-place :meth:`DNDarray.redistribute_`."""
    from . import memory

    out = memory.copy(arr)
    out.redistribute_(lshape_map, target_map)
    return out


def resplit(arr: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """Out-of-place resplit: split→split is one all-to-all, split→None gathers."""
    sanitation.sanitize_in(arr)
    return arr.resplit(axis)


def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape."""
    return a.gshape


# --------------------------------------------------------------------------- shapes
def reshape(a: DNDarray, *shape, **kwargs) -> DNDarray:
    """Reshape, the result split along ``new_split`` (heat_tpu's default: the old split if
    the new shape has that axis, else its last axis). A split array is first laid out
    along axis 0 (one all-to-all), where each rank holds a consecutive range of the
    row-major elements; those ranges move to the new shape's split-0 chunks by one
    ``redistribute`` of the flat elements, and a last all-to-all lays them along
    ``new_split``. Nothing is gathered."""
    sanitation.sanitize_in(a)
    new_split = kwargs.pop("new_split", None)
    if kwargs:
        raise TypeError(f"unexpected kwargs {tuple(kwargs)}")
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = tuple(int(s) for s in shape)
    if any(s == -1 for s in shape):
        known = int(np.prod([s for s in shape if s != -1]))
        missing = a.size // known if known else 0
        shape = tuple(missing if s == -1 else s for s in shape)
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {shape}")
    if new_split is None:
        new_split = None if a.split is None else (a.split if a.split < len(shape) else len(shape) - 1)
    else:
        new_split = sanitize_axis(shape, new_split)
    if len(shape) == 0:
        new_split = None
    if a.split is None:
        return _operations.wrap_global(a.larray.reshape(shape), a, new_split)
    if not a.is_distributed():
        return _wrap(a.larray.reshape(shape), shape, a, new_split)
    if new_split is None:  # a 0-d result of a one-element array
        return _operations.wrap_global(a._relayout(None).reshape(shape), a, None)
    comm = a.comm
    flat = a._relayout(0).reshape(-1)
    row_old = int(np.prod(a.gshape[1:])) if a.ndim > 1 else 1
    src = [c * row_old for c in comm.counts_displs_shape(a.gshape, 0)[0]]
    row_new = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    dst = [c * row_new for c in comm.counts_displs_shape(shape, 0)[0]]
    moved = comm.redistribute(flat, (a.size,), 0, src, dst)
    _, lshape0, _ = comm.chunk(shape, 0)
    res = _wrap(moved.reshape(lshape0), shape, a, 0)
    return res if new_split == 0 else res.resplit_(new_split)


def flatten(a: DNDarray) -> DNDarray:
    """The array as 1-D, split 0 if it was split."""
    sanitation.sanitize_in(a)
    return reshape(a, (a.size,), new_split=None if a.split is None else 0)


def ravel(a: DNDarray) -> DNDarray:
    """Alias of :func:`flatten`."""
    return flatten(a)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert a new axis: local, the split shifted past it."""
    sanitation.sanitize_in(a)
    axis = sanitize_axis(a.gshape + (1,), axis)
    split = a.split if a.split is None or a.split < axis else a.split + 1
    gshape = a.gshape[:axis] + (1,) + a.gshape[axis:]
    return _wrap(a.larray.unsqueeze(axis), gshape, a, split)


def squeeze(x: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None) -> DNDarray:
    """Remove axes of length one; a removed split axis leaves the array unsplit."""
    sanitation.sanitize_in(x)
    if axis is None:
        removed = tuple(i for i, s in enumerate(x.gshape) if s == 1)
    else:
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        removed = tuple(sanitize_axis(x.gshape, ax) for ax in axes)
        for ax in removed:
            if x.gshape[ax] != 1:
                raise ValueError(f"cannot squeeze axis {ax} with size {x.gshape[ax]}")
    split = x.split
    local = x.larray
    if split is not None and split in removed:
        local, split = x._relayout(None), None
    elif split is not None:
        split -= builtins.sum(1 for ax in removed if ax < split)
    gshape = tuple(s for i, s in enumerate(x.gshape) if i not in removed)
    value = local.reshape([s for i, s in enumerate(local.shape) if i not in removed])
    return _wrap(value, gshape, x, split)


def broadcast_to(x: DNDarray, shape: Sequence[int]) -> DNDarray:
    """Broadcast to ``shape``; the split moves with the leading axes added."""
    sanitation.sanitize_in(x)
    shape = tuple(int(s) for s in shape)
    split = None if x.split is None else x.split + (len(shape) - x.ndim)
    if split is None:
        return _wrap(x.larray.expand(shape).contiguous(), shape, x, None)
    if x.gshape[x.split] != shape[split]:  # the split axis itself broadcasts
        return _operations.wrap_global(x._relayout(None).expand(shape), x, split)
    _, lshape, _ = x.comm.chunk(shape, split)
    return _wrap(x.larray.expand(lshape).contiguous(), shape, x, split)


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """Broadcast arrays against each other."""
    arrays = [_ensure(a) for a in arrays]
    shapes = [a.gshape for a in arrays]
    out_shape = stride_tricks.broadcast_shapes(*shapes) if len(shapes) > 1 else shapes[0]
    return [broadcast_to(a, out_shape) for a in arrays]


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Move axes to new positions (a local permute)."""
    sanitation.sanitize_in(x)
    source = (source,) if isinstance(source, int) else source
    destination = (destination,) if isinstance(destination, int) else destination
    source = tuple(sanitize_axis(x.gshape, s) for s in source)
    destination = tuple(sanitize_axis(x.gshape, d) for d in destination)
    if len(source) != len(destination):
        raise ValueError("source and destination must have the same number of elements")
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    from .linalg import transpose

    return transpose(x, order)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Interchange two axes (a local permute)."""
    sanitation.sanitize_in(x)
    axis1, axis2 = sanitize_axis(x.gshape, axis1), sanitize_axis(x.gshape, axis2)
    axes = list(range(x.ndim))
    axes[axis1], axes[axis2] = axes[axis2], axes[axis1]
    from .linalg import transpose

    return transpose(x, axes)


# --------------------------------------------------------------------------- joining
def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis. The first operand's split that is not None
    wins, and every operand is laid out along it (None→split keeps each rank's chunk,
    split→split is an all-to-all). Along another axis the chunks join locally; along the
    split axis each operand moves to the part of the result's canonical chunks it
    covers, by one ``redistribute`` each."""
    if not isinstance(arrays, (tuple, list)):
        raise TypeError("concatenate requires a sequence of DNDarrays")
    if len(arrays) == 0:
        raise ValueError("need at least one array to concatenate")
    arrays = [_ensure(a) for a in arrays]
    proto = arrays[0]
    axis = sanitize_axis(proto.gshape, axis)
    dt = types.result_type(*arrays).torch_type()
    split = next((a.split for a in arrays if a.split is not None), None)
    gshape = list(proto.gshape)
    gshape[axis] = builtins.sum(a.gshape[axis] for a in arrays)
    for a in arrays:
        if a.ndim != proto.ndim or any(a.gshape[d] != gshape[d] for d in range(a.ndim) if d != axis):
            raise ValueError(f"all the input array dimensions except for axis {axis} must match")
    locs = [a._relayout(split).to(dt) for a in arrays]
    if split is None or axis != split or not proto.comm.is_distributed():
        return _wrap(torch.cat(locs, dim=axis), gshape, proto, split)
    comm = proto.comm
    dst = comm.counts_displs_shape(gshape, axis)[0]
    pieces, start = [], 0
    for a, loc in zip(arrays, locs):
        n = a.gshape[axis]
        src = comm.counts_displs_shape(a.gshape, axis)[0]
        pieces.append(comm.redistribute(loc, a.gshape, axis, src, _range_overlaps(start, n, dst)))
        start += n
    return _wrap(torch.cat(pieces, dim=axis), gshape, proto, split)


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack horizontally."""
    arrays = [_ensure(a) for a in arrays]
    return concatenate(arrays, axis=0 if all(a.ndim == 1 for a in arrays) else 1)


def _stacked(arrays, axis: int) -> DNDarray:
    """Concatenate along ``axis`` with 1-D operands made 2-D across it (their elements
    along the other axis), the result split by heat_tpu's rule: the first operand split
    that is not None, as given."""
    arrays = [_ensure(a) for a in arrays]
    split = next((a.split for a in arrays if a.split is not None), None)
    other = 1 - axis
    parts = [a if a.ndim > 1 else reshape(a, (a.gshape[0], 1) if axis else (1, a.gshape[0]),
                                          new_split=None if a.split is None else other)
             for a in arrays]
    res = concatenate(parts, axis=axis)
    return res if res.split == split else res.resplit_(split)


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack 1-D and 2-D arrays as the columns of a 2-D array."""
    return _stacked(arrays, 1)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack arrays row-wise."""
    return _stacked(arrays, 0)


vstack = row_stack


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join equally shaped arrays along a new axis; each is laid out along the first
    split given and the chunks stack locally."""
    arrays = [_ensure(a) for a in arrays]
    proto = arrays[0]
    for a in arrays[1:]:
        if a.gshape != proto.gshape:
            raise ValueError("all input arrays must have the same shape")
    axis = sanitize_axis(proto.gshape + (1,), axis)
    base = next((a.split for a in arrays if a.split is not None), None)
    dt = types.result_type(*arrays).torch_type()
    value = torch.stack([a._relayout(base).to(dt) for a in arrays], dim=axis)
    split = None if base is None else (base if base < axis else base + 1)
    gshape = proto.gshape[:axis] + (len(arrays),) + proto.gshape[axis:]
    return _operations.handle_out(_wrap(value, gshape, proto, split), out)


# --------------------------------------------------------------------------- splitting
def _sections(n: int, indices_or_sections) -> List[int]:
    if isinstance(indices_or_sections, (int, np.integer)):
        k = int(indices_or_sections)
        if k <= 0 or n % k:
            raise ValueError("array split does not result in an equal division")
        return [i * (n // k) for i in range(1, k)]
    return [int(i) for i in indices_or_sections]


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Split into sub-arrays along ``axis``; along another axis than the split each rank
    cuts its chunk, along the split axis the parts are unsplit (heat_tpu's rule), so the
    array is gathered: together the parts are the whole array on every rank."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.numpy().tolist()
    elif isinstance(indices_or_sections, np.ndarray):
        indices_or_sections = indices_or_sections.tolist()
    cuts = _sections(x.gshape[axis], indices_or_sections)
    if x.split == axis:
        return [_operations.wrap_global(p, x, None) for p in torch.tensor_split(x._relayout(None), cuts, dim=axis)]
    out = []
    for p in torch.tensor_split(x.larray, cuts, dim=axis):
        gshape = list(x.gshape)
        gshape[axis] = p.shape[axis]
        out.append(_wrap(p.contiguous(), gshape, x, x.split))
    return out


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along the third axis."""
    return split(x, indices_or_sections, axis=2)


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along the second axis (1-D: the first)."""
    return split(x, indices_or_sections, axis=0 if x.ndim < 2 else 1)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along the first axis."""
    return split(x, indices_or_sections, axis=0)


# --------------------------------------------------------------------------- reordering
def flip(a: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]] = None) -> DNDarray:
    """Reverse the order along ``axis`` (None: every axis). Along the split axis each
    rank reverses its chunk, which then covers the mirrored range of the result, and one
    ``redistribute`` restores the canonical chunks."""
    sanitation.sanitize_in(a)
    axes = tuple(range(a.ndim)) if axis is None else sanitize_axis(a.gshape, axis)
    axes = axes if isinstance(axes, tuple) else (axes,)
    local = torch.flip(a.larray, axes) if axes else a.larray.clone()
    if a.split is None or a.split not in axes or not a.is_distributed():
        return _wrap(local, a.gshape, a, a.split)
    comm, n = a.comm, a.gshape[a.split]
    counts, displs, _ = comm.counts_displs_shape(a.gshape, a.split)
    mirrored = [n - d - c for d, c in zip(displs, counts)]
    moved = comm.redistribute(local, a.gshape, a.split, counts, counts, src_displs=mirrored)
    return _wrap(moved, a.gshape, a, a.split)


def fliplr(a: DNDarray) -> DNDarray:
    """Flip along axis 1."""
    if a.ndim < 2:
        raise IndexError("fliplr requires at least 2 dimensions")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """Flip along axis 0."""
    return flip(a, 0)


def _rolled(comm, local: torch.Tensor, axis: int, counts: Sequence[int], dst: Sequence[Tuple[int, int]],
            shift: int) -> torch.Tensor:
    """Result positions ``dst[rank]`` = [lo, hi) of an axis of extent N = sum(counts) rolled
    by ``shift``, whose rank ``r`` holds ``counts[r]`` consecutive slices: position i takes
    source (i − shift) mod N. With s = shift mod N the sources cover [s, s + N) of a doubled
    axis, so [max(lo, s), hi) comes from one ``redistribute`` and [lo, min(hi, s)) from a
    second one over [lo + N, min(hi, s) + N): each rank receives its range, nothing more."""
    n = int(builtins.sum(counts))
    s = int(shift) % n if n else 0
    gshape = list(local.shape)
    gshape[axis] = n
    src = [d + s for d in np.cumsum([0] + list(counts[:-1])).tolist()]
    tail = [builtins.max(0, hi - builtins.max(lo, s)) for lo, hi in dst]
    head = [builtins.max(0, builtins.min(hi, s) - lo) for lo, hi in dst]
    late = comm.redistribute(local, gshape, axis, counts, tail, src_displs=src,
                             dst_displs=[builtins.max(lo, s) for lo, _ in dst])
    early = comm.redistribute(local, gshape, axis, counts, head, src_displs=src, dst_displs=[lo + n for lo, _ in dst])
    return torch.cat([early, late], dim=axis)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Roll elements along ``axis`` (None: the flattened array), as numpy's roll. The
    other axes roll locally. Along the split axis this rank's chunk of the result is at
    most two ranges of the source, which two ``redistribute`` calls bring (:func:`_rolled`);
    the flattened order of a split-0 array is rank-major, so a flat roll is the same on the
    flat chunks, and another split is relaid to split 0 (an all-to-all) and back."""
    sanitation.sanitize_in(x)
    comm = x.comm
    if axis is None:
        total = int(np.sum(shift))
        if x.split is None or not x.is_distributed():
            whole = x.larray if x.split is None else x._relayout(None)
            value = torch.roll(whole.reshape(-1), total).reshape(whole.shape)
            return _operations.wrap_global(value, x, x.split)
        local = x.larray if x.split == 0 else x._relayout(0)
        inner = int(np.prod(x.gshape[1:]))
        counts, displs, _ = comm.counts_displs_shape(x.gshape, 0)
        dst = [(d * inner, (d + c) * inner) for c, d in zip(counts, displs)]
        flat = _rolled(comm, local.reshape(-1), 0, [c * inner for c in counts], dst, total)
        rolled = DNDarray(flat.reshape(local.shape), x.gshape, x.dtype, 0, x.device, comm, True)
        return rolled if x.split == 0 else _wrap(rolled._relayout(x.split), x.gshape, x, x.split)
    axes = [sanitize_axis(x.gshape, ax) for ax in (axis if isinstance(axis, (tuple, list)) else (axis,))]
    shifts, axes = np.broadcast_arrays(np.atleast_1d(np.asarray(shift)), np.asarray(axes))  # numpy's pairing
    local_pairs = [(int(sh), int(ax)) for sh, ax in zip(shifts, axes) if ax != x.split or not x.is_distributed()]
    value = x.larray
    if local_pairs:
        value = torch.roll(value, [p[0] for p in local_pairs], [p[1] for p in local_pairs])
    along = [int(sh) for sh, ax in zip(shifts, axes) if ax == x.split and x.is_distributed()]
    if along:
        counts, displs, _ = comm.counts_displs_shape(x.gshape, x.split)
        value = _rolled(comm, value, x.split, counts, [(d, d + c) for c, d in zip(counts, displs)], builtins.sum(along))
    return _wrap(value, x.gshape, x, x.split)


def rot90(m: DNDarray, k: int = 1, axes: Sequence[int] = (0, 1)) -> DNDarray:
    """Rotate by 90° ``k`` times in the plane of ``axes``: flips and a transpose."""
    sanitation.sanitize_in(m)
    axes = tuple(sanitize_axis(m.gshape, ax) for ax in axes)
    if len(axes) != 2 or axes[0] == axes[1]:
        raise ValueError("len(axes) must be 2 with distinct entries")
    k %= 4
    if k == 0:
        return _wrap(m.larray.clone(), m.gshape, m, m.split)
    if k == 2:
        return flip(flip(m, axes[0]), axes[1])
    order = list(range(m.ndim))
    order[axes[0]], order[axes[1]] = order[axes[1]], order[axes[0]]
    from .linalg import transpose

    if k == 1:
        return transpose(flip(m, axes[1]), order)
    return flip(transpose(m, order), axes[1])


def _pad_widths(pad_width, ndim: int) -> List[Tuple[int, int]]:
    """numpy's pad widths as one (before, after) pair an axis."""
    w = np.asarray(pad_width, dtype=np.int64)
    if w.ndim == 0:
        return [(int(w), int(w))] * ndim
    if w.ndim == 1:
        return [(int(w[0]), int(w[-1]))] * ndim
    return [(int(p[0]), int(p[-1])) for p in np.broadcast_to(w, (ndim, w.shape[-1]))]


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """The source positions of an axis of ``n`` padded by ``before`` and ``after`` in a
    mode that copies elements (numpy's rule, also for pads wider than the axis)."""
    if n == 0 and before + after:
        raise ValueError(f"can't extend an empty axis with mode {mode!r}")
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, builtins.max(n - 1, 0))
    if mode == "wrap":
        return i % n
    if mode == "symmetric":
        j = i % (2 * n)
        return torch.where(j < n, j, 2 * n - 1 - j)
    if n == 1:  # reflect
        return torch.zeros_like(i)
    j = i % (2 * (n - 1))
    return torch.where(j < n, j, 2 * (n - 1) - j)


def _median(v: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.median along ``axis`` (kept): the middle of the sorted values, the mean of the two
    middles for an even count, NaN where the axis holds one."""
    n = v.shape[axis]
    s = torch.sort(v, dim=axis).values  # NaN last
    lo, hi = s.narrow(axis, (n - 1) // 2, 1), s.narrow(axis, n // 2, 1)
    mid = (lo + hi) * 0.5
    return torch.where(torch.isnan(v).any(axis, keepdim=True), float("nan"), mid)


def _extreme(v: torch.Tensor, axis, kind: str, comm=None) -> torch.Tensor:
    """torch.amax / amin along ``axis`` (an int or a tuple, kept), a NaN winning as in jnp;
    with ``comm``, of the chunks every rank holds along ``axis`` (one all-reduce; an empty
    chunk gives the operation's identity, and a NaN anywhere is carried by a second, one
    flag a value)."""
    op = torch.amax if kind == "max" else torch.amin
    if comm is None:
        return op(v, axis, keepdim=True)
    axes = axis if isinstance(axis, tuple) else (axis,)
    shape = [1 if d in axes else n for d, n in enumerate(v.shape)]
    if v.numel():
        stat = op(v, axis, keepdim=True)
    elif v.dtype.is_floating_point:
        stat = torch.full(shape, float("-inf") if kind == "max" else float("inf"), dtype=v.dtype, device=v.device)
    elif v.dtype == torch.bool:
        stat = torch.full(shape, kind == "min", dtype=v.dtype, device=v.device)
    else:
        info = torch.iinfo(v.dtype)
        stat = torch.full(shape, info.min if kind == "max" else info.max, dtype=v.dtype, device=v.device)
    comm.all_reduce(stat, kind)
    if v.dtype.is_floating_point:
        nan = torch.isnan(v).any(axis, keepdim=True) if v.numel() else torch.zeros(shape, dtype=torch.bool,
                                                                                   device=v.device)
        comm.all_reduce(nan, "max")
        stat = torch.where(nan, torch.full_like(stat, float("nan")), stat)
    return stat


def _split_median(v: torch.Tensor, axis: int, n: int, comm) -> torch.Tensor:
    """:func:`_median` of the chunks the ranks hold along ``axis`` (extent ``n``): the
    distributed sort keeps each rank's chunk, the two middle planes come from their owners
    (``take``, bit for bit), and a NaN anywhere is one flag a plane, all-reduced."""
    from . import dist_sort

    sv, _ = dist_sort.distributed_sort(comm, v, n, axis)
    counts = comm.counts_displs_shape([n if d == axis else s for d, s in enumerate(v.shape)], axis)[0]
    mid = comm.take(sv, axis, counts, torch.tensor([(n - 1) // 2, n // 2]), replicate=True)
    nan = torch.isnan(v).any(axis, keepdim=True) if v.shape[axis] else torch.zeros(
        mid.narrow(axis, 0, 1).shape, dtype=torch.bool, device=v.device)
    comm.all_reduce(nan, "max")
    return torch.where(nan, float("nan"), (mid.narrow(axis, 0, 1) + mid.narrow(axis, 1, 1)) * 0.5)


def _pad_fill(v: torch.Tensor, axis: int, b: int, e: int, mode: str, across=None):
    """The ``b`` leading and ``e`` trailing slices of ``v`` padded along ``axis`` in one of
    numpy's computed modes, as jnp.pad computes them (``_pad_stats``, ``_pad_linear_ramp``,
    ``_pad_empty``) with its defaults (every element counted, end values 0). A float mean
    is summed in float64 and rounded once, so the sum's order cannot change its bits.
    ``across`` = (comm, counts): ``v`` is this rank's chunk along ``axis`` of an array whose
    ranks hold ``counts`` slices there; each statistic is then taken across the ranks (the
    sums and counts all-reduced, the extremes all-reduced, the median on the distributed
    sort, the ramp's two edge planes fetched from their owners), never by a gather."""
    comm, counts = across if across is not None else (None, None)
    n = v.shape[axis] if comm is None else int(builtins.sum(counts))
    integer = not (v.dtype.is_floating_point or v.dtype.is_complex or v.dtype == torch.bool)

    def slab(fill: torch.Tensor, count: int) -> torch.Tensor:
        shape = list(v.shape)
        shape[axis] = count
        return fill.expand(shape)

    if b == 0 and e == 0:
        return v.narrow(axis, 0, 0), v.narrow(axis, 0, 0)
    if mode == "empty":  # jnp.empty is jnp.zeros
        return slab(v.new_zeros(()), b), slab(v.new_zeros(()), e)
    if n == 0:
        raise ValueError(f"can't extend an empty axis with mode {mode!r}")
    if mode == "linear_ramp":
        ct = _operations._inexact(types.canonical_heat_type(v.dtype)).torch_type()
        if comm is None:
            first, last = v.narrow(axis, 0, 1), v.narrow(axis, n - 1, 1)
        else:
            edges = comm.take(v, axis, counts, torch.tensor([0, n - 1]), replicate=True)
            first, last = edges.narrow(axis, 0, 1), edges.narrow(axis, 1, 1)

        def ramp(edge: torch.Tensor, num: int) -> torch.Tensor:
            # jnp.linspace(0, edge, num, endpoint=False): 0·(1 − t) + edge·t, t = i / num
            shape = [1] * v.ndim
            shape[axis] = num
            t = (torch.arange(num, dtype=ct, device=v.device) / num).view(shape)
            out = 0 * (1 - t) + edge.to(ct) * t
            return (torch.floor(out) if integer else out).to(v.dtype)

        return ramp(first, b), torch.flip(ramp(last, e), [axis])
    if mode in ("maximum", "minimum"):
        stat = _extreme(v, axis, "max" if mode == "maximum" else "min", comm)
    else:
        ct = _operations._inexact(types.canonical_heat_type(v.dtype)).torch_type()
        if mode == "mean":
            acc = torch.float64 if ct in (torch.float16, torch.bfloat16, torch.float32) else ct
            if comm is None:
                stat = torch.mean(v.to(acc), axis, keepdim=True).to(ct)
            else:
                total = comm.all_reduce(torch.sum(v.to(acc), axis, keepdim=True), "sum")
                stat = (total / n).to(ct)
        else:
            stat = _median(v.to(ct), axis) if comm is None else _split_median(v.to(ct), axis, n, comm)
        if integer:
            stat = torch.round(stat)
        stat = stat.to(v.dtype)
    return slab(stat, b), slab(stat, e)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """Pad an array (numpy's widths). Constant padding is local, the first rank taking
    the leading pad of the split axis and the last the trailing one, then rebalanced.
    The modes that copy elements (edge, wrap, reflect, symmetric) index each other axis
    locally; along the split axis this rank's chunk of the result is the source rows
    ``_pad_index`` gives for its range, fetched from their owners (``take``: also for pads
    wider than a chunk or than the axis, and with an empty rank). The computed modes
    (mean, median, maximum, minimum, linear_ramp, empty) pad axis by axis, each from the
    array padded so far, as jnp.pad does, by torch ops on its device; along the split axis
    each statistic is taken across the ranks (:func:`_pad_fill`) and the padded chunks are
    rebalanced."""
    sanitation.sanitize_in(array)
    widths = _pad_widths(pad_width, array.ndim)
    comm = array.comm
    distributed = array.split is not None and array.is_distributed()
    if mode in ("edge", "wrap", "reflect", "symmetric", "mean", "median", "maximum", "minimum", "linear_ramp",
                "empty"):
        value, gshape = array.larray, list(array.gshape)
        for axis, (b, e) in enumerate(widths):
            if not (distributed and axis == array.split):
                if mode in ("edge", "wrap", "reflect", "symmetric"):
                    value = value.index_select(axis, _pad_index(value.shape[axis], b, e, mode, value.device))
                else:
                    before, after = _pad_fill(value, axis, b, e, mode)
                    value = torch.cat([before, value, after], dim=axis)
                gshape[axis] += b + e
                continue
            counts = comm.counts_displs_shape(gshape, axis)[0]
            if mode in ("edge", "wrap", "reflect", "symmetric"):
                value = comm.take(value, axis, counts, _pad_index(gshape[axis], b, e, mode, value.device))
            else:
                before, after = _pad_fill(value, axis, b, e, mode, across=(comm, counts))
                parts = [before] if comm.rank == 0 else []
                parts += [value] + ([after] if comm.rank == comm.size - 1 else [])
                value = _operations.rebalance(torch.cat(parts, dim=axis), axis, array).larray
            gshape[axis] += b + e
        if not distributed:
            return _operations.wrap_global(value, array, array.split)
        return _wrap(value, gshape, array, array.split)
    if mode != "constant":
        raise ValueError(f"mode {mode!r} is not supported")
    local_widths = list(widths)
    if distributed:
        b, e = widths[array.split]
        local_widths[array.split] = (b if comm.rank == 0 else 0, e if comm.rank == comm.size - 1 else 0)
    lshape = [s + b + e for s, (b, e) in zip(array.larray.shape, local_widths)]
    value = torch.full(lshape, constant_values, dtype=array.larray.dtype, device=array.larray.device)
    value[tuple(slice(b, b + s) for s, (b, _) in zip(array.larray.shape, local_widths))] = array.larray
    if not distributed:
        return _wrap(value, value.shape if array.split is None else
                     [s + b + e for s, (b, e) in zip(array.gshape, widths)], array, array.split)
    return _operations.rebalance(value, array.split, array)


def repeat(a: DNDarray, repeats, axis: Optional[int] = None) -> DNDarray:
    """Repeat elements. Along the split axis (or flat, which is split 0) each rank
    repeats its own elements and the result is rebalanced."""
    a = _ensure(a)
    if axis is None:
        a = flatten(a)
        axis = 0
    axis = sanitize_axis(a.gshape, axis)
    if isinstance(repeats, DNDarray):
        repeats = repeats._relayout(None)
    elif not isinstance(repeats, int):
        repeats = torch.as_tensor(np.asarray(repeats))
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(a.larray.device)
        if repeats.numel() == 1:
            repeats = int(repeats.reshape(()).item())
    if a.split != axis or not a.is_distributed():
        value = torch.repeat_interleave(a.larray, repeats, dim=axis)
        gshape = list(a.gshape)
        gshape[axis] = value.shape[axis]
        return _wrap(value, gshape, a, a.split)
    if isinstance(repeats, torch.Tensor):
        offset, lshape, _ = a.comm.chunk(a.gshape, axis)
        repeats = repeats[offset : offset + lshape[axis]]
    return _operations.rebalance(torch.repeat_interleave(a.larray, repeats, dim=axis), axis, a)


def tile(x: DNDarray, reps: Sequence[int]) -> DNDarray:
    """Repeat the whole array ``reps`` times along each axis. The other axes repeat
    locally; along the split axis this rank's chunk of the result is the source rows
    i mod n of its range, fetched from their owners (``TorchCommunication.take``)."""
    sanitation.sanitize_in(x)
    reps = (reps,) if isinstance(reps, int) else tuple(int(r) for r in reps)
    nd = builtins.max(x.ndim, len(reps))
    full_reps = (1,) * (nd - len(reps)) + reps
    split = None if x.split is None else x.split + (nd - x.ndim)
    gshape = tuple(s * r for s, r in zip((1,) * (nd - x.ndim) + x.gshape, full_reps))
    if split is None or full_reps[split] == 1 or not x.is_distributed():
        return _wrap(torch.tile(x.larray, reps), gshape, x, split)
    value = torch.tile(x.larray, full_reps[:split] + (1,) + full_reps[split + 1:])
    n = x.gshape[x.split]
    counts = x.comm.counts_displs_shape(x.gshape, x.split)[0]
    rows = torch.arange(gshape[split], device=value.device) % builtins.max(n, 1)
    return _wrap(x.comm.take(value, split, counts, rows), gshape, x, split)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonals of the planes ``(dim1, dim2)``, appended as the last axis; local when
    the split is another axis. When the split is ``dim1`` or ``dim2`` each rank takes the
    piece of the diagonal that lies in its chunk (the offset moved by the chunk's first row
    or column), and one ``all_gather_v`` of the pieces, in rank order, gives the unsplit
    result (heat_tpu's rule)."""
    sanitation.sanitize_in(a)
    if a.ndim < 2:
        raise ValueError("diagonal requires at least 2 dimensions")
    dim1, dim2 = sanitize_axis(a.gshape, dim1), sanitize_axis(a.gshape, dim2)
    if dim1 == dim2:
        raise ValueError("dim1 and dim2 must be different")
    if a.split is None or (a.split in (dim1, dim2) and not a.is_distributed()):
        return _operations.wrap_global(torch.diagonal(a._relayout(None), offset, dim1, dim2).contiguous(), a, None)
    if a.split in (dim1, dim2):
        start, _, _ = a.comm.chunk(a.gshape, a.split)
        piece = torch.diagonal(a.larray, offset + start if a.split == dim1 else offset - start, dim1, dim2)
        value = a.comm.all_gather_v(piece.movedim(-1, 0).contiguous()).movedim(0, -1).contiguous()
        return _operations.wrap_global(value, a, None)
    split = a.split - builtins.sum(1 for d in (dim1, dim2) if d < a.split)
    value = torch.diagonal(a.larray, offset, dim1, dim2).contiguous()
    probe = torch.diagonal(torch.empty(a.gshape, device="meta"), offset, dim1, dim2)
    return _wrap(value, probe.shape, a, split)


def _vector_range(v: DNDarray, ranges: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Elements [lo, hi) = ``ranges[rank]`` of the split vector ``v`` on this rank, where
    every rank asks for its own range (``ranges``, the same on every rank; empty ranges
    allowed): one
    ``redistribute`` whose destination ranges may overlap, so each rank receives its range
    and nothing more."""
    counts = v.comm.counts_displs_shape(v.gshape, 0)[0]
    dst = [builtins.max(0, h - l) for l, h in ranges]
    return v.comm.redistribute(v.larray, v.gshape, 0, counts, dst, dst_displs=[l for l, _ in ranges])


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """A vector's diagonal matrix (split as the vector's), or a matrix's diagonal. For a
    split vector each rank builds only its own rows of the (n + |k|)² result, from the
    elements those rows hold (:func:`_vector_range`)."""
    sanitation.sanitize_in(a)
    if a.ndim != 1:
        return diagonal(a, offset=offset)
    if a.split is None or not a.is_distributed():
        return _operations.wrap_global(torch.diag(a._relayout(None), offset), a, a.split)
    n, k = a.gshape[0], int(offset)
    m = n + builtins.abs(k)
    counts, displs, _ = a.comm.counts_displs_shape((m, m), 0)
    # row j holds v[j] (k >= 0) or v[j + k] (k < 0), for the j where that element exists
    shift = builtins.min(k, 0)

    def rows_of(c, d):
        lo, hi = builtins.max(d + shift, 0), builtins.min(d + c + shift, n)
        return (lo, builtins.max(lo, hi))

    ranges = [rows_of(c, d) for c, d in zip(counts, displs)]
    lo, hi = ranges[a.comm.rank]
    vals = _vector_range(a, ranges)
    start, count = displs[a.comm.rank], counts[a.comm.rank]
    value = torch.zeros((count, m), dtype=a.larray.dtype, device=a.larray.device)
    i = torch.arange(lo, hi, device=value.device)  # element i sits at row i − shift, column i + max(k, 0)
    value[i - shift - start, i + builtins.max(k, 0)] = vals
    return _wrap(value, (m, m), a, 0)


# --------------------------------------------------------------------------- sorting
def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Sort along ``axis``; returns ``(values, int64 indices)``, the order of a stable
    sort (complex values in jnp's order: by the real part, then the imaginary, each with
    NaN last). Along the split axis this is the distributed merge-split network
    (:mod:`.dist_sort`), O(n/P) a rank; along another axis a local sort."""
    from . import dist_sort

    sanitation.sanitize_in(a)
    axis = sanitize_axis(a.gshape, axis)
    if a.ndim == 0:
        values, indices = a.larray.clone(), torch.zeros((), dtype=torch.int64, device=a.larray.device)
    elif axis == a.split:
        values, indices = dist_sort.distributed_sort(a.comm, a.larray, a.gshape[axis], axis, descending)
    elif a.larray.is_complex():  # jnp's (real, imaginary) order, which torch.sort lacks
        indices = _complex_order.argsort(a.larray, axis, descending)
        values = a.larray.take_along_dim(indices, axis)
    else:
        values, indices = torch.sort(a.larray, dim=axis, descending=descending, stable=True)
    v = _wrap(values, a.gshape, a, a.split)
    i = _wrap(indices.to(torch.int64), a.gshape, a, a.split)
    return _operations.handle_out(v, out), i


def _ordered_topk(x: torch.Tensor, k: int, largest: bool):
    """The ``k`` largest (or smallest) along the last axis, in order, ties by lowest
    index and NaN counted largest: the head of a stable sort. ``torch.topk`` finds the
    ``k``-th value v and a set that holds every element beating v; its entries equal to
    v are swapped for the lowest-indexed elements equal to v (``nonzero`` of the ties,
    which are few unless the data repeats much), and a stable sort orders the ``k``.
    One count is read back (``nonzero``'s)."""
    if k == 0 or x.shape[-1] == 0:
        return x[..., :0], torch.zeros(x.shape[:-1] + (0,), dtype=torch.int64, device=x.device)
    dtype, n = x.dtype, x.shape[-1]
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    top = torch.topk(x, k, dim=-1, largest=largest)
    v, top_index = top.values[..., k - 1 :], top.indices.reshape(-1, k)
    rows = top_index.shape[0]
    ties = (x == v).reshape(rows, n)
    found = torch.nonzero(ties)  # (row, index) of every tie, row by row, by index
    # v is an element of its row, so a row without ties has NaN for v
    if x.is_floating_point() and (found.shape[0] == 0 if rows == 1 else bool(torch.isnan(v).any())):
        ties = torch.where(torch.isnan(v), torch.isnan(x), x == v).reshape(rows, n)
        found = torch.nonzero(ties)
    slots = ties.gather(-1, top_index)  # top's entries equal to v, first in ``pos``
    pos = torch.argsort((~slots).to(torch.uint8), dim=-1, stable=True)
    counts = ties.sum(-1, keepdim=True)
    start = 0 if rows == 1 else torch.cumsum(counts, 0) - counts
    j = torch.arange(k, device=x.device).expand(rows, k)
    first_ties = found[:, 1][(start + j).clamp(max=found.shape[0] - 1)]
    fill = torch.where(j < slots.sum(-1, keepdim=True), first_ties, top_index.gather(-1, pos))
    index = torch.sort(top_index.scatter(-1, pos, fill).view(top.indices.shape), dim=-1).values
    order = torch.sort(x.gather(-1, index), dim=-1, descending=largest, stable=True)
    return order.values.to(dtype), index.gather(-1, order.indices)


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):  # noqa: A002
    """The ``k`` largest (smallest) entries along ``dim`` and their int64 indices, ties
    by lowest index. Along the split axis each rank picks its own ``k`` candidates and
    one all-gather of the P·k candidates decides (heat_tpu's ``_topk_split``); the result
    is then unsplit, as heat_tpu's."""
    sanitation.sanitize_in(a)
    dim = sanitize_axis(a.gshape, dim)
    if k > a.gshape[dim]:
        raise ValueError(f"selected index k={k} out of range for dimension of size {a.gshape[dim]}")
    x = a.larray.movedim(dim, -1)
    offset = 0
    if a.split == dim and a.is_distributed():
        offset, _, _ = a.comm.chunk(a.gshape, dim)
        kk = builtins.min(k, x.shape[-1])
        vals, idx = _ordered_topk(x, kk, largest)
        if kk < k:  # too few local elements: pad with sentinels that lose every tie
            pad = x.shape[:-1] + (k - kk,)
            if x.is_floating_point():
                fill = float("-inf") if largest else float("inf")
            elif x.dtype == torch.bool:
                fill = not largest
            else:
                info = torch.iinfo(x.dtype)
                fill = info.min if largest else info.max
            vals = torch.cat([vals, torch.full(pad, fill, dtype=x.dtype, device=x.device)], -1)
            idx = torch.cat([idx, torch.full(pad, a.gshape[dim], dtype=torch.int64, device=x.device)], -1)
        cand_v = a.comm.all_gather_stacked(vals).movedim(0, -2).flatten(-2)
        cand_i = a.comm.all_gather_stacked(idx + offset).movedim(0, -2).flatten(-2)
        order = torch.sort(cand_i, dim=-1, stable=True).indices  # candidates by index
        cand_v, cand_i = cand_v.gather(-1, order), cand_i.gather(-1, order)
        sel = torch.sort(cand_v, dim=-1, descending=largest, stable=True).indices[..., :k]
        values, indices = cand_v.gather(-1, sel), cand_i.gather(-1, sel)
        split = None
    else:
        values, indices = _ordered_topk(x, k, largest)
        split = a.split if a.split != dim else None
    values, indices = values.movedim(-1, dim).contiguous(), indices.movedim(-1, dim).contiguous()
    gshape = list(a.gshape)
    gshape[dim] = k
    v, i = _wrap(values, gshape, a, split), _wrap(indices, gshape, a, split)
    if out is not None:
        return _operations.handle_out(v, out[0]), _operations.handle_out(i, out[1])
    return v, i


def _unique_slices(full: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The distinct slices of ``full`` along ``axis`` in numpy's lexicographic order, NaN
    after every number, slices whose NaNs sit at the same places counting as one (as
    jnp.unique's); and the inverse. A stable sort a column, last column first."""
    rows = full.movedim(axis, 0).reshape(full.shape[axis], -1)
    keys = rows.to(torch.uint8) if rows.dtype == torch.bool else rows
    order = torch.arange(rows.shape[0], device=rows.device)
    for col in range(keys.shape[1] - 1, -1, -1):  # torch.sort puts NaN last
        order = order[torch.sort(keys[order, col], stable=True).indices]
    ranked = keys[order]
    new = ranked[1:] != ranked[:-1]
    if ranked.is_floating_point():
        new &= ~(torch.isnan(ranked[1:]) & torch.isnan(ranked[:-1]))
    first = torch.cat([torch.ones(min(1, rows.shape[0]), dtype=torch.bool, device=rows.device), new.any(1)])
    group = torch.cumsum(first, 0) - 1
    inverse = torch.empty_like(group).scatter_(0, order, group)
    distinct = rows[order[first]]
    out = distinct.reshape((distinct.shape[0],) + tuple(s for d, s in enumerate(full.shape) if d != axis))
    return out.movedim(0, axis).contiguous(), inverse.to(torch.int64)


def _unique_complex(a: DNDarray, return_inverse: bool):
    """:func:`unique` of a complex array in jnp's order (:mod:`._complex_order`): every
    value with a NaN counts as one, ``nan+0j``. A split array's partial uniques are merged
    by one variable-length all-gather, as the real path's; the inverse ranks each local
    element among the merged values by a stable sort of both."""
    local = a.larray.reshape(-1)
    part = _complex_order.unique(local)
    if a.split is not None and a.is_distributed():
        part = _complex_order.unique(a.comm.all_gather_v(part))
    local = torch.where(torch.isnan(local.real) | torch.isnan(local.imag), complex(float("nan"), 0.0), local)
    res = _operations.wrap_global(part, a, None)
    if not return_inverse:
        return res
    # part first, so an element sorts right after its own distinct value: its inverse is
    # the count of distinct values up to it, less one
    both = torch.cat([part, local])
    order = _complex_order.lexsort_with_index(both, torch.arange(both.numel(), device=both.device), 0, False)
    is_part = order < part.numel()
    before = torch.cumsum(is_part, 0) - 1
    inv = torch.empty_like(local, dtype=torch.int64)
    inv[order[~is_part] - part.numel()] = before[~is_part]
    inv = inv.view(a.larray.shape)
    if a.split is None:
        return res, _operations.wrap_global(inv, a, None)
    return res, _wrap(inv, a.gshape, a, a.split)


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):  # noqa: A002
    """The sorted unique elements. A split array's per-rank partial uniques are merged on
    the device by one variable-length all-gather of the partials (heat_tpu merges them on
    the host); the result is unsplit, and the inverse keeps the input's split. NaNs count
    as one value, as jnp.unique's do. ``axis`` uniques are computed on the gathered
    array: a sort of whole rows whose order the data decides."""
    sanitation.sanitize_in(a)
    if axis is not None:
        axis = sanitize_axis(a.gshape, axis)
        res, inv = _unique_slices(a._relayout(None), axis)
        if return_inverse:
            return _operations.wrap_global(res, a, None), _operations.wrap_global(inv, a, None)
        return _operations.wrap_global(res, a, None)
    if a.larray.is_complex():
        return _unique_complex(a, return_inverse)
    local = a.larray.reshape(-1)
    nan = torch.isnan(local) if local.is_floating_point() else None
    part = torch.unique(local[~nan] if nan is not None else local, sorted=True)
    if a.split is not None and a.is_distributed():
        part = torch.unique(a.comm.all_gather_v(part), sorted=True)
    if nan is not None:
        any_nan = nan.any().reshape(1)
        if a.split is not None:
            a.comm.all_reduce(any_nan, "max")
        if bool(any_nan.item()):
            part = torch.cat([part, part.new_full((1,), float("nan"))])
    res = _operations.wrap_global(part, a, None)
    if not return_inverse:
        return res
    inv = torch.searchsorted(part, a.larray.contiguous())
    if a.split is None:
        return res, _operations.wrap_global(inv, a, None)
    return res, _wrap(inv.to(torch.int64), a.gshape, a, a.split)
