"""Arithmetic operations (counterpart of heat_tpu/core/arithmetics.py): thin wrappers over
the dispatch layer in :mod:`._operations`, which owns split propagation, the cross-rank
reductions and the scans. ``diff`` along the split axis takes a one-slice halo from the
next rank and rebalances."""

from __future__ import annotations

import builtins

import torch

from . import _operations, sanitation, types
from .dndarray import DNDarray

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "divmod",
    "floordiv",
    "floor_divide",
    "fmod",
    "gcd",
    "hypot",
    "invert",
    "lcm",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nan_to_num",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise addition."""
    return _operations.binary_op(torch.add, t1, t2, out, where)


def _require_ints(*ts):
    for t in ts:
        dt = t.dtype if isinstance(t, DNDarray) else types.heat_type_of(t)
        if not types.heat_type_is_exact(dt):
            raise TypeError(f"operation is only supported for integer types, got {dt}")


def bitwise_and(t1, t2, out=None, where=None) -> DNDarray:
    _require_ints(t1, t2)
    return _operations.binary_op(torch.bitwise_and, t1, t2, out, where)


def bitwise_or(t1, t2, out=None, where=None) -> DNDarray:
    _require_ints(t1, t2)
    return _operations.binary_op(torch.bitwise_or, t1, t2, out, where)


def bitwise_xor(t1, t2, out=None, where=None) -> DNDarray:
    _require_ints(t1, t2)
    return _operations.binary_op(torch.bitwise_xor, t1, t2, out, where)


def bitwise_not(t, out=None) -> DNDarray:
    _require_ints(t)
    return _operations.local_op(torch.bitwise_not, t, out)


def invert(a, out=None) -> DNDarray:
    """Bitwise NOT; alias of bitwise_not."""
    return bitwise_not(a, out)


def copysign(a, b, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.copysign, a, b, out, where)


def cumsum(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along ``axis``; over the split axis an exclusive scan of the ranks'
    totals carries across. ``dtype`` sets the accumulator/result type."""
    return _operations.cum_op("sum", a, axis, out, dtype=dtype)


def cumprod(a: DNDarray, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along ``axis``. ``dtype`` sets the accumulator/result type."""
    return _operations.cum_op("prod", a, axis, out, dtype=dtype)


cumproduct = cumprod


def _diff_once(a: DNDarray, axis: int) -> DNDarray:
    """First difference along the split axis: each rank appends the first slice of the
    next rank's data and differences locally; the result is rebalanced."""
    comm, n = a.comm, a.gshape[axis]
    counts, displs = a.counts_displs()
    end = displs[comm.rank] + counts[comm.rank]
    want = 1 if 0 < counts[comm.rank] and end < n else 0
    wants = comm.all_gather_counts(want, a.larray.device)
    halo = comm.redistribute(a.larray, a.gshape, axis, counts, wants,
                             dst_displs=[d + c for d, c in zip(displs, counts)])
    local = torch.diff(torch.cat([a.larray, halo], dim=axis), dim=axis) if counts[comm.rank] else a.larray
    gshape = list(a.gshape)
    gshape[axis] = n - 1
    dst = comm.counts_displs_shape(gshape, axis)[0]
    moved = comm.redistribute(local, gshape, axis, [builtins.max(c - 1 + w, 0) for c, w in zip(counts, wants)], dst)
    return DNDarray(moved, tuple(gshape), types.canonical_heat_type(moved.dtype), axis, a.device, comm, True)


def diff(a: DNDarray, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """n-th discrete difference along ``axis``. Along the split axis each pass takes a
    one-slice halo from the next rank (heat_tpu/core/arithmetics.py diff)."""
    from . import factories, manipulations
    from .stride_tricks import sanitize_axis

    sanitation.sanitize_in(a)
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    axis = sanitize_axis(a.gshape, axis)
    parts = []
    for extra in (prepend, append):
        if extra is None:
            parts.append(None)
            continue
        e = extra if isinstance(extra, DNDarray) else factories.array(extra, device=a.device, comm=a.comm)
        if e.ndim == 0:
            shape = list(a.gshape)
            shape[axis] = 1
            e = factories.full(tuple(shape), e.item(), dtype=e.dtype, device=a.device, comm=a.comm)
        parts.append(e)
    if parts[0] is not None or parts[1] is not None:
        a = manipulations.concatenate([p for p in (parts[0], a, parts[1]) if p is not None], axis=axis)
    if a.is_distributed() and a.split == axis:
        for _ in range(n):
            if a.gshape[axis] == 0:
                break
            a = _diff_once(a, axis)
        if a.gshape[axis] == 0:
            a = DNDarray(a.larray, a.gshape, a.dtype, None, a.device, a.comm, True)
        return a
    value = torch.diff(a.larray, n=n, dim=axis) if a.gshape[axis] > n else a.larray.narrow(axis, 0, 0)
    gshape = list(a.gshape)
    gshape[axis] = builtins.max(a.gshape[axis] - n, 0)
    split = a.split if a.split is None or gshape[a.split] != 0 else None
    return DNDarray(value, tuple(gshape), types.canonical_heat_type(value.dtype), split, a.device, a.comm, True)


def div(t1, t2, out=None, where=None) -> DNDarray:
    """True division."""
    return _operations.binary_op(torch.true_divide, t1, t2, out, where)


divide = div


def divmod(t1, t2, out1=None, out2=None, out=(None, None), where=True):  # noqa: A001
    """Simultaneous floordiv and mod."""
    if out != (None, None):
        out1, out2 = out
    w = None if where is True else where
    return floordiv(t1, t2, out1, w), mod(t1, t2, out2, w)


def floordiv(t1, t2, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.floor_divide, t1, t2, out, where)


floor_divide = floordiv


def fmod(t1, t2, out=None, where=None) -> DNDarray:
    """C-style remainder (sign of the dividend)."""
    return _operations.binary_op(torch.fmod, t1, t2, out, where)


def gcd(a, b, out=None, where=None) -> DNDarray:
    _require_ints(a, b)
    return _operations.binary_op(torch.gcd, a, b, out, where)


def hypot(a, b, out=None, where=None) -> DNDarray:
    return _operations.binary_op(torch.hypot, a, b, out, where)


def lcm(a, b, out=None, where=None) -> DNDarray:
    _require_ints(a, b)
    return _operations.binary_op(torch.lcm, a, b, out, where)


def left_shift(t1, t2, out=None, where=None) -> DNDarray:
    _require_ints(t1, t2)
    return _operations.binary_op(torch.bitwise_left_shift, t1, t2, out, where)


def mod(t1, t2, out=None, where=None) -> DNDarray:
    """Modulo with the sign of the divisor (numpy ``mod``/``remainder``)."""
    return _operations.binary_op(torch.remainder, t1, t2, out, where)


remainder = mod


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise multiplication."""
    return _operations.binary_op(torch.mul, t1, t2, out, where)


multiply = mul


def _nan_to_num(v: torch.Tensor, nan=0.0, posinf=None, neginf=None) -> torch.Tensor:
    if not v.is_floating_point():
        return v.clone()
    return torch.nan_to_num(v, nan=nan, posinf=posinf, neginf=neginf)


def nan_to_num(a: DNDarray, nan: float = 0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    return _operations.local_op(_nan_to_num, a, out, nan=nan, posinf=posinf, neginf=neginf)


def nanprod(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product with NaNs taken as 1."""
    return _operations.reduce_op("nanprod", a, axis, out, keepdims)


def nansum(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:
    """Sum with NaNs taken as 0."""
    return _operations.reduce_op("nansum", a, axis, out, keepdims)


def neg(a: DNDarray, out=None) -> DNDarray:
    """Element-wise negation."""
    return _operations.local_op(torch.neg, a, out)


negative = neg


def pos(a: DNDarray, out=None) -> DNDarray:
    """Element-wise unary plus (a copy)."""
    return _operations.local_op(torch.clone, a, out)


positive = pos


def pow(t1, t2, out=None, where=None) -> DNDarray:  # noqa: A001
    """Element-wise power."""
    return _operations.binary_op(torch.pow, t1, t2, out, where)


power = pow


def prod(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product reduction; over the split axis, local products and one all_reduce."""
    return _operations.reduce_op("prod", a, axis, out, keepdims)


def right_shift(t1, t2, out=None, where=None) -> DNDarray:
    _require_ints(t1, t2)
    return _operations.binary_op(torch.bitwise_right_shift, t1, t2, out, where)


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Element-wise subtraction."""
    return _operations.binary_op(torch.sub, t1, t2, out, where)


subtract = sub


def sum(a: DNDarray, axis=None, out=None, keepdims=False) -> DNDarray:  # noqa: A001
    """Sum reduction; over the split axis, local sums and one all_reduce."""
    return _operations.reduce_op("sum", a, axis, out, keepdims)
