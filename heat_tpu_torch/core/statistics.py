"""Statistics (counterpart of heat_tpu/core/statistics.py).

An arg-reduction over the split axis takes each rank's local extreme and its global
index, gathers those few candidates on every rank and keeps numpy's rule: the extreme
value wins, and among equal values the lowest global index (a NaN counts as the extreme,
as in numpy). Indices are int64. Moments (``var``, ``std``, ``skew``, ``kurtosis``) are built from
the distributed mean and sums; ``percentile`` and ``median`` along the split axis read
their order statistics off the distributed sort (:mod:`.dist_sort`), fetching only the
bracketing planes.
"""

from __future__ import annotations

from builtins import max as builtins_max
from typing import Optional

import numpy as np
import torch

from . import _complex_order, _operations, sanitation, types
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "percentile",
    "skew",
    "std",
    "var",
]


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
    local, comm, split = x.larray, x.comm, x.split
    if local.dtype == torch.bool:
        local = local.to(torch.uint8)  # torch.argmax/argmin take no bool
    neutral = _operations._neutral("highest" if kind == "min" else "lowest", local.dtype)
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


def _maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _complex_order.maximum(a, b) if a.is_complex() else torch.maximum(a, b)


def _minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _complex_order.minimum(a, b) if a.is_complex() else torch.minimum(a, b)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum (NaN propagates; complex by jnp's (real, imaginary) rule)."""
    return _operations.binary_op(_maximum, x1, x2, out)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum (NaN propagates; complex by jnp's (real, imaginary) rule)."""
    return _operations.binary_op(_minimum, x1, x2, out)


def _inexact(x: DNDarray) -> DNDarray:
    return x.astype(_operations._inexact(x.dtype))


def _central(x: DNDarray, axis):
    """``x`` in its float type minus its mean over ``axis`` (kept as a size-1 axis)."""
    from . import arithmetics

    v = _inexact(x)
    return arithmetics.sub(v, mean(v, axis, keepdims=True))


def var(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance: the summed squared deviations from the distributed mean over
    ``N - ddof`` (of complex input, the squared moduli: a real result, as numpy's)."""
    from . import arithmetics

    sanitation.sanitize_in(x)
    keepdims = kwargs.get("keepdims", False)
    axis = sanitize_axis(x.gshape, axis)
    d = _central(x, axis)
    n = x.size if axis is None else int(np.prod([x.gshape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
    if types.heat_type_is_complexfloating(d.dtype):  # numpy's |x - mean|², in the real type
        from . import complex_math

        re, im = complex_math.real(d), complex_math.imag(d)
        sq = arithmetics.add(arithmetics.mul(re, re), arithmetics.mul(im, im))
    else:
        sq = arithmetics.mul(d, d)
    return arithmetics.div(arithmetics.sum(sq, axis, keepdims=keepdims), builtins_max(n - ddof, 0))


def std(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation: the square root of :func:`var`."""
    from . import exponential

    return exponential.sqrt(var(x, axis, ddof, **kwargs))


def _moment_ratio(x: DNDarray, axis, power: int):
    """(m_power / m2^(power/2), n) over ``axis`` (None: every element)."""
    from . import arithmetics

    if axis is not None and not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or an int, got {type(axis)}")
    if axis is None:
        from . import manipulations

        x, axis = manipulations.flatten(x), 0
    axis = sanitize_axis(x.gshape, axis)
    # heat_tpu computes the moments in promote_types(dtype, float32): float16 and bfloat16
    # in float32, every exact type in float32 (int64 too)
    d = _central(x if x.dtype in (types.float64, types.complex64, types.complex128) else x.astype(types.float32), axis)
    n = x.gshape[axis]
    m2 = mean(arithmetics.pow(d, 2), axis)
    mp = mean(arithmetics.pow(d, power), axis)
    return arithmetics.div(mp, arithmetics.pow(m2, power / 2)), n


def skew(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True) -> DNDarray:
    """Skewness (the third standardised moment)."""
    from . import arithmetics

    sanitation.sanitize_in(x)
    g1, n = _moment_ratio(x, axis, 3)
    return arithmetics.mul(g1, ((n * (n - 1)) ** 0.5) / (n - 2)) if unbiased else g1


def kurtosis(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Kurtosis (the fourth standardised moment), Fisher's (minus 3) by default."""
    from . import arithmetics

    sanitation.sanitize_in(x)
    k, n = _moment_ratio(x, axis, 4)
    if unbiased:
        k = arithmetics.add(arithmetics.mul(arithmetics.sub(arithmetics.mul(k, n + 1), 3 * (n - 1)),
                                            (n - 1) / ((n - 2) * (n - 3))), 3)
    return arithmetics.sub(k, 3) if Fischer else k


def average(x: DNDarray, axis=None, weights=None, returned: bool = False):
    """Weighted average over ``axis``: distributed sums of ``x·w`` and of ``w``."""
    from . import arithmetics, factories, manipulations

    sanitation.sanitize_in(x)
    if weights is None:
        result = mean(x, axis)
        if returned:
            axes = None if axis is None else (axis if isinstance(axis, tuple) else (axis,))
            n = x.size if axes is None else int(np.prod([x.gshape[a] for a in axes]))
            return result, factories.full(result.gshape, float(n), dtype=result.dtype, split=result.split,
                                          device=x.device, comm=x.comm)
        return result
    w = weights if isinstance(weights, DNDarray) else factories.array(weights, device=x.device, comm=x.comm)
    axis_s = sanitize_axis(x.gshape, axis) if axis is not None else None
    if w.gshape != x.gshape:
        if axis_s is None:
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        if isinstance(axis_s, tuple):
            raise TypeError("1D weights expect an integer axis.")
        if w.ndim != 1:
            raise TypeError("1D weights expected when shapes of x and weights differ.")
        if w.gshape[0] != x.gshape[axis_s]:
            raise ValueError("Length of weights not compatible with specified axis.")
        shape = [1] * x.ndim
        shape[axis_s] = w.gshape[0]
        w = manipulations.reshape(w, shape, new_split=None if w.split is None else axis_s)
    num = arithmetics.sum(arithmetics.mul(x, w), axis_s)
    den = arithmetics.sum(manipulations.broadcast_to(w, x.gshape) if w.gshape != x.gshape else w, axis_s)
    if bool((den == 0).any().item()):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    result = arithmetics.div(num, den)
    if returned:
        return result, manipulations.broadcast_to(den, result.gshape).astype(result.dtype)
    return result


def bincount(x: DNDarray, weights: Optional[DNDarray] = None, minlength: int = 0) -> DNDarray:
    """Occurrences of each value of a non-negative integer array: local counts to the
    global length, summed across ranks (unsplit, as heat_tpu's)."""
    sanitation.sanitize_in(x)
    local = x.larray.reshape(-1)
    if local.dtype == torch.bool:
        local = local.to(torch.int64)  # torch.bincount takes no bool; jnp counts False and True
    if x.size and bool((min(x) < 0).item()):
        raise ValueError("bincount: input array must have no negative elements")
    length = int(max(x).item()) + 1 if x.size else 0
    length = builtins_max(length, int(minlength))
    w = None
    if weights is not None:
        w = weights._relayout(x.split).reshape(-1) if isinstance(weights, DNDarray) else torch.as_tensor(weights)
    counts = torch.bincount(local, weights=w, minlength=length)
    if x.is_distributed():
        x.comm.all_reduce(counts, "sum")
    return DNDarray(counts, tuple(counts.shape), types.canonical_heat_type(counts.dtype), None, x.device, x.comm, True)


def bucketize(input: DNDarray, boundaries, out_int32: bool = False, right: bool = False, out=None) -> DNDarray:  # noqa: A002
    """The bucket of each element among sorted ``boundaries`` (torch.bucketize's sides):
    local, the split kept."""
    sanitation.sanitize_in(input)
    b = boundaries._relayout(None) if isinstance(boundaries, DNDarray) else torch.as_tensor(np.asarray(boundaries))
    b = b.to(input.larray.device)
    res = torch.searchsorted(b, input.larray.contiguous(), right=right).to(torch.int32 if out_int32 else torch.int64)
    return _operations.handle_out(DNDarray(res, input.gshape, types.canonical_heat_type(res.dtype), input.split,
                                           input.device, input.comm, True), out)


def digitize(x: DNDarray, bins, right: bool = False) -> DNDarray:
    """numpy's digitize of each element over monotonically increasing ``bins``: local."""
    sanitation.sanitize_in(x)
    b = bins._relayout(None) if isinstance(bins, DNDarray) else torch.as_tensor(np.asarray(bins))
    b = b.to(x.larray.device)
    res = torch.searchsorted(b, x.larray.contiguous(), right=not right, out_int32=True)
    return DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split, x.device, x.comm, True)


def _histogram_counts(x: DNDarray, edges: torch.Tensor, weights) -> torch.Tensor:
    """jnp.histogram's counts over ``edges``: searchsorted right, the last edge in the
    last bin, out-of-range elements dropped; local, then summed across ranks."""
    data = x.larray.reshape(-1)
    idx = torch.searchsorted(edges, data.contiguous(), right=True)
    idx = torch.where(data == edges[-1], edges.numel() - 1, idx)
    keep = (idx > 0) & (idx < edges.numel())
    # the counts take the edges' float type, as jnp.histogram's do (bool and int inputs too)
    w = torch.ones_like(data, dtype=edges.dtype) if weights is None else weights
    counts = torch.zeros(edges.numel(), dtype=w.dtype, device=data.device).index_add_(0, idx[keep], w[keep])[1:]
    if x.is_distributed():
        x.comm.all_reduce(counts, "sum")
    return counts


def _range(x: DNDarray, range_):
    if range_ is None:
        if x.size == 0:
            return 0.0, 1.0
        lo, hi = float(min(x).item()), float(max(x).item())
    else:
        lo, hi = float(range_[0]), float(range_[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return lo, hi


def histogram(a: DNDarray, bins: int = 10, range=None, normed=None, weights=None, density=None):  # noqa: A002
    """numpy's histogram of ``a`` (equal bins over ``range``): local counts summed across
    ranks; (hist, edges), unsplit."""
    from . import factories

    sanitation.sanitize_in(a)
    if normed is not None:
        raise NotImplementedError("'normed' is deprecated; use density instead")
    dt = _operations._inexact(a.dtype).torch_type()
    lo, hi = _range(a, range)
    edges = factories._linspace(lo, hi, int(bins) + 1, True, dt).to(a.larray.device)
    w = weights._relayout(a.split).reshape(-1) if isinstance(weights, DNDarray) else (
        None if weights is None else torch.as_tensor(np.asarray(weights)).reshape(-1).to(a.larray.device))
    hist = _histogram_counts(a, edges, None if w is None else w)
    if density:
        hist = hist / (hist.sum() * torch.diff(edges))
    return (DNDarray(hist, tuple(hist.shape), types.canonical_heat_type(hist.dtype), None, a.device, a.comm, True),
            DNDarray(edges, tuple(edges.shape), types.canonical_heat_type(edges.dtype), None, a.device, a.comm, True))


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:  # noqa: A002
    """torch.histc's histogram (min == max: the data's range), in the input's type."""
    sanitation.sanitize_in(input)
    rng = None if float(min) == float(max) else (min, max)
    hist, _ = histogram(input, bins=bins, range=rng)
    return _operations.handle_out(hist.astype(input.dtype), out)


def _variables(v, rowvar: bool, proto: DNDarray) -> DNDarray:
    """``m`` or ``y`` of :func:`cov` as a (variables, observations) DNDarray: a vector is one
    variable, ``rowvar`` False transposes (both local: the split moves with its axis); an
    array-like is unsplit on ``proto``'s device."""
    from . import manipulations
    from .linalg import transpose

    if not isinstance(v, DNDarray):
        t = torch.as_tensor(np.asarray(v), device=proto.larray.device)
        v = DNDarray(t, tuple(t.shape), types.canonical_heat_type(t.dtype), None, proto.device, proto.comm, True)
    if v.ndim > 2:
        raise ValueError(f"{'m' if v is proto else 'y'} has more than 2 dimensions")
    if v.ndim == 1:
        return manipulations.expand_dims(v, 0)
    return v if rowvar or v.gshape[0] == 1 else transpose(v)


def cov(m: DNDarray, y: Optional[DNDarray] = None, rowvar: bool = True, bias: bool = False, ddof: Optional[int] = None) -> DNDarray:
    """The covariance matrix of the variables (rows, or columns with ``rowvar`` False), in
    full fp32 products; unsplit, as heat_tpu's. ``y`` joins the variables by
    ``concatenate`` (which keeps the split). Observations split: the means by one
    all-reduce of the sums, then each rank's X_c·X_cᴴ and one all-reduce of the (vars ×
    vars) sums. Variables split: each rank computes its block rows X_c,r·X_cᴴ against every
    rank's centred block, passed around the ring (``ring_shift``), then one ``all_gather_v``
    of the block rows; no rank ever holds the observations of another's variables beside its
    own block and the one in flight."""
    from . import manipulations
    from .devices import full_fp32_matmul

    sanitation.sanitize_in(m)
    x = _variables(m, rowvar, m)
    if y is not None:
        x = manipulations.concatenate([x, _variables(y, rowvar, m)], axis=0)
    if ddof is None:
        ddof = 0 if bias else 1
    local = x.larray
    if not (local.is_floating_point() or local.is_complex()):
        local = local.to(_operations._inexact(x.dtype).torch_type())
    n_obs = x.gshape[1]
    if x.split is None or not x.is_distributed():
        xv = x._relayout(None) if x.split is not None else local
        xv = xv.to(local.dtype)
        xm = xv - xv.mean(1, keepdim=True)
        with full_fp32_matmul():
            res = (xm @ xm.conj().T) / builtins_max(n_obs - ddof, 0)
    elif x.split == 1:  # the observations are split
        mean = x.comm.all_reduce(local.sum(1, keepdim=True), "sum") / n_obs
        xm = local - mean
        with full_fp32_matmul():
            res = x.comm.all_reduce(xm @ xm.conj().T, "sum") / builtins_max(n_obs - ddof, 0)
    else:  # the variables are split: block rows by the ring
        xm = local - local.mean(1, keepdim=True)
        counts, displs, _ = x.comm.counts_displs_shape(x.gshape, 0)
        block = torch.empty((xm.shape[0], x.gshape[0]), dtype=xm.dtype, device=xm.device)
        with full_fp32_matmul():
            for src, other in x.comm.ring_blocks(xm, lambda r: (counts[r], n_obs)):
                block[:, displs[src]: displs[src] + counts[src]] = xm @ other.conj().T
        res = x.comm.all_gather_v(block, counts) / builtins_max(n_obs - ddof, 0)
    if res.shape == (1, 1):
        res = res.reshape(())
    return DNDarray(res, tuple(res.shape), types.canonical_heat_type(res.dtype), None, m.device, m.comm, True)


_METHODS = ("linear", "lower", "higher", "nearest", "midpoint")


def _planes(sv: torch.Tensor, idx: torch.Tensor, axis: int, x: DNDarray, distributed: bool) -> torch.Tensor:
    """The sorted planes at global positions ``idx`` along ``axis``, stacked first. A
    split axis: each rank fills the planes it holds into zeros and one sum across ranks
    gives them all (a few planes, not the array)."""
    if not distributed:
        return sv.index_select(axis, idx).movedim(axis, 0)
    offset, lshape, _ = x.comm.chunk(x.gshape, axis)
    mine = (idx >= offset) & (idx < offset + lshape[axis])
    shape = (idx.numel(),) + tuple(s for d, s in enumerate(sv.shape) if d != axis)
    out = torch.zeros(shape, dtype=sv.dtype, device=sv.device)
    pos = torch.nonzero(mine).reshape(-1)
    out[pos] = sv.index_select(axis, idx[pos] - offset).movedim(axis, 0)
    return x.comm.all_reduce(out, "sum")


def percentile(x: DNDarray, q, axis: Optional[int] = None, out: Optional[DNDarray] = None,
               interpolation: str = "linear", keepdims: bool = False) -> DNDarray:
    """The q-th percentiles along ``axis`` (None: of every element). The values are
    sorted along the axis (along the split axis by the distributed sort, each rank
    keeping its chunk), and only the bracketing planes are fetched. Along the split axis
    the interpolation is heat_tpu's there (``a + (b - a)·frac`` in the float type);
    along another axis jnp.percentile's (in float64, rounded). A NaN in a reduced slice
    gives NaN."""
    from . import dist_sort, manipulations

    sanitation.sanitize_in(x)
    if interpolation not in _METHODS:
        raise ValueError(f"interpolation can only be one of {_METHODS}")
    axis_s = sanitize_axis(x.gshape, axis) if axis is not None else None
    promoted = types.promote_types(x.dtype, types.float32)
    work = x.astype(promoted) if x.dtype is not promoted else x
    eff = axis_s
    if axis_s is None:
        work, eff = (manipulations.flatten(work) if x.ndim != 1 else work), 0
    n = work.gshape[eff]
    distributed = work.split == eff and work.is_distributed()
    nan = torch.isnan(work.larray).any(eff)
    if distributed:
        work.comm.all_reduce(nan, "max")
    any_nan = nan.any()
    if work.split is not None and work.split != eff:
        work.comm.all_reduce(any_nan.reshape(1), "max")
    heat_rule = work.split == eff and not bool(any_nan.item())
    if distributed:
        sv, _ = dist_sort.distributed_sort(work.comm, work.larray, n, eff)
    else:
        sv = torch.sort(work.larray, dim=eff).values
    q_arr = torch.as_tensor(np.asarray(q, dtype=np.float64))
    pos = (q_arr.reshape(-1) / 100.0 * (n - 1)).to(sv.device)
    floor, ceil = torch.floor(pos), torch.ceil(pos)
    lo = floor.clamp(0, n - 1).to(torch.int64)
    hi = ceil.clamp(0, n - 1).to(torch.int64)
    planes = _planes(sv, torch.cat([lo, hi]), eff, work, distributed)
    a, b = planes[: lo.numel()], planes[lo.numel():]
    view = (-1,) + (1,) * (a.ndim - 1)
    if interpolation == "lower":
        r = a
    elif interpolation == "higher":
        r = b
    elif interpolation == "nearest":
        near = (pos - lo <= 0.5) if heat_rule else (pos - floor <= 0.5)
        r = torch.where(near.view(view), a, b)
    elif interpolation == "midpoint":
        r = (a + b) / 2 if heat_rule else (a + b) * 0.5
    elif heat_rule:
        r = a + (b - a) * (pos - lo).to(a.dtype).view(view)
    else:
        hw = (pos - floor).view(view)
        r = (a.double() * (1 - hw) + b.double() * hw).to(a.dtype)
    r = torch.where(nan.unsqueeze(0), torch.full_like(r, float("nan")), r)
    rest = tuple(r.shape[1:])
    gshape_rest = tuple(s for d, s in enumerate(work.gshape) if d != eff)
    if keepdims:
        rest = (1,) * x.ndim if axis_s is None else rest[:eff] + (1,) + rest[eff:]
        gshape_rest = (1,) * x.ndim if axis_s is None else gshape_rest[:eff] + (1,) + gshape_rest[eff:]
    qshape = tuple(np.shape(q))
    r = r.reshape(qshape + rest)
    out_split = _operations._out_split_reduce(x, axis_s, keepdims) if axis_s is not None else None
    if out_split is not None and np.ndim(q):
        out_split += np.ndim(q)
    res = DNDarray(r.contiguous(), qshape + gshape_rest, promoted, out_split, x.device, x.comm, True)
    return _operations.handle_out(res, out)


def median(x: DNDarray, axis: Optional[int] = None, keepdims: bool = False) -> DNDarray:
    """The median: the 50th :func:`percentile`."""
    return percentile(x, 50.0, axis=axis, keepdims=keepdims)
