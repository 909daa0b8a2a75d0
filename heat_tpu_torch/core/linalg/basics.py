"""Basic linear algebra (counterpart of heat_tpu/core/linalg/basics.py).

Every float product is ``torch.matmul`` (cuBLAS on the card) with f32 in full fp32, TF32
off (:func:`.comm_plan._mm`), where heat_tpu asks XLA for ``Precision.HIGHEST``
(heat_tpu/core/linalg/basics.py:53-69). Bool and integer products, ``matmul``'s, ``dot``'s
and ``vdot``'s, go to the integer product (:mod:`..kernels.int_matmul`, a hand kernel on the
card, where cuBLAS has none): modulo 2^bits of the type, bool the OR of ANDs, as XLA's dot.
heat_tpu's linalg runs no Pallas kernel.

Each rank holds its chunk, so the data movement heat_tpu leaves to XLA is written out.
``matmul`` of two split 2-D operands goes through the planner (:mod:`.comm_plan`: the ring
collective matmul, the reduce-scatter contraction, or the general path below). The
general path keeps what is local local: a row-split ``a`` multiplies its rows by the whole
``b``, a column-split ``b`` its columns by the whole ``a``, contraction-dim splits add
their partial products in one all-reduce; any other layout gathers. ``vdot``, ``trace``, the
triangles, the vector norms and the matrix norms 'fro', ±1 and ±inf of a split array work on
each rank's chunk, with one all-reduce of a total where the split axis is summed. The dense
factorisations (``det``, ``inv``), ``cross``, ``outer`` and the matrix norms 2, −2 and 'nuc'
(the singular values of the whole matrix) work on the gathered value and keep this rank's
chunk of the result.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

from .. import _operations, sanitation, types
from ..dndarray import DNDarray
from ..kernels import int_matmul
from ..stride_tricks import broadcast_shapes, sanitize_axis
from . import comm_plan


__all__ = [
    "PARITY_PRECISION",
    "cross",
    "det",
    "dot",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]

PARITY_PRECISION = "highest"
"""heat_tpu's precision marker for parity-critical products. A no-op here: every f32
product already runs in full fp32 (TF32 off)."""


def _wrap_local(value: torch.Tensor, proto: DNDarray, split: Optional[int], gshape) -> DNDarray:
    return DNDarray(value, tuple(gshape), types.canonical_heat_type(value.dtype), split, proto.device, proto.comm, True)


def _matmul_split(a: DNDarray, b: DNDarray, nd_out: int) -> Optional[int]:
    """heat_tpu's output split of ``matmul`` (basics.py:100-115): a's rows, else b's
    columns, else a's batch dim, else b's; None for contraction-dim splits."""
    row_dim = nd_out - (2 if b.ndim >= 2 else 1) if a.ndim >= 2 else None
    col_dim = nd_out - 1 if b.ndim >= 2 else None
    split = None
    if a.ndim >= 2 and a.split == a.ndim - 2 and row_dim is not None and row_dim >= 0:
        split = row_dim
    elif b.ndim >= 2 and b.split == b.ndim - 1 and col_dim is not None and col_dim >= 0:
        split = col_dim
    elif a.split is not None and a.ndim >= 2 and a.split < a.ndim - 2:
        split = a.split  # batch dim
    elif b.split is not None and b.ndim >= 2 and b.split < b.ndim - 2:
        split = b.split
    if nd_out == 0:
        split = None
    return split


def _out_shape(a: DNDarray, b: DNDarray):
    """Global shape of ``matmul(a, b)`` by numpy's rules: a 1-D operand gains a unit dim
    that the result drops, batch dims broadcast."""
    sa = a.gshape if a.ndim > 1 else (1,) + a.gshape
    sb = b.gshape if b.ndim > 1 else b.gshape + (1,)
    if a.ndim == 0 or b.ndim == 0 or sa[-1] != sb[-2]:
        raise ValueError(f"matmul: shapes {a.gshape} and {b.gshape} are not aligned")
    shape = broadcast_shapes(sa[:-2], sb[:-2]) + (sa[-2], sb[-1])
    if a.ndim == 1:
        shape = shape[:-2] + shape[-1:]
    if b.ndim == 1:
        shape = shape[:-1]
    return shape


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False, precision=None) -> DNDarray:
    """Matrix product of distributed operands (heat_tpu basics.py:82).

    Output split: a row-split ``a`` gives a row-split product, a column-split ``b`` a
    column-split one, a batch-dim split is kept, contraction-dim splits reduce away to
    None (``HEAT_TPU_LINALG_PLAN=rs`` makes them a ``split=0`` reduce-scatter instead).
    Two split 2-D operands go through the planner; ``precision`` is accepted for
    heat_tpu's signature and has no effect (f32 always runs in full fp32)."""
    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    planned = comm_plan.try_matmul(a, b)
    if planned is not NotImplemented:
        return planned
    gshape = _out_shape(a, b)
    split = _matmul_split(a, b, len(gshape))
    ct = types.promote_types(a.dtype, b.dtype).torch_type()
    comm = a.comm
    if comm.size == 1 or not (a.is_distributed() or b.is_distributed()):
        value = comm_plan._mm(a.larray.to(ct), b.larray.to(ct))
        return _wrap_local(value, a, split, gshape)
    row_dim = len(gshape) - (2 if b.ndim >= 2 else 1) if a.ndim >= 2 else None
    col_dim = len(gshape) - 1 if b.ndim >= 2 else None
    contract_a = a.ndim - 1
    contract_b = b.ndim - 2 if b.ndim >= 2 else 0
    if split is not None and split == row_dim and a.split == a.ndim - 2:
        value = comm_plan._mm(a.larray.to(ct), b._relayout(None).to(ct))  # a's rows, b whole
        return _wrap_local(value, a, split, gshape)
    if split is not None and split == col_dim and b.split == b.ndim - 1:
        value = comm_plan._mm(a._relayout(None).to(ct), b.larray.to(ct))  # a whole, b's columns
        return _wrap_local(value, a, split, gshape)
    if split is None and (a.split in (None, contract_a)) and (b.split in (None, contract_b)):
        # contraction-dim splits: this rank's chunk of k from both, partials all-reduced
        al = a.larray if a.split == contract_a else a.larray.narrow(contract_a, *_k_chunk(a, contract_a))
        bl = b.larray if b.split == contract_b else b.larray.narrow(contract_b, *_k_chunk(b, contract_b))
        value = comm.all_reduce(comm_plan._mm(al.to(ct), bl.to(ct)), "sum")
        return _wrap_local(value, a, None, gshape)
    # any other layout (batch-dim splits among them): both whole, keep this rank's chunk
    value = comm_plan._mm(a._relayout(None).to(ct), b._relayout(None).to(ct))
    return _operations.wrap_global(value, a, split)


def _k_chunk(x: DNDarray, axis: int):
    """(start, length) of this rank's chunk of ``x``'s ``axis``."""
    start, lshape, _ = x.comm.chunk(x.gshape, axis)
    return start, lshape[axis]


def dot(a, b, out: Optional[DNDarray] = None, precision=None) -> Union[DNDarray, float]:
    """Dot product (heat_tpu basics.py:122): inner product of 1-D operands, ``matmul``
    otherwise."""
    from .. import arithmetics

    if isinstance(a, (int, float)) or isinstance(b, (int, float)) or a.ndim == 0 or b.ndim == 0:
        return arithmetics.mul(a, b)
    if a.ndim == 1 and b.ndim == 1:
        if a.gshape != b.gshape:
            raise ValueError(f"shapes {a.gshape} and {b.gshape} not aligned")
        ct = types.promote_types(a.dtype, b.dtype).torch_type()
        if a.is_distributed() and a.split == b.split:
            value = a.comm.all_reduce(_dot(a.larray.to(ct), b.larray.to(ct)), "sum")
        else:
            value = _dot(a._relayout(None).to(ct), b._relayout(None).to(ct))
        return _operations.handle_out(_operations.wrap_global(value, a, None), out)
    return _operations.handle_out(matmul(a, b), out)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The inner product of two 1-D tensors of one type: ``torch.dot``, bool and integers
    through the integer product (torch.dot takes neither on the card)."""
    if a.is_floating_point() or a.is_complex():
        return torch.dot(a, b)
    return int_matmul.matmul(a, b)


def vecdot(x1: DNDarray, x2: DNDarray, axis: Optional[int] = None, keepdims: bool = False) -> DNDarray:
    """Vector dot along an axis (the last by default)."""
    from .. import arithmetics

    m = arithmetics.mul(x1, x2)
    if axis is None:
        axis = m.ndim - 1
    return arithmetics.sum(m, axis=axis, keepdims=keepdims)


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Dot of the flattened operands, the first conjugated. Split operands are brought to
    one layout (the second reshaped to the first's shape, then relaid to its split: an
    all-to-all, or this rank's chunk of an unsplit one), each rank takes the dot of its
    chunks and one all-reduce sums them; integer and bool operands through ``_dot``."""
    from ..manipulations import reshape

    ct = types.promote_types(x1.dtype, x2.dtype).torch_type()
    split = x1.split if x1.split is not None else x2.split
    if split is None or x1.comm.size == 1:
        a, b = x1._relayout(None).reshape(-1).to(ct), x2._relayout(None).reshape(-1).to(ct)
        value = torch.vdot(a, b) if a.is_complex() or a.is_floating_point() else _dot(a, b)
        return _operations.wrap_global(value, x1, None)
    if x1.size != x2.size:
        raise ValueError(f"vdot: operands of {x1.size} and {x2.size} elements")
    shape = x1.gshape if x1.split is not None else x2.gshape
    x1, x2 = (x if x.gshape == shape else reshape(x, shape, new_split=split if x.split is not None else None)
              for x in (x1, x2))
    a, b = x1._relayout(split).reshape(-1).to(ct), x2._relayout(split).reshape(-1).to(ct)
    value = torch.vdot(a, b) if a.is_complex() or a.is_floating_point() else _dot(a, b)
    return _operations.wrap_global(x1.comm.all_reduce(value, "sum"), x1, None)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of two vectors (operands of more dimensions are flattened first, as
    numpy's are); split 0 if ``a`` is split, else 1 if ``b`` is, unless ``split`` says
    otherwise. The other vector is gathered: every row or column of the result needs all of
    it."""
    from ..manipulations import flatten

    sanitation.sanitize_in(a)
    sanitation.sanitize_in(b)
    a, b = (flatten(v) if v.ndim != 1 else v for v in (a, b))
    if split is None:
        split = 0 if a.split is not None else (1 if b.split is not None else None)
    ct = types.promote_types(a.dtype, b.dtype).torch_type()
    gshape = (a.gshape[0], b.gshape[0])
    if split == 0:
        value = torch.outer(a._relayout(0).to(ct), b._relayout(None).to(ct))
    elif split == 1:
        value = torch.outer(a._relayout(None).to(ct), b._relayout(0).to(ct))
    else:
        value = torch.outer(a._relayout(None).to(ct), b._relayout(None).to(ct))
    return _operations.handle_out(_wrap_local(value, a, split, gshape), out)


def cross(a: DNDarray, b: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1) -> DNDarray:
    """Cross product of 3-vectors (2-vectors as numpy's), result split as ``a``; both
    operands are gathered (whole by definition: their vectors run along any axis)."""
    ct = types.promote_types(a.dtype, b.dtype).torch_type()
    av, bv = a._relayout(None).to(ct), b._relayout(None).to(ct)
    if axis != -1:
        axisa = axisb = axisc = axis
    av, bv = av.movedim(axisa, -1), bv.movedim(axisb, -1)
    if av.shape[-1] == 2 or bv.shape[-1] == 2:
        # numpy's rule: a 2-vector has z = 0; two 2-vectors give the z component only
        both2 = av.shape[-1] == 2 and bv.shape[-1] == 2
        av = torch.nn.functional.pad(av, (0, 3 - av.shape[-1]))
        bv = torch.nn.functional.pad(bv, (0, 3 - bv.shape[-1]))
        av, bv = torch.broadcast_tensors(av, bv)
        value = torch.linalg.cross(av, bv, dim=-1)
        if both2:
            return _operations.wrap_global(value[..., 2].contiguous(), a, a.split)
    else:
        av, bv = torch.broadcast_tensors(av, bv)
        value = torch.linalg.cross(av, bv, dim=-1)
    value = value.movedim(-1, axisc)
    return _operations.wrap_global(value.contiguous(), a, a.split)


def _square(a: DNDarray) -> None:
    sanitation.sanitize_in(a)
    if a.ndim < 2 or a.gshape[-1] != a.gshape[-2]:
        raise ValueError(f"last two dimensions must be square, got {a.gshape}")


def det(a: DNDarray) -> DNDarray:
    """Determinant (LU on the gathered matrix); whole on every rank."""
    _square(a)
    return _operations.wrap_global(torch.linalg.det(a._relayout(None)), a, None)


def inv(a: DNDarray) -> DNDarray:
    """Matrix inverse (LU on the gathered matrix), split as ``a``."""
    _square(a)
    return _operations.wrap_global(torch.linalg.inv(a._relayout(None)), a, a.split)


def trace(a: DNDarray, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out=None) -> Union[DNDarray, float]:
    """Sum along a diagonal; a Python scalar for a 2-D input without ``out``. A split array
    sums the piece of the diagonal in its chunk, then one all-reduce (split ``axis1`` or
    ``axis2``) or one gather of the result's pieces (another split) gives it whole, exact
    for integers and bools as the sum of the whole diagonal."""
    from ..manipulations import diagonal

    sanitation.sanitize_in(a)
    axis1, axis2 = sanitize_axis(a.gshape, axis1), sanitize_axis(a.gshape, axis2)
    if a.split is not None and a.is_distributed():
        piece = diagonal(a, offset, axis1, axis2) if a.split not in (axis1, axis2) else None
        if piece is None:
            start, _, _ = a.comm.chunk(a.gshape, a.split)
            local = offset + start if a.split == axis1 else offset - start
            value = a.comm.all_reduce(torch.diagonal(a.larray, local, axis1, axis2).sum(-1), "sum")
        else:  # the diagonals of another split axis: each rank sums its own, one gather of the sums
            value = a.comm.all_gather_v(piece.larray.sum(-1).movedim(piece.split, 0).contiguous()).movedim(
                0, piece.split)
    else:
        value = torch.diagonal(a._relayout(None), offset=offset, dim1=axis1, dim2=axis2).sum(-1)
    if dtype is not None:
        value = value.to(types.canonical_heat_type(dtype).torch_type())
    elif types.heat_type_is_exact(a.dtype) and a.dtype not in (types.uint8, types.bool):
        value = value.to(a.dtype.torch_type())  # jnp.trace keeps signed integer types; bools sum as int64
    res = _operations.wrap_global(value, a, None)
    if out is not None:
        out.larray = res.larray.to(out.dtype.torch_type())
        return out
    if res.ndim == 0:
        return res.larray.item()  # whole on every rank
    return res


def transpose(a: DNDarray, axes: Optional[Sequence[int]] = None) -> DNDarray:
    """Permute the dimensions: a local permute, the split remapped."""
    sanitation.sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = tuple(int(ax) + a.ndim if ax < 0 else int(ax) for ax in axes)
        if sorted(axes) != list(range(a.ndim)):
            raise ValueError(f"axes do not match tensor of dimension {a.ndim}")
    split = axes.index(a.split) if a.split is not None else None
    gshape = tuple(a.gshape[ax] for ax in axes)
    return DNDarray(a.larray.permute(axes).contiguous(), gshape, a.dtype, split, a.device, a.comm, True)


def _tri_op(a: DNDarray, k: int, op) -> DNDarray:
    """The lower or upper triangle of the last two axes; a vector first becomes the square
    matrix of its rows (split 0 if the vector is split). Each rank takes the triangle of its
    chunk with ``k`` moved by the chunk's first global row (split on the rows) or column
    (split on the columns); a split vector's rank builds only its own rows, from the
    elements that survive in them (:func:`..manipulations._vector_range`)."""
    from ..manipulations import _vector_range

    sanitation.sanitize_in(a)
    k = int(k)
    if a.ndim == 1:
        n = a.gshape[0]
        if a.split is None or not a.is_distributed():
            value = op(a._relayout(None).expand(n, n), diagonal=k)
            return _operations.wrap_global(value.contiguous(), a, 0 if a.split is not None else None)
        counts, displs, _ = a.comm.counts_displs_shape((n, n), 0)

        def cols_of(c, d):
            # the columns rows [d, d + c) keep: j <= i + k (tril), j >= i + k (triu)
            if c == 0:
                return (0, 0)
            lo, hi = (0, d + c + k) if op is torch.tril else (d + k, n)
            lo, hi = min(max(lo, 0), n), min(max(hi, 0), n)
            return (lo, max(lo, hi))

        ranges = [cols_of(c, d) for c, d in zip(counts, displs)]
        lo, hi = ranges[a.comm.rank]
        row = torch.zeros(n, dtype=a.larray.dtype, device=a.larray.device)
        row[lo:hi] = _vector_range(a, ranges)
        start, count = displs[a.comm.rank], counts[a.comm.rank]
        value = op(row.expand(count, n), diagonal=k + start).contiguous()
        return DNDarray(value, (n, n), a.dtype, 0, a.device, a.comm, True)
    start, _, _ = a.comm.chunk(a.gshape, a.split) if a.split is not None else (0, None, None)
    rows, cols = a.ndim - 2, a.ndim - 1
    shift = start if a.split == rows else (-start if a.split == cols else 0)
    return DNDarray(op(a.larray, diagonal=k + shift), a.gshape, a.dtype, a.split, a.device, a.comm, True)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower triangle."""
    return _tri_op(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper triangle."""
    return _tri_op(m, k, torch.triu)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector norm over ``axis`` (every axis by default); float64 for integer and bool
    input, as jnp.linalg.vector_norm's under x64, and the real type for complex input. The
    2-norm over the split axis is a local sum of squares and one all-reduce; other orders
    work on the gathered value."""
    rt = x.dtype if types.heat_type_is_inexact(x.dtype) else types.float64
    return _vector_norm(x, axis, keepdims, ord, _real(rt.torch_type()))


def _real(t: torch.dtype) -> torch.dtype:
    """The real type of a complex torch type (a real one as it is)."""
    return t.to_real() if t.is_complex else t


def _vector_norm(x: DNDarray, axis, keepdims: bool, ord, rt: torch.dtype) -> DNDarray:
    """:func:`vector_norm` computed in ``rt``."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    axes = tuple(range(x.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    split = None if axis is None else _operations._out_split_reduce(x, axis, keepdims)
    if keepdims:
        gshape = tuple(1 if d in axes else s for d, s in enumerate(x.gshape))
    else:
        gshape = tuple(s for d, s in enumerate(x.gshape) if d not in axes)
    if split is not None and split >= len(gshape):
        split = None
    v = x.larray
    across = x.is_distributed() and x.split in axes
    if ord in (None, 2):
        # complex: jnp's real(x·conj(x)), the squares of both parts
        sq = v.real * v.real + v.imag * v.imag if v.is_complex() else v.to(rt) * v.to(rt)
        sq = torch.sum(sq, dim=axes, keepdim=keepdims) if x.ndim else sq
        if across:
            x.comm.all_reduce(sq, "sum")
        return _wrap_local(torch.sqrt(sq), x, split, gshape)
    if not across:  # the reduced axes are whole on this rank
        value = torch.linalg.vector_norm(v if v.is_complex() else v.to(rt), ord=ord, dim=axes, keepdim=keepdims)
        return _wrap_local(value, x, split, gshape)
    from ..manipulations import _extreme

    mag = v.abs().to(rt) if v.is_complex() else v.to(rt).abs()
    ord = float(ord)
    if math.isinf(ord):  # the largest or smallest |x|, NaN winning
        value = _extreme(mag, axes, "max" if ord > 0 else "min", x.comm)
    elif ord == 0:  # the count of nonzero elements
        value = x.comm.all_reduce(torch.sum((mag != 0).to(rt), dim=axes, keepdim=True), "sum")
    else:  # (Σ|x|^p)^(1/p), the sum all-reduced
        value = x.comm.all_reduce(torch.sum(mag ** ord, dim=axes, keepdim=True), "sum") ** (1.0 / ord)
    if not keepdims:
        value = value.reshape([s for d, s in enumerate(value.shape) if d not in axes])
    return _wrap_local(value, x, split, gshape)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm of the last two axes (Frobenius by default), whole on every rank. As
    heat_tpu's (jnp.linalg.matrix_norm), it takes the last two axes whatever ``axis`` says;
    :func:`norm` takes the two axes it is given."""
    sanitation.sanitize_in(x)
    if x.ndim < 2:
        raise ValueError("matrix_norm requires at least 2 dimensions")
    return _matrix_norm(x, (x.ndim - 2, x.ndim - 1), keepdims, ord)


def _matrix_norm(x: DNDarray, axis, keepdims: bool, ord) -> DNDarray:
    """The matrix norm over the two axes ``axis``. For a split array 'fro', 1, −1, inf and
    −inf take the sums of |x| along rows or columns locally, then a sum across ranks where
    the summed axis is split, or a max / min across ranks where the other one is (a split
    batch axis: one gather of the result's pieces); 2, −2 and 'nuc' need the singular values
    of the whole matrix, so they gather it."""
    rt = _operations._inexact(x.dtype).torch_type()
    ord = ord if ord is not None else "fro"
    r, c = (sanitize_axis(x.gshape, ax) for ax in axis)
    if x.split is None or not x.is_distributed() or ord not in ("fro", 1, -1, float("inf"), float("-inf")):
        value = torch.linalg.matrix_norm(x._relayout(None).to(rt), ord=ord, dim=(r, c), keepdim=keepdims)
        return _operations.wrap_global(value, x, None)
    from ..manipulations import _extreme

    mag = x.larray.to(rt).abs()
    if ord == "fro":
        value = torch.sum(mag * mag, dim=(r, c), keepdim=True)
        if x.split in (r, c):
            x.comm.all_reduce(value, "sum")
        value = torch.sqrt(value)
    else:
        summed, other = (r, c) if ord in (1, -1) else (c, r)  # 1: the largest column sum, inf: row sum
        kind = "max" if ord in (1, float("inf")) else "min"
        sums = torch.sum(mag, dim=summed, keepdim=True)
        if x.split == summed:
            x.comm.all_reduce(sums, "sum")
        value = _extreme(sums, other, kind, x.comm if x.split == other else None)
    if x.split not in (r, c):  # a split batch axis: each rank holds its matrices' norms
        value = x.comm.all_gather_v(value.movedim(x.split, 0).contiguous()).movedim(0, x.split)
    if not keepdims:
        value = value.squeeze(max(r, c)).squeeze(min(r, c))
    return _operations.wrap_global(value.contiguous(), x, None)


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """numpy's ``norm``: the 2-norm of the flattened array by default, a matrix norm over
    two axes, a vector norm over one."""
    sanitation.sanitize_in(x)
    rt = _real(_operations._inexact(x.dtype).torch_type())  # jnp.linalg.norm: float32 for int32
    if axis is None and ord is None:
        return _vector_norm(x, None, False, None, rt)
    axis = sanitize_axis(x.gshape, axis)
    if axis is None:
        axis = tuple(range(x.ndim))
    if isinstance(axis, tuple) and len(axis) == 2:
        return _matrix_norm(x, axis, keepdims, ord)
    if isinstance(axis, tuple):
        axis = axis[0]
    return _vector_norm(x, axis, keepdims, ord, rt)


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of vector ``a`` onto vector ``b``."""
    from .. import arithmetics

    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"projection gets 1-D vectors, got {a.ndim}-D and {b.ndim}-D")
    scale = arithmetics.div(dot(a, b), dot(b, b))
    return arithmetics.mul(scale, b)
