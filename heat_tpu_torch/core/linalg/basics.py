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
their partial products in one all-reduce; any other layout gathers. The small dense
operations (``det``, ``inv``, ``cross``, ``trace``, the triangles, the matrix norms) work
on the gathered value and keep this rank's chunk of the result.
"""

from __future__ import annotations

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
    """Dot of the flattened operands, the first conjugated."""
    ct = types.promote_types(x1.dtype, x2.dtype).torch_type()
    a, b = x1._relayout(None).reshape(-1).to(ct), x2._relayout(None).reshape(-1).to(ct)
    value = torch.vdot(a, b) if a.is_complex() or a.is_floating_point() else _dot(a, b)
    return _operations.wrap_global(value, x1, None)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of two vectors (operands of more dimensions are flattened first, as
    numpy's are); split 0 if ``a`` is split, else 1 if ``b`` is, unless ``split`` says
    otherwise."""
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
    """Cross product of 3-vectors (2-vectors as numpy's), result split as ``a``."""
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
    """Sum along a diagonal; a Python scalar for a 2-D input without ``out``."""
    sanitation.sanitize_in(a)
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
        return res.item()
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
    """The lower or upper triangle; a vector first becomes the square matrix of its rows.
    Computed on the gathered value, because a chunk's triangle depends on its offset."""
    sanitation.sanitize_in(a)
    if a.ndim == 1:
        n = a.gshape[0]
        value = op(a._relayout(None).expand(n, n), diagonal=k)
        return _operations.wrap_global(value.contiguous(), a, 0 if a.split is not None else None)
    return _operations.wrap_global(op(a._relayout(None), diagonal=k), a, a.split)


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
    if ord in (None, 2):
        v = x.larray
        # complex: jnp's real(x·conj(x)), the squares of both parts
        sq = v.real * v.real + v.imag * v.imag if v.is_complex() else v.to(rt) * v.to(rt)
        sq = torch.sum(sq, dim=axes, keepdim=keepdims) if x.ndim else sq
        if x.is_distributed() and x.split in axes:
            x.comm.all_reduce(sq, "sum")
        return _wrap_local(torch.sqrt(sq), x, split, gshape)
    whole = x._relayout(None)
    value = torch.linalg.vector_norm(whole if whole.is_complex() else whole.to(rt), ord=ord, dim=axes, keepdim=keepdims)
    return _operations.wrap_global(value, x, split)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm of the last two axes (Frobenius by default), whole on every rank."""
    sanitation.sanitize_in(x)
    if axis is None:
        if x.ndim < 2:
            raise ValueError("matrix_norm requires at least 2 dimensions")
        axis = (x.ndim - 2, x.ndim - 1)
    rt = _operations._inexact(x.dtype).torch_type()
    value = torch.linalg.matrix_norm(x._relayout(None).to(rt), ord=ord if ord is not None else "fro", dim=tuple(axis), keepdim=keepdims)
    return _operations.wrap_global(value, x, None)


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
        return matrix_norm(x, axis=axis, keepdims=keepdims, ord=ord)
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
