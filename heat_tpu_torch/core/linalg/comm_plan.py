"""Communication planner for distributed contractions (counterpart of
heat_tpu/core/linalg/comm_plan.py).

``matmul`` of two split 2-D operands picks one of three plans, by heat_tpu's cost model:

``xla``
    The general path of :func:`.basics.matmul`: the operands are brought to the
    product's layout by gathers (or, for a contraction-dim split, the partial products
    are all-reduced). Modelled wire bytes: ``(P−1)·|operand|`` for every split operand
    (the gather-both baseline), or ``2(P−1)·|C|`` for the contraction-split all-reduce.
``ring``
    The ring collective matmul: one panel of the rotating operand in flight over
    :meth:`TorchCommunication.ring_shift`, each rank's partial product computed while the
    next panel travels, the last panel consumed without a hop. ``(P−1)·|rotating
    operand|`` wire bytes; the gathered operand never exists.
``rs``
    The reduce-scatter contraction for contraction-dim splits: the local partial product
    is reduce-scattered into a ``split=0`` result, ``(P−1)·|C|`` wire bytes. It changes the
    result's split (``None`` → ``0``), so ``auto`` never picks it; ``HEAT_TPU_LINALG_PLAN=rs``
    asks for it.

The ``resplit`` move serves :meth:`DNDarray.resplit_`: split→split is one all-to-all,
each rank sending each peer only its tile, ``(P−1)/P·|array|`` on the wire.

``HEAT_TPU_LINALG_PLAN`` (``auto``/``xla``/``ring``/``rs``; anything else means ``auto``)
is read on every call; heat_tpu memoises it. Byte counts use heat_tpu's padded extents
(``P·ceil(n/P)``), so a :class:`Plan` equals heat_tpu's for the same shapes, splits, dtypes
and knob, although the port moves ragged chunks and pads nothing. Each executed plan
counts ``linalg.plan.<kind>`` and ``linalg.bytes.<kind>`` in :data:`COUNTERS`.

Unlike heat_tpu, a ring or rs plan that fails raises: no plan gives way to another.
Each ring or rs plan, and each all-to-all resplit, is a program of heat_tpu's
signature-cached executor (``core/_executor.py``, family ``"mm"``) with heat_tpu's replay
spec, so the compile cache records it and :func:`replay_warmup` rebuilds it at boot.
Every plan issues collectives, which every rank must issue in the same order, so its
program runs inline on the calling thread (the executor's collective-bearing programs
never queue); below the jit threshold the plan runs without a program.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import _executor, types
from ..devices import full_fp32_matmul
from ..dndarray import DNDarray
from ..kernels import int_matmul

__all__ = [
    "COUNTERS", "Plan", "linalg_plan", "plan_matmul", "replay_warmup", "reset_counters", "try_matmul", "try_resplit",
]

PLAN_KNOB = "HEAT_TPU_LINALG_PLAN"
_PLANS = ("auto", "xla", "ring", "rs")

COUNTERS: Dict[str, int] = {}
"""``linalg.plan.<kind>`` (calls) and ``linalg.bytes.<kind>`` (modelled wire bytes) of every
executed plan, with ``linalg.bytes.gather_baseline``; the resplit move counts
``linalg.plan.resplit``, ``linalg.bytes.resplit`` and ``linalg.bytes.resplit_gather_baseline``."""


class Plan(NamedTuple):
    """One planned contraction: its ``kind`` (``xla``/``ring``/``rs``), the ``variant``
    within it, and the modelled wire bytes of the plan (``nbytes``) and of gathering both
    operands (``baseline``)."""

    kind: str
    variant: str
    nbytes: int
    baseline: int


# ring variants by (a.split, b.split): which operand rotates and how the product is
# assembled; rs variants by the same key: where the local partial comes from
_RING_VARIANTS = {(0, 0): "rA", (1, 1): "rB", (0, 1): "rC"}
_RS_VARIANTS = {(1, 0): "s10", (None, 0): "sN0", (1, None): "s1N"}


def linalg_plan() -> str:
    """``HEAT_TPU_LINALG_PLAN``, read now: ``auto`` (the default and any unknown value),
    ``xla``, ``ring`` or ``rs``."""
    plan = os.environ.get(PLAN_KNOB, "auto").strip().lower()
    return plan if plan in _PLANS else "auto"


def reset_counters() -> None:
    COUNTERS.clear()


def _count(name: str, value: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + int(value)


def _np_dtype(t) -> np.dtype:
    """The numpy dtype of a heat type (bfloat16, which numpy lacks, as float16: the same
    itemsize, and it promotes alike with every type but float16)."""
    tt = types.canonical_heat_type(t).torch_type()
    if tt == torch.bfloat16:
        return np.dtype(np.float16)
    return np.dtype(str(tt).split(".")[-1])


def _padded_dim(n: int, size: int) -> int:
    """heat_tpu's physical extent of a split dimension: ``n`` rounded up to a multiple of
    ``size``."""
    n = int(n)
    return (-(-n // size) if n else 0) * size


def _phys_bytes(comm, gshape, split, dtype) -> int:
    """heat_tpu's padded-physical bytes of one global operand."""
    count = 1
    for d, extent in enumerate(gshape):
        count *= _padded_dim(extent, comm.size) if d == split else int(extent)
    return count * _np_dtype(dtype).itemsize


def _plannable_dtype(x: DNDarray) -> bool:
    dt = _np_dtype(x.dtype)
    return (np.issubdtype(dt, np.floating) or np.issubdtype(dt, np.integer)) and not np.issubdtype(dt, np.bool_)


def _structural(a, b):
    """The shared communicator when ``(a, b)`` is a plannable distributed 2-D contraction
    (size > 1, real or integer dtypes, conformable shapes), else ``None``."""
    if not (isinstance(a, DNDarray) and isinstance(b, DNDarray)):
        return None
    if a.ndim != 2 or b.ndim != 2:
        return None
    comm = a.comm
    if comm is not b.comm or comm.size <= 1:
        return None
    if a.gshape[1] != b.gshape[0]:
        return None
    if not (_plannable_dtype(a) and _plannable_dtype(b)):
        return None
    return comm


def _out_itemsize(a: DNDarray, b: DNDarray) -> int:
    return int(np.promote_types(_np_dtype(a.dtype), _np_dtype(b.dtype)).itemsize)


def plan_matmul(a: DNDarray, b: DNDarray) -> Optional[Plan]:
    """The plan for ``matmul(a, b)``, or ``None`` when the pair is not a plannable
    distributed contraction (the caller takes the general path and records nothing).

    ``auto`` picks ``ring`` wherever a ring variant applies and ``xla`` otherwise;
    ``ring`` and ``rs`` force their plan where it applies and give ``xla`` elsewhere;
    ``xla`` always gives ``xla``."""
    comm = _structural(a, b)
    if comm is None:
        return None
    if a.split is None and b.split is None:
        return None  # purely local: nothing to plan, nothing to record
    P = comm.size
    baseline = 0
    if a.split is not None:
        baseline += (P - 1) * _phys_bytes(comm, a.gshape, a.split, a.dtype)
    if b.split is not None:
        baseline += (P - 1) * _phys_bytes(comm, b.gshape, b.split, b.dtype)
    knob = linalg_plan()
    key = (a.split, b.split)

    ring_variant = _RING_VARIANTS.get(key)
    if ring_variant is not None and knob in ("auto", "ring"):
        rot = a if ring_variant == "rB" else b
        return Plan("ring", ring_variant, (P - 1) * _phys_bytes(comm, rot.gshape, rot.split, rot.dtype), baseline)

    rs_variant = _RS_VARIANTS.get(key)
    if rs_variant is not None and knob == "rs":
        c_bytes = _padded_dim(a.gshape[0], P) * b.gshape[1] * _out_itemsize(a, b)
        return Plan("rs", rs_variant, (P - 1) * c_bytes, baseline)

    return Plan("xla", "", _xla_bytes(comm, a, b, baseline), baseline)


def _xla_bytes(comm, a: DNDarray, b: DNDarray, baseline: int) -> int:
    """Modelled wire bytes of the general path: the contraction-split all-reduce
    (``2(P−1)·|C|``) when both splits land on the contraction pair, else gathering both."""
    if (a.split, b.split) in _RS_VARIANTS:
        return 2 * (comm.size - 1) * a.gshape[0] * b.gshape[1] * _out_itemsize(a, b)
    return baseline


def _record(plan: Plan) -> None:
    _count(f"linalg.plan.{plan.kind}")
    _count(f"linalg.bytes.{plan.kind}", plan.nbytes)
    _count("linalg.bytes.gather_baseline", plan.baseline)


def try_matmul(a: DNDarray, b: DNDarray) -> Any:
    """Plan ``matmul(a, b)`` and run it when the plan is ``ring`` or ``rs``. Returns the
    product, or ``NotImplemented`` for the caller's general path (plan ``xla`` or an
    unplannable pair). A ring or rs program that fails raises."""
    plan = plan_matmul(a, b)
    if plan is None:
        return NotImplemented
    if plan.kind == "xla":
        _record(plan)
        return NotImplemented
    value, split = _execute(plan, a, b)
    _record(plan)
    gshape = (a.gshape[0], b.gshape[1])
    return DNDarray(value, gshape, types.canonical_heat_type(value.dtype), split, a.device, a.comm, True)


def _mm_spec(plan: Plan, a: DNDarray, b: DNDarray) -> dict:
    """heat_tpu's replay spec of a planned contraction (comm_plan.py:372): the port pads
    nothing, so each operand's physical shape is its global one; ``precision`` is
    ``HIGHEST`` when an operand is float32 (heat_tpu's ``_contraction_precision``)."""
    from .._operations import _np_dtype_str, mesh_spec

    f32 = any(x.larray.dtype == torch.float32 for x in (a, b))
    return {
        "family": "mm", "kind": plan.kind, "variant": plan.variant,
        "a_gshape": list(a.gshape), "a_split": a.split,
        "a_dtype": _np_dtype_str(a.larray.dtype), "a_phys": list(a.gshape),
        "b_gshape": list(b.gshape), "b_split": b.split,
        "b_dtype": _np_dtype_str(b.larray.dtype), "b_phys": list(b.gshape),
        "precision": "HIGHEST" if f32 else None, "mesh": mesh_spec(a.comm),
    }


def _execute(plan: Plan, a: DNDarray, b: DNDarray):
    """Run a ring or rs plan as the executor's ``mm`` program for its signature (the
    plan itself below the jit threshold). Returns ``(local product, split)``."""
    comm = a.comm
    run = _ring if plan.kind == "ring" else _reduce_scatter
    al, bl = _operands(a, b)
    ag, bg = a.gshape, b.gshape
    key = ("mm", plan.kind, plan.variant, ag, bg, a.split, b.split, comm,
           _executor.operand_sig(al), _executor.operand_sig(bl))
    split = {"ring": 1 if plan.variant == "rB" else 0, "rs": 0}[plan.kind]

    def build():
        def body(x, y):
            return run(plan.variant, comm, ag, bg, x, y)[0]

        return body, None, "staged", {"collective": True}

    prog = _executor.lookup(key, build, label=f"mm.{plan.kind}.{plan.variant}",
                            spec=lambda: _mm_spec(plan, a, b))
    if prog is None:
        return run(plan.variant, comm, ag, bg, al, bl)
    return prog(al, bl), split


# ------------------------------------------------------------------ the products
def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Every product of the linalg package: ``torch.matmul`` with f32 in full fp32 (TF32
    off; heat_tpu's ``Precision.HIGHEST``); bool and integer operands through the integer
    product (:mod:`..kernels.int_matmul`: the hand kernel on the card, where cuBLAS has
    no integer GEMM), modulo 2^bits and the OR of ANDs, as XLA's dot."""
    if not (x.is_floating_point() or x.is_complex()):
        return int_matmul.matmul(x, y)
    with full_fp32_matmul():
        return torch.matmul(x, y)


def _operands(a: DNDarray, b: DNDarray):
    """Both local tensors in the product's dtype."""
    ct = types.promote_types(a.dtype, b.dtype).torch_type()
    return a.larray.to(ct), b.larray.to(ct)


def _ring(variant: str, comm, a_gshape, b_gshape, al: torch.Tensor, bl: torch.Tensor):
    """The ring collective matmul (heat_tpu ``_ring_body``, comm_plan.py:219): ``P − 1``
    hops of one panel of the rotating operand (:meth:`TorchCommunication.ring_blocks`),
    each overlapping the product of the panel in hand; the last panel is consumed without
    a hop. Panels are ragged, possibly empty: each one's extents come from its owner's
    chunk. Returns ``(local product, split)``.

    ``rA``: a split 0, b split 0 (the contraction dim): b's row panels rotate and meet the
    matching column panel of a's rows. ``rB``: a split 1 (contraction), b split 1: a's
    column panels rotate and meet the matching rows of b's columns. ``rC``: a split 0, b
    split 1: b's column panels rotate into their column slot of a's rows."""
    (m, k), n = a_gshape, b_gshape[1]
    k_counts, k_displs, _ = comm.counts_displs_shape((k,), 0)
    if variant == "rA":
        rot, fixed, out = bl, al, al.new_zeros((al.shape[0], n))

        def recv_shape(r):
            return (k_counts[r], n)

        def contrib(src, blk, out):
            return out + _mm(fixed[:, k_displs[src] : k_displs[src] + k_counts[src]], blk)

        split = 0
    elif variant == "rB":
        rot, fixed, out = al, bl, al.new_zeros((m, bl.shape[1]))

        def recv_shape(r):
            return (m, k_counts[r])

        def contrib(src, blk, out):
            return out + _mm(blk, fixed[k_displs[src] : k_displs[src] + k_counts[src]])

        split = 1
    elif variant == "rC":
        n_counts, n_displs, _ = comm.counts_displs_shape((n,), 0)
        rot, fixed, out = bl, al, al.new_empty((al.shape[0], n))

        def recv_shape(r):
            return (k, n_counts[r])

        def contrib(src, blk, out):
            out[:, n_displs[src] : n_displs[src] + n_counts[src]] = _mm(fixed, blk)
            return out

        split = 0
    else:
        raise ValueError(f"unknown ring variant {variant!r}")
    for src, blk in comm.ring_blocks(rot, recv_shape):
        out = contrib(src, blk, out)
    return out, split


def _reduce_scatter(variant: str, comm, a_gshape, b_gshape, al: torch.Tensor, bl: torch.Tensor):
    """The reduce-scatter contraction (heat_tpu ``_rs_body``, comm_plan.py:309): this
    rank's partial product over its contraction-dim chunk, reduce-scattered straight into
    a ``split=0`` result. ``s10``: both operands split on the contraction dim; ``sN0``: a
    whole, sliced to b's rows; ``s1N``: b whole, sliced to a's columns."""
    k = a_gshape[1]
    start, (kr,), _ = comm.chunk((k,), 0)
    if variant == "sN0":
        al = al[:, start : start + kr]
    elif variant == "s1N":
        bl = bl[start : start + kr]
    elif variant != "s10":
        raise ValueError(f"unknown rs variant {variant!r}")
    return comm.reduce_scatter(_mm(al, bl), 0), 0


# ------------------------------------------------------------------ all-to-all resplit
def resplit_eligible(x: DNDarray, axis: Optional[int]) -> bool:
    """Whether ``x.resplit(axis)`` is a split→split move for the all-to-all (heat_tpu
    comm_plan.py:400; any dtype here, the all-to-all moves bool as bytes)."""
    return (
        isinstance(x, DNDarray)
        and axis is not None
        and x.split is not None
        and axis != x.split
        and x.comm.size > 1
        and linalg_plan() != "xla"
    )


def try_resplit(x: DNDarray, axis: int) -> Any:
    """This rank's chunk of ``x`` laid out along ``axis``, by one all-to-all from
    ``x.split`` (heat_tpu comm_plan.py:416), or ``NotImplemented`` for the caller's gather."""
    if not resplit_eligible(x, axis):
        return NotImplemented
    comm = x.comm
    src, extent = x.split, x.gshape[x.split]
    value = x.larray
    key = ("mm", "resplit", x.gshape, src, axis, comm, _executor.operand_sig(value))

    def build():
        def body(v):
            return comm.all_to_all(v, split_axis=axis, concat_axis=src, concat_extent=extent)

        return body, None, "staged", {"collective": True}

    def spec():
        from .._operations import _np_dtype_str, mesh_spec

        return {
            "family": "mm", "kind": "resplit", "gshape": list(x.gshape), "split": src, "dst": axis,
            "dtype": _np_dtype_str(value.dtype), "phys": list(x.gshape), "mesh": mesh_spec(comm),
        }

    prog = _executor.lookup(key, build, label=f"mm.resplit.{src}->{axis}", spec=spec)
    if prog is None:
        moved = comm.all_to_all(value, split_axis=axis, concat_axis=src, concat_extent=extent)
    else:
        moved = prog(value)
    P = comm.size
    phys = _phys_bytes(comm, x.gshape, x.split, x.dtype)
    _count("linalg.plan.resplit")
    _count("linalg.bytes.resplit", (P - 1) * phys // P)
    _count("linalg.bytes.resplit_gather_baseline", (P - 1) * phys)
    return moved


# ------------------------------------------------------------------ warmup replay
def replay_warmup(spec: dict, zeros_dnd) -> bool:
    """Re-enter a recorded family-``"mm"`` program over zeros of the recorded
    signature (heat_tpu comm_plan.py:478; the compile cache's warmup).
    ``zeros_dnd(gshape, split, dtype_str)`` is ``_compile_cache._zeros_dnd``. False when
    the recorded physical layout or mesh is not this process's, or the plan the
    planner makes here is another one."""
    from .._operations import mesh_spec

    if spec.get("kind") == "resplit":
        x = zeros_dnd(spec["gshape"], spec["split"], spec["dtype"])
        if list(x.gshape) != list(spec["phys"]) or mesh_spec(x.comm) != spec.get("mesh"):
            return False
        return try_resplit(x, spec["dst"]) is not NotImplemented
    a = zeros_dnd(spec["a_gshape"], spec["a_split"], spec["a_dtype"])
    b = zeros_dnd(spec["b_gshape"], spec["b_split"], spec["b_dtype"])
    if (list(a.gshape) != list(spec["a_phys"]) or list(b.gshape) != list(spec["b_phys"])
            or mesh_spec(a.comm) != spec.get("mesh")):
        return False
    plan = plan_matmul(a, b)
    if plan is None or (plan.kind, plan.variant) != (spec["kind"], spec["variant"]):
        return False
    _execute(plan, a, b)
    return True
