"""The dispatch wrappers: binary, local (elementwise) and reduction operations with
Heat's split and type semantics (counterpart of heat_tpu/core/_operations.py).

Each wrapper works on this rank's local tensors, and routes through the
signature-cached executor (:mod:`_executor`) unless ``HEAT_TPU_EAGER_DISPATCH=1``:

- an elementwise binary or local op whose operands share one ``(gshape, split,
  comm)`` family, with no ``out=``/``where=``, does not run at call time: it
  returns a deferred node of the executor's expression graph, which runs as one
  program when the result's local tensor is first read;
- every other call runs its local compute as a cached one-op program (the staged
  ``b.log``/``l``/``r``/``c`` families); a reduction or scan over the split axis
  of a distributed array issues a collective, so its program runs inline;
- the eager path below each is the same compute called directly. Each wrapper's
  compute is one function (a kernel object or a ``_*_compute`` function) that all
  three paths call, so the executor's results are bit-equal to eager dispatch.

Each wrapper is also a ``dispatch`` slice of the profiler's request scope while
the profiler is on. A binary operation first brings both
operands to the output's distribution (the dominant-split rule, :func:`_out_split_binary`);
a reduction over the split axis is a local reduction followed by one ``all_reduce``.
Result dtypes follow heat_tpu's, which are JAX's with x64 enabled: Python scalars are
weak, integer true division gives float32 (float64 from int64), and sums of small
integer types accumulate in int64.
"""

from __future__ import annotations

import builtins
import contextlib
import functools
import json
import threading
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import _complex_order, _executor, _result_cache, factories, profiler, sanitation, types
from ._executor import Deferred, operand_sig
from .dndarray import DNDarray
from .stride_tricks import broadcast_shapes, sanitize_axis

__all__ = ["wrap_result", "wrap_global", "rebalance", "binary_op", "local_op", "reduce_op", "cum_op"]

_PY_SCALARS = (builtins.bool, builtins.int, builtins.float, builtins.complex)
# operations whose result is bool whatever they compute in
_COMPARISONS = (
    torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge,
    torch.logical_and, torch.logical_or, torch.logical_xor, torch.isclose,
)


# operations that turn exact operands into floats (as true division does), and those
# that turn bool operands into int32
_FLOAT_RESULTS = (torch.true_divide, torch.hypot, torch.copysign, torch.logaddexp, torch.logaddexp2, torch.atan2)
_INT_FROM_BOOL = (torch.floor_divide, torch.remainder, torch.fmod, torch.bitwise_left_shift, torch.bitwise_right_shift)
_INT_DIVISIONS = (torch.floor_divide, torch.remainder, torch.fmod)


def _by_zero_as_xla(operation: Callable, a: torch.Tensor, b: torch.Tensor, bools: bool, **kw) -> torch.Tensor:
    """An integer division or remainder with XLA's results where the divisor is 0, on
    the CPU and the card alike (torch raises on the CPU and the card's hardware answers
    otherwise): a remainder by 0 is 0, except ``fmod`` of two bool operands, which is
    XLA's rem(x, 0) = x; x // 0 is XLA's x / 0, all bits set, stepped down by one where
    a signed x is not 0 (jnp's floor correction): -1 for 0, -2 otherwise, and the
    largest value for an unsigned type."""
    zero = b == 0
    value = operation(a, torch.where(zero, torch.ones_like(b), b), **kw)
    if operation is torch.fmod and bools:
        special = a
    elif operation is not torch.floor_divide:
        special = torch.zeros((), dtype=value.dtype, device=value.device)
    elif value.dtype == torch.uint8:
        special = torch.full((), 255, dtype=value.dtype, device=value.device)
    else:
        special = torch.where(a == 0, -1, -2).to(value.dtype)
    return torch.where(zero, special, value)


def _profiled_dispatch(family: str):
    """Wrap a dispatch wrapper in a profiler ``dispatch`` slice so every
    framework-level op attributes to the ambient request scope. Idle cost: one
    module-attribute read."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(operation, *args, **kwargs):
            if not profiler._active:
                return fn(operation, *args, **kwargs)
            name = operation if isinstance(operation, str) else _executor._op_label(operation)
            with profiler.scope("dispatch", f"{family}:{name}"):
                return fn(operation, *args, **kwargs)

        return wrapped

    return deco


class _BinaryKernel:
    """One binary operation at one (compute, result) type pair: the local compute of
    :func:`binary_op` that its eager path, its staged programs and its deferred
    nodes all run. Tensor operands are cast to the compute type; a scalar is filled
    into a 0-d tensor of the compute type on the operand's device (no copy from the
    host: some torch functions take no Python number or CPU scalar, and CUDA
    divides by a CPU scalar as a product with its reciprocal, which rounds
    otherwise). ``compute_dtype`` also tells a captured CUDA graph which dtype each
    scalar's static buffer needs."""

    __slots__ = ("operation", "compute_dtype", "result_dtype", "by_zero", "bools", "__name__")

    def __init__(self, operation, compute_dtype, result_dtype, by_zero, bools):
        self.operation = operation
        self.compute_dtype = compute_dtype
        self.result_dtype = result_dtype
        self.by_zero = by_zero
        self.bools = bools
        self.__name__ = _executor._op_label(operation)

    def __call__(self, a, b, **kw):
        ct = self.compute_dtype
        device = b.device if type(a) in _executor._PY_SCALAR_TYPES or not isinstance(a, torch.Tensor) else a.device
        a = _as_compute(a, ct, device)
        b = _as_compute(b, ct, device)
        if self.by_zero:
            value = _by_zero_as_xla(self.operation, a, b, self.bools, **kw)
        else:
            value = self.operation(a, b, **kw)
        return value.to(self.result_dtype)


def _as_compute(t, ct, device):
    if type(t) not in _executor._PY_SCALAR_TYPES and isinstance(t, torch.Tensor):
        return t.to(ct)
    return torch.full((), t.item() if isinstance(t, np.generic) else t, dtype=ct, device=device)


class _LocalKernel:
    """One elementwise operation, with the input cast to ``cast`` first (the float
    type heat_tpu's transcendental functions compute an exact input in) or not."""

    __slots__ = ("operation", "cast", "__name__")

    def __init__(self, operation, cast):
        self.operation = operation
        self.cast = cast
        self.__name__ = _executor._op_label(operation)

    def __call__(self, x, **kw):
        return self.operation(x if self.cast is None else x.to(self.cast), **kw)


# canonical kernel objects: the executor keys programs on their identity
_KERNELS: dict = {}
_KERNELS_LOCK = threading.Lock()
_MAX_KERNELS = 4096


def _kernel(cls, *args):
    key = (cls,) + args
    try:
        k = _KERNELS.get(key)
    except TypeError:  # an unhashable operation: a kernel of its own each call
        return cls(*args)
    if k is None:
        with _KERNELS_LOCK:
            k = _KERNELS.get(key)
            if k is None:
                if len(_KERNELS) >= _MAX_KERNELS:
                    for stale in list(_KERNELS)[: _MAX_KERNELS // 2]:
                        del _KERNELS[stale]
                k = _KERNELS[key] = cls(*args)
    return k


# heat_tpu's ``jax.numpy`` name of each operation the port dispatches through the
# wrappers above: (jnp name, port module, the module's public function, the operation
# the function hands to binary_op/local_op, ``torch.<name>`` or a module attribute).
# The replay specs of the compile cache name operations by their jnp names, so a
# manifest written by either package replays in the other; :func:`jnp_name` maps a
# kernel to its name and :func:`resolve_jnp` a name to the public function that
# dispatches it. An operation outside the table has no spec (a counted warmup gap).
JNP_OPS = (
    ("add", "arithmetics", "add", "torch.add"),
    ("subtract", "arithmetics", "sub", "torch.sub"),
    ("multiply", "arithmetics", "mul", "torch.mul"),
    ("true_divide", "arithmetics", "div", "torch.true_divide"),
    ("floor_divide", "arithmetics", "floordiv", "torch.floor_divide"),
    ("mod", "arithmetics", "mod", "torch.remainder"),
    ("fmod", "arithmetics", "fmod", "torch.fmod"),
    ("power", "arithmetics", "pow", "torch.pow"),
    ("copysign", "arithmetics", "copysign", "torch.copysign"),
    ("hypot", "arithmetics", "hypot", "torch.hypot"),
    ("bitwise_and", "arithmetics", "bitwise_and", "torch.bitwise_and"),
    ("bitwise_or", "arithmetics", "bitwise_or", "torch.bitwise_or"),
    ("bitwise_xor", "arithmetics", "bitwise_xor", "torch.bitwise_xor"),
    ("bitwise_not", "arithmetics", "bitwise_not", "torch.bitwise_not"),
    ("left_shift", "arithmetics", "left_shift", "torch.bitwise_left_shift"),
    ("right_shift", "arithmetics", "right_shift", "torch.bitwise_right_shift"),
    ("negative", "arithmetics", "neg", "torch.neg"),
    ("exp", "exponential", "exp", "torch.exp"),
    ("exp2", "exponential", "exp2", "torch.exp2"),
    ("expm1", "exponential", "expm1", "torch.expm1"),
    ("log", "exponential", "log", "torch.log"),
    ("log2", "exponential", "log2", "torch.log2"),
    ("log10", "exponential", "log10", "torch.log10"),
    ("log1p", "exponential", "log1p", "torch.log1p"),
    ("logaddexp", "exponential", "logaddexp", "torch.logaddexp"),
    ("logaddexp2", "exponential", "logaddexp2", "torch.logaddexp2"),
    ("sqrt", "exponential", "sqrt", "torch.sqrt"),
    ("square", "exponential", "square", "_square"),
    ("sin", "trigonometrics", "sin", "torch.sin"),
    ("cos", "trigonometrics", "cos", "torch.cos"),
    ("tan", "trigonometrics", "tan", "torch.tan"),
    ("sinh", "trigonometrics", "sinh", "torch.sinh"),
    ("cosh", "trigonometrics", "cosh", "torch.cosh"),
    ("tanh", "trigonometrics", "tanh", "torch.tanh"),
    ("arcsin", "trigonometrics", "arcsin", "torch.asin"),
    ("arccos", "trigonometrics", "arccos", "torch.acos"),
    ("arctan", "trigonometrics", "arctan", "torch.atan"),
    ("arcsinh", "trigonometrics", "arcsinh", "torch.asinh"),
    ("arccosh", "trigonometrics", "arccosh", "torch.acosh"),
    ("arctanh", "trigonometrics", "arctanh", "torch.atanh"),
    ("arctan2", "trigonometrics", "arctan2", "torch.atan2"),
    ("deg2rad", "trigonometrics", "deg2rad", "torch.deg2rad"),
    ("rad2deg", "trigonometrics", "rad2deg", "torch.rad2deg"),
    ("abs", "rounding", "abs", "_abs_any"),
    ("fabs", "rounding", "fabs", "torch.abs"),
    ("ceil", "rounding", "ceil", "_ceil"),
    ("floor", "rounding", "floor", "_floor"),
    ("trunc", "rounding", "trunc", "_trunc"),
    ("equal", "relational", "eq", "torch.eq"),
    ("not_equal", "relational", "ne", "torch.ne"),
    ("less", "relational", "lt", "torch.lt"),
    ("less_equal", "relational", "le", "torch.le"),
    ("greater", "relational", "gt", "torch.gt"),
    ("greater_equal", "relational", "ge", "torch.ge"),
    ("logical_and", "logical", "logical_and", "torch.logical_and"),
    ("logical_or", "logical", "logical_or", "torch.logical_or"),
    ("logical_xor", "logical", "logical_xor", "torch.logical_xor"),
    ("logical_not", "logical", "logical_not", "torch.logical_not"),
    ("isfinite", "logical", "isfinite", "torch.isfinite"),
    ("isinf", "logical", "isinf", "torch.isinf"),
    ("isnan", "logical", "isnan", "torch.isnan"),
)
_JNP_BY_OP: Optional[dict] = None
_CUM_JNP = {"sum": "cumsum", "prod": "cumprod"}


def _jnp_by_op() -> dict:
    global _JNP_BY_OP
    if _JNP_BY_OP is None:
        import importlib

        table = {}
        for name, module, _fn, op in JNP_OPS:
            if op.startswith("torch."):
                table[getattr(torch, op[len("torch."):])] = name
            else:
                table[getattr(importlib.import_module(f"{__package__}.{module}"), op)] = name
        _JNP_BY_OP = table
    return _JNP_BY_OP


def jnp_name(kernel) -> Optional[str]:
    """heat_tpu's ``jax.numpy`` name of a binary or local kernel's operation, or None."""
    return _jnp_by_op().get(getattr(kernel, "operation", None))


def resolve_jnp(name: str) -> Callable:
    """The port's public function that dispatches heat_tpu's ``jax.numpy`` ``name``
    (``KeyError`` for a name outside :data:`JNP_OPS`)."""
    import importlib

    for jname, module, fn, _op in JNP_OPS:
        if jname == name:
            return getattr(importlib.import_module(f"{__package__}.{module}"), fn)
    raise KeyError(name)


_staged_only = threading.local()


@contextlib.contextmanager
def staged_only():
    """Within the block, binary and local ops skip the deferred graph and take their
    staged one-op programs (the compile cache's replay of a recorded ``l`` spec)."""
    prev = getattr(_staged_only, "on", False)
    _staged_only.on = True
    try:
        yield
    finally:
        _staged_only.on = prev


def _np_dtype_str(dtype: torch.dtype) -> Optional[str]:
    """numpy's ``dtype.str`` of a torch dtype (None for bfloat16, which numpy lacks)."""
    try:
        return torch.empty((), dtype=dtype).numpy().dtype.str
    except (TypeError, RuntimeError):
        return None


def mesh_spec(comm) -> dict:
    """heat_tpu's mesh description of a communicator: one axis ``d`` of ``size``
    devices, or the ``(dcn, ici)`` mesh of a hierarchical one."""
    if comm.is_hierarchical:
        return {"shape": [comm.n_nodes, comm.node_size], "axes": ["dcn", "ici"]}
    return {"shape": [comm.size], "axes": ["d"]}


def _staged_spec(family, name, fn_kwargs, value, gshape, split, comm, **extra):
    """The JSON-able replay description of one staged ``l``/``r``/``c`` signature,
    heat_tpu's dict for the same signature (heat_tpu/core/_operations.py:83): the jnp
    name, kwargs, global shape, split, input dtype, physical shape and mesh. The port
    pads nothing, so its physical shape is the global one: a spec recorded on a ragged
    heat_tpu layout names another physical shape, and replays as skipped. None when
    the operation has no jnp name or the kwargs do not survive JSON; raises (a
    counted warmup-spec gap) when ``extra`` is not JSON-able."""
    if name is None:
        return None
    if fn_kwargs and json.loads(json.dumps(fn_kwargs)) != fn_kwargs:
        return None
    if extra:
        json.dumps(extra)
    dt = _np_dtype_str(value.dtype)
    if dt is None:
        return None
    spec = {
        "family": family, "op": name,
        "kwargs": dict(fn_kwargs) if fn_kwargs else {},
        "gshape": list(gshape), "split": split,
        "dtype": dt, "phys": list(gshape),
        "mesh": mesh_spec(comm),
    }
    spec.update(extra)
    return spec


# (operand type keys, operation) -> (compute type, result type, kernel): binary_op's
# type rules and its kernel, resolved once per pair of operand types
_BINARY_PLANS: dict = {}


def _type_key(t):
    """What binary_op's type rules read of an operand: a DNDarray's dtype, a Python
    scalar's type (weakly typed), a numpy scalar's dtype (strongly typed)."""
    if isinstance(t, DNDarray):
        return t.dtype
    if isinstance(t, np.generic):
        return t.dtype
    return type(t)


def _binary_plan(t1, t2, operation):
    """(compute type, result type, kernel) of ``operation(t1, t2)``, cached by the
    operands' type keys."""
    key = (_type_key(t1), _type_key(t2), operation)
    try:
        hit = _BINARY_PLANS.get(key)
    except TypeError:  # an unhashable operation
        hit, key = None, None
    if hit is not None:
        return hit
    compute, result = _binary_types(t1, t2, operation)
    by_zero = operation in _INT_DIVISIONS and types.heat_type_is_exact(compute)
    bools = by_zero and all(
        isinstance(t, builtins.bool) or (not _is_weak(t) and _strong_type(t) is types.bool) for t in (t1, t2)
    )
    hit = (compute, result, _kernel(_BinaryKernel, operation, compute.torch_type(), result.torch_type(), by_zero, bools))
    if key is not None:
        with _KERNELS_LOCK:
            if len(_BINARY_PLANS) >= _MAX_KERNELS:
                for stale in list(_BINARY_PLANS)[: _MAX_KERNELS // 2]:
                    del _BINARY_PLANS[stale]
            _BINARY_PLANS[key] = hit
    return hit


def _is_complexish(*ts) -> bool:
    for t in ts:
        if isinstance(t, DNDarray) and issubclass(t.dtype, types.complexfloating):
            return True
        if isinstance(t, complex) and not isinstance(t, bool):
            return True
    return False


def _is_weak(x) -> bool:
    """Python scalars are weakly typed (numpy scalars are not)."""
    return isinstance(x, _PY_SCALARS) and not isinstance(x, np.generic)


def _strong_type(x):
    if isinstance(x, DNDarray):
        return x.dtype
    return types.canonical_heat_type(getattr(x, "dtype", None) or np.asarray(x).dtype)


def _weak_promote(strong, weak) -> type:
    """JAX's promotion of a strongly typed operand with a Python scalar (x64 on)."""
    if isinstance(weak, builtins.bool):
        return strong
    if isinstance(weak, builtins.int):
        return types.int64 if strong is types.bool else strong
    if isinstance(weak, builtins.float):
        return types.float64 if types.heat_type_is_exact(strong) else strong
    if issubclass(strong, types.complexfloating):
        return strong
    return types.complex64 if strong in (types.float16, types.bfloat16, types.float32) else types.complex128


def _inexact(t) -> type:
    """The float type an exact type turns into under true division / mean."""
    if types.heat_type_is_inexact(t):
        return t
    return types.float64 if t is types.int64 else types.float32


def _binary_types(t1, t2, operation) -> Tuple[type, type]:
    """(compute type, result type) of ``operation(t1, t2)``; at most one operand is a
    Python scalar."""
    if _is_weak(t1):
        compute = _weak_promote(_strong_type(t2), t1)
    elif _is_weak(t2):
        compute = _weak_promote(_strong_type(t1), t2)
    else:
        compute = types.promote_types(_strong_type(t1), _strong_type(t2))
    if operation in _FLOAT_RESULTS:
        compute = _inexact(compute)
    if operation in _INT_FROM_BOOL and compute is types.bool:
        compute = types.int32  # jnp divides, takes remainders of and shifts bools in int32
    if operation is torch.pow and not _is_weak(t1) and _strong_type(t1) is types.bool:
        # jnp.power raises a bool base to a bool or Python-int exponent in int32
        if compute in (types.bool, types.int64) and (_is_weak(t2) or _strong_type(t2) is types.bool):
            compute = types.int32
    if operation in _COMPARISONS:
        return compute, types.bool
    return compute, compute


def wrap_result(
    value: torch.Tensor, proto: DNDarray, split: Optional[int], gshape: Optional[Sequence[int]] = None
) -> DNDarray:
    """Wrap this rank's local ``value`` in a DNDarray with ``proto``'s device/comm.
    ``gshape`` is the global shape; it may be left out when the value is whole on
    every rank (``split`` None or a single rank). An out-of-range split becomes None."""
    if split is not None and (value.ndim == 0 or split >= value.ndim or split < 0):
        split = None
    if gshape is None:
        if split is not None and proto.comm.size > 1:
            raise ValueError("wrap_result needs the global shape of a distributed result")
        gshape = tuple(value.shape)
    return DNDarray(
        value, tuple(gshape), types.canonical_heat_type(value.dtype), split, proto.device, proto.comm, True
    )


def wrap_global(value: torch.Tensor, proto: DNDarray, split: Optional[int]) -> DNDarray:
    """A DNDarray of the global ``value``, whole on every rank, keeping this rank's chunk
    along ``split`` (an out-of-range split becomes None)."""
    if split is not None and (value.ndim == 0 or split >= value.ndim or split < 0):
        split = None
    gshape = tuple(value.shape)
    if split is not None:
        _, _, slices = proto.comm.chunk(gshape, split)
        value = value[slices].contiguous()
    return DNDarray(value, gshape, types.canonical_heat_type(value.dtype), split, proto.device, proto.comm, True)


def rebalance(local: torch.Tensor, axis: int, proto: DNDarray, src_displs=None) -> DNDarray:
    """Pieces the ranks hold along ``axis`` (in rank order, or from ``src_displs``) as a
    split array with the canonical chunks: one all-gather of the counts and one
    ``TorchCommunication.redistribute``."""
    comm = proto.comm
    counts = comm.all_gather_counts(local.shape[axis], local.device)
    gshape = list(local.shape)
    gshape[axis] = sum(counts)
    dst = comm.counts_displs_shape(gshape, axis)[0]
    moved = comm.redistribute(local, gshape, axis, counts, dst, src_displs=src_displs)
    return DNDarray(moved, tuple(gshape), types.canonical_heat_type(moved.dtype), axis, proto.device, comm, True)


def handle_out(res: DNDarray, out: Optional[DNDarray]) -> DNDarray:
    """Write ``res`` into a user-provided ``out`` buffer, casting to its dtype."""
    if out is None:
        return res
    sanitation.sanitize_out(out, res.gshape, res.split)
    out.larray = res.larray.to(out.dtype.torch_type())
    return out


def _out_split_binary(out_shape: Tuple[int, ...], *operands) -> Optional[int]:
    """Dominant-operand split rule (heat_tpu/core/_operations.py:250): a split operand
    beats an unsplit one; a split on a non-broadcast dim beats a split on a broadcast dim;
    the first operand beats the second."""
    nd = len(out_shape)
    best = None
    for arr in operands:
        if not isinstance(arr, DNDarray) or arr.split is None:
            continue
        s = arr.split + (nd - arr.ndim)
        broadcasted = arr.gshape[arr.split] == 1 and out_shape[s] != 1
        if not broadcasted:
            return s
        if best is None:
            best = s
    return best


def _local_operand(arr: DNDarray, out_shape: Tuple[int, ...], out_split: Optional[int]) -> torch.Tensor:
    """``arr``'s local tensor laid out like the output: chunked along the output's
    split where ``arr`` spans it, whole where it broadcasts against it."""
    if out_split is None:
        return arr._relayout(None)
    d = out_split - (len(out_shape) - arr.ndim)
    if d < 0 or (arr.gshape[d] == 1 and out_shape[out_split] != 1):
        return arr._relayout(None)
    return arr._relayout(d)


@_profiled_dispatch("binary")
def binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Apply a binary torch operation with Heat's split/type semantics."""
    fn_kwargs = fn_kwargs or {}
    both_scalars = not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray) and np.isscalar(t1) and np.isscalar(t2)
    if both_scalars:
        # two Python scalars compute at numpy's (x64) types: int → int64, float → float64
        t1 = factories.array(np.asarray(t1))
    proto = next((t for t in (t1, t2) if isinstance(t, DNDarray)), None)
    kw = {} if proto is None else {"device": proto.device, "comm": proto.comm}
    t1, t2 = (t if isinstance(t, DNDarray) or np.isscalar(t) else factories.array(t, **kw) for t in (t1, t2))
    if proto is None:
        proto = next(t for t in (t1, t2) if isinstance(t, DNDarray))

    compute, result, kernel = _binary_plan(t1, t2, operation)
    staged = not both_scalars and _executor.executor_enabled() and not _is_complexish(t1, t2)
    if staged and out is None and where is None and not getattr(_staged_only, "on", False):
        # fused deferral first: the aligned elementwise case grows the graph
        res = _binary_defer(kernel, t1, t2, fn_kwargs)
        if res is not NotImplemented:
            return res

    shapes = [t.gshape for t in (t1, t2) if isinstance(t, DNDarray)]
    out_shape = broadcast_shapes(*shapes)
    out_split = _out_split_binary(out_shape, t1, t2)
    a, b = (_local_operand(t, out_shape, out_split) if isinstance(t, DNDarray) else t for t in (t1, t2))
    leaves = [a, b]
    if where is not None:
        w = where if isinstance(where, DNDarray) else factories.array(where, device=proto.device, comm=proto.comm)
        leaves.append(_local_operand(w, out_shape, out_split))
    if out_split is not None and out_split >= len(out_shape):
        out_split = None
    out_dtype = None
    if out is not None:
        sanitation.sanitize_out(out, out_shape, out_split)
        out_dtype = out.dtype.torch_type()
    compute_fn = functools.partial(_binary_compute, kernel, fn_kwargs, where is not None, out_dtype)
    if staged:
        value = _binary_jit(kernel, compute_fn, leaves, out, fn_kwargs, out_shape, out_split, where is not None)
        if isinstance(value, DNDarray):
            return value
        if value is not NotImplemented:
            return DNDarray(value, out_shape, result, out_split, proto.device, proto.comm, True)
    value = compute_fn(*leaves, *(() if out is None else (out.larray,)))
    if out is not None:
        out.larray = value
        return out
    return DNDarray(value, out_shape, result, out_split, proto.device, proto.comm, True)


def _binary_compute(kernel, fn_kwargs, has_where, out_dtype, a, b, *rest):
    """binary_op's local compute: the kernel, then numpy's ``where`` rule (where it
    is False the result keeps ``out``'s value, or 0), then the cast to ``out``'s
    dtype. ``rest`` is (where,) / (where, out) / (out,)."""
    value = kernel(a, b, **fn_kwargs)
    if has_where:
        w = rest[0].to(torch.bool)
        if out_dtype is not None:
            base = rest[1].to(value.dtype)
        else:
            base = torch.zeros((), dtype=value.dtype, device=value.device)
        value = torch.where(w, value, base)
    if out_dtype is not None:
        value = value.to(out_dtype)
    return value


def _binary_defer(kernel, t1, t2, fn_kwargs):
    """Append a binary op to the executor's expression graph; NotImplemented when
    the operands are not one aligned ``(gshape, split, comm)`` family."""
    proto = None
    raw = []
    for t in (t1, t2):
        if isinstance(t, DNDarray):
            if proto is None:
                proto = t
            elif t.gshape != proto.gshape or t.split != proto.split or t.comm is not proto.comm:
                return NotImplemented
            payload = t._payload
            raw.append(("d" if isinstance(payload, Deferred) else "a", payload))
        elif np.isscalar(t):
            raw.append(("s", t))
        else:
            return NotImplemented
    node = _executor.defer_node(kernel, fn_kwargs, raw, proto.gshape, proto.split, proto.comm)
    if node is _executor.UNSUPPORTED:
        return NotImplemented
    res = DNDarray(node, proto.gshape, types.canonical_heat_type(node.dtype), proto.split, proto.device, proto.comm, True)
    # liveness registry: while this DNDarray lives, a program that executes the
    # node must emit (memoise) its value
    _executor.note_wrapped(node, res)
    return res


def _binary_jit(kernel, compute_fn, leaves, out, fn_kwargs, out_shape, out_split, has_where):
    """Run binary_op's compute as a cached ``b.log`` program; with ``out`` the
    program takes out's tensor as its trailing argument and may write the result
    into its storage (``sanitation.sanitize_donation``). Returns the result
    tensor, ``out``, or NotImplemented (the eager path)."""
    kwsig = _executor.kwargs_sig(fn_kwargs)
    if kwsig is _executor.UNSUPPORTED:
        return NotImplemented
    has_out = out is not None
    key = (
        "b.log", kernel, kwsig, tuple(out_shape), out_split, _executor._first_device(leaves),
        tuple(operand_sig(v) for v in leaves[:2]),
        operand_sig(leaves[2]) if has_where else None,
        (out.larray.dtype, tuple(out.larray.shape)) if has_out else None,
    )

    def build():
        return compute_fn, (len(leaves) if has_out else None), "staged", {}

    prog = _executor.lookup(key, build, label=f"b.log:{kernel.__name__}")
    if prog is None:
        return NotImplemented
    try:
        if has_out:
            donate = sanitation.sanitize_donation(out, leaves)
            if donate and _result_cache._enabled:
                _result_cache.note_donation((id(out.larray),))
            out.larray = prog(*leaves, out.larray, donate=donate)
            return out
        return prog(*leaves)
    except Exception as exc:
        if not _executor.fallback_after_failure(key, prog, exc):
            raise
        return NotImplemented


def _staged(key, label, compute, value, out, out_shape, out_split, collective, spec=None):
    """Run ``compute(value)`` as a cached one-op program (the ``l``/``r``/``c``
    families). With ``out`` the program also casts to out's dtype and takes out's
    tensor as a trailing argument it may write into. A program that issues a
    collective runs inline on this thread; the others go through
    ``_executor.call_staged`` (batched with concurrent same-signature calls).
    ``spec`` is the lazy replay description (:func:`_staged_spec`) of the call
    without ``out``. Returns the result tensor, ``out``, or NotImplemented (the
    eager path)."""
    has_out = out is not None
    out_dtype = out.dtype.torch_type() if has_out else None
    key = key + (out_dtype,)

    def build():
        opts = {"collective": collective}
        if has_out:
            return functools.partial(_cast_out, compute, out_dtype), 1, "staged", opts
        return compute, None, "staged", opts

    prog = _executor.lookup(key, build, label=label, spec=None if has_out else spec)
    if prog is None:
        return NotImplemented
    try:
        if has_out:
            sanitation.sanitize_out(out, out_shape, out_split)
            donate = sanitation.sanitize_donation(out, [value])
            if donate and _result_cache._enabled:
                _result_cache.note_donation((id(out.larray),))
            out.larray = prog(value, out.larray, donate=donate)
            return out
        if collective:
            return prog(value)
        return _executor.call_staged(key, prog, value)
    except Exception as exc:
        if not _executor.fallback_after_failure(key, prog, exc):
            raise
        return NotImplemented


def _cast_out(compute, out_dtype, value, out_buf):
    return compute(value).to(out_dtype)


@_profiled_dispatch("local")
def local_op(
    operation: Callable, x: DNDarray, out: Optional[DNDarray] = None, no_cast: bool = True, **fn_kwargs
) -> DNDarray:
    """Elementwise operation on the local tensor, no communication. With ``no_cast``
    False an exact input is first cast to the float type heat_tpu's function returns
    for it (float32; float64 from int64), as jnp's transcendental functions do."""
    sanitation.sanitize_in(x)
    kernel = _kernel(_LocalKernel, operation, None if no_cast else _inexact(x.dtype).torch_type())
    if _executor.executor_enabled() and not _is_complexish(x):
        if out is None and not getattr(_staged_only, "on", False):
            res = _local_defer(kernel, x, fn_kwargs)
            if res is not NotImplemented:
                return res
        kwsig = _executor.kwargs_sig(fn_kwargs)
        if kwsig is not _executor.UNSUPPORTED:
            value = x.larray
            key = ("l", kernel, kwsig, operand_sig(value), x.gshape, x.split, value.device)
            res = _staged(key, f"l:{kernel.__name__}", functools.partial(kernel, **fn_kwargs), value,
                          out, x.gshape, x.split, False,
                          spec=lambda: _staged_spec("l", jnp_name(kernel), fn_kwargs, value, x.gshape,
                                                    x.split, x.comm))
            if isinstance(res, DNDarray):
                return res
            if res is not NotImplemented:
                return DNDarray(res, x.gshape, types.canonical_heat_type(res.dtype), x.split, x.device, x.comm,
                                x.balanced)
    value = kernel(x.larray, **fn_kwargs)
    res = DNDarray(
        value, x.gshape, types.canonical_heat_type(value.dtype), x.split, x.device, x.comm, x.balanced
    )
    return handle_out(res, out)


def _local_defer(kernel, x, fn_kwargs):
    """Append an elementwise op to the expression graph; NotImplemented → staged."""
    payload = x._payload
    node = _executor.defer_node(
        kernel, fn_kwargs, [("d" if isinstance(payload, Deferred) else "a", payload)], x.gshape, x.split, x.comm
    )
    if node is _executor.UNSUPPORTED:
        return NotImplemented
    res = DNDarray(node, x.gshape, types.canonical_heat_type(node.dtype), x.split, x.device, x.comm, x.balanced)
    _executor.note_wrapped(node, res)
    return res


def _out_split_reduce(
    x: DNDarray, axis: Optional[Union[int, Tuple[int, ...]]], keepdims: bool
) -> Optional[int]:
    """Split bookkeeping for reductions (heat_tpu/core/_operations.py:1039)."""
    if x.split is None:
        return None
    if axis is None:
        return None
    axes = axis if isinstance(axis, tuple) else (axis,)
    if x.split in axes:
        return None
    if keepdims:
        return x.split
    return x.split - builtins.sum(1 for ax in axes if ax < x.split)


# the identity element each reduction fills an empty local chunk with
# (heat_tpu/core/_operations.py:1055-1081), and the all_reduce that merges ranks
_REDUCTIONS = {
    "sum": ("zero", "sum"),
    "prod": ("one", "prod"),
    "nansum": ("zero", "sum"),
    "nanprod": ("one", "prod"),
    "mean": ("zero", "sum"),
    "min": ("highest", "min"),
    "max": ("lowest", "max"),
    "all": ("highest", "min"),
    "any": ("lowest", "max"),
}


def _neutral(kind: str, dtype: torch.dtype):
    if kind == "zero":
        return 0
    if kind == "one":
        return 1
    if dtype == torch.bool:
        return kind == "highest"
    if not dtype.is_floating_point and not dtype.is_complex:
        info = torch.iinfo(dtype)
        return info.max if kind == "highest" else info.min
    inf = float("inf") if kind == "highest" else float("-inf")
    return complex(inf, inf) if dtype.is_complex else inf  # both parts: last in either order


def _reduce_type(kind: str, t) -> type:
    """heat_tpu's result type: sum/prod accumulate small exact types in int64, mean
    turns exact types into floats, min/max keep the type."""
    if kind in ("all", "any"):
        return types.bool
    if kind in ("sum", "prod", "nansum", "nanprod") and types.heat_type_is_exact(t):
        return types.int64
    if kind == "mean":
        return _inexact(t)
    return t


def _local_reduce(kind: str, value: torch.Tensor, axes: Tuple[int, ...], keepdims: bool) -> torch.Tensor:
    if kind.startswith("nan"):
        if value.is_floating_point() or value.is_complex():
            value = torch.where(torch.isnan(value), _neutral(_REDUCTIONS[kind][0], value.dtype), value)
        kind = kind[3:]
    if kind == "all":
        return torch.all(value, dim=axes, keepdim=keepdims)
    if kind == "any":
        return torch.any(value, dim=axes, keepdim=keepdims)
    if kind in ("sum", "mean"):
        return torch.sum(value, dim=axes, keepdim=keepdims)
    if kind in ("min", "max") and value.is_complex():
        return _complex_extreme(kind, value, axes, keepdims)
    if kind == "min":
        return torch.amin(value, dim=axes, keepdim=keepdims)
    if kind == "max":
        return torch.amax(value, dim=axes, keepdim=keepdims)
    for ax in sorted(axes, reverse=True):  # torch.prod takes one dim at a time
        value = torch.prod(value, dim=ax, keepdim=keepdims)
    return value


def _complex_extreme(kind: str, value: torch.Tensor, axes: Tuple[int, ...], keepdims: bool) -> torch.Tensor:
    """min or max of complex ``value`` over ``axes`` in (real, imaginary) order
    (:mod:`._complex_order`): the axes moved last and flattened, the first extreme taken."""
    rest = [d for d in range(value.ndim) if d not in axes]
    moved = value.permute(*rest, *axes).reshape([value.shape[d] for d in rest] + [-1])
    result = _complex_order.extreme(moved, -1, kind)[0].squeeze(-1)
    if keepdims:
        result = result.reshape([1 if d in axes else s for d, s in enumerate(value.shape)])
    return result


@_profiled_dispatch("reduce")
def reduce_op(
    kind: str,
    x: DNDarray,
    axis: Optional[Union[int, Sequence[int]]] = None,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
) -> DNDarray:
    """Reduce ``x`` (``kind``: sum, prod, nansum, nanprod, mean, min, max, all, any) over
    ``axis``.

    Over the split axis this is a local reduction followed by one ``all_reduce``; an
    empty local chunk contributes the reduction's identity element. A floating min or
    max takes a second ``all_reduce`` of its NaN flags, so a NaN on any rank gives NaN
    where it lies, as numpy does."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    out_split = _out_split_reduce(x, axis, keepdims)
    axes = tuple(range(x.ndim)) if axis is None else (axis if isinstance(axis, tuple) else (axis,))
    rtype = _reduce_type(kind, x.dtype)
    crosses = x.is_distributed() and x.split in axes
    if keepdims:
        gshape = tuple(1 if i in axes else s for i, s in enumerate(x.gshape))
    else:
        gshape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    if out_split is not None and out_split >= len(gshape):
        out_split = None
    count = int(np.prod([x.gshape[a] for a in axes])) if kind == "mean" else None
    compute = functools.partial(
        _reduce_compute, kind, axes, keepdims, rtype.torch_type(), x.split if crosses else None,
        x.comm if crosses else None, x.ndim == 0, count,
    )
    value = x.larray
    if _executor.executor_enabled() and not _is_complexish(x):
        key = ("r", kind, operand_sig(value), x.gshape, x.split, axis, keepdims, value.device,
               x.comm if crosses else None)
        res = _staged(key, f"r:{kind}", compute, value, out, gshape, out_split, crosses,
                      spec=lambda: _staged_spec("r", kind, {}, value, x.gshape, x.split, x.comm,
                                                axis=axis, keepdims=keepdims, out_split=out_split))
        if isinstance(res, DNDarray):
            return res
        if res is not NotImplemented:
            return DNDarray(res, gshape, rtype, out_split, x.device, x.comm, True)
    res = DNDarray(compute(value), gshape, rtype, out_split, x.device, x.comm, True)
    return handle_out(res, out)


def _reduce_compute(kind, axes, keepdims, rt, split, comm, scalar, count, value):
    """reduce_op's compute on this rank's tensor. ``split``/``comm`` are set when the
    reduction crosses the split axis of a distributed array: the identity element
    stands in for an empty chunk, and the ranks' partials merge by ``all_reduce``."""
    neutral_kind, merge = _REDUCTIONS[kind]
    # jnp sums float16 and bfloat16 in float32 and rounds once, also across devices: the
    # ranks' partials stay float32 until the merge is done
    half = kind in ("sum", "nansum", "mean") and rt in (torch.float16, torch.bfloat16)
    value = value.to(torch.float32 if half else rt)
    if comm is not None and value.shape[split] == 0:
        shape = list(value.shape)
        shape[split] = 1
        value = torch.full(shape, _neutral(neutral_kind, value.dtype), dtype=value.dtype, device=value.device)
    if scalar:
        result = value.clone()
    else:
        result = _local_reduce(kind, value, axes, keepdims)
    if comm is not None:
        # neither gloo nor NCCL promises that MIN/MAX propagate NaN: a rank's NaN is
        # carried across by a flag of its own and written back after the merge
        nan = torch.isnan(result) if kind in ("min", "max") and result.is_floating_point() else None
        if kind in ("min", "max") and result.is_complex():
            result = comm.all_reduce_lexicographic(result, kind)
        else:
            comm.all_reduce(result, merge)
        if nan is not None:
            result.masked_fill_(comm.all_reduce(nan, "max"), float("nan"))
    if kind == "mean":
        result = result / count
    return result.to(rt) if half else result


@_profiled_dispatch("cum")
def cum_op(kind: str, x: DNDarray, axis: int, out: Optional[DNDarray] = None, dtype=None) -> DNDarray:
    """Cumulative sum or product (``kind``) along ``axis`` (heat_tpu/core/_operations.py:1200).
    Along the split axis it is the local scan followed by an exclusive scan of the
    ranks' totals: one all-gather of P values, each rank combining the totals of the
    ranks before it into its chunk. ``dtype`` is the accumulator and result type
    (default: the input's, bool accumulating in int64)."""
    sanitation.sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if axis is None:
        raise NotImplementedError("cumulative operations require an explicit axis")
    if dtype is not None:
        target = types.canonical_heat_type(dtype)
    else:
        target = types.int64 if x.dtype is types.bool else x.dtype
    ct = target.torch_type()
    collective = x.is_distributed() and axis == x.split
    compute = functools.partial(_cum_compute, kind, axis, ct, x.comm if collective else None)
    value = x.larray
    if _executor.executor_enabled() and not _is_complexish(x):
        name = "cumsum" if kind == "sum" else "cumprod"
        key = ("c", name, operand_sig(value), x.gshape, x.split, axis, ct, value.device,
               x.comm if collective else None)
        res = _staged(key, f"c:{name}", compute, value, out, x.gshape, x.split, collective,
                      spec=lambda: _staged_spec("c", name, {}, value, x.gshape, x.split, x.comm, axis=axis,
                                                target=None if dtype is None else _np_dtype_str(ct)))
        if isinstance(res, DNDarray):
            return res
        if res is not NotImplemented:
            return DNDarray(res, x.gshape, target, x.split, x.device, x.comm, True)
    res = DNDarray(compute(value), x.gshape, target, x.split, x.device, x.comm, True)
    return handle_out(res, out)


def _cum_compute(kind, axis, ct, comm, value):
    """cum_op's compute on this rank's tensor; ``comm`` is set for a scan along the
    split axis of a distributed array (the ranks' totals, one all-gather)."""
    value = value.to(ct)
    scan = torch.cumsum if kind == "sum" else torch.cumprod
    result = scan(value, dim=axis, dtype=ct) if value.ndim else value.clone()
    if comm is not None:
        shape = list(result.shape)
        shape[axis] = 1
        neutral = 0 if kind == "sum" else 1
        total = result.narrow(axis, result.shape[axis] - 1, 1) if result.shape[axis] else result.new_full(shape, neutral)
        totals = comm.all_gather_stacked(total)[: comm.rank]
        if totals.shape[0]:
            carry = totals.sum(0, dtype=ct) if kind == "sum" else totals.prod(0, dtype=ct)
            result = result + carry if kind == "sum" else result * carry
    return result.to(ct)
