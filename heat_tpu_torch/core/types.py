"""Type system: Heat's datatype class hierarchy over torch dtypes.

Counterpart of heat_tpu/core/types.py. Each concrete class knows its backend dtype through
``torch_type()`` (heat_tpu's ``jax_type()``). The promotion lattice is the one heat_tpu
gets from JAX with x64 enabled; ``torch.promote_types`` agrees with it on every pair of the
twelve types below, which ``tests/test_torch_core.py`` checks.
"""

from __future__ import annotations

import builtins
from typing import Any, Type

import numpy as np
import torch

__all__ = [
    "iscomplex",
    "isreal",
    "datatype",
    "number",
    "integer",
    "signedinteger",
    "unsignedinteger",
    "floating",
    "flexible",
    "complexfloating",
    "bool",
    "bool_",
    "int8",
    "byte",
    "int16",
    "short",
    "int32",
    "int",
    "int64",
    "long",
    "uint8",
    "ubyte",
    "float16",
    "half",
    "bfloat16",
    "float32",
    "float",
    "float_",
    "float64",
    "double",
    "complex64",
    "cfloat",
    "csingle",
    "complex128",
    "cdouble",
    "canonical_heat_type",
    "heat_type_of",
    "heat_type_is_exact",
    "heat_type_is_inexact",
    "heat_type_is_complexfloating",
    "issubdtype",
    "iscomplexobj",
    "promote_types",
    "result_type",
    "can_cast",
    "finfo",
    "iinfo",
]


class _DatatypeMeta(type):
    def __repr__(cls):
        return f"heat_tpu_torch.{cls.__name__}"

    def __str__(cls):
        return cls.__name__


class datatype(metaclass=_DatatypeMeta):
    """Base class of the type hierarchy. Calling a concrete type casts data to a
    DNDarray of that type: ``ht.float32([1, 2])``."""

    _torch_type = None
    _char = None

    def __new__(cls, *value, device=None, comm=None):
        from . import factories

        if cls._torch_type is None:
            raise TypeError(f"cannot instantiate abstract type {cls.__name__}")
        if len(value) == 0:
            value = ((0,),)
        if len(value) != 1:
            raise TypeError(f"{cls.__name__} takes at most 1 argument, got {len(value)}")
        return factories.array(value[0], dtype=cls, device=device, comm=comm)

    @classmethod
    def torch_type(cls) -> torch.dtype:
        """The backing ``torch.dtype``."""
        if cls._torch_type is None:
            raise TypeError(f"abstract type {cls.__name__} has no backend dtype")
        return cls._torch_type

    @classmethod
    def char(cls):
        if cls._char is None:
            raise TypeError(f"abstract type {cls.__name__} has no character code")
        return cls._char


class bool(datatype):  # noqa: A001 — shadows builtins.bool on purpose, like heat_tpu
    _torch_type = torch.bool
    _char = "u1"


bool_ = bool


class number(datatype):
    pass


class integer(number):
    pass


class signedinteger(integer):
    pass


class unsignedinteger(integer):
    pass


class floating(number):
    pass


class flexible(datatype):
    pass


class complexfloating(number):
    pass


class int8(signedinteger):
    _torch_type = torch.int8
    _char = "b"


byte = int8


class int16(signedinteger):
    _torch_type = torch.int16
    _char = "h"


short = int16


class int32(signedinteger):
    _torch_type = torch.int32
    _char = "i"


int = int32  # noqa: A001


class int64(signedinteger):
    _torch_type = torch.int64
    _char = "l"


long = int64


class uint8(unsignedinteger):
    _torch_type = torch.uint8
    _char = "B"


ubyte = uint8


class float16(floating):
    _torch_type = torch.float16
    _char = "e"


half = float16


class bfloat16(floating):
    _torch_type = torch.bfloat16
    _char = "E"


class float32(floating):
    _torch_type = torch.float32
    _char = "f"


float = float32  # noqa: A001
float_ = float32


class float64(floating):
    _torch_type = torch.float64
    _char = "d"


double = float64


class complex64(complexfloating):
    _torch_type = torch.complex64
    _char = "F"


cfloat = complex64
csingle = complex64


class complex128(complexfloating):
    _torch_type = torch.complex128
    _char = "D"


cdouble = complex128


# --------------------------------------------------------------------------- registries
_HEAT_TYPES = [
    bool,
    uint8,
    int8,
    int16,
    int32,
    int64,
    float16,
    bfloat16,
    float32,
    float64,
    complex64,
    complex128,
]

__TORCH_TO_HEAT = {t._torch_type: t for t in _HEAT_TYPES}

__CANONICAL = {}
for _t in _HEAT_TYPES:
    __CANONICAL[_t] = _t
    __CANONICAL[_t.__name__] = _t
    __CANONICAL[_t._torch_type] = _t
    if _t is not bfloat16:  # numpy has no bfloat16
        _np = np.dtype(str(_t._torch_type).replace("torch.", ""))
        __CANONICAL[_np] = _t
        __CANONICAL[_np.name] = _t
__CANONICAL["bool_"] = bool
# python builtins: heat_tpu runs with x64, so Python ints are int64 and complex is
# complex128; Python floats are the framework float, float32
__CANONICAL[builtins.bool] = bool
__CANONICAL[builtins.int] = int64
__CANONICAL[builtins.float] = float32
__CANONICAL[builtins.complex] = complex128
for _np_t in (np.bool_, np.uint8, np.int8, np.int16, np.int32, np.int64,
              np.float16, np.float32, np.float64, np.complex64, np.complex128):
    __CANONICAL[_np_t] = __CANONICAL[np.dtype(_np_t)]


def canonical_heat_type(a_type: Any) -> Type[datatype]:
    """Canonicalise str / numpy / torch / python / heat dtypes to the heat class."""
    if isinstance(a_type, type) and issubclass(a_type, datatype):
        if a_type._torch_type is None:
            raise TypeError(f"data type {a_type!r} is abstract")
        return a_type
    try:
        hashed = __CANONICAL.get(a_type)
        if hashed is not None:
            return hashed
    except TypeError:
        pass
    try:
        return __CANONICAL[np.dtype(a_type)]
    except (TypeError, KeyError):
        raise TypeError(f"data type {a_type!r} is not understood") from None


def heat_type_of(obj: Any) -> Type[datatype]:
    """Heat type of an arbitrary object's elements."""
    from .dndarray import DNDarray

    if isinstance(obj, DNDarray):
        return obj.dtype
    dt = getattr(obj, "dtype", None)
    if dt is not None:
        return canonical_heat_type(dt)
    if isinstance(obj, (list, tuple)):
        return canonical_heat_type(np.asarray(obj).dtype)
    return canonical_heat_type(type(obj))


def heat_type_is_exact(ht_dtype: Any) -> builtins.bool:
    """True for integer/bool types."""
    t = canonical_heat_type(ht_dtype)
    return issubclass(t, integer) or t is bool


def heat_type_is_inexact(ht_dtype: Any) -> builtins.bool:
    """True for floating/complex types."""
    t = canonical_heat_type(ht_dtype)
    return issubclass(t, (floating, complexfloating))


def heat_type_is_complexfloating(ht_dtype: Any) -> builtins.bool:
    return issubclass(canonical_heat_type(ht_dtype), complexfloating)


def promote_types(type1: Any, type2: Any) -> Type[datatype]:
    """Smallest type safely holding both, on heat_tpu's lattice; e.g.
    ``promote_types(bfloat16, float16) → float32``."""
    t1 = canonical_heat_type(type1)
    t2 = canonical_heat_type(type2)
    return canonical_heat_type(torch.promote_types(t1.torch_type(), t2.torch_type()))


def result_type(*arrays_and_types: Any) -> Type[datatype]:
    """Promotion over arrays, scalars and dtypes, as heat_tpu's ``result_type``.

    Python scalars are *weak*: a Python int never widens an integer type (but makes
    bool int64), a Python float turns an exact type into float32 and never widens a
    float type, a Python complex turns float32 and exact types into complex64.
    """
    from .dndarray import DNDarray

    strong = None
    weak = None  # the strongest weak kind seen: "b" < "i" < "f" < "c"
    order = {"b": 0, "i": 1, "f": 2, "c": 3}
    for a in arrays_and_types:
        if isinstance(a, DNDarray):
            t = a.dtype
        elif isinstance(a, type) and issubclass(a, datatype):
            t = a
        elif isinstance(a, (builtins.bool, builtins.int, builtins.float, builtins.complex)) and not isinstance(
            a, np.generic
        ):
            kind = {builtins.bool: "b", builtins.int: "i", builtins.float: "f", builtins.complex: "c"}[type(a)]
            if weak is None or order[kind] > order[weak]:
                weak = kind
            continue
        else:
            t = canonical_heat_type(getattr(a, "dtype", None) or np.asarray(a).dtype)
        strong = t if strong is None else promote_types(strong, t)
    if weak is None:
        return strong
    if strong is None:
        return {"b": bool, "i": int64, "f": float32, "c": complex64}[weak]
    if weak == "i" and strong is bool:
        return int64
    if weak == "f" and heat_type_is_exact(strong):
        return float32
    if weak == "c" and not issubclass(strong, complexfloating):
        return complex128 if strong is float64 else complex64
    return strong


def issubdtype(arg1: Any, arg2: Any) -> builtins.bool:
    """numpy-style dtype comparison on the heat hierarchy (abstract types included)."""
    t1 = arg1 if (isinstance(arg1, type) and issubclass(arg1, datatype)) else canonical_heat_type(arg1)
    if isinstance(arg2, type) and issubclass(arg2, datatype):
        return issubclass(t1, arg2)
    return issubclass(t1, canonical_heat_type(arg2))


def iscomplexobj(x: Any) -> builtins.bool:
    return heat_type_is_complexfloating(heat_type_of(x))


def _np(t) -> np.dtype:
    """numpy's dtype of a heat type, bfloat16 standing in as float16 (numpy has none)."""
    return np.dtype(np.float16) if t is bfloat16 else np.dtype(str(t.torch_type()).replace("torch.", ""))


def can_cast(from_: Any, to: Any, casting: str = "intuitive") -> builtins.bool:
    """Whether a cast is allowed under ``casting``: numpy's "no", "safe", "same_kind" and
    "unsafe", and heat's default "intuitive" (safe, and any integer to any float)."""
    from .dndarray import DNDarray

    to_t = canonical_heat_type(to)
    if isinstance(from_, DNDarray):
        from_t = from_.dtype
    elif isinstance(from_, (builtins.int, builtins.float, builtins.complex, builtins.bool)):
        return builtins.bool(np.can_cast(np.min_scalar_type(from_), _np(to_t)))
    else:
        from_t = canonical_heat_type(from_)
    if casting == "no":
        return from_t is to_t
    if casting == "unsafe":
        return True
    f_np, t_np = _np(from_t), _np(to_t)
    if casting == "same_kind":
        order = {"b": 0, "u": 1, "i": 1, "f": 2, "c": 3}
        return order[f_np.kind] <= order[t_np.kind]
    if casting in ("safe", "intuitive"):
        if from_t is to_t:
            return True
        safe = builtins.bool(np.can_cast(f_np, t_np))
        if casting == "intuitive" and not safe and f_np.kind in "biu" and t_np.kind in "fc":
            return True
        return safe
    raise ValueError(f"invalid casting rule {casting!r}")


class finfo:
    """Machine limits of a float type: bits, eps, max, min, tiny."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not issubclass(t, (floating, complexfloating)):
            raise TypeError(f"data type {t!r} not inexact")
        return super().__new__(cls)

    def __init__(self, dtype):
        t = canonical_heat_type(dtype)
        info = torch.finfo(t.torch_type())
        self.bits = info.bits
        self.eps = builtins.float(info.eps)
        self.max = builtins.float(info.max)
        self.min = builtins.float(info.min)
        self.tiny = builtins.float(info.tiny)
        self.dtype = t

    def __repr__(self):
        return f"finfo(dtype={self.dtype}, eps={self.eps}, max={self.max}, min={self.min})"


class iinfo:
    """Machine limits of an integer type (bool: 8 bits, 0 and 1)."""

    def __new__(cls, dtype):
        t = canonical_heat_type(dtype)
        if not (issubclass(t, integer) or t is bool):
            raise TypeError(f"data type {t!r} not exact")
        return super().__new__(cls)

    def __init__(self, dtype):
        t = canonical_heat_type(dtype)
        if t is bool:
            self.bits, self.max, self.min = 8, 1, 0
        else:
            info = torch.iinfo(t.torch_type())
            self.bits, self.max, self.min = info.bits, builtins.int(info.max), builtins.int(info.min)
        self.dtype = t

    def __repr__(self):
        return f"iinfo(dtype={self.dtype}, max={self.max}, min={self.min})"


def _iscomplex(v: torch.Tensor) -> torch.Tensor:
    return v.imag != 0 if v.is_complex() else torch.zeros(v.shape, dtype=torch.bool, device=v.device)


def _isreal(v: torch.Tensor) -> torch.Tensor:
    return v.imag == 0 if v.is_complex() else torch.ones(v.shape, dtype=torch.bool, device=v.device)


def iscomplex(x):
    """Element-wise: whether the value has a non-zero imaginary part."""
    from . import _operations

    return _operations.local_op(_iscomplex, x)


def isreal(x):
    """Element-wise: whether the value's imaginary part is zero."""
    from . import _operations

    return _operations.local_op(_isreal, x)
