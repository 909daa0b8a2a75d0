"""Random number generation with heat_tpu's streams (counterpart of heat_tpu/core/random.py).

heat_tpu keeps a global (seed, counter) state, derives a key for each draw as
``fold_in(fold_in(key(seed), hi), lo)`` of the counter's 32-bit halves and advances the
counter by the draw's *global* element count (heat_tpu/core/random.py:64). Its draws are
``jax.random``'s with ``jax_threefry_partitionable`` on, where the bits of element ``i``
of a draw are ``threefry2x32(key, hi(i), lo(i))``. This module computes the same
Threefry-2x32 hash in torch integer ops, so each rank computes only the counters of its
own chunk and the streams equal heat_tpu's bit for bit, whatever the number of ranks.
Values are uint32 held in int64 lanes masked to 32 bits; the same code runs on Python
ints (keys) and on CPU and CUDA tensors (counters).

``normal`` goes through XLA's inverse error function, ported as its polynomials (Giles'
single- and double-precision approximations); its logarithm is torch's, so the draws
are held to heat_tpu's within 4 ulp in float32 and 32 ulp in float64 (the uniform draws
beneath them are bit for bit).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_shape

__all__ = [
    "get_state",
    "normal",
    "permutation",
    "rand",
    "ranf",
    "randint",
    "random_integer",
    "randn",
    "random",
    "random_sample",
    "randperm",
    "sample",
    "seed",
    "set_state",
    "standard_normal",
]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

__seed: int = 0
__counter: int = 0
_state_lock = threading.Lock()


# --------------------------------------------------------------------------- Threefry-2x32
def _rotl(x, d: int):
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(key: Tuple[int, int], x1, x2):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under ``key``, 20 rounds
    (jax ``_threefry2x32_lowering``). ``x1``/``x2`` are Python ints or int64 tensors
    holding uint32 values."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def _key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)``: the 64-bit seed as two uint32 halves."""
    s = int(seed) % 2**64
    return s >> 32, s & M32


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: the hash of the counter pair ``(0, data)``."""
    return threefry2x32(key, 0, int(data) & M32)


def _split(key: Tuple[int, int], num: int = 2) -> Tuple[Tuple[int, int], ...]:
    """``jax.random.split(key, num)`` with partitionable Threefry: key ``i`` is the hash
    of the counter pair (hi(i), lo(i))."""
    return tuple(threefry2x32(key, i >> 32, i & M32) for i in range(int(num)))


def _next_key(nelem: int) -> Tuple[int, int]:
    """The key of the next draw; the counter advances by the global element count
    (heat_tpu/core/random.py:64)."""
    global __counter
    with _state_lock:
        sd, base = __seed, __counter
        __counter = base + int(nelem)
    return _fold_in(_fold_in(_key(sd), (base >> 32) & M32), base & M32)


def _counters(shape, split, comm, device, slices=None) -> torch.Tensor:
    """This rank's chunk of the row-major iota over the global ``shape`` (int64): a slice
    of the flat element indices, strided for ``split`` != 0; or, with ``slices`` (one
    slice an axis), the block that they cut."""
    if slices is None:
        _, lshape, slices = comm.chunk(shape, split)
    else:
        lshape = tuple(s.stop - s.start for s in slices)
    idx = torch.zeros(lshape, dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        view = [1] * len(shape)
        view[d] = lshape[d]
        idx += torch.arange(slices[d].start, slices[d].stop, dtype=torch.int64, device=device).view(view) * stride
        stride *= shape[d]
    return idx


def _bits(key, shape, split, comm, device, slices=None):
    """The two 32-bit halves of every element's hash, for this rank's chunk (or the block
    that ``slices`` cut)."""
    idx = _counters(shape, split, comm, device, slices)
    return threefry2x32(key, idx >> 32, idx & M32)


def _bits32(key, shape, split, comm, device) -> torch.Tensor:
    b1, b2 = _bits(key, shape, split, comm, device)
    return b1 ^ b2


def _uniform01(key, shape, dtype, split, comm, device, slices=None) -> torch.Tensor:
    """Floats in [0, 1): random mantissa bits under the exponent of 1.0, minus 1 (jax
    ``_uniform``)."""
    b1, b2 = _bits(key, shape, split, comm, device, slices)
    if dtype is types.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
    return bits.view(torch.float64) - 1.0


# XLA's single-precision inverse error function (Giles): two polynomials in
# w = -log1p(-x²), one for w < 5 and one beyond
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b).to(x.dtype) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


# XLA's double-precision inverse error function (Giles): three polynomials in w, for
# w < 6.25, w < 16 and beyond; the longer ones run on where the shorter stop
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17, 6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05, 0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06, 2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334, 3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08, 2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221),
)


def _erfinv64(x: torch.Tensor) -> torch.Tensor:
    lt625_c, lt16_c, ge16_c = _ERFINV64
    w = -torch.log1p(-x * x)
    lt625, lt16 = w < 6.25, w < 16.0

    def coef(i):
        c = torch.full_like(x, lt625_c[i])
        if i < len(lt16_c):
            c = torch.where(lt625, c, lt16_c[i])
        if i < len(ge16_c):
            c = torch.where(lt16, c, ge16_c[i])
        return c

    w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0).to(x.dtype))
    p = coef(0)
    for i in range(1, len(lt625_c)):
        step = coef(i) + p * w
        p = step if i < len(ge16_c) else torch.where(lt16 if i < len(lt16_c) else lt625, step, p)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _setup(shape, split, device, comm):
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    split = None if split is None else int(split) % max(len(shape), 1)
    return comm, device, split


# --------------------------------------------------------------------------- state
def get_state() -> Tuple[str, int, int, int, float]:
    """The generator's state, as heat_tpu's: ``("Threefry", seed, counter, 0, 0.0)``."""
    with _state_lock:
        return ("Threefry", __seed, __counter, 0, 0.0)


def set_state(state: Tuple[str, int, int, int, float]) -> None:
    """Set the generator's state."""
    if state[0] != "Threefry":
        raise ValueError(f"random state must be of type Threefry, got {state[0]}")
    global __seed, __counter
    with _state_lock:
        __seed = int(state[1])
        __counter = int(state[2])


def seed(seed: Optional[int] = None) -> None:  # noqa: A001
    """Seed the generator; None draws a seed from the OS's entropy on rank 0 and
    broadcasts it, so every rank draws the same streams."""
    global __seed, __counter
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2**32)
        comm = sanitize_comm(None)
        if comm.is_distributed():
            from .devices import get_device

            t = torch.tensor(int(seed), dtype=torch.int64, device=get_device().torch_device)
            seed = int(comm.bcast(t, root=0).item())
    with _state_lock:
        __seed = int(seed)
        __counter = 0


# --------------------------------------------------------------------------- draws
def rand(*d: int, dtype=types.float32, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1)."""
    shape = sanitize_shape(d if d else ())
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.float32, types.float64):
        raise ValueError(f"Unsupported dtype {dtype} for rand")
    comm, device, split = _setup(shape, split, device, comm)
    key = _next_key(int(np.prod(shape)) if shape else 1)
    value = _uniform01(key, shape, dtype, split, comm, device.torch_device)
    return DNDarray(value, shape, dtype, split, device, comm, True)


def random(shape: Optional[Tuple[int, ...]] = None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Uniform samples in [0, 1) of ``shape``."""
    shape = sanitize_shape(shape) if shape is not None else ()
    return rand(*shape, dtype=dtype, split=split, device=device, comm=comm)


def ranf(*args, **kwargs) -> DNDarray:
    """Alias of :func:`random`."""
    return random(*args, **kwargs)


def random_sample(*args, **kwargs) -> DNDarray:
    """Alias of :func:`random`."""
    return random(*args, **kwargs)


def sample(*args, **kwargs) -> DNDarray:
    """Alias of :func:`random`."""
    return random(*args, **kwargs)


def randint(low: int, high: Optional[int] = None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Integers in [low, high): jax's draw of two words an element, reduced modulo the
    span (jax ``_randint``), with its unsigned wrap-around replayed (a 64-bit span of
    2**31 or more in 32-bit limbs, so no int64 product overflows)."""
    if high is None:
        low, high = 0, low
    if size is None:
        size = ()
    if isinstance(size, int):
        size = (size,)
    size = sanitize_shape(size)
    if low >= high:
        raise ValueError(f"low >= high ({low} >= {high})")
    if not -(2**63) <= low < high < 2**63:  # jax reads both bounds as int64
        raise OverflowError(f"randint bounds ({low}, {high}) overflow int64")
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.int32, types.int64):
        raise ValueError(f"Unsupported dtype {dtype} for randint")
    comm, device, split = _setup(size, split, device, comm)
    key = _next_key(int(np.prod(size)) if size else 1)
    value = _randint_values(key, size, low, high, dtype, split, comm, device.torch_device)
    return DNDarray(value, size, dtype, split, device, comm, True)


def random_integer(low: int, high: Optional[int] = None, size=None, dtype=types.int32, split=None, device=None, comm=None) -> DNDarray:
    """Alias of :func:`randint`."""
    return randint(low, high, size, dtype, split, device, comm)


def standard_normal(shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples: ``sqrt(2)·erfinv(u)`` for u uniform on
    ``(nextafter(-1, 0), 1)`` (jax ``_normal_real``)."""
    shape = sanitize_shape(shape) if shape is not None else ()
    dtype = types.canonical_heat_type(dtype)
    if dtype not in (types.float32, types.float64):
        raise ValueError(f"Unsupported dtype {dtype} for standard_normal")
    comm, device, split = _setup(shape, split, device, comm)
    key = _next_key(int(np.prod(shape)) if shape else 1)
    npt = np.float32 if dtype is types.float32 else np.float64
    lo = np.nextafter(npt(-1.0), npt(0.0), dtype=npt)
    scale = float(npt(1.0) - lo)
    u = _uniform01(key, shape, dtype, split, comm, device.torch_device) * scale + float(lo)
    u = torch.clamp_min(u, float(lo))
    e = _erfinv32(u) if dtype is types.float32 else _erfinv64(u)
    return DNDarray(float(npt(math.sqrt(2))) * e, shape, dtype, split, device, comm, True)


def randn(*d: int, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Standard-normal samples."""
    return standard_normal(sanitize_shape(d if d else ()), dtype, split, device, comm)


def normal(mean=0.0, std=1.0, shape=None, dtype=types.float32, split=None, device=None, comm=None) -> DNDarray:
    """Normal samples with ``mean`` and ``std`` (scalars or DNDarrays)."""
    if shape is None:
        shape = getattr(mean, "gshape", None) or getattr(std, "gshape", None) or ()
    s = standard_normal(shape, dtype=dtype, split=split, device=device, comm=comm)
    from . import arithmetics

    return arithmetics.add(arithmetics.mul(s, std), mean)


# --------------------------------------------------------------------------- key-level draws
# heat_tpu's clustering calls jax.random with explicit keys (jax.random.key(seed), split,
# randint, uniform, choice); these give the same bits for a key held as its two uint32
# words, computed whole on the caller's device.
def _randint_values(key, size, low: int, high: int, dtype, split=None, comm=None, dev=None) -> torch.Tensor:
    """jax ``_randint`` under ``key``: two words an element from the halves of
    ``split(key)``, reduced modulo the span with its unsigned wrap-around replayed."""
    comm = sanitize_comm(comm)
    info = torch.iinfo(dtype.torch_type())
    lo, hi = max(int(low), info.min), min(int(high), info.max)
    nbits = info.bits
    span = (hi - lo) % 2**nbits
    if int(high) > info.max:
        span = (span + 1) % 2**nbits
    k1, k2 = _split(key)
    if nbits == 32:
        higher, lower = (_bits32(k, size, split, comm, dev) for k in (k1, k2))
        if span == 0:  # the whole range: XLA's x % 0 is x, so the offset is the low word
            offset = lower
        else:
            mult = (2**16 % span) ** 2 % 2**32 % span
            offset = (((higher % span) * mult) & M32) + (lower % span)
            offset = (offset & M32) % span
    else:
        h, l = (_bits(k, size, split, comm, dev) for k in (k1, k2))  # noqa: E741
        if 0 < span < 2**31:  # every product below 2**62: plain int64 arithmetic
            mult = (2**32 % span) ** 2 % span
            r32 = 2**32 % span
            h_mod = ((h[0] % span) * r32 + h[1] % span) % span
            l_mod = ((l[0] % span) * r32 + l[1] % span) % span
            offset = (h_mod * mult + l_mod) % span
        else:
            # jax's uint64 arithmetic, wrapping, replayed in 32-bit limbs; a span of 0 (the
            # whole range) leaves every remainder as it is, as XLA's x % 0 does for unsigned x
            mult = (2**32 % span) ** 2 % 2**64 % span if span else 0
            offset = _u64_mod(_u64_add(_u64_mul_const(_u64_mod(h, span), mult), _u64_mod(l, span)), span)
            return _u64_to_int64(_u64_add(offset, (lo % 2**64 >> 32, lo % 2**32)))
    return (offset + lo).to(dtype.torch_type())


# uint64 values as (high, low) pairs of uint32 held in int64 tensors (or Python ints): no
# int64 product below takes factors of more than 16 and 32 bits, so none overflows
def _u64_mul_const(x, c: int):
    """x · c modulo 2**64 for the constant c."""
    xh, xl = x
    ch, cl = c >> 32, c & M32
    x0, x1 = xl & 0xFFFF, xl >> 16
    c0, c1 = cl & 0xFFFF, cl >> 16
    mid = x0 * c1 + x1 * c0  # < 2**33
    low = x0 * c0 + ((mid & 0xFFFF) << 16)  # < 2**33
    high = x1 * c1 + (mid >> 16) + (low >> 32)  # the high word of xl · cl
    # the cross terms xh·cl + xl·ch only reach the high word: their low 32 bits
    cross = _lo32_mul(xh, cl) + _lo32_mul(xl, ch)
    return (high + cross) & M32, low & M32


def _lo32_mul(a, c: int):
    """(a · c) mod 2**32 for a uint32 tensor ``a`` and a uint32 constant ``c``."""
    c0, c1 = c & 0xFFFF, c >> 16
    return (a * c0 + (((a & 0xFFFF) * c1) << 16)) & M32


def _u64_add(x, y):
    lo = x[1] + y[1]
    return (x[0] + y[0] + (lo >> 32)) & M32, lo & M32


def _u64_sub(x, y):
    """x - y modulo 2**64."""
    lo = x[1] - y[1]  # in (-2**32, 2**32): lo >> 32 is the borrow, 0 or -1
    return (x[0] - y[0] + (lo >> 32)) & M32, lo & M32


def _u64_mod(x, s: int):
    """x mod s for the constant s >= 2**31 (0: x as it is). The quotient x / s (below
    2**33) from float64, which misses it by less than one; one less than its floor is at
    most the true quotient and at least two below it, so x - q·s is exact in limbs and
    below 3s, and two conditional subtractions of s finish it."""
    if s == 0:
        return x
    xh, xl = x
    q = torch.floor((xh.double() * 2**32 + xl.double()) / float(s)).to(torch.int64)
    q = (q - 1).clamp_min(0)
    r = _u64_sub(x, _u64_mul_const((q >> 32, q & M32), s))
    sh, sl = s >> 32, s & M32
    for _ in range(2):
        ge = (r[0] > sh) | ((r[0] == sh) & (r[1] >= sl))
        d = _u64_sub(r, (sh, sl))
        r = torch.where(ge, d[0], r[0]), torch.where(ge, d[1], r[1])
    return r


def _u64_to_int64(x) -> torch.Tensor:
    """The int64 of the same 64 bits."""
    xh, xl = x
    return (xh - ((xh >> 31) << 32)) * 2**32 + xl


def _key_randint(key, shape, low: int, high: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, low, high)`` at heat_tpu's default int64."""
    return _randint_values(key, tuple(shape), low, high, types.int64, dev=device)


def _key_uniform(key, shape, dtype=types.float32, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1)."""
    return _uniform01(key, tuple(shape), dtype, None, sanitize_comm(None), device)


def _xla_cumsum(p: torch.Tensor) -> torch.Tensor:
    """The inclusive scan of a 1-D tensor in XLA's CPU order for ``jnp.cumsum`` (its
    reduce-window rewrite with base 16): rows of 16 scanned in order, the rows' totals
    scanned the same way, and each row's exclusive carry added to it; 16 elements or
    fewer in order. Only additions in the tensor's own type, so the CPU and the card give
    the same bits."""
    n = p.shape[0]
    if n <= 16:
        out = p.clone()
        for j in range(1, n):
            out[j] = out[j - 1] + p[j]
        return out
    m = -(-n // 16)
    rows = torch.zeros(m * 16, dtype=p.dtype, device=p.device)
    rows[:n] = p
    rows = rows.view(m, 16)
    scan = rows.clone()
    for j in range(1, 16):
        scan[:, j] = scan[:, j - 1] + rows[:, j]
    carry = torch.zeros(m, dtype=p.dtype, device=p.device)
    carry[1:] = _xla_cumsum(scan[:, 15].contiguous())[:-1]
    return (scan + carry[:, None]).view(-1)[:n]


def _choice_draws(key, m: int, total: torch.Tensor) -> torch.Tensor:
    """The ``m`` targets of ``jax.random.choice(key, n, (m,), p=p)`` (with replacement):
    ``total · (1 − uniform)``, ``total`` the last element of ``p``'s cumulative sum; the
    pick is the first index whose cumulative sum reaches its target."""
    dtype = types.canonical_heat_type(total.dtype)
    return total * (1 - _key_uniform(key, (m,), dtype, total.device))


def _key_choice(key, m: int, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, len(p), (m,), p=p)`` (int64), its cumulative sum in XLA's
    CPU order (:func:`_xla_cumsum`)."""
    cuml = _xla_cumsum(p)
    return torch.searchsorted(cuml, _choice_draws(key, m, cuml[-1]))


def _shuffled(key, n: int, comm, device) -> torch.Tensor:
    """jax ``_shuffle`` of ``arange(n)``: ``ceil(3·ln n / ln(2³² − 1))`` rounds, each a
    split of the key and a stable sort by 32 fresh random bits an element. Every rank
    computes the whole permutation, as heat_tpu's one global program does."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = _split(key)
        sort_keys = _bits32(sub, (n,), None, comm, device)
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def randperm(n: int, dtype=types.int64, split=None, device=None, comm=None) -> DNDarray:
    """A random permutation of ``arange(n)``, heat_tpu's: computed whole on every rank,
    each keeping its chunk."""
    if not isinstance(n, int):
        raise TypeError(f"n must be an int, got {type(n)}")
    dtype = types.canonical_heat_type(dtype)
    comm, device, split = _setup((n,), split, device, comm)
    perm = _shuffled(_next_key(n), n, comm, device.torch_device)
    _, _, slices = comm.chunk((n,), split)
    return DNDarray(perm[slices].to(dtype.torch_type()), (n,), dtype, split, device, comm, True)


def permutation(x: Union[int, DNDarray], **kwargs) -> DNDarray:
    """A random permutation of ``range(x)``, or of ``x``'s rows (heat_tpu's stream; a
    split array's rows are fetched by integer indexing)."""
    if isinstance(x, int):
        return randperm(x, **kwargs)
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected int or DNDarray, got {type(x)}")
    if kwargs:
        raise TypeError(f"unexpected kwargs {tuple(kwargs)} for DNDarray input")
    perm = _shuffled(_next_key(x.gshape[0]), x.gshape[0], x.comm, x.larray.device)
    from . import indexing

    return indexing._take_rows(x, perm)


# a fixed default seed, heat_tpu's (heat_tpu/core/random.py:282)
seed(ord("h") + ord("e") + ord("a") + ord("t"))
