"""Functional neural-network ops (counterpart of heat_tpu/nn/functional.py).

``torch.nn.functional``'s ops under heat_tpu's names, signatures and DNDarray rules. Every
function takes a ``torch.Tensor`` or a DNDarray; a DNDarray is computed as one global
array, as heat_tpu computes it, and the result's split follows heat_tpu's rule for the op:

- elementwise ops (``relu``, ``gelu``, ``dropout``, ...) keep any split;
- ops with a batch axis (convolutions, pools, ``softmax``, ``linear``, ``one_hot``, ...)
  keep a split along axis 0 only (heat_tpu's ``_rewrap``, functional.py:101), and a split
  along any other axis comes back whole;
- ``layer_norm`` keeps a split outside the normalised axes, ``flatten`` one before
  ``start_dim``, ``cosine_similarity`` and ``pairwise_distance`` one outside the reduced axis;
- the losses' ``"mean"`` and ``"sum"`` are global, returned as 0-dim tensors.

Where the split lies along an axis the op treats independently, each rank computes its own
chunk (a batch-split convolution, an elementwise op on any split); reductions across ranks
(``batch_norm``'s moments, the losses' sums and weights) are one ``all_reduce`` through the
array's communicator; anything else is computed on the gathered array and re-chunked.

``gelu`` is the exact erf form by default, as torch's and heat_tpu's (:132). ``dropout``
and ``dropout2d`` take heat_tpu's PRNG key, given as the two uint32 words of
``jax.random.key_data(key)``, and draw the mask ``uniform(key, shape) < 1 - p`` with the
port's Threefry-2x32 (``core/random.py``), so it equals heat_tpu's ``jax.random.bernoulli``
mask bit for bit (its float64 uniforms, as heat_tpu runs with x64 on); a split array draws
its own chunk of the global mask. Inside :func:`batch_rows` (the data-parallel optimizers'
steps hand their loss this rank's rows of a batch that heat_tpu's one program holds whole),
a mask over a plain tensor with this rank's rows along the batch axis is drawn over the
whole batch and cut to those rows. Matrix products and convolutions run in full fp32 (TF32
off for cuBLAS and cuDNN), as heat_tpu's f32 is.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as TF

from ..core import random as _random
from ..core import types
from ..core._operations import wrap_global, wrap_result
from ..core.communication import sanitize_comm
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray

__all__ = [
    "relu",
    "leaky_relu",
    "gelu",
    "elu",
    "sigmoid",
    "tanh",
    "softmax",
    "log_softmax",
    "linear",
    "conv1d",
    "conv2d",
    "max_pool1d",
    "max_pool2d",
    "avg_pool1d",
    "avg_pool2d",
    "dropout",
    "dropout2d",
    "batch_norm",
    "layer_norm",
    "group_norm",
    "flatten",
    "one_hot",
    "nll_loss",
    "cross_entropy",
    "mse_loss",
    "l1_loss",
    "silu",
    "mish",
    "softplus",
    "hardtanh",
    "embedding",
    "conv_transpose2d",
    "adaptive_avg_pool2d",
    "adaptive_max_pool2d",
    "pad",
    "normalize",
    "cosine_similarity",
    "pairwise_distance",
    "binary_cross_entropy",
    "binary_cross_entropy_with_logits",
    "smooth_l1_loss",
    "huber_loss",
    "scaled_dot_product_attention",
]


# ---------------------------------------------------------------------- DNDarray rules
def _whole(t):
    """All of ``t`` on this rank: a DNDarray gathered, anything else as it is."""
    return t._relayout(None) if isinstance(t, DNDarray) else t


def _same(split):
    return split


def _batch(split):
    return split if split == 0 else None


def _run(x, fn: Callable, local: Callable[[int], bool] = lambda s: True, rule: Callable = _same):
    """``fn`` over ``x`` as one global array, its result's split by ``rule(x.split)``.

    A distributed DNDarray whose split axis ``s`` passes ``local(s)`` (``fn`` treats the
    rows along it independently and keeps the axis) is computed chunk by chunk; anything
    else is gathered, computed whole and chunked by the rule."""
    if not isinstance(x, DNDarray):
        return fn(x)
    s, target = x.split, rule(x.split)
    if x.is_distributed() and local(s):
        out = fn(x.larray)
        gshape = list(out.shape)
        gshape[s] = x.gshape[s]
        res = wrap_result(out, x, s, tuple(gshape))
        return res if target == s else res.resplit(target)
    return wrap_global(fn(x.larray if not x.is_distributed() else _whole(x)), x, target)


def _elementwise(fn: Callable) -> Callable:
    def wrapped(x, *args, **kwargs):
        return _run(x, lambda v: fn(v, *args, **kwargs))

    wrapped.__name__ = fn.__name__
    return wrapped


def _like(t, x: DNDarray, s: int):
    """This rank's part of ``t`` (a tensor or DNDarray broadcastable against ``x``'s global
    shape) for ``x``'s chunk along ``s``: sliced where ``t`` spans that axis, else whole."""
    if t is None:
        return None
    if isinstance(t, DNDarray):
        if t.split == s and t.gshape == x.gshape:
            return t.larray
        t = _whole(t)
    if not isinstance(t, torch.Tensor):
        return t
    ax = s - (x.ndim - t.ndim)
    if ax < 0 or t.shape[ax] != x.gshape[s]:
        return t
    return t[x.comm.chunk(tuple(t.shape), ax)[2]]


def _batch_rows(t, x: DNDarray):
    """This rank's rows along axis 0 of ``t`` (a tensor or DNDarray of ``x``'s batch) for
    ``x``'s chunk along axis 0."""
    if isinstance(t, DNDarray) and t.split == 0 and t.gshape[0] == x.gshape[0]:
        return t.larray
    t = _whole(t)
    return t[x.comm.chunk(tuple(t.shape), 0)[2]]


def _p(t):
    """A parameter-like argument (weight, bias, running statistics) whole on this rank."""
    return _whole(t)


def _proto(*ts) -> Optional[DNDarray]:
    return next((t for t in ts if isinstance(t, DNDarray)), None)


def _key(key) -> Tuple[int, int]:
    """heat_tpu's PRNG key as its two uint32 words (``jax.random.key_data``)."""
    words = [int(w) for w in (key.tolist() if hasattr(key, "tolist") else key)]
    if len(words) != 2:
        raise ValueError(f"a PRNG key is two uint32 words (jax.random.key_data), got {key!r}")
    return words[0] & _random.M32, words[1] & _random.M32


def _subkeys(key, num: int):
    """``jax.random.split(key, num)`` of heat_tpu's key."""
    return _random._split(_key(key), num)


# (axis, first row, rows here, rows in all) of the batch whose rows this rank's tensors
# hold, while a data-parallel step runs its loss on them (see batch_rows)
_BATCH_ROWS: contextvars.ContextVar = contextvars.ContextVar("heat_tpu_torch_batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(axis: int, first: int, count: int, total: int):
    """Within the block, this rank's plain tensors hold rows ``first .. first + count - 1``
    of a batch of ``total`` rows along ``axis``: a keyed mask (``dropout``, ``dropout2d``,
    attention dropout) over a plain tensor with ``count`` rows along ``axis`` is drawn
    over ``total`` rows and cut to this rank's, so it equals the rows of heat_tpu's mask,
    which its one program draws over the whole batch. ``DataParallelOptimizer.step`` and
    ``DASO.step`` set it around ``loss_fn``."""
    token = _BATCH_ROWS.set((axis, first, count, total))
    try:
        yield
    finally:
        _BATCH_ROWS.reset(token)


def _keep(key, shape, p: float, device, split=None, comm=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, 1 - p, shape)``: float64 uniforms below 1 - p (heat_tpu
    runs with x64, so the probability is a float64), this rank's chunk along ``split``; a
    plain tensor's mask (no ``comm``) inside :func:`batch_rows`, its rows of the batch's."""
    shape = tuple(shape)
    rows = _BATCH_ROWS.get()
    if comm is None and rows is not None and len(shape) > rows[0] and shape[rows[0]] == rows[2]:
        axis, first, count, total = rows
        whole = shape[:axis] + (total,) + shape[axis + 1:]
        cut = tuple(slice(first, first + count) if a == axis else slice(0, n) for a, n in enumerate(whole))
        u = _random._uniform01(_key(key), whole, types.float64, None, None, device, cut)
    else:
        u = _random._uniform01(_key(key), shape, types.float64, split, sanitize_comm(comm), device)
    return u < (1.0 - p)


def _inverted(v: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """Kept values over 1 - p (a device scalar of v's type: CUDA divides by a CPU scalar
    through its reciprocal), dropped ones 0."""
    scale = torch.full((), 1.0 - p, dtype=v.dtype, device=v.device)
    return torch.where(keep, v / scale, torch.zeros((), dtype=v.dtype, device=v.device))


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _one(v) -> int:
    return v if isinstance(v, int) else v[0]


def _str_padding(padding: str, strides):
    """torch's padding strings: 'valid' is none, 'same' keeps the extent (stride 1 only)."""
    if padding == "valid":
        return "valid"
    if padding == "same":
        if any(s != 1 for s in strides):
            raise ValueError("padding='same' requires stride 1 (torch semantics)")
        return "same"
    raise ValueError(f"padding must be an int, a tuple, 'same' or 'valid', got {padding!r}")


# ---------------------------------------------------------------------- activations
relu = _elementwise(TF.relu)
sigmoid = _elementwise(torch.sigmoid)
tanh = _elementwise(torch.tanh)
silu = _elementwise(TF.silu)
mish = _elementwise(TF.mish)


def elu(x, alpha: float = 1.0):
    return _run(x, lambda v: TF.elu(v, alpha))


def gelu(x, approximate: str = "none"):
    """torch's gelu: the exact erf form by default, ``approximate='tanh'`` the fast one."""
    if approximate not in ("none", "tanh"):
        raise ValueError(f"approximate must be 'none' or 'tanh', got {approximate!r}")
    return _run(x, lambda v: TF.gelu(v, approximate=approximate))


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    """torch's softplus: linear where ``x·beta > threshold``."""
    return _run(x, lambda v: TF.softplus(v, beta, threshold))


def hardtanh(x, min_val: float = -1.0, max_val: float = 1.0):
    return _run(x, lambda v: torch.clamp(v, min_val, max_val))


def leaky_relu(x, negative_slope: float = 0.01):
    return _run(x, lambda v: TF.leaky_relu(v, negative_slope), rule=_batch)


def softmax(x, dim: int = -1):
    nd = x.ndim
    return _run(x, lambda v: torch.softmax(v, dim), local=lambda s: s != dim % nd, rule=_batch)


def log_softmax(x, dim: int = -1):
    nd = x.ndim
    return _run(x, lambda v: torch.log_softmax(v, dim), local=lambda s: s != dim % nd, rule=_batch)


# ---------------------------------------------------------------------- linear and convolutions
def _batch_axis(split) -> bool:
    """An op on (N, C, ...) treats its rows along the batch axis independently."""
    return split == 0


def linear(x, weight, bias=None):
    """``x @ W.T + b``, torch's (out, in) weight layout."""
    w, b = _p(weight), _p(bias)
    nd = x.ndim

    def fn(v):
        with full_fp32_matmul():
            return TF.linear(v, w.to(v.dtype), None if b is None else b.to(v.dtype))

    return _run(x, fn, local=lambda s: s < nd - 1, rule=_batch)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """2-D convolution, torch semantics: x (N, C, H, W), weight (O, C/groups, kH, kW)."""
    w, b = _p(weight), _p(bias)
    pad = _str_padding(padding, _pair(stride)) if isinstance(padding, str) else _pair(padding)

    def fn(v):
        with full_fp32_matmul():
            return TF.conv2d(v, w.to(v.dtype), None if b is None else b.to(v.dtype), _pair(stride), pad,
                             _pair(dilation), groups)

    return _run(x, fn, local=_batch_axis, rule=_batch)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """1-D convolution, torch semantics: x (N, C, L), weight (O, C/groups, k)."""
    w, b = _p(weight), _p(bias)
    pad = _str_padding(padding, (_one(stride),)) if isinstance(padding, str) else _one(padding)

    def fn(v):
        with full_fp32_matmul():
            return TF.conv1d(v, w.to(v.dtype), None if b is None else b.to(v.dtype), _one(stride), pad,
                             _one(dilation), groups)

    return _run(x, fn, local=_batch_axis, rule=_batch)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0, output_padding=0, groups: int = 1, dilation=1):
    """torch's conv_transpose2d: x (N, C, H, W), weight (C, O/groups, kH, kW)."""
    w, b = _p(weight), _p(bias)

    def fn(v):
        with full_fp32_matmul():
            return TF.conv_transpose2d(v, w.to(v.dtype), None if b is None else b.to(v.dtype), _pair(stride),
                                       _pair(padding), _pair(output_padding), groups, _pair(dilation))

    return _run(x, fn, local=_batch_axis, rule=_batch)


# ---------------------------------------------------------------------- pools
def max_pool1d(x, kernel_size, stride=None, padding=0):
    k = _one(kernel_size)
    s = k if stride is None else _one(stride)
    return _run(x, lambda v: TF.max_pool1d(v, k, s, _one(padding)), local=_batch_axis, rule=_batch)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    return _run(x, lambda v: TF.max_pool2d(v, k, s, _pair(padding)), local=_batch_axis, rule=_batch)


def avg_pool1d(x, kernel_size, stride=None, padding=0):
    """Padded positions count toward the divisor (torch's default)."""
    k = _one(kernel_size)
    s = k if stride is None else _one(stride)
    return _run(x, lambda v: TF.avg_pool1d(v, k, s, _one(padding)), local=_batch_axis, rule=_batch)


def avg_pool2d(x, kernel_size, stride=None, padding=0):
    """Padded positions count toward the divisor (torch's default)."""
    k = _pair(kernel_size)
    s = k if stride is None else _pair(stride)
    return _run(x, lambda v: TF.avg_pool2d(v, k, s, _pair(padding)), local=_batch_axis, rule=_batch)


def _adaptive(pool, v, output_size):
    """torch's adaptive pool over the two trailing axes of any (..., H, W)."""
    lead = v.shape[:-2]
    out = pool(v.reshape(-1, *v.shape[-2:]), _pair(output_size))
    return out.reshape(*lead, *out.shape[-2:])


def adaptive_avg_pool2d(x, output_size):
    nd = x.ndim
    return _run(x, lambda v: _adaptive(TF.adaptive_avg_pool2d, v, output_size), local=lambda s: s < nd - 2,
                rule=_batch)


def adaptive_max_pool2d(x, output_size):
    nd = x.ndim
    return _run(x, lambda v: _adaptive(TF.adaptive_max_pool2d, v, output_size), local=lambda s: s < nd - 2,
                rule=_batch)


# ---------------------------------------------------------------------- dropout
def dropout(x, p: float = 0.5, training: bool = True, key=None):
    """Inverted dropout with heat_tpu's key: kept values over 1 - p. Inert (``x`` itself)
    outside training or at p = 0; a split DNDarray draws its chunk of the global mask."""
    if not training or p == 0.0:
        return x
    if key is None:
        raise ValueError("dropout in training mode needs an explicit PRNG key")
    if not isinstance(x, DNDarray):
        return _inverted(x, _keep(key, x.shape, p, x.device), p)
    v = x.larray
    keep = _keep(key, x.gshape, p, v.device, x.split, x.comm)
    return wrap_result(_inverted(v, keep, p), x, x.split, x.gshape)


def dropout2d(x, p: float = 0.5, training: bool = True, key=None):
    """Channel dropout: zeroes whole (N, C) feature maps (torch's Dropout2d)."""
    if not training or p == 0.0:
        return x
    if key is None:
        raise ValueError("dropout2d in training mode needs an explicit PRNG key")
    shape = tuple(x.shape[:2]) + (1,) * (x.ndim - 2)

    def fn(v, split=None, comm=None):
        return _inverted(v, _keep(key, shape, p, v.device, split, comm), p)

    if isinstance(x, DNDarray) and x.is_distributed() and x.split == 0:
        return _run(x, lambda v: fn(v, 0, x.comm), local=_batch_axis, rule=_batch)
    return _run(x, fn, local=lambda s: False, rule=_batch)


# ---------------------------------------------------------------------- normalisation
def _moments(v: torch.Tensor, axes, comm=None, n_global=None):
    """Mean and biased variance of ``v`` over ``axes`` in two passes (heat_tpu's
    ``jnp.mean``/``jnp.var``), summed across the ranks of ``comm`` when given."""
    if comm is None:
        mean = torch.mean(v, dim=axes)
        shape = [1 if i in axes else n for i, n in enumerate(v.shape)]
        return mean, torch.mean((v - mean.reshape(shape)) ** 2, dim=axes)
    shape = [1 if i in axes else n for i, n in enumerate(v.shape)]
    mean = comm.all_reduce(torch.sum(v, dim=axes)) / n_global
    var = comm.all_reduce(torch.sum((v - mean.reshape(shape)) ** 2, dim=axes)) / n_global
    return mean, var


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training: bool = False, momentum: float = 0.1,
               eps: float = 1e-5):
    """Batch normalisation over every axis but the channel axis 1. Returns ``(out,
    batch_mean, batch_var)`` as heat_tpu's does (the statistics for a caller's running
    estimates). On a batch split the moments are global: the sums cross the ranks."""
    rm, rv, w, b = _p(running_mean), _p(running_var), _p(weight), _p(bias)
    use_batch = training or rm is None

    def fn(v, comm=None, n=None):
        axes = (0,) + tuple(range(2, v.ndim))
        mean, var = _moments(v, axes, comm, n) if use_batch else (rm, rv)
        shape = (1, -1) + (1,) * (v.ndim - 2)
        out = (v - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out, mean, var

    if isinstance(x, DNDarray) and x.is_distributed() and x.split == 0:
        n = x.size // x.gshape[1] if x.size else 0
        out, mean, var = fn(x.larray, x.comm, n)
        return wrap_result(out, x, 0, x.gshape), mean, var
    if isinstance(x, DNDarray):
        out, mean, var = fn(_whole(x))
        return wrap_global(out, x, _batch(x.split)), mean, var
    return fn(x)


def layer_norm(x, normalized_shape, weight=None, bias=None, eps: float = 1e-5):
    w, b = _p(weight), _p(bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    nd = x.ndim
    axes = tuple(range(nd - len(normalized_shape), nd))

    def fn(v):
        mean, var = _moments(v, axes)
        shape = [1 if i in axes else n for i, n in enumerate(v.shape)]
        out = (v - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
        if w is not None:
            out = out * w
        if b is not None:
            out = out + b
        return out

    return _run(x, fn, local=lambda s: s not in axes, rule=lambda s: s if s not in axes else None)


def group_norm(x, num_groups: int, weight=None, bias=None, eps: float = 1e-5):
    """torch's group_norm over (N, C, *spatial): per sample, so a batch split stays local."""
    w, b = _p(weight), _p(bias)
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"num_channels {c} not divisible by num_groups {num_groups}")

    def fn(v):
        g = v.reshape(v.shape[0], num_groups, c // num_groups, *v.shape[2:])
        axes = tuple(range(2, g.ndim))
        mean, var = _moments(g, axes)
        shape = [1 if i in axes else n for i, n in enumerate(g.shape)]
        out = ((g - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)).reshape(v.shape)
        shape = (1, -1) + (1,) * (v.ndim - 2)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out

    return _run(x, fn, local=_batch_axis, rule=_batch)


def normalize(x, p: float = 2.0, dim: int = 1, eps: float = 1e-12):
    """``x / max(||x||_p, eps)`` along ``dim``; any split survives."""
    nd = x.ndim

    def fn(v):
        n = torch.sum(torch.abs(v) ** p, dim=dim, keepdim=True) ** (1.0 / p)
        return v / torch.clamp_min(n, eps)

    return _run(x, fn, local=lambda s: s != dim % nd)


# ---------------------------------------------------------------------- shapes and lookups
def flatten(x, start_dim: int = 0, end_dim: int = -1):
    nd = x.ndim
    end = end_dim if end_dim >= 0 else nd + end_dim

    def fn(v):
        return v.reshape(*v.shape[:start_dim], -1, *v.shape[end + 1 :])

    def rule(s):
        return s if s is not None and s < start_dim else (0 if s == 0 else None)

    return _run(x, fn, local=lambda s: s < start_dim, rule=rule)


def one_hot(x, num_classes: int):
    """``jax.nn.one_hot``: float64 rows (heat_tpu's default float under x64)."""
    return _run(x, lambda v: TF.one_hot(v.long(), num_classes).to(torch.float64), rule=_batch)


def embedding(x, weight, padding_idx: Optional[int] = None):
    """Row lookup; the ``padding_idx`` row takes no gradient (torch's rule). Any split of
    the indices survives."""
    w = _p(weight)
    return _run(x, lambda v: TF.embedding(v.long(), w, padding_idx))


def pad(x, pad_widths, mode: str = "constant", value: float = 0.0):
    """torch's pad: (before, after) pairs from the last axis backwards."""
    if len(pad_widths) % 2:
        raise ValueError("pad_widths must hold (before, after) pairs")
    modes = ("constant", "reflect", "replicate", "circular")
    if mode not in modes:
        raise ValueError(f"unsupported pad mode {mode!r}; expected one of {sorted(modes)}")
    widths = [int(w) for w in pad_widths]
    nd = x.ndim
    padded = range(nd - len(widths) // 2, nd)

    def fn(v):
        if mode == "constant":
            return TF.pad(v, widths, value=value)
        # torch pads the trailing axes of a batched tensor in these modes
        lead = v.shape[: nd - len(widths) // 2]
        flat = v.reshape(1, -1, *v.shape[nd - len(widths) // 2 :])
        out = TF.pad(flat, widths, mode=mode)
        return out.reshape(*lead, *out.shape[2:])

    return _run(x, fn, local=lambda s: s not in padded, rule=_batch)


# ---------------------------------------------------------------------- distances
def cosine_similarity(x1, x2, dim: int = 1, eps: float = 1e-8):
    """``x1·x2 / (max(|x1|, eps)·max(|x2|, eps))`` along ``dim`` (each norm clamped)."""
    proto = _proto(x1, x2)
    v1, v2 = _whole(x1), _whole(x2)
    n1 = torch.clamp_min(torch.linalg.vector_norm(v1, dim=dim), eps)
    n2 = torch.clamp_min(torch.linalg.vector_norm(v2, dim=dim), eps)
    out = torch.sum(v1 * v2, dim=dim) / (n1 * n2)
    if proto is None:
        return out
    d = dim % proto.ndim
    s = proto.split
    keep = None if s is None or s == d else (s if s < d else s - 1)
    return wrap_global(out, proto, keep)


def pairwise_distance(x1, x2, p: float = 2.0, eps: float = 1e-6, keepdim: bool = False):
    """``||x1 − x2 + eps||_p`` over the last axis."""
    proto = _proto(x1, x2)
    v1, v2 = _whole(x1), _whole(x2)
    out = torch.sum(torch.abs(v1 - v2 + eps) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)
    if proto is None:
        return out
    s = proto.split
    return wrap_global(out, proto, s if s is not None and s < proto.ndim - 1 else None)


# ---------------------------------------------------------------------- losses
def _reduce(per: torch.Tensor, reduction: str, proto: Optional[DNDarray], split, gshape, weight_sum=None):
    """The losses' reduction: a global mean (over ``weight_sum`` where given) or sum as a
    0-dim tensor, or the per-element losses as a DNDarray like ``proto``."""
    comm = proto.comm if proto is not None and split is not None and proto.is_distributed() else None
    if reduction in ("mean", "sum"):
        total = torch.sum(per)
        den = torch.sum(weight_sum) if weight_sum is not None else torch.tensor(float(per.numel()), device=per.device)
        if comm is not None:
            both = comm.all_reduce(torch.stack([total, den.to(total.dtype)]))
            total, den = both[0], both[1]
        if reduction == "sum":
            return total
        return total / den if weight_sum is not None else total / den.to(total.dtype)
    if proto is None:
        return per
    if comm is not None:
        return wrap_result(per, proto, split, gshape)
    return wrap_global(per, proto, split)


def _pointwise_loss(pred, target, loss_fn, reduction, *extras):
    """An elementwise loss: computed on this rank's chunk of a split prediction (the
    target and elementwise extras sliced to match), else whole; 'none' keeps the split."""
    proto = _proto(pred, target)
    if proto is not None and proto.is_distributed():
        s = proto.split
        per = loss_fn(_like(pred, proto, s), _like(target, proto, s), *(_like(e, proto, s) for e in extras))
        return _reduce(per, reduction, proto, s, proto.gshape)
    per = loss_fn(_whole(pred), _whole(target), *(_whole(e) for e in extras))
    return _reduce(per, reduction, proto, None if proto is None else proto.split, None)


def mse_loss(pred, target, reduction: str = "mean"):
    return _pointwise_loss(pred, target, lambda p, t: (p - t) ** 2, reduction)


def l1_loss(pred, target, reduction: str = "mean"):
    return _pointwise_loss(pred, target, lambda p, t: torch.abs(p - t), reduction)


def smooth_l1_loss(pred, target, reduction: str = "mean", beta: float = 1.0):
    """Quadratic below ``beta``, linear above; ``beta = 0`` is L1."""

    def fn(p, t):
        d = torch.abs(p - t)
        return d if beta == 0.0 else torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)

    return _pointwise_loss(pred, target, fn, reduction)


def huber_loss(pred, target, reduction: str = "mean", delta: float = 1.0):
    def fn(p, t):
        d = torch.abs(p - t)
        return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))

    return _pointwise_loss(pred, target, fn, reduction)


def binary_cross_entropy(pred, target, weight=None, reduction: str = "mean"):
    """On probabilities, each log clamped at -100; ``weight`` scales each element."""

    def fn(p, t, w=None):
        lo = torch.clamp_min(torch.log(p), -100.0)
        l1 = torch.clamp_min(torch.log1p(-p), -100.0)
        loss = -(t * lo + (1.0 - t) * l1)
        return loss if w is None else loss * w

    return _pointwise_loss(pred, target, fn, reduction, weight)


def binary_cross_entropy_with_logits(pred, target, weight=None, reduction: str = "mean", pos_weight=None):
    """Sigmoid and BCE in one stable op; ``pos_weight`` scales the positive class."""

    def fn(z, t, w=None, pw=None):
        pos = t * TF.logsigmoid(z)
        loss = -((pos if pw is None else pw * pos) + (1.0 - t) * TF.logsigmoid(-z))
        return loss if w is None else loss * w

    return _pointwise_loss(pred, target, fn, reduction, weight, pos_weight)


def _class_losses(lp2: torch.Tensor, t: torch.Tensor, weight, ignore_index: int):
    """heat_tpu's ``_nll_core``: (picked log-probability, its class weight, kept) per row
    of the flattened (M, C) log-probabilities, ignored targets weighted 0."""
    keep = t != ignore_index
    safe = torch.where(keep, t, torch.zeros_like(t))
    picked = torch.gather(lp2, 1, safe[:, None])[:, 0]
    w = weight[safe] if weight is not None else torch.ones_like(picked)
    return picked, torch.where(keep, w, torch.zeros_like(w)), keep


def _flat_classes(x: torch.Tensor, target: torch.Tensor):
    """(M, C) rows of x (N, C) or (N, C, d1, ...) and the flat int targets."""
    t = target.long()
    x2 = torch.movedim(x, 1, -1).reshape(-1, x.shape[1]) if x.ndim > 2 else x
    return x2, t.reshape(-1)


def _class_loss(inp, target, weight, reduction, per_fn):
    """nll_loss/cross_entropy: rows of this rank's batch chunk on a batch split, else whole;
    the mean divides by the weights' global sum."""
    proto = _proto(inp, target)
    w = _p(weight)
    if proto is not None and proto.is_distributed() and proto.split == 0:
        x, t = _batch_rows(inp, proto), _batch_rows(target, proto)
        split, gshape = 0, (proto.gshape[0],) + tuple(t.shape[1:])
    else:
        x, t = _whole(inp), _whole(target)
        split, gshape = None if proto is None else _batch(proto.split), None
    per, ws = per_fn(x, t, w)
    if reduction == "mean":
        return _reduce(per, "mean", proto, split, gshape, weight_sum=ws)
    return _reduce(per.reshape(t.shape), reduction, proto, split, gshape)


def nll_loss(log_probs, target, weight=None, ignore_index: int = -100, reduction: str = "mean"):
    """Negative log likelihood (torch semantics: class ``weight``, ``ignore_index``,
    (N, C, d1, ...) inputs; the mean is over the kept targets' weights)."""

    def per_fn(x, t, w):
        lp2, tf = _flat_classes(x, t)
        picked, ws, _ = _class_losses(lp2, tf, w, ignore_index)
        return -picked * ws, ws

    return _class_loss(log_probs, target, weight, reduction, per_fn)


def cross_entropy(logits, target, weight=None, ignore_index: int = -100, reduction: str = "mean",
                  label_smoothing: float = 0.0):
    """Softmax cross-entropy on raw logits in f32 (torch semantics: ``weight``,
    ``ignore_index``, ``label_smoothing`` as (1 − ls)·onehot + ls/C, (N, C, d1, ...))."""

    def per_fn(x, t, w):
        lg2, tf = _flat_classes(x.float(), t)
        lp2 = torch.log_softmax(lg2, dim=-1)
        picked, ws, keep = _class_losses(lp2, tf, w, ignore_index)
        per = -picked * ws
        if label_smoothing:
            smooth = torch.sum(lp2 * (w if w is not None else 1.0), dim=-1) / lp2.shape[-1]
            per = (1.0 - label_smoothing) * per - label_smoothing * torch.where(keep, smooth, torch.zeros_like(smooth))
        return per, ws

    return _class_loss(logits, target, weight, reduction, per_fn)


def __getattr__(name: str):
    """``scaled_dot_product_attention`` lives with the ring and flash dispatch in
    :mod:`.attention`; torch exposes it under ``nn.functional``, and so does heat_tpu. It is
    looked up at first use, as :mod:`.attention` imports this module."""
    if name == "scaled_dot_product_attention":
        from .attention import scaled_dot_product_attention

        return scaled_dot_product_attention
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
