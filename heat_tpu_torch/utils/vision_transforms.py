"""Image transforms (counterpart of heat_tpu/utils/vision_transforms.py; the reference's
heat/utils/vision_transforms.py passes through to torchvision).

The common transforms in plain torch ops, without torchvision, over channel-first values:
HW images, CHW images or NCHW batches; numpy arrays, tensors or DNDarrays (a DNDarray
comes back a DNDarray, its split kept). Each is a callable object, alone or inside
:class:`Compose`. The random transforms draw from heat_tpu's key stream: an explicit
``key`` (heat_tpu's PRNG key as its two uint32 words, ``jax.random.key_data``) or the
module's seeded stream (:func:`seed`), through the port's Threefry
(``heat_tpu_torch.core.random``), so the flips and crops are heat_tpu's under the same
seeds. A batch split along its sample axis is transformed rank by rank, each rank
drawing its chunk of the per-sample draws; any other split works on the gathered value.
"""

from __future__ import annotations

import inspect
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import random as _random
from ..core import types
from ..core.devices import get_device
from ..core.dndarray import DNDarray

__all__ = [
    "Compose",
    "ToTensor",
    "Normalize",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "RandomCrop",
    "CenterCrop",
    "Resize",
    "Lambda",
    "seed",
]

_state = {"key": _random._key(0)}


def seed(value: int) -> None:
    """Seed the stream of the random transforms called without a key (heat_tpu's
    ``jax.random.key(value)``)."""
    _state["key"] = _random._key(value)


def _words(key) -> Tuple[int, int]:
    """heat_tpu's PRNG key as its two uint32 words."""
    words = [int(w) for w in (key.tolist() if hasattr(key, "tolist") else key)]
    if len(words) != 2:
        raise ValueError(f"a PRNG key is two uint32 words (jax.random.key_data), got {key!r}")
    return words[0] & _random.M32, words[1] & _random.M32


def _next_key(key) -> Tuple[int, int]:
    if key is not None:
        return _words(key)
    _state["key"], sub = _random._split(_state["key"])
    return sub


class _Value:
    """A transform's operand: the tensor it works on, and how to give the result back.
    A DNDarray unsplit, or split along the sample axis of an NCHW batch, is worked on
    rank by rank (``local``); another split is gathered and the result chunked again."""

    def __init__(self, x):
        self.proto = x if isinstance(x, DNDarray) else None
        if self.proto is None:
            self.v = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), device=get_device().torch_device)
            self.local = True
        else:
            self.local = x.split is None or (x.ndim == 4 and x.split == 0)
            self.v = x.larray if self.local else x._global()

    def draw_split(self) -> Optional[int]:
        """The split of the per-sample draws: this rank's chunk of them when it holds a
        chunk of the samples."""
        return 0 if self.proto is not None and self.local and self.proto.split == 0 else None

    def wrap(self, value: torch.Tensor):
        p = self.proto
        if p is None:
            return value
        dtype = types.canonical_heat_type(value.dtype)
        split = p.split if p.split is not None and p.split < value.ndim else None
        if self.local:
            gshape = list(value.shape)
            if split is not None:
                gshape[split] = p.gshape[split]
            return DNDarray(value, tuple(gshape), dtype, split, p.device, p.comm, True)
        _, _, slices = p.comm.chunk(value.shape, split)
        return DNDarray(value[slices].contiguous(), tuple(value.shape), dtype, split, p.device, p.comm, True)


def _spatial_axes(ndim: int) -> Tuple[int, int]:
    """(H, W) axes for 2-D images, 3-D CHW or 4-D NCHW values."""
    if ndim == 2:
        return 0, 1
    if ndim == 3:
        return 1, 2
    if ndim == 4:
        return 2, 3
    raise ValueError(f"expected a 2-D/3-D/4-D image value, got {ndim}-D")


def _accepts_key(transform) -> bool:
    try:
        return "key" in inspect.signature(transform).parameters
    except (TypeError, ValueError):
        return False


class Compose:
    """Chain transforms (torchvision.transforms.Compose semantics); a ``key`` is split
    into one for each transform, as heat_tpu's."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)
        # random transforms take key=, the others do not (decided once by signature)
        self._takes_key = [_accepts_key(t) for t in self.transforms]

    def __call__(self, x, key=None):
        keys = _random._split(_words(key), len(self.transforms)) if key is not None else [None] * len(self.transforms)
        for t, k, takes_key in zip(self.transforms, keys, self._takes_key):
            x = t(x, key=k) if takes_key else t(x)
        return x

    def __repr__(self) -> str:
        return f"Compose([{', '.join(repr(t) for t in self.transforms)}])"


class ToTensor:
    """uint8 [0, 255] → float32 [0, 1] (torchvision.ToTensor without its HWC→CHW move;
    arrays keep their layout)."""

    def __call__(self, x):
        op = _Value(x)
        v = op.v
        v = v.to(torch.float32) / 255.0 if not (v.is_floating_point() or v.is_complex()) else v.to(torch.float32)
        return op.wrap(v)

    def __repr__(self) -> str:
        return "ToTensor()"


class Normalize:
    """Channel-wise (x - mean) / std, the channel axis the last-but-two of ≥3-D values
    (CHW, NCHW), as torchvision's."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, x):
        op = _Value(x)
        v = op.v
        shape = self.mean.shape if v.ndim < 3 else (-1, 1, 1)
        mean = torch.as_tensor(self.mean.reshape(shape), device=v.device)
        std = torch.as_tensor(self.std.reshape(shape), device=v.device)
        return op.wrap((v - mean) / std)

    def __repr__(self) -> str:
        return f"Normalize(mean={self.mean.tolist()}, std={self.std.tolist()})"


def _flip_draw(op: _Value, key, p: float) -> torch.Tensor:
    """heat_tpu's ``jax.random.bernoulli(key, p, shape)``: float64 uniforms below ``p``
    (x64: a Python float is float64), one a sample of a 4-D batch, else one."""
    v = op.v
    if v.ndim == 4:
        n = op.proto.gshape[0] if op.proto is not None else v.shape[0]
        shape = (n, 1, 1, 1)
    else:
        shape = ()
    comm = op.proto.comm if op.proto is not None else None
    u = _random._uniform01(_next_key(key), shape, types.float64, op.draw_split(), _random.sanitize_comm(comm), v.device)
    return u < p


class RandomHorizontalFlip:
    """Flip along W with probability p, a decision a sample for 4-D batches."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def _axis(self, ndim: int) -> int:
        return _spatial_axes(ndim)[1]

    def __call__(self, x, key=None):
        op = _Value(x)
        flip = _flip_draw(op, key, self.p)
        return op.wrap(torch.where(flip, torch.flip(op.v, dims=(self._axis(op.v.ndim),)), op.v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(p={self.p})"


class RandomVerticalFlip(RandomHorizontalFlip):
    """Flip along H with probability p, a decision a sample for 4-D batches."""

    def _axis(self, ndim: int) -> int:
        return _spatial_axes(ndim)[0]


class RandomCrop:
    """Crop to ``size`` at a uniform offset, the same for every sample of a batch, after
    an optional zero ``padding`` of H and W."""

    def __init__(self, size: Union[int, Tuple[int, int]], padding: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = int(padding)

    def __call__(self, x, key=None):
        op = _Value(x)
        v = op.v
        k = _next_key(key)
        h_ax, w_ax = _spatial_axes(v.ndim)
        if self.padding:
            pads = [0, 0] * v.ndim  # torch's pad lists the last axis first
            for ax in (h_ax, w_ax):
                pads[2 * (v.ndim - 1 - ax)] = pads[2 * (v.ndim - 1 - ax) + 1] = self.padding
            v = torch.nn.functional.pad(v, pads)
        th, tw = self.size
        kh, kw = _random._split(k)
        oh = int(_random._key_randint(kh, (), 0, v.shape[h_ax] - th + 1))
        ow = int(_random._key_randint(kw, (), 0, v.shape[w_ax] - tw + 1))
        return op.wrap(v.narrow(h_ax, oh, th).narrow(w_ax, ow, tw))

    def __repr__(self) -> str:
        return f"RandomCrop(size={self.size}, padding={self.padding})"


class CenterCrop:
    def __init__(self, size: Union[int, Tuple[int, int]]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        op = _Value(x)
        v = op.v
        h_ax, w_ax = _spatial_axes(v.ndim)
        th, tw = self.size
        oh = (v.shape[h_ax] - th) // 2
        ow = (v.shape[w_ax] - tw) // 2
        return op.wrap(v.narrow(h_ax, oh, th).narrow(w_ax, ow, tw))

    def __repr__(self) -> str:
        return f"CenterCrop(size={self.size})"


def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) weights of ``jax.image.resize(..., "bilinear")`` along one axis: the
    triangle kernel, widened by the downscale factor (antialiasing), normalized, zero for
    samples outside the input; computed in float64 as heat_tpu's x64 does."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0)


class Resize:
    """Bilinear resize of the spatial axes (torchvision.Resize with an (h, w) size),
    heat_tpu's ``jax.image.resize`` weights, computed in float32."""

    def __init__(self, size: Union[int, Tuple[int, int]]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, x):
        op = _Value(x)
        v = op.v
        out = v.to(torch.float32)
        for ax, n in zip(_spatial_axes(v.ndim), self.size):
            if out.shape[ax] == n:
                continue  # an identity along this axis
            w = torch.as_tensor(_bilinear_weights(out.shape[ax], n), dtype=torch.float32, device=v.device)
            out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
        return op.wrap(out.to(v.dtype) if v.is_floating_point() else out)

    def __repr__(self) -> str:
        return f"Resize(size={self.size})"


class Lambda:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x):
        return self.fn(x)

    def __repr__(self) -> str:
        return f"Lambda({getattr(self.fn, '__name__', 'fn')})"
