"""Array factories (counterpart of heat_tpu/core/factories.py).

Each factory makes only this rank's chunk: a constant fill allocates the local shape
directly, and a global source (numpy data, a tensor, ``arange``) is cut to the local chunk
before it moves to the device. Default dtypes are heat_tpu's: ``arange`` over Python
ints is int32, Python floats are float32, Python ints in data are int64, and float64
numpy data stays float64.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from . import types
from .communication import sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray
from .stride_tricks import sanitize_axis, sanitize_shape

__all__ = [
    "arange",
    "array",
    "asarray",
    "empty",
    "empty_like",
    "eye",
    "from_partitioned",
    "from_partition_dict",
    "full",
    "full_like",
    "linspace",
    "logspace",
    "meshgrid",
    "ones",
    "ones_like",
    "zeros",
    "zeros_like",
]


def _from_global(value: torch.Tensor, dtype, split, device, comm) -> DNDarray:
    """Wrap a global tensor: keep this rank's chunk along ``split``, cast, and move it
    to ``device``."""
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    dtype = types.canonical_heat_type(dtype if dtype is not None else value.dtype)
    split = sanitize_axis(tuple(value.shape), split)
    gshape = tuple(value.shape)
    _, _, slices = comm.chunk(gshape, split)
    local = value[slices] if split is not None else value
    local = local.to(device=device.torch_device, dtype=dtype.torch_type()).contiguous()
    return DNDarray(local, gshape, dtype, split, device, comm, True)


def arange(*args, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """``arange(stop)`` / ``arange(start, stop[, step])``."""
    num_args = len(args)
    if num_args == 1:
        start, stop, step = 0, args[0], 1
    elif num_args == 2:
        start, stop, step = args[0], args[1], 1
    elif num_args == 3:
        start, stop, step = args
    else:
        raise TypeError(f"function takes minimum one and at most 3 positional arguments ({num_args} given)")
    if dtype is None:
        # heat_tpu: all-int arguments give int32, anything else the default float
        ints = all(isinstance(a, (int, np.integer)) for a in (start, stop, step))
        dtype = types.int32 if ints else types.float32
    # computed in float64/int64 and cast, so the values match numpy's arange
    work = torch.int64 if types.heat_type_is_exact(dtype) else torch.float64
    value = torch.arange(start, stop, step, dtype=work)
    return _from_global(value, dtype, split, device, comm)


def _torch_from_numpy(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def array(
    obj: Any,
    dtype=None,
    copy: Optional[bool] = None,
    ndmin: int = 0,
    order: str = "C",
    split: Optional[int] = None,
    is_split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Central array ingest: nested sequences, numpy arrays, torch tensors and
    DNDarrays. ``split`` chunks a global source over the ranks; ``is_split`` declares
    ``obj`` to be this rank's chunk along that axis, and the global shape is gathered
    from every rank's chunk."""
    if split is not None and is_split is not None:
        raise ValueError(f"split and is_split are mutually exclusive, got {split}, {is_split}")
    if order not in ("C", "K"):
        raise NotImplementedError("only row-major memory layout is supported")

    if isinstance(obj, DNDarray):
        comm = comm or obj.comm
        device = device or obj.device
        if split is None and is_split is None:
            split = obj.split
        value = obj._global()
    elif isinstance(obj, torch.Tensor):
        value = obj.detach()
    else:
        np_value = np.asarray(obj)
        if dtype is None and np_value.dtype == np.float64 and not isinstance(obj, (np.ndarray, np.generic)):
            # Python floats default to the framework float type (f32), as in heat_tpu
            np_value = np_value.astype(np.float32)
        value = _torch_from_numpy(np_value)
    while value.ndim < ndmin:
        value = value.unsqueeze(0)

    if is_split is None:
        return _from_global(value, dtype, split, device, comm)

    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    is_split = sanitize_axis(tuple(value.shape), is_split)
    dtype = types.canonical_heat_type(dtype if dtype is not None else value.dtype)
    local = value.to(device=device.torch_device, dtype=dtype.torch_type()).contiguous()
    extents = comm.all_gather_stacked(torch.tensor(local.shape, dtype=torch.int64, device=local.device)).cpu()
    for d in range(local.ndim):
        if d != is_split and not bool((extents[:, d] == local.shape[d]).all()):
            raise ValueError(f"is_split chunks disagree on non-split dim {d}: {extents[:, d].tolist()}")
    gshape = list(local.shape)
    gshape[is_split] = int(extents[:, is_split].sum())
    counts = extents[:, is_split].tolist()
    canonical = comm.lshape_map(gshape, is_split)[:, is_split].tolist()
    if counts != canonical:  # other chunks than the canonical ones: rebalance
        local = comm.redistribute(local, gshape, is_split, counts, canonical)
    return DNDarray(local, tuple(gshape), dtype, is_split, device, comm, True)


def asarray(obj, dtype=None, copy=None, order="C", is_split=None, device=None) -> DNDarray:
    """``obj`` as a DNDarray, the object itself when it is one already of that type and
    device."""
    if (
        is_split is None
        and copy is not True
        and isinstance(obj, DNDarray)
        and (dtype is None or obj.dtype is types.canonical_heat_type(dtype))
        and (device is None or obj.device == sanitize_device(device))
    ):
        return obj
    return array(obj, dtype=dtype, copy=copy, order=order, is_split=is_split, device=device)


def eye(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """A 2-D array with ones on the diagonal; each rank fills its own chunk."""
    if isinstance(shape, (int, np.integer)):
        n = m = int(shape)
    else:
        shape = tuple(shape)
        n, m = (int(shape[0]),) * 2 if len(shape) == 1 else (int(shape[0]), int(shape[1]))
    out = zeros((n, m), dtype=dtype, split=split, device=device, comm=comm)
    return out.fill_diagonal(1)


def _linspace(start: float, stop: float, num: int, endpoint: bool, dtype: torch.dtype) -> torch.Tensor:
    """jnp.linspace's values: ``start·(1 − t) + stop·t`` for ``t = i/div`` in ``dtype``, and
    ``stop`` itself last when ``endpoint``."""
    div = (num - 1) if endpoint else num
    if num <= 1:
        return torch.full((num,), start, dtype=dtype)
    step = torch.arange(div, dtype=dtype) / div
    out = torch.tensor(start, dtype=dtype) * (1 - step) + torch.tensor(stop, dtype=dtype) * step
    return torch.cat([out, torch.tensor([stop], dtype=dtype)]) if endpoint else out


def linspace(start, stop, num: int = 50, endpoint: bool = True, retstep: bool = False, dtype=None,
             split=None, device=None, comm=None):
    """Evenly spaced samples, heat_tpu's: computed in float64 and, without ``dtype``,
    given as float32."""
    num = int(num)
    if num < 0:
        raise ValueError(f"number of samples 'num' must be non-negative, got {num}")
    step = (stop - start) / max(1, num - (1 if endpoint else 0))
    value = _linspace(float(start), float(stop), num, endpoint, torch.float64)
    out = _from_global(value, types.float32 if dtype is None else dtype, split, device, comm)
    return (out, step) if retstep else out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None, split=None, device=None, comm=None) -> DNDarray:
    """Log-spaced samples ``base ** linspace(start, stop)``, computed in float64."""
    value = torch.pow(float(base), _linspace(float(start), float(stop), int(num), endpoint, torch.float64))
    return _from_global(value, types.float32 if dtype is None else dtype, split, device, comm)


def meshgrid(*arrays, indexing: str = "xy"):
    """Coordinate matrices from coordinate vectors; the output is split along the axis
    that carried a split input ('xy' swaps the first two). The vectors are gathered: each
    is whole along its axis of every output."""
    if indexing not in ("xy", "ij"):
        raise ValueError(f"indexing must be 'xy' or 'ij', got {indexing}")
    arrs = [asarray(a) for a in arrays]
    split_in = next((i for i, a in enumerate(arrs) if a.split is not None), None)
    out_split = None
    if split_in is not None and len(arrs) > 1:
        out_split = {0: 1, 1: 0}.get(split_in, split_in) if indexing == "xy" else split_in
    values = torch.meshgrid(*[a._relayout(None) for a in arrs], indexing=indexing)
    return [_from_global(v, v.dtype, out_split, arrs[0].device, arrs[0].comm) for v in values]


def __factory(shape, dtype, split, fill, device, comm) -> DNDarray:
    """Shared logic of empty/ones/zeros/full: allocate the local chunk only."""
    shape = sanitize_shape(shape)
    dtype = types.canonical_heat_type(dtype)
    device = sanitize_device(device)
    comm = sanitize_comm(comm)
    split = sanitize_axis(shape, split)
    _, lshape, _ = comm.chunk(shape, split)
    local = torch.full(lshape, fill, dtype=dtype.torch_type(), device=device.torch_device)
    return DNDarray(local, shape, dtype, split, device, comm, True)


def empty(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """An array of ``shape``; zero-filled, as heat_tpu's is."""
    return __factory(shape, dtype, split, 0, device, comm)


def zeros(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Zeros."""
    return __factory(shape, dtype, split, 0, device, comm)


def ones(shape, dtype=types.float32, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Ones."""
    return __factory(shape, dtype, split, 1, device, comm)


def full(shape, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """Constant fill. Without ``dtype``, the type of ``fill_value``: int64 for ints,
    float32 for Python floats, as in heat_tpu."""
    if dtype is None:
        dt = np.result_type(fill_value)
        if dt == np.float64 and isinstance(fill_value, float):
            dt = np.float32
        dtype = types.canonical_heat_type(dt)
    return __factory(shape, dtype, split, fill_value, device, comm)


def __factory_like(a, dtype, split, factory, device, comm) -> DNDarray:
    """Shared logic of the *_like factories."""
    shape = a.shape if isinstance(a, (DNDarray, np.ndarray, torch.Tensor)) else np.asarray(a).shape
    if dtype is None:
        try:
            dtype = types.heat_type_of(a)
        except TypeError:
            dtype = types.float32
    if split is None and isinstance(a, DNDarray):
        split = a.split
    if device is None and isinstance(a, DNDarray):
        device = a.device
    if comm is None and isinstance(a, DNDarray):
        comm = a.comm
    return factory(tuple(shape), dtype=dtype, split=split, device=device, comm=comm)


def empty_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return __factory_like(a, dtype, split, empty, device, comm)


def zeros_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return __factory_like(a, dtype, split, zeros, device, comm)


def ones_like(a, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    return __factory_like(a, dtype, split, ones, device, comm)


def full_like(a, fill_value, dtype=None, split=None, device=None, comm=None, order="C") -> DNDarray:
    """As heat_tpu's: without ``dtype`` the type comes from ``fill_value``, not ``a``."""
    shape = a.shape if isinstance(a, (DNDarray, np.ndarray, torch.Tensor)) else np.asarray(a).shape
    if isinstance(a, DNDarray):
        split = a.split if split is None else split
        device = device or a.device
        comm = comm or a.comm
    return full(tuple(shape), fill_value, dtype=dtype, split=split, device=device, comm=comm)


def from_partitioned(x, comm=None, device=None) -> DNDarray:
    """A DNDarray from an object with ``__partitioned__`` (or that dict itself)."""
    parted = x if isinstance(x, dict) else x.__partitioned__
    return from_partition_dict(parted, comm=comm, device=device)


def from_partition_dict(parted: dict, comm=None, device=None) -> DNDarray:
    """A DNDarray from a ``__partitioned__`` dict: split along the one axis the
    partition grid divides (none: every rank holds the whole). Each rank takes the
    partitions located on it that carry data, joined in the order of their starts, and
    the chunks are rebalanced to the canonical ones (:func:`array`'s ``is_split``)."""
    comm = sanitize_comm(comm)
    shape = tuple(parted["shape"])
    get = parted.get("get", lambda v: v)
    tiling = tuple(parted.get("partition_tiling", (1,) * len(shape)))
    split_dims = [i for i, t in enumerate(tiling) if t > 1]
    if len(split_dims) > 1:
        raise ValueError(f"Only one split-dimension allowed, got {len(split_dims)}")
    split = split_dims[0] if split_dims else None
    parts = sorted(parted["partitions"].values(), key=lambda p: tuple(p["start"]))

    def tensor(v) -> torch.Tensor:
        return v if isinstance(v, torch.Tensor) else _torch_from_numpy(np.asarray(v))

    if split is None:
        res = array(tensor(get(next(p["data"] for p in parts if p["data"] is not None))), device=device, comm=comm)
    else:
        mine = [tensor(get(p["data"])) for p in parts if p["data"] is not None and comm.rank in p["location"]]
        if mine:
            local = torch.cat(mine, dim=split)
        else:
            empty = tuple(0 if i == split else n for i, n in enumerate(shape))
            local = _torch_from_numpy(np.empty(empty, dtype=parts[0]["dtype"]))
        res = array(local, is_split=split, device=device, comm=comm)
    if res.gshape != shape:
        raise ValueError(f"partitioned data of shape {res.gshape} does not match declared {shape}")
    return res
