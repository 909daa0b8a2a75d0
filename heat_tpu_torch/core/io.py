"""Parallel I/O (counterpart of heat_tpu/core/io.py; the reference's heat/core/io.py).

Each rank reads and writes only its own slab: the hyperslab of its chunk by the
ceil-division rule of :meth:`TorchCommunication.chunk`, as the reference's loaders do
(``io.py:211-238``). heat_tpu assembles XLA's sharded array from per-shard callbacks;
here a rank's slab becomes its local tensor directly, on the device asked for.

- HDF5 (h5py) and zarr (tensorstore) read and write per-rank slabs. A split HDF5 save at
  several ranks creates the dataset on rank 0 and then writes rank by rank, one barrier
  a round (heat_tpu's ``_serialized_shard_write``, the reference's token ring); a zarr
  store is chunked on the split grid, so the ranks write their chunks together.
- CSV is indexed by a binary newline scan and each rank parses only the byte range of
  its rows at ``split=0``; NPY reads through a memory map, each rank copying its slab.
- NetCDF sits behind :func:`supports_netcdf`, as in heat_tpu.

Whole-file writes (``mode="w"`` HDF5, CSV, NPY) go through ``resilience.atomic_write``
(temp file, fsync, rename, retried under the site's policy). In-place writes (HDF5
``"a"``/``"r+"``, NetCDF) are not idempotent, so they run single-attempt unless an
operator registers a site policy (:func:`_guarded_write`). Files that only rank 0 writes
(CSV, NPY, unsplit arrays) are gathered to it, and every rank leaves the call after the
file is on disk.

The import gates are heat_tpu's: h5py, netCDF4 and tensorstore are optional, and the
functions that need one exist only when it imports.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import resilience, types
from .communication import TorchCommunication, sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray, _numpy_dtype

__all__ = [
    "load",
    "load_csv",
    "load_npy",
    "save_csv",
    "save_npy",
    "save",
    "supports_hdf5",
    "supports_netcdf",
    "supports_zarr",
]

# In-place writes are not idempotent: a half-applied attempt followed by a blind replay
# would duplicate appends or trip over the already-created dataset, masking the real
# error. They run single-attempt by default (injected faults still fire and surface), and
# an operator may opt a site into retries with resilience.set_policy.
_SINGLE_ATTEMPT = resilience.Policy(max_attempts=1)


def _guarded_write(site: str, fn, *args, **kwargs):
    """Run an in-place file write under ht.resilience when a fault plan is armed or a site
    policy is registered (one attribute read when idle)."""
    if resilience._active:
        policy = resilience.site_policy(site) or _SINGLE_ATTEMPT
        return resilience.guard(site, fn, *args, policy=policy, **kwargs)
    return fn(*args, **kwargs)


try:
    import h5py

    _HAS_HDF5 = True
except ImportError:
    _HAS_HDF5 = False

try:
    import netCDF4 as nc

    _HAS_NETCDF = True
except ImportError:
    _HAS_NETCDF = False

try:
    import tensorstore as _ts

    _HAS_ZARR = True
except ImportError:
    _HAS_ZARR = False

_VALID_WRITE_MODES = frozenset(["w", "a", "r+"])


def supports_hdf5() -> bool:
    """True if HDF5 I/O is available (reference ``io.py:36``)."""
    return _HAS_HDF5


def supports_netcdf() -> bool:
    """True if NetCDF I/O is available (reference ``io.py:50``)."""
    return _HAS_NETCDF


def supports_zarr() -> bool:
    """True if the tensorstore-backed zarr path is available."""
    return _HAS_ZARR


# ------------------------------------------------------------------ helpers
def _np_dtype(dtype) -> np.dtype:
    """numpy's dtype of a heat type (``ml_dtypes.bfloat16`` for bfloat16)."""
    return _numpy_dtype(types.canonical_heat_type(dtype).torch_type())


def _host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (bfloat16 as ``ml_dtypes.bfloat16``)."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_numpy_dtype(torch.bfloat16))
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A host slab as a tensor of ``dtype`` on ``device``, copied there once."""
    t = types.canonical_heat_type(dtype).torch_type()
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # a read-only buffer (a file map) is only read here: copied to the device, or cloned
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        host = torch.from_numpy(arr.view(np.int16) if arr.dtype.name == "bfloat16" else arr)
    if arr.dtype.name == "bfloat16":
        host = host.view(torch.bfloat16)
    out = host.to(device=device.torch_device, dtype=t)
    # on the CPU the tensor may still be the numpy buffer: own it
    return out.clone() if out.data_ptr() == host.data_ptr() else out


def _local_slab(read, gshape, split, comm: TorchCommunication, dtype, device) -> DNDarray:
    """The DNDarray whose every rank holds ``read(slices)`` of its own chunk: the
    per-rank hyperslab read of the reference (``io.py:211-238``)."""
    gshape = tuple(int(s) for s in gshape)
    if split is not None:
        split = split % len(gshape)
    _, lshape, slices = comm.chunk(gshape, split)
    if 0 in lshape:
        arr = np.zeros(lshape, _np_dtype(dtype))
    else:
        arr = np.asarray(read(slices)).astype(_np_dtype(dtype), copy=False).reshape(lshape)
    dtype = types.canonical_heat_type(dtype)
    return DNDarray(_to_tensor(arr, dtype, device), gshape, dtype, split, device, comm, True)


def _is_writer(comm: TorchCommunication) -> bool:
    """Rank 0 creates files and writes the ones that cannot take per-rank slabs."""
    return comm.rank == 0


def _serialized_shard_write(comm: TorchCommunication, write_my_shards) -> None:
    """Each rank writes its shards, one rank at a time (the reference's ``io.py:231-238``:
    receive from the previous rank, write, send to the next; here a barrier a round).
    Host memory per rank stays its own chunk; nothing is gathered."""
    for p in range(comm.size):
        if comm.rank == p:
            write_my_shards()
        comm.barrier()


if _HAS_ZARR:
    __all__.extend(["load_zarr", "save_zarr"])

    def _zarr_spec(path: str) -> dict:
        return {"driver": "zarr", "kvstore": {"driver": "file", "path": os.path.abspath(path)}}

    def save_zarr(data: DNDarray, path: str) -> None:
        """Write a DNDarray to a zarr store chunked on the split grid: rank 0 creates the
        store, then every rank writes its own chunk (chunk-aligned writes need no lock)."""
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, not {type(data)}")
        comm = data.comm
        np_dtype = _np_dtype(data.dtype)
        # the chunk shape is rank 0's canonical chunk, the same on every rank
        _, lshape, _ = comm.chunk(data.gshape, data.split, rank=0)
        chunk_shape = [max(1, int(s)) for s in lshape]
        if data.split is None:
            if _is_writer(comm):
                store = _ts.open(
                    _zarr_spec(path), create=True, delete_existing=True, dtype=_ts.dtype(np_dtype),
                    shape=list(data.gshape), chunk_layout=_ts.ChunkLayout(chunk_shape=chunk_shape),
                ).result()
                store[...] = _host(data.larray)
            comm.barrier()
            return
        if _is_writer(comm):
            _ts.open(
                _zarr_spec(path), create=True, delete_existing=True, dtype=_ts.dtype(np_dtype),
                shape=list(data.gshape), chunk_layout=_ts.ChunkLayout(chunk_shape=chunk_shape),
            ).result()
        comm.barrier()
        store = _ts.open(_zarr_spec(path)).result()
        for index, value in data.iter_shards():
            store[index].write(_host(value)).result()
        comm.barrier()

    def load_zarr(path: str, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
        """Load a zarr store; each rank reads only its own chunk's slab."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        store = _ts.open(_zarr_spec(path)).result()
        gshape = tuple(store.shape)
        if dtype is None:
            dtype = types.canonical_heat_type(torch.from_numpy(np.empty(0, store.dtype.numpy_dtype)).dtype)
        return _local_slab(lambda sl: store[sl].read().result(), gshape, split, comm, dtype, device)


if _HAS_HDF5:
    __all__.extend(["load_hdf5", "save_hdf5"])

    def load_hdf5(
        path: str,
        dataset: str,
        dtype=types.float32,
        load_fraction: float = 1.0,
        split: Optional[int] = None,
        device=None,
        comm=None,
    ) -> DNDarray:
        """Load an HDF5 dataset (reference ``io.py:58``): every rank reads only the
        hyperslab of its chunk. ``load_fraction`` below 1 keeps that share of the rows
        at ``split=0``, as heat_tpu's."""
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(dataset, str):
            raise TypeError(f"dataset must be str, not {type(dataset)}")
        if not isinstance(load_fraction, float):
            raise TypeError(f"load_fraction must be float, not {type(load_fraction)}")
        if not 0.0 < load_fraction <= 1.0:
            raise ValueError(f"load_fraction must be in (0, 1], got {load_fraction}")
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        with h5py.File(path, "r") as handle:
            data = handle[dataset]
            gshape = tuple(data.shape)
            if load_fraction < 1.0 and split == 0:
                gshape = (int(gshape[0] * load_fraction),) + gshape[1:]
            return _local_slab(lambda sl: data[sl], gshape, split, comm, dtype, device)

    def save_hdf5(data: DNDarray, path: str, dataset: str, mode: str = "w", **kwargs) -> None:
        """Save to an HDF5 dataset (reference ``io.py:167-238``): per-rank hyperslab
        writes. At several ranks rank 0 creates the dataset in ``mode``, then the ranks
        write their slabs one at a time; the global array is never gathered. At one rank
        ``mode="w"`` writes the whole file atomically and ``"a"``/``"r+"`` in place."""
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, not {type(data)}")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if mode not in _VALID_WRITE_MODES:
            raise ValueError(f"mode was {mode}, not in possible modes {_VALID_WRITE_MODES}")
        comm = data.comm
        np_dtype = _np_dtype(data.dtype)
        if comm.is_distributed():
            if _is_writer(comm):

                def create() -> None:
                    with h5py.File(path, mode) as handle:
                        dset = handle.create_dataset(dataset, data.gshape, dtype=np_dtype, **kwargs)
                        if data.split is None:
                            dset[...] = _host(data.larray)

                _guarded_write("io.save_hdf5", create)
            comm.barrier()
            if data.split is None:
                return

            def write_my_shards() -> None:
                with h5py.File(path, "r+") as handle:
                    dset = handle[dataset]
                    for index, value in data.iter_shards():
                        dset[index] = _host(value)

            _serialized_shard_write(comm, write_my_shards)
            return

        def write_file(target_path: str, file_mode: str) -> None:
            with h5py.File(target_path, file_mode) as handle:
                dset = handle.create_dataset(dataset, data.gshape, dtype=np_dtype, **kwargs)
                dset[...] = _host(data.larray)

        if mode == "w":
            # assembled at a temp path and committed with one rename: a crashed or
            # injected-fault save never leaves a torn .h5 behind
            resilience.atomic_write(path, lambda tmp: write_file(tmp, "w"), site="io.save_hdf5")
        else:
            _guarded_write("io.save_hdf5", write_file, path, mode)


def _netcdf_has_fancy_keys(file_slices) -> bool:
    """True when ``file_slices`` holds anything but plain forward slices or Ellipsis:
    such keys take the whole-variable write path."""
    keys = file_slices if isinstance(file_slices, tuple) else (file_slices,)
    return any(not (k is Ellipsis or (isinstance(k, slice) and (k.step is None or k.step > 0))) for k in keys)


def _compose_netcdf_slices(file_slices, gshape, var_shape, unlimited):
    """Resolve ``file_slices`` into one ``range`` per variable dimension mapping data
    indices to file indices, or None when the keys cannot address the data per shard
    (fancy keys, extent mismatch, or overrun of a limited dimension). Unlimited
    dimensions may address past their current extent: that is the append."""
    nd = len(var_shape)
    if len(gshape) != nd:
        return None
    if not isinstance(file_slices, tuple):
        file_slices = (file_slices,)
    if Ellipsis in file_slices:
        i = file_slices.index(Ellipsis)
        fill = nd - (len(file_slices) - 1)
        file_slices = file_slices[:i] + (slice(None),) * fill + file_slices[i + 1 :]
    file_slices = file_slices + (slice(None),) * (nd - len(file_slices))
    if len(file_slices) != nd or _netcdf_has_fancy_keys(file_slices):
        return None
    ranges = []
    for d, (fs, vs) in enumerate(zip(file_slices, var_shape)):
        step = fs.step if fs.step is not None else 1
        start = fs.start if fs.start is not None else 0
        if start < 0:
            start += vs
        if fs.stop is None:
            # an omitted stop covers the data on an unlimited dimension (the append) and
            # the whole remaining extent on a limited one
            stop = start + step * gshape[d] if unlimited[d] else vs
        else:
            stop = fs.stop + vs if fs.stop < 0 else fs.stop
        rng = range(start, stop, step)
        if len(rng) != gshape[d]:
            return None
        if not unlimited[d] and rng and rng[-1] >= vs:
            return None
        ranges.append(rng)
    return ranges


if _HAS_NETCDF:
    __all__.extend(["load_netcdf", "save_netcdf"])

    def load_netcdf(path: str, variable: str, dtype=types.float32, split: Optional[int] = None, device=None,
                    comm=None) -> DNDarray:
        """Load a NetCDF variable (reference ``io.py:284``): every rank reads its slab."""
        comm = sanitize_comm(comm)
        device = sanitize_device(device)
        with nc.Dataset(path, "r") as handle:
            data = handle.variables[variable]
            return _local_slab(lambda sl: data[sl], tuple(data.shape), split, comm, dtype, device)

    def save_netcdf(data: DNDarray, path: str, variable: str, mode: str = "w", dimension_names=None,
                    is_unlimited: bool = False, file_slices=slice(None), **kwargs) -> None:
        """Save to a NetCDF variable (reference ``io.py:367-571``): rank 0 creates the
        variable, then each rank writes its slab through ``file_slices`` one at a time;
        fancy keys or a dimension-count mismatch take one whole-variable write on rank 0."""
        if not isinstance(data, DNDarray):
            raise TypeError(f"data must be a DNDarray, not {type(data)}")
        if not isinstance(path, str):
            raise TypeError(f"path must be str, not {type(path)}")
        if not isinstance(variable, str):
            raise TypeError(f"variable must be str, not {type(variable)}")
        if mode not in _VALID_WRITE_MODES:
            raise ValueError(f"mode was {mode}, not in possible modes {_VALID_WRITE_MODES}")
        if dimension_names is None:
            dimension_names = [f"{variable}_dim_{i}" for i in range(data.ndim)]
        elif isinstance(dimension_names, str):
            dimension_names = [dimension_names]
        elif isinstance(dimension_names, tuple):
            dimension_names = list(dimension_names)
        elif not isinstance(dimension_names, list):
            raise TypeError(f"dimension_names must be list or tuple or string, not {type(dimension_names)}")
        if len(dimension_names) != data.ndim:
            raise ValueError(f"{len(dimension_names)} names given for {data.ndim} dimensions")
        comm = data.comm
        np_dtype = _np_dtype(data.dtype)

        def ensure_variable(handle):
            if variable in handle.variables:
                return handle.variables[variable]
            for name, size in zip(dimension_names, data.gshape):
                if name not in handle.dimensions:
                    handle.createDimension(name, None if is_unlimited else size)
            return handle.createVariable(variable, np_dtype, tuple(dimension_names), **kwargs)

        whole = data.split is None or _netcdf_has_fancy_keys(file_slices)
        value = data.numpy() if whole else None  # a gather on every rank, before any round
        if _is_writer(comm):

            def create() -> None:
                with nc.Dataset(path, mode) as handle:
                    var = ensure_variable(handle)
                    if whole:
                        var[file_slices] = value

            _guarded_write("io.save_netcdf", create)
        comm.barrier()
        if whole:
            return
        with nc.Dataset(path, "r") as handle:
            var = handle.variables[variable]
            var_shape = tuple(var.shape)
            unlimited = [handle.dimensions[d].isunlimited() for d in var.dimensions]
        ranges = _compose_netcdf_slices(file_slices, data.gshape, var_shape, unlimited)
        if ranges is None:
            raise ValueError(
                f"file_slices {file_slices!r} do not address the data extent {data.gshape} within the variable's "
                "dimensions"
            )

        def write_my_shards() -> None:
            with nc.Dataset(path, "r+") as handle:
                var = handle.variables[variable]
                for index, shard in data.iter_shards():
                    key = tuple(slice(r[sl.start], r[sl.stop - 1] + r.step, r.step) for r, sl in zip(ranges, index))
                    var[key] = _host(shard)

        _serialized_shard_write(comm, lambda: _guarded_write("io.save_netcdf", write_my_shards))


def load_csv(
    path: str,
    header_lines: int = 0,
    sep: str = ",",
    dtype=types.float32,
    encoding: str = "utf-8",
    split: Optional[int] = None,
    device=None,
    comm=None,
) -> DNDarray:
    """Load a CSV file with byte-offset chunked parsing (reference ``io.py:723``).

    A binary newline scan over a memory map of the file indexes the row offsets (blank
    lines dropped, as ``np.genfromtxt`` does); at ``split=0`` each rank then decodes and
    parses only the byte range of its own rows, the dominant cost. Other splits parse
    every row and keep this rank's chunk."""
    import mmap

    if not isinstance(path, str):
        raise TypeError(f"path must be str, not {type(path)}")
    if not isinstance(sep, str):
        raise TypeError(f"separator must be str, not {type(sep)}")
    if not isinstance(header_lines, int):
        raise TypeError(f"header_lines must be int, not {type(header_lines)}")
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    dtype = types.canonical_heat_type(dtype)
    np_dtype = _np_dtype(dtype)

    with open(path, "rb") as fh:
        try:
            blob = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)  # outlives the closed file
        except ValueError:  # an empty file cannot be mapped
            blob = b""
    offsets = [0]
    pos = blob.find(b"\n")
    while pos != -1:
        offsets.append(pos + 1)
        pos = blob.find(b"\n", pos + 1)
    if offsets[-1] >= len(blob):  # a trailing newline leaves no final partial row
        offsets.pop()
    offsets.append(len(blob))
    row_starts, row_ends = [], []
    for s, e in zip(offsets[header_lines:-1], offsets[header_lines + 1 :]):
        if blob[s:e].strip():
            row_starts.append(s)
            row_ends.append(e)
    nrows = len(row_starts)
    if nrows == 0:
        return _local_slab(lambda sl: np.empty((0,), np_dtype), (0,), split, comm, dtype, device)

    def parse_rows(lo: int, hi: int) -> np.ndarray:
        chunk = blob[row_starts[lo] : row_ends[hi - 1]].decode(encoding)
        fields = [line.split(sep) for line in chunk.splitlines() if line.strip()]
        return np.asarray(fields, dtype=np_dtype)

    ncols = len(blob[row_starts[0] : row_ends[0]].decode(encoding).split(sep))
    gshape: Tuple[int, ...] = (nrows,) if ncols == 1 else (nrows, ncols)
    if split == 0:

        def read(sl):
            lo, hi = sl[0].start, sl[0].stop
            return parse_rows(lo, hi).reshape((hi - lo,) + gshape[1:])

        return _local_slab(read, gshape, split, comm, dtype, device)
    whole = parse_rows(0, nrows).reshape(gshape)
    return _local_slab(lambda sl: whole[sl], gshape, split, comm, dtype, device)


def save_csv(
    data: DNDarray,
    path: str,
    header_lines: Optional[List[str]] = None,
    sep: str = ",",
    decimals: int = -1,
    truncate: bool = True,
    **kwargs,
) -> None:
    """Save to CSV (reference ``io.py:949``): gathered to rank 0, which writes the file
    atomically; every rank returns once it is on disk."""
    if not isinstance(data, DNDarray):
        raise TypeError(f"data must be a DNDarray, not {type(data)}")
    if data.ndim > 2:
        raise ValueError("CSV can only store 1-D or 2-D arrays")
    arr = data.numpy()
    if _is_writer(data.comm):
        if decimals >= 0:
            fmt = f"%.{decimals}f"
        elif np.issubdtype(arr.dtype, np.integer):
            fmt = "%d"
        else:
            fmt = "%.18e"
        header = "\n".join(header_lines) if header_lines else ""
        resilience.atomic_write(
            path,
            lambda tmp: np.savetxt(tmp, arr.reshape(arr.shape[0], -1), delimiter=sep, fmt=fmt, header=header,
                                   comments=""),
            site="io.save_csv",
        )
    data.comm.barrier()


def load_npy(path: str, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Load a .npy file (reference ``load_npy_from_path`` ``io.py:612``) through a memory
    map: each rank copies only its own slab."""
    comm = sanitize_comm(comm)
    device = sanitize_device(device)
    arr = np.load(path, mmap_mode="r")
    if dtype is None:
        dtype = types.canonical_heat_type(torch.from_numpy(np.empty(0, arr.dtype)).dtype)
    return _local_slab(lambda sl: arr[sl], arr.shape, split, comm, dtype, device)


def save_npy(data: DNDarray, path: str) -> None:
    """Save to a .npy file: gathered to rank 0, written atomically (temp, fsync, rename,
    policy-retried); every rank returns once it is on disk."""
    arr = data.numpy()
    if _is_writer(data.comm):

        def write(tmp: str) -> None:
            # np.save(path) would append ".npy" to the temp name; an explicit handle
            # keeps the rename target exact
            with open(tmp, "wb") as fh:
                np.save(fh, arr)

        resilience.atomic_write(path, write, site="io.save_npy")
    data.comm.barrier()


def load(path: str, *args, **kwargs) -> DNDarray:
    """Load by file extension (reference ``io.py:672``)."""
    if not isinstance(path, str):
        raise TypeError(f"expected path to be str, but was {type(path)}")
    extension = os.path.splitext(path)[-1].strip().lower()
    if extension in (".h5", ".hdf5"):
        if not supports_hdf5():
            raise RuntimeError(f"hdf5 is required for file extension {extension}")
        return load_hdf5(path, *args, **kwargs)
    if extension in (".nc", ".nc4", ".netcdf"):
        if not supports_netcdf():
            raise RuntimeError(f"netcdf is required for file extension {extension}")
        return load_netcdf(path, *args, **kwargs)
    if extension in (".csv", ".txt"):
        return load_csv(path, *args, **kwargs)
    if extension == ".npy":
        return load_npy(path, *args, **kwargs)
    if extension == ".zarr":
        if not supports_zarr():
            raise RuntimeError(f"tensorstore is required for file extension {extension}")
        return load_zarr(path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {extension}")


def save(data: DNDarray, path: str, *args, **kwargs) -> None:
    """Save by file extension (reference ``io.py:1083``)."""
    if not isinstance(path, str):
        raise TypeError(f"expected path to be str, but was {type(path)}")
    extension = os.path.splitext(path)[-1].strip().lower()
    if extension in (".h5", ".hdf5"):
        if not supports_hdf5():
            raise RuntimeError(f"hdf5 is required for file extension {extension}")
        return save_hdf5(data, path, *args, **kwargs)
    if extension in (".nc", ".nc4", ".netcdf"):
        if not supports_netcdf():
            raise RuntimeError(f"netcdf is required for file extension {extension}")
        return save_netcdf(data, path, *args, **kwargs)
    if extension in (".csv", ".txt"):
        return save_csv(data, path, *args, **kwargs)
    if extension == ".npy":
        return save_npy(data, path)
    if extension == ".zarr":
        if not supports_zarr():
            raise RuntimeError(f"tensorstore is required for file extension {extension}")
        return save_zarr(data, path, *args, **kwargs)
    raise ValueError(f"unsupported file extension {extension}")
