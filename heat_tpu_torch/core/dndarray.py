"""DNDarray: a distributed n-D array as this rank's local ``torch.Tensor`` plus metadata.

Counterpart of heat_tpu/core/dndarray.py. There the payload is the *global* ``jax.Array``
laid out by XLA, with a padded physical layout for ragged extents. Here, as in the
original Heat, each rank holds only its chunk along ``split`` (``split=None``: every
rank holds the whole array), by the ceil-division chunk rule of
:meth:`TorchCommunication.chunk`. There is no padded layout: a ragged extent leaves the
trailing ranks with shorter, possibly empty, chunks.

Note that ``larray`` is the *local* tensor here but the global value in heat_tpu; compare
the two packages through :meth:`DNDarray.numpy`.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from . import _executor, types
from ._executor import Deferred
from .communication import TorchCommunication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray", "LocalIndex"]

Scalar = Union[int, float, bool, complex]


class LocalIndex:
    """Indexing of this rank's local tensor alone (``x.lloc[key]``, ``x.lloc[key] =
    value``), with torch's rules and no communication."""

    def __init__(self, obj: torch.Tensor):
        self.obj = obj

    def __getitem__(self, key):
        return self.obj[key]

    def __setitem__(self, key, value) -> None:
        self.obj[key] = value


class _CallableTuple(tuple):
    """A tuple that may also be called: ``x.stride`` (numpy's spelling) and
    ``x.stride()`` / ``x.stride(dim)`` (torch's) both work."""

    def __call__(self, dim: Optional[int] = None):
        return self if dim is None else self[dim]


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy's dtype of a torch dtype (``ml_dtypes.bfloat16`` for bfloat16)."""
    if dtype == torch.bfloat16:
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty(0, dtype=dtype).numpy().dtype


class DNDarray:
    """Distributed N-Dimensional array.

    Parameters
    ----------
    array : torch.Tensor
        This rank's local chunk.
    gshape : tuple of int
        Global shape.
    dtype : datatype
        Heat datatype class.
    split : int or None
        The distributed axis, or None for an array every rank holds whole.
    device : Device
        Where the local tensor lives.
    comm : TorchCommunication
        The communicator.
    balanced : bool
        Whether chunks follow the canonical chunk rule (always True here).
    """

    def __init__(
        self,
        array: torch.Tensor,
        gshape: Tuple[int, ...],
        dtype: type,
        split: Optional[int],
        device: Device,
        comm: TorchCommunication,
        balanced: Optional[bool] = True,
    ):
        self.__array = array
        self.__gshape = tuple(int(s) for s in gshape)
        self.__dtype = dtype
        self.__split = split
        self.__device = device
        self.__comm = comm
        self.__balanced = balanced
        self.__halo_prev = None
        self.__halo_next = None

    # ------------------------------------------------------------------ properties
    @property
    def larray(self) -> torch.Tensor:
        """This rank's local tensor — the one accessor every read of it goes
        through. A payload deferred by the dispatch executor (a pending fused-op
        graph node) is **forced** here: the reachable graph runs as one cached
        program (or its value was already memoised by an earlier force) and the
        concrete tensor replaces the node. Since a caller may write the tensor in
        place, every pending deferred read of its storage is settled first
        (``_executor.settle_readers``).

        Replacing the payload also ends this array's role in the executor's
        liveness registry: ``_executor.note_wrapped`` holds a weak reference to
        this DNDarray and the force path checks ``holder._payload is node``."""
        arr = self.__array
        if isinstance(arr, Deferred):
            arr = arr.force()
            self.__array = arr
        if _executor._readers:
            _executor.settle_readers(arr)
        return arr

    @property
    def _payload(self):
        """The raw payload WITHOUT forcing: a concrete ``torch.Tensor`` or a pending
        :class:`~._executor.Deferred` node. Only the dispatch layer reads this."""
        return self.__array

    @larray.setter
    def larray(self, array: torch.Tensor) -> None:
        if not isinstance(array, torch.Tensor):
            raise TypeError(f"larray must be a torch.Tensor, got {type(array)}")
        if tuple(array.shape) != self.lshape:
            raise ValueError(f"local tensor shape {tuple(array.shape)} does not match chunk shape {self.lshape}")
        self.__array = array
        self.__dtype = types.canonical_heat_type(array.dtype)

    @property
    def balanced(self) -> Optional[bool]:
        return self.__balanced

    @property
    def comm(self) -> TorchCommunication:
        return self.__comm

    @property
    def device(self) -> Device:
        return self.__device

    @property
    def dtype(self):
        return self.__dtype

    @property
    def gshape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.__gshape

    @property
    def ndim(self) -> int:
        return len(self.__gshape)

    @property
    def size(self) -> int:
        return int(np.prod(self.__gshape)) if self.__gshape else 1

    gnumel = size

    @property
    def lnumel(self) -> int:
        return self.__array.numel()  # a Deferred node knows its local size too

    @property
    def lshape(self) -> Tuple[int, ...]:
        """This rank's chunk shape under the canonical chunking."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        return lshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

    @property
    def nbytes(self) -> int:
        """Bytes of the global array (its elements times their size; no padding)."""
        return self.size * self.__array.dtype.itemsize

    gnbytes = nbytes

    @property
    def lnbytes(self) -> int:
        """Bytes of this rank's chunk."""
        return self.lnumel * self.__array.dtype.itemsize

    @property
    def stride(self) -> Tuple[int, ...]:
        """Row-major strides of the global array in elements (a callable tuple:
        ``x.stride`` and ``x.stride()`` both work)."""
        strides, acc = [], 1
        for s in reversed(self.__gshape):
            strides.append(acc)
            acc *= max(s, 1)
        return _CallableTuple(reversed(strides))

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major strides of the global array in bytes."""
        return tuple(s * self.__array.dtype.itemsize for s in self.stride)

    @property
    def real(self) -> "DNDarray":
        from .complex_math import real

        return real(self)

    @property
    def imag(self) -> "DNDarray":
        from .complex_math import imag

        return imag(self)

    @property
    def lloc(self) -> LocalIndex:
        """Get and set items of this rank's local tensor."""
        return LocalIndex(self.larray)

    @property
    def __partitioned__(self) -> dict:
        """The partition interface (:meth:`create_partition_interface`)."""
        return self.create_partition_interface()

    def create_partition_interface(self, no_data: bool = False) -> dict:
        """The ``__partitioned__`` dict: every rank's chunk by its position in the
        partition grid, with its start, shape, location and dtype; ``data`` is this rank's
        local tensor for its own chunk (None for the others', and with ``no_data``)."""
        comm, split, ndim = self.__comm, self.__split, self.ndim

        def position(rank: int) -> Tuple[int, ...]:
            return tuple(rank if i == split else 0 for i in range(ndim))

        dtype = _numpy_dtype(self.larray.dtype)
        partitions = {}
        for r in range(comm.size):  # unsplit: one position, the last rank's entry kept, as heat_tpu's
            _, lshape, slices = comm.chunk(self.__gshape, split, rank=r)
            partitions[position(r)] = {
                "start": tuple(sl.start for sl in slices),
                "shape": tuple(lshape),
                "data": None,
                "location": [r],
                "dtype": dtype,
            }
        own = position(comm.rank if split is not None else 0)
        if not no_data:
            partitions[own]["data"] = self.larray
        grid = [1] * ndim
        if split is not None:
            grid[split] = comm.size
        return {
            "shape": self.__gshape,
            "partition_tiling": tuple(grid),
            "partitions": partitions,
            "locals": [own],
            "get": lambda x: x,
        }

    @property
    def lshards(self) -> list:
        """This rank's shard values (heat_tpu's ``lshards``): its chunk, or nothing when
        the chunk is empty."""
        return [value for _, value in self.iter_shards()]

    def iter_shards(self):
        """Yield ``(global_index, shard_value)`` for each shard this rank holds (heat_tpu's
        ``iter_shards``, the backbone of per-shard I/O). A rank holds one chunk: its
        slices of the global shape and its local tensor. An empty chunk yields nothing,
        as heat_tpu skips the shards that are all padding."""
        _, lshape, slices = self.__comm.chunk(self.__gshape, self.__split)
        if 0 in lshape:
            return
        yield slices, self.larray

    # ------------------------------------------------------------------ distribution
    def lshape_map(self, force_check: bool = False) -> "DNDarray":
        """(size, ndim) map of every rank's chunk shape."""
        from . import factories

        lmap = self.__comm.lshape_map(self.__gshape, self.__split)
        return factories.array(lmap, dtype=types.int64, split=None, device=self.__device, comm=self.__comm)

    def counts_displs(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts and offsets along the split axis."""
        if self.__split is None:
            raise ValueError("Non-distributed DNDarray. Cannot calculate counts and displacements.")
        counts, displs, _ = self.__comm.counts_displs_shape(self.__gshape, self.__split)
        return counts, displs

    def create_lshape_map(self, force_check: bool = False) -> "DNDarray":
        return self.lshape_map(force_check)

    def is_distributed(self) -> bool:
        """True if the data is split over more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    def is_balanced(self, force_check: bool = False) -> bool:
        """Chunks always follow the canonical rule here: every operation that leaves a
        rank with another extent rebalances (``TorchCommunication.redistribute``)."""
        return True

    def balance_(self) -> "DNDarray":
        """Rebalance in place (heat_tpu/core/dndarray.py:411): the chunks are canonical
        already, so this only sets the flag."""
        self.__balanced = True
        return self

    def redistribute_(self, lshape_map=None, target_map=None) -> "DNDarray":
        """Redistribute to ``target_map`` (heat_tpu/core/dndarray.py:417). A DNDarray's
        chunks are the canonical ones, so the canonical map is the only target it can
        hold; any other raises, as heat_tpu's does."""
        if target_map is not None:
            tmap = np.asarray(target_map.numpy() if isinstance(target_map, DNDarray) else target_map)
            if not np.array_equal(tmap, self.__comm.lshape_map(self.__gshape, self.__split)):
                raise NotImplementedError(
                    "a DNDarray holds the canonical chunks; arbitrary target lshape maps are not representable"
                )
        self.__balanced = True
        return self

    def collect_(self, target_rank: int = 0) -> "DNDarray":
        """Gather the whole array on every rank: split becomes None."""
        return self.resplit_(None)

    # ------------------------------------------------------------------ halos
    def get_halo(self, halo_size: int, prev: bool = True, next: bool = True) -> None:  # noqa: A002
        """Fetch the ``halo_size`` slices along the split axis before and after this
        rank's chunk (heat_tpu/core/dndarray.py:495): global positions ``[start - h,
        start)`` and ``[end, end + h)``, clipped to the array, from whichever ranks hold
        them. One all-gather of the wanted ranges and one ``redistribute`` each way."""
        if not isinstance(halo_size, int) or halo_size < 0:
            raise (TypeError if not isinstance(halo_size, int) else ValueError)(
                f"halo_size needs to be a non-negative Python int, got {halo_size}"
            )
        self.__halo_prev = self.__halo_next = None
        if self.__split is None or not self.is_distributed():
            return
        comm, ax, n = self.__comm, self.__split, self.__gshape[self.__split]
        counts, displs, _ = comm.counts_displs_shape(self.__gshape, ax)
        start, end = displs[comm.rank], displs[comm.rank] + counts[comm.rank]
        halos = []
        for lo, hi, want in ((max(start - halo_size, 0), start, prev and start > 0),
                             (end, min(end + halo_size, n), next and end < n)):
            lo, hi = (lo, hi) if want else (0, 0)
            ranges = comm.all_gather_stacked(torch.tensor([lo, hi - lo], device=self.larray.device)).tolist()
            got = comm.redistribute(self.larray, self.__gshape, ax, counts, [r[1] for r in ranges],
                                    src_displs=displs, dst_displs=[r[0] for r in ranges])
            halos.append(got if want else None)
        self.__halo_prev, self.__halo_next = halos

    @property
    def halo_prev(self) -> Optional[torch.Tensor]:
        return self.__halo_prev

    @property
    def halo_next(self) -> Optional[torch.Tensor]:
        return self.__halo_next

    @property
    def array_with_halos(self) -> torch.Tensor:
        """This rank's chunk with the fetched halos attached along the split axis."""
        parts = [p for p in (self.halo_prev, self.larray, self.halo_next) if p is not None]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.__split or 0)

    def _global(self) -> torch.Tensor:
        """The whole array on every rank (an all-gather when distributed)."""
        return self.__comm.all_gather(self.larray, self.__gshape, self.__split)

    def _relayout(self, axis: Optional[int]) -> torch.Tensor:
        """This rank's local tensor for the array laid out along ``axis``. split→split
        goes through the planner's all-to-all (``linalg/comm_plan.py``: each rank sends
        each peer only the tile it needs, (P−1)/P of the array on the wire), except under
        ``HEAT_TPU_LINALG_PLAN=xla``, which gathers the whole array as heat_tpu's XLA path
        does; split→None gathers; None→split keeps this rank's chunk."""
        if axis == self.__split:
            return self.larray
        if axis is not None and self.__split is not None:
            from .linalg import comm_plan

            moved = comm_plan.try_resplit(self, axis)
            if moved is not NotImplemented:
                return moved
        full = self.larray if self.__split is None else self._global()
        if axis is None:
            return full
        _, _, slices = self.__comm.chunk(self.__gshape, axis)
        return full[slices].clone()

    def resplit_(self, axis: Optional[int] = None) -> "DNDarray":
        """Redistribute in place along ``axis``: split→None gathers, None→split keeps
        this rank's chunk, split→split is one all-to-all (:meth:`_relayout`)."""
        axis = sanitize_axis(self.__gshape, axis)
        self.__array = self._relayout(axis)
        self.__split = axis
        return self

    def resplit(self, axis: Optional[int] = None) -> "DNDarray":
        """Out-of-place :meth:`resplit_`."""
        axis = sanitize_axis(self.__gshape, axis)
        return DNDarray(
            self._relayout(axis), self.__gshape, self.__dtype, axis, self.__device, self.__comm, True
        )

    def _rebind(self, other: "DNDarray") -> None:
        """Take ``other``'s payload, shape, dtype and split in place (``qr``'s
        ``overwrite_a`` and the in-place operators); a deferred payload stays
        deferred."""
        payload = other._payload
        if isinstance(payload, Deferred):
            _executor.note_wrapped(payload, self)
        self.__array = payload
        self.__gshape = other.gshape
        self.__dtype = other.dtype
        self.__split = other.split

    @property
    def T(self) -> "DNDarray":
        """The transpose (every axis reversed); a local permute with the split remapped."""
        from .linalg import basics

        return basics.transpose(self)

    # ------------------------------------------------------------------ conversion
    def astype(self, dtype, copy: bool = True) -> "DNDarray":
        """Cast to a new datatype."""
        dtype = types.canonical_heat_type(dtype)
        casted = self.larray.to(dtype.torch_type())
        if copy:
            return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm, self.__balanced)
        self.__array = casted
        self.__dtype = dtype
        return self

    def cpu(self) -> "DNDarray":
        """This array with its chunks on the host."""
        from .devices import cpu

        return DNDarray(self.larray.cpu(), self.__gshape, self.__dtype, self.__split, cpu, self.__comm, self.__balanced)

    def numpy(self) -> np.ndarray:
        """The global array as numpy, on every rank (an all-gather when distributed).
        bfloat16, which numpy lacks, comes back as ``ml_dtypes.bfloat16``, as heat_tpu's."""
        value = self._global().detach().cpu()
        if value.dtype == torch.bfloat16:
            import ml_dtypes

            return value.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return value.numpy()

    def item(self) -> Scalar:
        """The single element as a Python scalar."""
        if self.size != 1:
            raise ValueError("only one-element DNDarrays can be converted to Python scalars")
        return self._global().reshape(()).item()

    def tolist(self) -> list:
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self.numpy()
        return out.astype(dtype) if dtype is not None else out

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.__gshape[0]

    def __bool__(self) -> bool:
        return bool(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __complex__(self) -> complex:
        return complex(self.item())

    def __index__(self) -> int:
        return int(self.item())

    def __repr__(self) -> str:
        from . import printing

        return printing.__str__(self)

    __str__ = __repr__

    # ------------------------------------------------------------------ fills and indexing
    def fill_diagonal(self, value) -> "DNDarray":
        """Fill the main diagonal in place (heat_tpu/core/dndarray.py:621): each rank
        writes the diagonal entries of its own chunk."""
        if self.ndim != 2:
            raise ValueError("fill_diagonal requires a 2-D DNDarray")
        offset, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        ax = 0 if self.__split is None else self.__split
        n = min(self.__gshape)
        lo, hi = max(offset, 0), min(offset + lshape[ax], n)
        if hi > lo:
            g = torch.arange(lo, hi, device=self.larray.device)
            rows, cols = (g - offset, g) if ax == 0 else (g, g - offset)
            self.larray[rows, cols] = torch.as_tensor(value, dtype=self.larray.dtype, device=self.larray.device)
        return self

    def _index_split(self, key) -> Optional[int]:
        """Split bookkeeping for indexing (heat_tpu/core/dndarray.py:632, copied as it
        is): the output axis the split axis survives as, or None."""
        if self.__split is None:
            return None
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            n_explicit = sum(1 for k in key if k is not Ellipsis and k is not None)
            expanded = []
            for k in key:
                if k is Ellipsis:
                    expanded.extend([slice(None)] * (self.ndim - n_explicit))
                else:
                    expanded.append(k)
            key = tuple(expanded)
        dim = 0  # input dim cursor
        out_dim = 0  # output dim cursor
        adv_seen = False
        for k in key:
            if k is None:
                out_dim += 1
                continue
            if dim == self.__split:
                if isinstance(k, slice):
                    return out_dim
                return None  # integer/advanced index consumed the split dim
            if isinstance(k, (int, np.integer)):
                dim += 1
            elif isinstance(k, slice):
                dim += 1
                out_dim += 1
            else:  # advanced index (array-like / bool mask)
                if isinstance(k, DNDarray):
                    adv, is_bool = k.ndim, k.dtype is types.bool
                elif isinstance(k, torch.Tensor):
                    adv, is_bool = k.ndim, k.dtype == torch.bool
                else:
                    arr = np.asarray(k)
                    adv, is_bool = arr.ndim, arr.dtype == np.bool_
                dim += adv if is_bool else 1
                if not adv_seen:
                    out_dim += 1
                    adv_seen = True
        if dim <= self.__split:
            return out_dim + (self.__split - dim)
        return None

    def __getitem__(self, key) -> "DNDarray":
        """Indexing with numpy's rules (heat_tpu/core/dndarray.py:680). Basic slices of
        the split axis cut each chunk locally and rebalance; a boolean mask selects
        locally; an integer on the split axis is answered by the rank that holds it
        (:mod:`.indexing`)."""
        from . import indexing

        return indexing._getitem(self, key)

    def __setitem__(self, key, value) -> None:
        """Assignment with numpy's rules (heat_tpu/core/dndarray.py:697): each rank writes
        the elements of its chunk that ``key`` hits, with ``value`` cut to them."""
        from . import indexing

        indexing._setitem(self, key, value)

    def __iter__(self):
        for i in range(self.__gshape[0] if self.ndim else 0):
            yield self[i]

    # ------------------------------------------------------------------ reductions
    def sum(self, axis=None, out=None, keepdims=False) -> "DNDarray":
        from . import arithmetics

        return arithmetics.sum(self, axis, out, keepdims)

    def prod(self, axis=None, out=None, keepdims=False) -> "DNDarray":
        from . import arithmetics

        return arithmetics.prod(self, axis, out, keepdims)

    def mean(self, axis=None, keepdims=False) -> "DNDarray":
        from . import statistics

        return statistics.mean(self, axis, keepdims)

    def min(self, axis=None, out=None, keepdims=None) -> "DNDarray":
        from . import statistics

        return statistics.min(self, axis, out, keepdims)

    def max(self, axis=None, out=None, keepdims=None) -> "DNDarray":
        from . import statistics

        return statistics.max(self, axis, out, keepdims)

    def argmin(self, axis=None, out=None, keepdims=False) -> "DNDarray":
        from . import statistics

        return statistics.argmin(self, axis, out, keepdims)

    def argmax(self, axis=None, out=None, keepdims=False) -> "DNDarray":
        from . import statistics

        return statistics.argmax(self, axis, out, keepdims)

    # ------------------------------------------------------------------ arithmetic dunders
    def __add__(self, other):
        from . import arithmetics

        return arithmetics.add(self, other)

    def __radd__(self, other):
        from . import arithmetics

        return arithmetics.add(other, self)

    def __sub__(self, other):
        from . import arithmetics

        return arithmetics.sub(self, other)

    def __rsub__(self, other):
        from . import arithmetics

        return arithmetics.sub(other, self)

    def __mul__(self, other):
        from . import arithmetics

        return arithmetics.mul(self, other)

    def __rmul__(self, other):
        from . import arithmetics

        return arithmetics.mul(other, self)

    def __truediv__(self, other):
        from . import arithmetics

        return arithmetics.div(self, other)

    def __rtruediv__(self, other):
        from . import arithmetics

        return arithmetics.div(other, self)

    def __pow__(self, other):
        from . import arithmetics

        return arithmetics.pow(self, other)

    def __rpow__(self, other):
        from . import arithmetics

        return arithmetics.pow(other, self)

    def __neg__(self):
        from . import arithmetics

        return arithmetics.neg(self)

    def __floordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(self, other)

    def __rfloordiv__(self, other):
        from . import arithmetics

        return arithmetics.floordiv(other, self)

    def __mod__(self, other):
        from . import arithmetics

        return arithmetics.mod(self, other)

    def __rmod__(self, other):
        from . import arithmetics

        return arithmetics.mod(other, self)

    def __lshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(self, other)

    def __rlshift__(self, other):
        from . import arithmetics

        return arithmetics.left_shift(other, self)

    def __rshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(self, other)

    def __rrshift__(self, other):
        from . import arithmetics

        return arithmetics.right_shift(other, self)

    def __and__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(self, other)

    def __rand__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_and(other, self)

    def __or__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(self, other)

    def __ror__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_or(other, self)

    def __xor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(self, other)

    def __rxor__(self, other):
        from . import arithmetics

        return arithmetics.bitwise_xor(other, self)

    def __divmod__(self, other):
        from . import arithmetics

        return arithmetics.divmod(self, other)

    def __matmul__(self, other):
        from .linalg import matmul

        return matmul(self, other)

    def __pos__(self):
        from . import arithmetics

        return arithmetics.pos(self)

    def __abs__(self):
        from . import rounding

        return rounding.abs(self)

    def __invert__(self):
        from . import arithmetics

        return arithmetics.invert(self)

    def __iadd__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.add(self, other))
        return self

    def __isub__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.sub(self, other))
        return self

    def __imul__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.mul(self, other))
        return self

    def __itruediv__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.div(self, other))
        return self

    def __ifloordiv__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.floordiv(self, other))
        return self

    def __imod__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.mod(self, other))
        return self

    def __ipow__(self, other):
        from . import arithmetics

        self._rebind(arithmetics.pow(self, other))
        return self

    # ------------------------------------------------------------------ comparisons
    def __eq__(self, other):
        from . import relational

        return relational.eq(self, other)

    def __ne__(self, other):
        from . import relational

        return relational.ne(self, other)

    def __lt__(self, other):
        from . import relational

        return relational.lt(self, other)

    def __le__(self, other):
        from . import relational

        return relational.le(self, other)

    def __gt__(self, other):
        from . import relational

        return relational.gt(self, other)

    def __ge__(self, other):
        from . import relational

        return relational.ge(self, other)

    # ------------------------------------------------------------------ method aliases
    def abs(self, out=None, dtype=None):
        from . import rounding

        return rounding.abs(self, out, dtype)

    def all(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.all(self, axis, out, keepdims)

    def any(self, axis=None, out=None, keepdims=False):
        from . import logical

        return logical.any(self, axis, out, keepdims)

    def median(self, axis=None, keepdims=False):
        from . import statistics

        return statistics.median(self, axis, keepdims=keepdims)

    def std(self, axis=None, ddof=0, **kwargs):
        from . import statistics

        return statistics.std(self, axis, ddof=ddof, **kwargs)

    def var(self, axis=None, ddof=0, **kwargs):
        from . import statistics

        return statistics.var(self, axis, ddof=ddof, **kwargs)

    def cumsum(self, axis, out=None):
        from . import arithmetics

        return arithmetics.cumsum(self, axis, out=out)

    def cumprod(self, axis, out=None):
        from . import arithmetics

        return arithmetics.cumprod(self, axis, out=out)

    def reshape(self, *shape, new_split=None, **kwargs):
        from . import manipulations

        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return manipulations.reshape(self, shape, new_split=new_split, **kwargs)

    def flatten(self):
        from . import manipulations

        return manipulations.flatten(self)

    def ravel(self):
        from . import manipulations

        return manipulations.ravel(self)

    def squeeze(self, axis=None):
        from . import manipulations

        return manipulations.squeeze(self, axis)

    def expand_dims(self, axis):
        from . import manipulations

        return manipulations.expand_dims(self, axis)

    def transpose(self, axes=None):
        from .linalg import transpose

        return transpose(self, axes)

    def tril(self, k=0):
        from .linalg import tril

        return tril(self, k)

    def triu(self, k=0):
        from .linalg import triu

        return triu(self, k)

    def flip(self, axis=None):
        from . import manipulations

        return manipulations.flip(self, axis)

    def roll(self, shift, axis=None):
        from . import manipulations

        return manipulations.roll(self, shift, axis)

    def nonzero(self):
        from . import indexing

        return indexing.nonzero(self)

    def unique(self, sorted=False, return_inverse=False, axis=None):  # noqa: A002
        from . import manipulations

        return manipulations.unique(self, sorted, return_inverse, axis)

    def round(self, decimals=0, out=None, dtype=None):
        from . import rounding

        return rounding.round(self, decimals, out, dtype)

    def floor(self, out=None):
        from . import rounding

        return rounding.floor(self, out)

    def ceil(self, out=None):
        from . import rounding

        return rounding.ceil(self, out)

    def trunc(self, out=None):
        from . import rounding

        return rounding.trunc(self, out)

    def clip(self, min=None, max=None, out=None):  # noqa: A002
        from . import rounding

        return rounding.clip(self, min, max, out)

    def copy(self):
        from . import memory

        return memory.copy(self)

    def exp(self, out=None):
        from . import exponential

        return exponential.exp(self, out)

    def log(self, out=None):
        from . import exponential

        return exponential.log(self, out)

    def sqrt(self, out=None):
        from . import exponential

        return exponential.sqrt(self, out)

    def sin(self, out=None):
        from . import trigonometrics

        return trigonometrics.sin(self, out)

    def cos(self, out=None):
        from . import trigonometrics

        return trigonometrics.cos(self, out)

    def tanh(self, out=None):
        from . import trigonometrics

        return trigonometrics.tanh(self, out)

    def isclose(self, other, rtol=1e-05, atol=1e-08, equal_nan=False):
        from . import logical

        return logical.isclose(self, other, rtol, atol, equal_nan)

    def tile(self, reps):
        from . import manipulations

        return manipulations.tile(self, reps)

    __hash__ = None  # mutable container, like heat_tpu's
