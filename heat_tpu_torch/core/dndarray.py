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

from . import types
from .communication import TorchCommunication
from .devices import Device
from .stride_tricks import sanitize_axis

__all__ = ["DNDarray"]

Scalar = Union[int, float, bool, complex]


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

    # ------------------------------------------------------------------ properties
    @property
    def larray(self) -> torch.Tensor:
        """This rank's local tensor."""
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
        return self.__array.numel()

    @property
    def lshape(self) -> Tuple[int, ...]:
        """This rank's chunk shape under the canonical chunking."""
        _, lshape, _ = self.__comm.chunk(self.__gshape, self.__split)
        return lshape

    @property
    def split(self) -> Optional[int]:
        return self.__split

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

    def is_distributed(self) -> bool:
        """True if the data is split over more than one rank."""
        return self.__split is not None and self.__comm.size > 1

    def _global(self) -> torch.Tensor:
        """The whole array on every rank (an all-gather when distributed)."""
        return self.__comm.all_gather(self.__array, self.__gshape, self.__split)

    def _relayout(self, axis: Optional[int]) -> torch.Tensor:
        """This rank's local tensor for the array laid out along ``axis``. split→split
        goes through the planner's all-to-all (``linalg/comm_plan.py``: each rank sends
        each peer only the tile it needs, (P−1)/P of the array on the wire), except under
        ``HEAT_TPU_LINALG_PLAN=xla``, which gathers the whole array as heat_tpu's XLA path
        does; split→None gathers; None→split keeps this rank's chunk."""
        if axis == self.__split:
            return self.__array
        if axis is not None and self.__split is not None:
            from .linalg import comm_plan

            moved = comm_plan.try_resplit(self, axis)
            if moved is not NotImplemented:
                return moved
        full = self.__array if self.__split is None else self._global()
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
        """Take ``other``'s local tensor, shape, dtype and split in place (``qr``'s
        ``overwrite_a``)."""
        self.__array = other.larray
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
        casted = self.__array.to(dtype.torch_type())
        if copy:
            return DNDarray(casted, self.__gshape, dtype, self.__split, self.__device, self.__comm, self.__balanced)
        self.__array = casted
        self.__dtype = dtype
        return self

    def numpy(self) -> np.ndarray:
        """The global array as numpy, on every rank (an all-gather when distributed)."""
        return self._global().detach().cpu().numpy()

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

    def __repr__(self) -> str:
        return (
            f"DNDarray({self.numpy()!r}, dtype=heat_tpu_torch.{self.__dtype.__name__}, "
            f"device={self.__device}, split={self.__split})"
        )

    __str__ = __repr__

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

    __hash__ = None  # mutable container, like heat_tpu's
