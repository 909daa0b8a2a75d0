"""Communication layer over ``torch.distributed`` (counterpart of heat_tpu/core/communication.py).

A DNDarray holds its rank's local ``torch.Tensor``; ranks talk over ``torch.distributed``
(NCCL on the card, gloo on the CPU). When no process group is initialised the world is a
single rank and every collective is the identity. Every collective of the package lives
in this file.

Chunking follows heat_tpu's ceil-division rule (heat_tpu/core/communication.py:311-337):
rank ``r`` owns ``[r*c, min((r+1)*c, n))`` with ``c = ceil(n / size)``, so lshape maps
agree between the two packages. Trailing ranks may own empty chunks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["TorchCommunication", "COMM_WORLD", "get_comm", "use_comm", "sanitize_comm"]

_REDUCE_OPS = {"sum": "SUM", "prod": "PRODUCT", "min": "MIN", "max": "MAX"}


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class TorchCommunication:
    """A communicator over a ``torch.distributed`` process group (None: the default
    group). ``size``/``rank`` are read when asked, so a communicator made before
    ``init_process_group`` sees the group made after it."""

    def __init__(self, group=None):
        self.group = group

    # ------------------------------------------------------------------ topology
    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if _initialized() else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if _initialized() else 0

    def is_distributed(self) -> bool:
        return self.size > 1

    def __repr__(self) -> str:
        return f"TorchCommunication(size={self.size}, rank={self.rank})"

    # ------------------------------------------------------------------ chunking
    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The chunk of the global ``shape`` owned by ``rank`` along ``split``, by the
        ceil-division rule. Returns ``(offset, local_shape, slices)``."""
        if rank is None:
            rank = self.rank
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        split = int(split)
        n = shape[split]
        c = -(-n // self.size) if n else 0  # ceil division; 0-size stays 0
        start = min(rank * c, n)
        end = min((rank + 1) * c, n)
        lshape = shape[:split] + (end - start,) + shape[split + 1 :]
        slices = tuple(
            slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape)
        )
        return start, lshape, slices

    def counts_displs_shape(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts/displacements along ``split``, and this rank's lshape."""
        counts, displs = [], []
        for r in range(self.size):
            offset, lshape, _ = self.chunk(shape, split, rank=r)
            counts.append(lshape[split])
            displs.append(offset)
        _, lshape, _ = self.chunk(shape, split)
        return tuple(counts), tuple(displs), tuple(lshape)

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every rank's local shape."""
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            _, lshape, _ = self.chunk(shape, split, rank=r)
            out[r] = lshape
        return out

    # ------------------------------------------------------------------ collectives
    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``tensor`` across ranks in place (``op``: sum, prod, min, max) and
        return it."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported reduction {op!r}, expected one of {sorted(_REDUCE_OPS)}")
        if self.size == 1:
            return tensor
        red = getattr(dist.ReduceOp, _REDUCE_OPS[op])
        if tensor.dtype == torch.bool:
            # neither NCCL nor gloo reduces bool; sum over bool means "any"
            buf = tensor.to(torch.uint8)
            dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "sum" else red, group=self.group)
            tensor.copy_(buf.bool())
            return tensor
        dist.all_reduce(tensor, op=red, group=self.group)
        return tensor

    def all_reduce_packed(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sums across ranks of ``tensors`` (one dtype and device, any shapes), by one
        collective over a flat buffer that packs them all; at world 1 the tensors as given.
        A data-parallel step reduces every gradient and its loss this way, in one call
        instead of one per parameter."""
        tensors = list(tensors)
        if self.size == 1 or not tensors:
            return tensors
        if len({(t.dtype, t.device) for t in tensors}) != 1:
            raise ValueError("all_reduce_packed takes tensors of one dtype and device")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def all_gather(self, local: torch.Tensor, gshape: Sequence[int], split: Optional[int]) -> torch.Tensor:
        """The global tensor of shape ``gshape`` from every rank's chunk along
        ``split``; chunks may be uneven or empty (each is padded to the ceil-division
        extent for the collective and trimmed after)."""
        gshape = tuple(int(s) for s in gshape)
        if split is None or self.size == 1:
            return local
        n = gshape[split]
        if n == 0:
            return local
        c = -(-n // self.size)
        moved = local.movedim(split, 0)
        dtype = moved.dtype
        if dtype == torch.bool:
            moved = moved.to(torch.uint8)
        if moved.shape[0] < c:
            pad = moved.new_zeros((c - moved.shape[0],) + tuple(moved.shape[1:]))
            moved = torch.cat([moved, pad], dim=0)
        moved = moved.contiguous()
        parts = [torch.empty_like(moved) for _ in range(self.size)]
        dist.all_gather(parts, moved, group=self.group)
        full = torch.cat(parts, dim=0)[:n]
        if dtype == torch.bool:
            full = full.bool()
        return full.movedim(0, split).contiguous()

    def all_gather_stacked(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's equally shaped ``tensor``, stacked along a new leading axis."""
        stacked = tensor.unsqueeze(0)
        return self.all_gather(stacked, (self.size,) + tuple(tensor.shape), 0)

    def bcast(self, tensor: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Broadcast ``tensor`` from ``root`` in place and return it."""
        if self.size > 1:
            dist.broadcast(tensor, src=root, group=self.group)
        return tensor


# the default communicator: the default process group, or a single rank
COMM_WORLD = TorchCommunication()
__default_comm = COMM_WORLD


def get_comm() -> TorchCommunication:
    """The current default communicator."""
    return __default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator (None: the world)."""
    global __default_comm
    __default_comm = COMM_WORLD if comm is None else sanitize_comm(comm)


def sanitize_comm(comm: Optional[TorchCommunication]) -> TorchCommunication:
    """Validate ``comm`` or return the default."""
    if comm is None:
        return get_comm()
    if isinstance(comm, TorchCommunication):
        return comm
    raise TypeError(f"Unknown communication, must be a TorchCommunication, got {type(comm)}")
