"""Memory helpers (counterpart of heat_tpu/core/memory.py)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["copy", "sanitize_memory_layout"]


def copy(x: DNDarray) -> DNDarray:
    """A copy of the array: each rank clones its chunk (heat_tpu/core/memory.py:12)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, got {type(x)}")
    return DNDarray(x.larray.clone(), x.gshape, x.dtype, x.split, x.device, x.comm, x.balanced)


def sanitize_memory_layout(x, order: str = "C"):
    """Memory layout normalisation (heat_tpu/core/memory.py:25): row-major only."""
    if order == "K":
        raise NotImplementedError("Internal usage of torch.clone() means losing original memory layout for now.")
    if order not in ("C",):
        raise ValueError(f"only row-major ('C') layout is supported, got {order!r}")
    return x
