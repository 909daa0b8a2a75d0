"""Input validation (counterpart of heat_tpu/core/sanitation.py: ``sanitize_in``,
``sanitize_out`` and ``sanitize_sequence``)."""

from __future__ import annotations

from typing import Optional, Sequence

from .dndarray import DNDarray

__all__ = ["sanitize_in", "sanitize_out", "sanitize_sequence"]


def sanitize_in(x: object) -> None:
    """Verify ``x`` is a DNDarray."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input must be a DNDarray, is {type(x)}")


def sanitize_out(
    out: object,
    output_shape: Sequence[int],
    output_split: Optional[int],
    output_device=None,
    output_comm=None,
) -> None:
    """Verify an ``out`` buffer's shape and bring it to the required split."""
    sanitize_in(out)
    if tuple(out.shape) != tuple(output_shape):
        raise ValueError(f"Expecting output buffer of shape {tuple(output_shape)}, got {tuple(out.shape)}")
    if out.split != output_split:
        out.resplit_(output_split)


def sanitize_sequence(seq):
    """Check that ``seq`` is a valid sequence and return it as a list."""
    if isinstance(seq, list):
        return seq
    if isinstance(seq, tuple):
        return list(seq)
    if isinstance(seq, DNDarray):
        return seq.tolist()
    raise TypeError(f"seq must be a list, tuple or DNDarray, got {type(seq)}")
