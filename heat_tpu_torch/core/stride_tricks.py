"""Shape/axis sanitation helpers (counterpart of heat_tpu/core/stride_tricks.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape", "sanitize_slice"]


def broadcast_shapes(*shapes: Sequence[int]) -> Tuple[int, ...]:
    """NumPy broadcasting of several shapes."""
    try:
        return tuple(np.broadcast_shapes(*[tuple(s) for s in shapes]))
    except ValueError as e:
        raise ValueError(f"operands could not be broadcast, input shapes {shapes}") from e


def broadcast_shape(shape_a: Sequence[int], shape_b: Sequence[int]) -> Tuple[int, ...]:
    """Broadcast two shapes."""
    return broadcast_shapes(shape_a, shape_b)


def sanitize_axis(
    shape: Sequence[int], axis: Optional[Union[int, Sequence[int]]]
) -> Optional[Union[int, Tuple[int, ...]]]:
    """Normalise ``axis`` to non-negative value(s) within ``len(shape)``."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        axes = tuple(sanitize_axis(shape, a) for a in axis)
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated axis in {axis}")
        return axes
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    original = axis
    if ndim == 0 and axis in (-1, 0):
        return 0
    if axis < 0:
        axis += ndim
    if axis < 0 or axis >= max(ndim, 1):
        raise ValueError(f"axis {original} out of bounds for {ndim}-dimensional array")
    return axis


def sanitize_shape(shape: Union[int, Sequence[int]], lval: int = 0) -> Tuple[int, ...]:
    """Normalise a shape argument to a tuple of non-negative ints ≥ ``lval``."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    shape = tuple(int(s) for s in shape)
    for s in shape:
        if s < lval:
            raise ValueError(f"negative dimensions are not allowed, got shape {shape}")
    return shape


def sanitize_slice(sl: slice, max_dim: int) -> slice:
    """Resolve a slice against a dimension size."""
    if not isinstance(sl, slice):
        raise TypeError("can only sanitize slices")
    return slice(*sl.indices(max_dim))
