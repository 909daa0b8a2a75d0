"""Input validation (counterpart of heat_tpu/core/sanitation.py; its buffer-donation
helpers are XLA's and have no counterpart)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from .dndarray import DNDarray

__all__ = [
    "sanitize_distribution",
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_lshape",
    "sanitize_out",
    "sanitize_sequence",
    "scalar_to_1d",
]


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


def sanitize_in_tensor(x: object) -> None:
    """Verify ``x`` is a torch.Tensor."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"input must be a torch.Tensor, is {type(x)}")


def sanitize_infinity(x: Union[DNDarray, torch.Tensor]) -> Union[int, float]:
    """The largest value ``x``'s type holds."""
    dtype = x.dtype.torch_type() if isinstance(x, DNDarray) else x.dtype
    if dtype.is_floating_point or dtype.is_complex:
        return float(torch.finfo(dtype).max)
    return 1 if dtype == torch.bool else int(torch.iinfo(dtype).max)


def sanitize_lshape(array: DNDarray, tensor) -> None:
    """Verify ``tensor`` has the shape of ``array``'s chunk on this rank (or its global
    shape)."""
    tshape = tuple(tensor.shape)
    if tshape == tuple(array.lshape) or tshape == tuple(array.gshape):
        return
    raise ValueError(f"local tensor shape {tshape} does not match chunk shape {array.lshape}")


def sanitize_distribution(*args: DNDarray, target: DNDarray, diff_map=None) -> Union[DNDarray, List[DNDarray]]:
    """``args`` laid out like ``target``: chunks are canonical, so the same split is the
    same distribution, and another split is a resplit."""
    out = []
    for arg in args:
        sanitize_in(arg)
        out.append(arg if arg.split == target.split else arg.resplit(target.split))
    return out[0] if len(out) == 1 else out


def scalar_to_1d(x: DNDarray) -> DNDarray:
    """A one-element DNDarray as 1-D of one element."""
    if x.ndim == 1 and x.size == 1:
        return x
    return DNDarray(x._relayout(None).reshape(1), (1,), x.dtype, None, x.device, x.comm, True)
