"""Input validation and the executor's buffer-donation contract (counterpart of
heat_tpu/core/sanitation.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import sys

import torch

from .dndarray import DNDarray

__all__ = [
    "sanitize_distribution",
    "sanitize_donation",
    "sanitize_in",
    "sanitize_in_tensor",
    "sanitize_infinity",
    "sanitize_leaf_donation",
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


def _storage_owned(t: torch.Tensor) -> bool:
    """Whether writing into ``t``'s storage can be observed through nothing but
    ``t``: no autograd history, and no other tensor on the storage — a view of
    ``t`` or a sibling view; ``t`` may itself be a view of a base nothing else
    holds (a local chunk cut from a temporary). The storage's use count is the
    tensor's reference, its base's, and the temporary storage object asking for
    it. (A CPU tensor made by ``torch.from_numpy`` shares the numpy array's
    memory without a torch reference; the port's factories copy their input, so
    such memory is never a user's array.)"""
    if t.requires_grad:
        return False
    use_count = getattr(torch._C, "_storage_Use_Count", None)
    if use_count is None:
        return False
    base = t._base
    allowed = 2
    if base is not None:
        # the ``base`` local, getrefcount's argument, and the reference the view's
        # tensor keeps to its base's Python object
        if base.requires_grad or sys.getrefcount(base) > 3:
            return False
        allowed = 3
    del base
    return use_count(t.untyped_storage()._cdata) <= allowed


def sanitize_donation(out: DNDarray, operand_arrays: Sequence) -> bool:
    """Whether ``out``'s local tensor may be **donated** to a staged ``out=``
    program: the program then writes the result into its storage.

    heat_tpu's contract, for torch tensors: the tensor must not also be a program
    operand (``ht.add(a, b, out=a)``), no reference beyond the ``out`` array itself
    may exist (a user holding ``buf = x.larray``, or a deferred op still reading
    it, keeps it undonatable for exactly as long as that holder exists), and — as a
    torch tensor can share its storage — it must not be a view, have a live view,
    or require grad. Callers check *before* putting the tensor into their own
    argument list. When this returns False the program runs without writing in
    place; correctness never depends on donation."""
    buf = out.larray
    if any(buf is arr for arr in operand_arrays):
        return False
    # expected references: the DNDarray's attribute, the ``buf`` local, and the
    # getrefcount argument
    return sys.getrefcount(buf) <= 3 and _storage_owned(buf)


def _call_ref_overhead() -> int:
    """How many references one Python call layer adds to an argument (measured
    once, so the leaf-donation refcount contract is exact on any CPython)."""
    probe = object()

    def _measure(x):
        return sys.getrefcount(x)

    return _measure(probe) - sys.getrefcount(probe)


_LEAF_CALL_OVERHEAD = _call_ref_overhead()


def sanitize_leaf_donation(buf, plan_refs: int) -> bool:
    """Whether a fused-graph *leaf* tensor may be donated to the deferred
    executor's program (its storage receives an output of the same shape and
    dtype). Safe only when the forcing program is the tensor's last reader:
    ``plan_refs`` persistent references are accounted for by the caller (the
    plan's operand tuples and its leaf list); on top of those come getrefcount's
    argument and this call's own references. Anything beyond — a live DNDarray
    payload, a user-held ``x.larray``, a deferred graph outside the plan —
    refuses, as do a shared storage and autograd history (:func:`sanitize_donation`)."""
    return sys.getrefcount(buf) <= plan_refs + 1 + _LEAF_CALL_OVERHEAD and _storage_owned(buf)


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
