"""Signal processing (counterpart of heat_tpu/core/signal.py): the 1-D ``convolve``.

Along a split signal each rank computes the outputs of its own chunk's positions from its
chunk and the ``m - 1`` samples before it, fetched with ``DNDarray.get_halo``; the rank
holding the signal's end also computes the ``m - 1`` trailing outputs. The pieces are
rebalanced to the canonical chunks of the result, and ``same``/``valid`` cut it by a
distributed slice.
"""

from __future__ import annotations

import torch

from . import _operations, types
from .devices import full_fp32_matmul
from .dndarray import DNDarray

__all__ = ["convolve"]


def _full_valid(ext: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The valid correlation of ``ext`` with the reversed filter ``v`` (conv1d, in full fp32
    on the card: cuDNN takes f32 convolutions in TF32 by default)."""
    if ext.shape[0] < v.shape[0]:
        return ext[:0]
    with full_fp32_matmul():
        return torch.nn.functional.conv1d(ext.view(1, 1, -1), v.flip(0).view(1, 1, -1)).view(-1)


def convolve(a, v, mode: str = "full") -> DNDarray:
    """Discrete linear convolution of two 1-D arrays (the longer is the signal), in the
    float type of their promoted type."""
    from . import factories

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if not isinstance(v, DNDarray):
        v = factories.array(v, device=a.device, comm=a.comm)
    if a.ndim != 1 or v.ndim != 1:
        raise ValueError("convolve requires 1-D inputs")
    if mode not in ("full", "same", "valid"):
        raise ValueError(f"unsupported mode {mode!r}")
    if mode == "same" and v.gshape[0] % 2 == 0:
        raise ValueError("mode 'same' is not supported for even-sized filter weights")
    if a.gshape[0] < v.gshape[0]:
        a, v = v, a
    # jnp.convolve computes exact types in floats, as heat_tpu's does
    dt = _operations._inexact(types.promote_types(a.dtype, v.dtype))
    ct = dt.torch_type()
    n, m = a.gshape[0], v.gshape[0]
    vv = v._relayout(None).to(ct)
    local = a.larray.to(ct)
    if a.split is None or not a.is_distributed():
        whole = a._relayout(None).to(ct) if a.split is not None else local
        pad = whole.new_zeros(m - 1)
        full = _full_valid(torch.cat([pad, whole, pad]), vv)
        res = _operations.wrap_global(full, a, a.split)
    else:
        a.get_halo(m - 1, next=False)
        offset, lshape, _ = a.comm.chunk(a.gshape, 0)
        prev = a.halo_prev.to(ct) if a.halo_prev is not None else local[:0]
        lead = local.new_zeros(max(0, (m - 1) - prev.shape[0])) if lshape[0] else local[:0]
        last = lshape[0] > 0 and offset + lshape[0] == n
        trail = local.new_zeros(m - 1) if last else local[:0]
        piece = _full_valid(torch.cat([lead, prev, local, trail]), vv) if lshape[0] else local[:0]
        res = _operations.rebalance(piece, 0, a)
        res = DNDarray(res.larray, res.gshape, dt, a.split, a.device, a.comm, True)
    if mode == "same":
        off = (m - 1) // 2
        res = res[off : off + n]
    elif mode == "valid":
        res = res[m - 1 : n]
    return res
