"""K1: fused KMeans assignment + centroid accumulation, a CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``heat_tpu/core/kernels/kmeans.py:44`` (``_kernel``,
launched by ``_fused_pallas``; entry ``fused_assign_update``). One streaming pass over
x (n, d) f32 against centers (k, d) f32 gives the labels, the per-cluster sums and counts
and the sum of squared distances, without the (n, k) distance matrix ever reaching
device memory. The source, ``csrc/kmeans_assign.cu``, says what bounds it on the card
(one read of x: it is memory-bound at ~2 FLOP/byte for k = 8) and how its design answers.

The wrapper takes the plain PyTorch version, :func:`fused_assign_update_reference`, only
for tensors that lie on the CPU. A CUDA tensor launches the kernel or raises: there is no
fallback. ``launches`` counts the kernel's launches: one launch is the pair of CUDA
kernels that make up K1, ``kmeans_assign_partial`` (the pass over x, one record per block)
followed by ``kmeans_reduce_partials`` (the fixed-order sum of the blocks' records).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..devices import full_fp32_matmul
from . import _nvcc

__all__ = [
    "fits_smem",
    "grid_blocks",
    "fused_assign_update",
    "fused_assign_update_packed",
    "fused_assign_update_reference",
    "unpack",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu"

launches = 0
"""Launches of the CUDA kernel since import (or since a caller reset it to 0)."""

# must agree with kWarps / kMaxColsPerLane in the source
_WARPS = 8
_MAX_D = 256
# dynamic shared memory a block may opt into on sm_90 (227 KB)
_SMEM_BUDGET = 232_448

_LIB = None
_MAX_BLOCKS: Dict[Tuple[int, int, int], int] = {}


def smem_bytes(d: int, k: int) -> int:
    """Shared memory of one block: centers, |c|², and one packed record per warp."""
    return 4 * (k * d + k + _WARPS * (k * d + k + 1))


def fits_smem(d: int, k: int) -> bool:
    """The kernel's gate (the counterpart of heat_tpu's ``_fits_vmem``): a row fits in
    the registers of one warp and the block's records fit in shared memory. Larger shapes
    take the generic Lloyd path."""
    return 1 <= d <= _MAX_D and k >= 1 and smem_bytes(d, k) <= _SMEM_BUDGET


def grid_blocks(n: int, d: int, k: int, device: torch.device) -> Tuple[int, int]:
    """(blocks, warps per block) of the launch for ``n`` rows on a CUDA ``device``: the
    blocks resident on the card at once, fewer when there are fewer rows than warps."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    max_blocks = _MAX_BLOCKS.get((dev, d, k))
    if max_blocks is None:
        lib = _lib()
        out = ctypes.c_int(0)
        _raise_on(lib, lib.kmeans_assign_max_blocks(dev, d, k, ctypes.byref(out)), "occupancy query")
        max_blocks = _MAX_BLOCKS[(dev, d, k)] = out.value
    return max(1, min(max_blocks, -(-n // _WARPS))), _WARPS


def fused_assign_update_reference(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (mirrors heat_tpu/core/kernels/kmeans.py:28-41):
    (labels int32, sums, counts, sse) of nearest-centroid assignment, with the cross
    term in full fp32."""
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(centers * centers, dim=1)[None, :]
    with full_fp32_matmul():
        xc = torch.matmul(x, centers.T)
    d2 = torch.clamp_min(xx + cc - 2.0 * xc, 0.0)
    labels = torch.argmin(d2, dim=1).to(torch.int32)  # first index of the row minimum
    k = centers.shape[0]
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, labels, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    )
    sse = torch.sum(torch.amin(d2, dim=1)) if x.shape[0] else x.new_zeros(())
    return labels, sums, counts, sse


def unpack(packed: torch.Tensor, k: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums (k, d), counts (k,), sse ()) views of a packed k*d + k + 1 record."""
    return packed[: k * d].view(k, d), packed[k * d : k * d + k], packed[k * d + k]


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    for t, name in ((x, "x"), (centers, "centers")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[1] != centers.shape[1]:
        raise ValueError(f"x has {x.shape[1]} features, centers {centers.shape[1]}")
    if x.device != centers.device:
        raise ValueError(f"x is on {x.device}, centers on {centers.device}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_assign_max_blocks.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.kmeans_assign_max_blocks.restype = i
        lib.kmeans_assign_launch.argtypes = [i, p, p, ll, i, i, p, p, i, p, p]
        lib.kmeans_assign_launch.restype = i
        lib.kmeans_assign_smem_bytes.argtypes = [i, i]
        lib.kmeans_assign_smem_bytes.restype = ll
        lib.kmeans_error_string.argtypes = [i]
        lib.kmeans_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kmeans_assign: {what} failed: {lib.kmeans_error_string(rc).decode()} ({rc})")


def fused_assign_update_packed(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) int32, packed (k*d + k + 1,) f32: sums, counts, sse) in one pass.

    CPU tensors take the plain version; CUDA tensors launch K1 (its two kernels) on the
    current stream without synchronising, and count one launch. Raises on a dtype other than f32, on non-contiguous input and,
    on the card, on shapes beyond :func:`fits_smem`."""
    global launches
    _check(x, centers)
    n, d = x.shape
    k = centers.shape[0]
    if x.device.type == "cpu":
        labels, sums, counts, sse = fused_assign_update_reference(x, centers)
        return labels, torch.cat([sums.reshape(-1), counts, sse.reshape(1)])
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on CUDA or CPU tensors, got {x.device}")
    if not fits_smem(d, k):
        raise ValueError(f"(d={d}, k={k}) is beyond the kernel's gate (d <= {_MAX_D}, shared memory)")
    if n >= 2**31:
        raise ValueError(f"n={n} rows overflow the int32 labels")
    lib = _lib()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    blocks, _ = grid_blocks(n, d, k, x.device)
    m = k * d + k + 1
    # allocated on the stream the kernels run on: when `scratch` is freed on return, the
    # caching allocator hands its memory only to work queued after them on that stream
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    scratch = torch.empty((blocks, m), dtype=torch.float32, device=x.device)
    packed = torch.empty(m, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.kmeans_assign_launch(
        dev, x.data_ptr(), centers.data_ptr(), n, d, k,
        labels.data_ptr(), scratch.data_ptr(), blocks, packed.data_ptr(), stream,
    )
    _raise_on(lib, rc, "launch")
    launches += 1
    return labels, packed


def fused_assign_update(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels, sums, counts, sse) in one streaming pass over ``x``: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    labels, packed = fused_assign_update_packed(x, centers)
    return (labels, *unpack(packed, centers.shape[0], x.shape[1]))
