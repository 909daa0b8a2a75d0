"""The integer and bool matrix product, a CUDA C++ kernel for Hopper.

Replaces no Pallas kernel: heat_tpu leaves integer and bool products to XLA's
``dot_general`` (``jnp.matmul``, ``jnp.dot``, ``jnp.vdot``), which gives the product
modulo 2^bits of the operands' type and, for bool, the OR of ANDs. cuBLAS has no integer
GEMM, so ``torch.matmul`` raises on CUDA integer tensors; this kernel
(``csrc/int_gemm.cu``) computes them on the card. Every order of its wrapping sums gives
the same bits, so its result is exact and bit-equal to XLA's; the source says what bounds
its design (integer instructions, IMAD) and how it is laid out.

The wrapper takes the plain PyTorch version, :func:`int_matmul_reference`, only for
tensors that lie on the CPU. A CUDA tensor launches the kernel or raises: there is no
fallback. ``launches`` counts one a product (a call of :func:`matmul` that computes
anything).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict

import torch

from . import _nvcc

__all__ = ["DTYPES", "int_matmul_reference", "matmul"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm.cu"

launches = 0
"""Products launched on the card since import (or since a caller reset it to 0)."""
# the count moves under this lock: request threads launch the kernel concurrently
_count_lock = threading.Lock()

# the source's dtype codes
DTYPES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3, torch.int32: 4, torch.int64: 5}
_DOT_THREADS = 256

_LIB = None
_SMS: Dict[int, int] = {}


def int_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version. On the CPU: ``torch.matmul`` (integers wrap modulo 2^bits there
    too); bool as the product of its int32 values compared with 0, exact while k < 2**31.
    On the card, where torch.matmul takes no integer tensor: :func:`_limb_matmul`."""
    if a.device.type != "cpu":
        return _limb_matmul(a, b)
    if a.dtype == torch.bool:
        return torch.matmul(a.to(torch.int32), b.to(torch.int32)) != 0
    return torch.matmul(a, b)


def _limb_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product modulo 2^bits through float64 products, exact on any device: each
    operand cut into its bytes (two's complement), every pair of byte planes whose weight
    stays below 2^bits multiplied in float64 (each sum below 255²·k < 2^53 while k < 2^37,
    so exact), the planes' sums added byte by byte with their carries, and the bytes put
    back together as the type. Bool is the float64 product compared with 0."""
    if a.dtype == torch.bool:
        return torch.matmul(a.double(), b.double()) != 0
    nbytes = torch.iinfo(a.dtype).bits // 8
    planes_a = [((a.to(torch.int64) >> (8 * i)) & 0xFF).double() for i in range(nbytes)]
    planes_b = [((b.to(torch.int64) >> (8 * i)) & 0xFF).double() for i in range(nbytes)]
    out, carry = [], None
    for t in range(nbytes):  # byte t of the result: the planes of weight 2^(8t), and the carry
        total = sum(torch.matmul(planes_a[i], planes_b[t - i]) for i in range(t + 1)).to(torch.int64)
        total = total if carry is None else total + carry
        out.append(total & 0xFF)
        carry = total >> 8
    low = sum(out[i] << (8 * i) for i in range(min(nbytes, 4)))  # below 2^32
    if nbytes == 8:
        high = sum(out[i] << (8 * (i - 4)) for i in range(4, 8))
        return (high - ((high >> 31) << 32)) * 2**32 + low  # the int64 of the same bits
    if a.dtype != torch.uint8:  # the signed value of the low bits
        low = low - ((low >> (8 * nbytes - 1)) << (8 * nbytes))
    return low.to(a.dtype)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int_gemm_launch.argtypes = [i, i, p, p, p, ll, ll, ll, ll, ll, ll, p]
        lib.int_gemm_launch.restype = i
        lib.int_dot_launch.argtypes = [i, i, p, p, p, p, ll, i, p]
        lib.int_dot_launch.restype = i
        lib.int_gemm_sm_count.argtypes = [i, ctypes.POINTER(i)]
        lib.int_gemm_sm_count.restype = i
        lib.int_gemm_error_string.argtypes = [i]
        lib.int_gemm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"int_gemm: {what} failed: {lib.int_gemm_error_string(rc).decode()} ({rc})")


def _sms(lib: ctypes.CDLL, dev: int) -> int:
    if dev not in _SMS:
        n = ctypes.c_int(0)
        _raise_on(lib, lib.int_gemm_sm_count(dev, ctypes.byref(n)), "the SM count")
        _SMS[dev] = n.value
    return _SMS[dev]


def _accumulator(dtype: torch.dtype) -> torch.dtype:
    """The storage of the dot's uint32 (uint64 for int64) accumulator."""
    return torch.int64 if dtype == torch.int64 else torch.int32


def _count() -> None:
    global launches
    with _count_lock:
        launches += 1


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for t, name in ((a, "a"), (b, "b")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be bool or an integer type of 8 to 64 bits, got {t.dtype}")
    if a.dtype != b.dtype:
        raise TypeError(f"a is {a.dtype}, b {b.dtype}: promote them first")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int_matmul runs on CUDA or CPU tensors, got {a.device}")


def _launch(a: torch.Tensor, b: torch.Tensor, a_batch: int, b_batch: int, batch: int) -> torch.Tensor:
    """(batch, m, n) = a · b on the card: ``a`` holds ``batch`` (m, k) matrices a_batch
    elements apart (0: one for all), ``b`` (k, n) ones b_batch apart; both contiguous."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    c = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if k == 0:
        return c.zero_()
    lib = _lib()
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = DTYPES[a.dtype]
    if m == 1 and n == 1 and batch == 1:
        blocks = max(1, min(-(-k // (_DOT_THREADS * 8)), 4 * _sms(lib, dev)))
        # allocated on the stream the kernel runs on: when it is freed on return, the caching
        # allocator hands its memory only to work queued after it on that stream
        partial = torch.zeros(1, dtype=_accumulator(a.dtype), device=a.device)
        rc = lib.int_dot_launch(dev, code, a.data_ptr(), b.data_ptr(), c.data_ptr(), partial.data_ptr(), k, blocks, stream)
    else:
        rc = lib.int_gemm_launch(dev, code, a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k, a_batch, b_batch, stream)
    _raise_on(lib, rc, "launch")
    _count()
    return c


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul``'s shapes (1-D operands, broadcast batch dimensions) for bool and
    integer tensors of one type: the kernel on CUDA tensors (a 1-D operand as a one-row or
    one-column matrix, the batch dimensions as the kernel's batch), the plain version on
    CPU tensors."""
    _check(a, b)
    if a.dim() == 0 or b.dim() == 0:
        raise ValueError("matmul: both operands must have at least one dimension")
    a2 = a.unsqueeze(0) if a.dim() == 1 else a
    b2 = b.unsqueeze(-1) if b.dim() == 1 else b
    if a2.shape[-1] != b2.shape[-2]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and {tuple(b.shape)} are not aligned")
    if a.device.type == "cpu":
        return int_matmul_reference(a, b)
    batch_shape = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
    batch = 1
    for s in batch_shape:
        batch *= s
    m, k, n = a2.shape[-2], a2.shape[-1], b2.shape[-1]
    if a2.dim() == 2:
        a_batch, a3 = 0, a2.contiguous()
    else:
        a3, a_batch = a2.expand(*batch_shape, m, k).contiguous(), m * k
    if b2.dim() == 2:
        b_batch, b3 = 0, b2.contiguous()
    else:
        b3, b_batch = b2.expand(*batch_shape, k, n).contiguous(), k * n
    c = _launch(a3, b3, a_batch, b_batch, batch)
    if not batch_shape:
        c = c[0]
    else:
        c = c.view(*batch_shape, m, n)
    if a.dim() == 1:
        c = c.squeeze(-2)
    if b.dim() == 1:
        c = c.squeeze(-1)
    return c
