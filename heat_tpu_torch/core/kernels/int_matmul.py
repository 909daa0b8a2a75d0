"""The integer and bool matrix product, CUDA C++ kernels for Hopper.

Replaces no Pallas kernel: heat_tpu leaves integer and bool products to XLA's
``dot_general`` (``jnp.matmul``, ``jnp.dot``, ``jnp.vdot``), which gives the product
modulo 2^bits of the operands' type and, for bool, the OR of ANDs. cuBLAS has no integer
GEMM, so ``torch.matmul`` raises on CUDA integer tensors; these kernels compute them on
the card. Every order of their wrapping sums gives the same bits, so each result is exact
and bit-equal to XLA's. A product takes one of three routes (:func:`route`):

- bool, uint8 and int8 matrices: ``csrc/int_gemm_tc.cu`` on the int8 tensor cores
  (wgmma fed by TMA; B given as Bᵀ, written by the same source's transpose kernel, and k
  padded with zeros to 16 bytes: :func:`tc_operands`);
- int16, int32 and int64 matrices: ``csrc/int_gemm.cu`` on integer instructions (IMAD);
- the 1-D dot of any type (m = n = 1): ``int_gemm.cu``'s dot kernel.

Each source says what bounds its design and how it is laid out. The wrapper takes the
plain PyTorch version, :func:`int_matmul_reference`, only for tensors that lie on the CPU.
A CUDA tensor launches a kernel or raises: there is no fallback. Each kernel counts its
launches, one a product: ``launches`` those of ``int_gemm.cu``, ``tc.launches`` those of
the tensor-core product and ``transpose.launches`` those of the transpose, all under
``_count_lock``.
"""

from __future__ import annotations

import ctypes
import threading
import types
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from . import _nvcc

__all__ = ["DTYPES", "TC_DTYPES", "batched", "int_matmul_reference", "matmul", "padded_k", "route", "tc_operands",
           "tc_reference", "transpose_pad_reference"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm.cu"
TC_SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm_tc.cu"

launches = 0
"""Products launched on ``int_gemm.cu`` since import (or since a caller reset it to 0)."""
# the counts move under this lock: request threads launch the kernels concurrently
_count_lock = threading.Lock()

# the tensor-core product and the transpose that gives it Bᵀ, each with its source and count
tc = types.SimpleNamespace(SOURCE=TC_SOURCE, launches=0)
transpose = types.SimpleNamespace(SOURCE=TC_SOURCE, launches=0)

# the sources' dtype codes
DTYPES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3, torch.int32: 4, torch.int64: 5}
# the types of one byte, which the int8 tensor cores multiply (bool as uint8)
TC_DTYPES = (torch.bool, torch.uint8, torch.int8)
_DOT_THREADS = 256
_K_ALIGN = 16  # TMA's global strides are multiples of 16 bytes

_LIB = None
_TC_LIB = None
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


def _tc_lib() -> ctypes.CDLL:
    global _TC_LIB
    if _TC_LIB is None:
        lib = _nvcc.load(TC_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int_gemm_tc_launch.argtypes = [i, i, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, p]
        lib.int_gemm_tc_launch.restype = i
        lib.int_transpose_pad_launch.argtypes = [i, p, p, ll, ll, ll, ll, p]
        lib.int_transpose_pad_launch.restype = i
        lib.int_gemm_tc_error_string.argtypes = [i]
        lib.int_gemm_tc_error_string.restype = ctypes.c_char_p
        _TC_LIB = lib
    return _TC_LIB


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        name = "int_gemm_tc" if lib is _TC_LIB else "int_gemm"
        message = (lib.int_gemm_tc_error_string if lib is _TC_LIB else lib.int_gemm_error_string)(rc).decode()
        raise RuntimeError(f"{name}: {what} failed: {message} ({rc})")


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


def route(dtype: torch.dtype, batch: int, m: int, n: int) -> str:
    """The kernel a product of ``batch`` (m, k) · (k, n) matrices of ``dtype`` takes on
    the card: ``"dot"`` for one 1-D dot (int_gemm.cu's dot kernel), ``"tensor_cores"`` for
    bool, uint8 and int8 (int_gemm_tc.cu), ``"imad"`` for int16, int32 and int64
    (int_gemm.cu)."""
    if m == 1 and n == 1 and batch == 1:
        return "dot"
    return "tensor_cores" if dtype in TC_DTYPES else "imad"


def padded_k(k: int) -> int:
    """k rounded up to 16: the row of bytes that TMA can address."""
    return -(-k // _K_ALIGN) * _K_ALIGN


class TcOperands(NamedTuple):
    """The tensor-core product's operands: ``a`` (batch_a · m, k_pad) and ``bt`` (batch_b ·
    n, k_pad) of bytes, zeros past k, each 16-byte aligned; batch z's rows of A start at
    z · a_rows_batch (0 where one A serves every batch), those of Bᵀ at z · b_rows_batch."""

    a: torch.Tensor
    bt: torch.Tensor
    batch: int
    m: int
    n: int
    k_pad: int
    a_rows_batch: int
    b_rows_batch: int


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % _K_ALIGN == 0


def _pad_k(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """(batch, rows, k) → (batch, rows, k_pad), zeros past k: ``x`` itself where k already is
    k_pad and ``x`` is contiguous and 16-byte aligned, else a copy."""
    if x.shape[-1] == k_pad and x.is_contiguous() and _aligned(x):
        return x
    out = torch.zeros((*x.shape[:-1], k_pad), dtype=x.dtype, device=x.device)
    out[..., :x.shape[-1]] = x
    return out


def transpose_pad_reference(b: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The plain version of the transpose kernel: b (batch, k, n) → (batch, n, k_pad), zeros
    past k."""
    return _pad_k(b.transpose(-1, -2), k_pad)


def _transpose_pad(b: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Bᵀ padded: a (batch, 1, k) view of ``b`` where n is 1 (B already is Bᵀ) and needs no
    padding, else the transpose kernel on a CUDA tensor and its plain version on a CPU one."""
    batch, k, n = b.shape
    if n == 1:
        return _pad_k(b.view(batch, 1, k), k_pad)
    if b.device.type == "cpu":
        return transpose_pad_reference(b, k_pad)
    lib = _tc_lib()
    bt = torch.empty((batch, n, k_pad), dtype=b.dtype, device=b.device)
    dev = b.device.index if b.device.index is not None else torch.cuda.current_device()
    rc = lib.int_transpose_pad_launch(dev, b.data_ptr(), bt.data_ptr(), batch, k, n, k_pad,
                                      torch.cuda.current_stream(b.device).cuda_stream)
    _raise_on(lib, rc, "the transpose's launch")
    with _count_lock:
        transpose.launches += 1
    return bt


def tc_operands(a: torch.Tensor, b: torch.Tensor, a_batch: int, b_batch: int, batch: int) -> TcOperands:
    """The tensor-core product's operands of ``a`` (batch_a, m, k) and ``b`` (batch_b, k, n),
    each contiguous, batch_a (batch_b) being ``batch`` where a_batch (b_batch) is not 0, else
    1: A with k padded to 16, and Bᵀ padded the same way (the transpose kernel on the card)."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    k_pad = padded_k(k)
    batch_a, batch_b = (batch if a_batch else 1), (batch if b_batch else 1)
    ap = _pad_k(a.reshape(batch_a, m, k), k_pad)
    bt = _transpose_pad(b.reshape(batch_b, k, n), k_pad)
    return TcOperands(ap.view(batch_a * m, k_pad), bt.reshape(batch_b * n, k_pad), batch, m, n, k_pad,
                      m if a_batch else 0, n if b_batch else 0)


def tc_reference(ops: TcOperands, dtype: torch.dtype) -> torch.Tensor:
    """What the tensor-core kernel computes from its operands, in plain PyTorch: for each
    batch, the rows of A against the rows of Bᵀ in exact int64 sums, wrapped to int32 as the
    kernel's accumulators wrap, then cut to the type (bool: compared with 0)."""
    out = []
    for z in range(ops.batch):
        a = ops.a[z * ops.a_rows_batch:z * ops.a_rows_batch + ops.m]
        bt = ops.bt[z * ops.b_rows_batch:z * ops.b_rows_batch + ops.n]
        a = a.view(torch.uint8) if dtype == torch.bool else a
        bt = bt.view(torch.uint8) if dtype == torch.bool else bt
        acc = torch.matmul(a.to(torch.int64), bt.to(torch.int64).T)
        acc = ((acc + 2**31) % 2**32) - 2**31  # the int32 accumulator's wrap
        out.append(acc != 0 if dtype == torch.bool else acc.to(torch.int32).to(dtype))
    return torch.stack(out)


def _launch_tc(a: torch.Tensor, b: torch.Tensor, a_batch: int, b_batch: int, batch: int,
               c: torch.Tensor) -> None:
    lib = _tc_lib()
    ops = tc_operands(a, b, a_batch, b_batch, batch)
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    rc = lib.int_gemm_tc_launch(dev, DTYPES[a.dtype], ops.a.data_ptr(), ops.bt.data_ptr(), c.data_ptr(), batch,
                                ops.m, ops.n, ops.k_pad, ops.a.shape[0], ops.bt.shape[0], ops.a_rows_batch,
                                ops.b_rows_batch, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "launch")
    with _count_lock:
        tc.launches += 1


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
    kind = route(a.dtype, batch, m, n)
    if kind == "tensor_cores":
        _launch_tc(a, b, a_batch, b_batch, batch, c)
        return c
    lib = _lib()
    dev = a.device.index if a.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = DTYPES[a.dtype]
    if kind == "dot":
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


def batched(a2: torch.Tensor, b2: torch.Tensor) -> tuple:
    """The kernels' operands of ``a2`` (..., m, k) and ``b2`` (..., k, n): (a3, b3, a_batch,
    b_batch, batch_shape), the batch dimensions broadcast; an operand of two dimensions is
    one contiguous matrix that serves every batch (its batch stride 0), a batched one is
    expanded to the batch shape and made contiguous (its stride one matrix)."""
    batch_shape = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
    m, k, n = a2.shape[-2], a2.shape[-1], b2.shape[-1]
    if a2.dim() == 2:
        a_batch, a3 = 0, a2.contiguous()
    else:
        a3, a_batch = a2.expand(*batch_shape, m, k).contiguous(), m * k
    if b2.dim() == 2:
        b_batch, b3 = 0, b2.contiguous()
    else:
        b3, b_batch = b2.expand(*batch_shape, k, n).contiguous(), k * n
    return a3, b3, a_batch, b_batch, batch_shape


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
    a3, b3, a_batch, b_batch, batch_shape = batched(a2, b2)
    c = _launch(a3, b3, a_batch, b_batch, batch_shape.numel())
    m, n = a2.shape[-2], b2.shape[-1]
    c = c.view(*batch_shape, m, n)
    if a.dim() == 1:
        c = c.squeeze(-2)
    if b.dim() == 1:
        c = c.squeeze(-1)
    return c
