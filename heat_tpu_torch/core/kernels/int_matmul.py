"""The integer and bool matrix product, CUDA C++ kernels for Hopper.

Replaces no Pallas kernel: heat_tpu leaves integer and bool products to XLA's
``dot_general`` (``jnp.matmul``, ``jnp.dot``, ``jnp.vdot``), which gives the product
modulo 2^bits of the operands' type and, for bool, the OR of ANDs. cuBLAS has no integer
GEMM, so ``torch.matmul`` raises on CUDA integer tensors; these kernels compute them on
the card. Every order of their wrapping sums gives the same bits, so each result is exact
and bit-equal to XLA's. A product takes one of three routes (:func:`route`):

- bool, uint8 and int8 matrices: ``csrc/int_gemm_tc.cu`` on the int8 tensor cores
  (wgmma fed by TMA; B given as Bᵀ, written by the same source's transpose kernel, and k
  padded with zeros to 16 bytes: :func:`tc_operands`, emulated by :func:`tc_reference`);
- int16, int32 and int64 matrices: ``csrc/int_gemm_planes.cu`` on the same int8 tensor
  cores, as products of the operands' byte planes summed by weight (the planes written by
  the same source's two split kernels: :func:`plane_operands`, emulated by
  :func:`plane_reference`);
- the 1-D dot of any type (m = n = 1): ``csrc/int_gemm.cu``'s dot kernel.

Each source says what bounds its design and how it is laid out. The wrapper takes the
plain PyTorch version, :func:`int_matmul_reference`, only for tensors that lie on the CPU.
A CUDA tensor launches a kernel or raises: there is no fallback. Each kernel counts its
launches under ``_count_lock``: ``launches`` those of ``int_gemm.cu`` (one a dot),
``tc.launches`` those of the tensor-core product and ``transpose.launches`` those of its
transpose, ``byte_planes.launches`` those of the byte-plane product, and
``split_planes.launches`` and ``split_planes_t.launches`` those of its split kernels (one a
product each; two of ``split_planes`` where B is one column and needs no transpose).
"""

from __future__ import annotations

import ctypes
import threading
import types
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from . import _nvcc

__all__ = ["DTYPES", "INT64_CHUNK", "MAX_BATCH", "TC_DTYPES", "batched", "int_matmul_reference", "matmul",
           "padded_k", "plane_operands", "plane_reference", "planes_reference", "route", "tc_operands", "tc_reference",
           "transpose_pad_reference"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm.cu"
TC_SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm_tc.cu"
PLANES_SOURCE = Path(__file__).resolve().parent / "csrc" / "int_gemm_planes.cu"

launches = 0
"""Dots launched on ``int_gemm.cu`` since import (or since a caller reset it to 0)."""
# the counts move under this lock: request threads launch the kernels concurrently
_count_lock = threading.Lock()

# the tensor-core product and the transpose that gives it Bᵀ, each with its source and count
tc = types.SimpleNamespace(SOURCE=TC_SOURCE, launches=0)
transpose = types.SimpleNamespace(SOURCE=TC_SOURCE, launches=0)
# the byte-plane product and the two kernels that split its operands into planes (A's rows, and
# B's as planes of Bᵀ), each with its source and count
byte_planes = types.SimpleNamespace(SOURCE=PLANES_SOURCE, launches=0)
split_planes = types.SimpleNamespace(SOURCE=PLANES_SOURCE, launches=0)
split_planes_t = types.SimpleNamespace(SOURCE=PLANES_SOURCE, launches=0)

# the sources' dtype codes
DTYPES = {torch.bool: 0, torch.uint8: 1, torch.int8: 2, torch.int16: 3, torch.int32: 4, torch.int64: 5}
# the types of one byte, which the int8 tensor cores multiply (bool as uint8)
TC_DTYPES = (torch.bool, torch.uint8, torch.int8)
# int64's classes 0 to 3 sum whole in uint32 for at most (2^32 - 1) // (4·255²) = 16,512 steps
# of k; the kernel takes k in chunks of this many (kChunkK in int_gemm_planes.cu)
INT64_CHUNK = 16384
_DOT_THREADS = 256
MAX_BATCH = 65535  # the matrix kernels' batch is their grid's z
_K_ALIGN = 16  # TMA's global strides are multiples of 16 bytes

_LIB = None
_TC_LIB = None
_PLANES_LIB = None
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


def _planes_lib() -> ctypes.CDLL:
    global _PLANES_LIB
    if _PLANES_LIB is None:
        lib = _nvcc.load(PLANES_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int_gemm_planes_launch.argtypes = [i, i, p, p, p, ll, ll, ll, ll, ll, ll, ll, ll, p]
        lib.int_gemm_planes_launch.restype = i
        lib.int_planes_launch.argtypes = [i, i, p, p, ll, ll, ll, p]
        lib.int_planes_launch.restype = i
        lib.int_planes_t_launch.argtypes = [i, i, p, p, ll, ll, ll, ll, p]
        lib.int_planes_t_launch.restype = i
        lib.int_gemm_planes_error_string.argtypes = [i]
        lib.int_gemm_planes_error_string.restype = ctypes.c_char_p
        _PLANES_LIB = lib
    return _PLANES_LIB


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        name = "int_gemm_planes" if lib is _PLANES_LIB else "int_gemm_tc" if lib is _TC_LIB else "int_gemm"
        message = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: {what} failed: {message} ({rc})")


def _device(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


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
    bool, uint8 and int8 (int_gemm_tc.cu), ``"byte_planes"`` for int16, int32 and int64
    (int_gemm_planes.cu). No matrix-vector threshold sends a product with few output tiles
    to integer instructions: at n = 1 (8192² against a vector) the byte planes beat the
    IMAD kernel they replaced for int16, int32 and int64 alike (``tools/ab_int.py``), so
    every matrix of those types takes them."""
    if m == 1 and n == 1 and batch == 1:
        return "dot"
    return "tensor_cores" if dtype in TC_DTYPES else "byte_planes"


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
    dev = _device(b)
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
    dev = _device(a)
    rc = lib.int_gemm_tc_launch(dev, DTYPES[a.dtype], ops.a.data_ptr(), ops.bt.data_ptr(), c.data_ptr(), batch,
                                ops.m, ops.n, ops.k_pad, ops.a.shape[0], ops.bt.shape[0], ops.a_rows_batch,
                                ops.b_rows_batch, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "launch")
    with _count_lock:
        tc.launches += 1


class PlaneOperands(NamedTuple):
    """The byte-plane product's operands: ``a`` (S, batch_a · m, k_pad) and ``bt`` (S, batch_b
    · n, k_pad) of uint8, plane p holding byte p of each entry (two's complement read as
    unsigned; S the type's bytes), zeros past k, each 16-byte aligned; batch z's rows of a
    plane of A start at z · a_rows_batch (0 where one A serves every batch), those of Bᵀ at
    z · b_rows_batch."""

    a: torch.Tensor
    bt: torch.Tensor
    batch: int
    m: int
    n: int
    k_pad: int
    a_rows_batch: int
    b_rows_batch: int


def planes_reference(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The plain version of the split kernel: x (rows, k) of int16, int32 or int64 → (S, rows,
    k_pad) uint8, plane p byte p of each entry (two's complement read as unsigned), zeros past
    k. The split of Bᵀ is this of ``b.transpose(-1, -2)``'s rows."""
    rows, k = x.shape
    wide = x.to(torch.int64)
    out = torch.zeros((x.element_size(), rows, k_pad), dtype=torch.uint8, device=x.device)
    for p in range(x.element_size()):
        out[p, :, :k] = ((wide >> (8 * p)) & 0xFF).to(torch.uint8)
    return out


def _split(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The planes of x (rows, k), contiguous: the split kernel on a CUDA tensor, its plain
    version on a CPU one."""
    if x.device.type == "cpu":
        return planes_reference(x, k_pad)
    lib = _planes_lib()
    rows, k = x.shape
    out = torch.empty((x.element_size(), rows, k_pad), dtype=torch.uint8, device=x.device)
    rc = lib.int_planes_launch(_device(x), x.element_size(), x.data_ptr(), out.data_ptr(), rows, k, k_pad,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "the split's launch")
    with _count_lock:
        split_planes.launches += 1
    return out


def _split_t(b: torch.Tensor, k_pad: int) -> torch.Tensor:
    """The planes of Bᵀ of b (batch, k, n), contiguous: (S, batch · n, k_pad). Where n is 1, B
    already is Bᵀ and the split kernel takes it; else the transposing split kernel on a CUDA
    tensor, and the plain version on a CPU one."""
    batch, k, n = b.shape
    if n == 1:
        return _split(b.view(batch, k), k_pad)
    if b.device.type == "cpu":
        return planes_reference(b.transpose(-1, -2).reshape(batch * n, k), k_pad)
    lib = _planes_lib()
    out = torch.empty((b.element_size(), batch * n, k_pad), dtype=torch.uint8, device=b.device)
    rc = lib.int_planes_t_launch(_device(b), b.element_size(), b.data_ptr(), out.data_ptr(), batch, k, n, k_pad,
                                 torch.cuda.current_stream(b.device).cuda_stream)
    _raise_on(lib, rc, "the transposing split's launch")
    with _count_lock:
        split_planes_t.launches += 1
    return out


def plane_operands(a: torch.Tensor, b: torch.Tensor, a_batch: int, b_batch: int, batch: int) -> PlaneOperands:
    """The byte-plane product's operands of ``a`` (batch_a, m, k) and ``b`` (batch_b, k, n) of
    int16, int32 or int64, each contiguous, batch_a (batch_b) being ``batch`` where a_batch
    (b_batch) is not 0, else 1: A's planes and Bᵀ's, k padded to 16 (the split kernels on
    the card)."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    k_pad = padded_k(k)
    batch_a, batch_b = (batch if a_batch else 1), (batch if b_batch else 1)
    ap = _split(a.reshape(batch_a * m, k), k_pad)
    bt = _split_t(b.reshape(batch_b, k, n), k_pad)
    return PlaneOperands(ap, bt, batch, m, n, k_pad, m if a_batch else 0, n if b_batch else 0)


def plane_reference(ops: PlaneOperands, dtype: torch.dtype, chunk: int = INT64_CHUNK) -> torch.Tensor:
    """What the byte-plane kernel computes from its operands, in plain PyTorch: for each
    batch and each class s < S, Pₛ, the exact int64 sum of the u8 plane products aᵢ·bⱼᵀ
    with i + j = s, as the kernel's int32 accumulator holds it (read as uint32, so wrapped
    modulo 2^32), then combined modulo 2^bits. int16 and int32: Horner's rule over the
    classes, C = (…(P_{S-1}·2^8 + P_{S-2})·2^8 … + P₀) modulo 2^32, cut to the type. int64:
    H, the same over classes 7 to 4, as C's high word; classes 3 to 0 over each chunk of
    ``chunk`` steps of k, each class's chunk sum wrapped to uint32 and added shifted by 8s,
    modulo 2^64. Exact, and equal to the product, while ``chunk`` ≤ 16,512."""
    planes = ops.a.shape[0]
    out = []
    for z in range(ops.batch):
        a = [ops.a[p, z * ops.a_rows_batch:z * ops.a_rows_batch + ops.m].to(torch.int64) for p in range(planes)]
        bt = [ops.bt[p, z * ops.b_rows_batch:z * ops.b_rows_batch + ops.n].to(torch.int64) for p in range(planes)]

        def cls(s: int, lo: int, hi: int) -> torch.Tensor:
            """Pₛ over k in [lo, hi), wrapped to uint32 as the kernel's accumulator."""
            return sum(torch.matmul(a[i][:, lo:hi], bt[s - i][:, lo:hi].T) for i in range(s + 1)) % 2**32

        if planes < 8:
            acc = torch.zeros((ops.m, ops.n), dtype=torch.int64, device=ops.a.device)
            for s in reversed(range(planes)):
                acc = ((acc << 8) + cls(s, 0, ops.k_pad)) % 2**32
            bits = 8 * planes
            low = acc % 2**bits
            out.append((low - ((low >> (bits - 1)) << bits)).to(dtype))
            continue
        high = torch.zeros((ops.m, ops.n), dtype=torch.int64, device=ops.a.device)
        for s in range(7, 3, -1):
            high = ((high << 8) + cls(s, 0, ops.k_pad)) % 2**32
        low = torch.zeros_like(high)  # C = high·2^32 + low, each word kept below 2^32
        for lo in range(0, ops.k_pad, chunk):
            for s in range(3, -1, -1):
                term = cls(s, lo, lo + chunk) << (8 * s)  # below 2^56
                low = low + (term & 0xFFFFFFFF)
                high = (high + (term >> 32) + (low >> 32)) & 0xFFFFFFFF
                low = low & 0xFFFFFFFF
        out.append((high - ((high >> 31) << 32)) * 2**32 + low)  # the int64 of the same bits
    return torch.stack(out)


def _launch_planes(a: torch.Tensor, b: torch.Tensor, a_batch: int, b_batch: int, batch: int,
                   c: torch.Tensor) -> None:
    lib = _planes_lib()
    ops = plane_operands(a, b, a_batch, b_batch, batch)
    rc = lib.int_gemm_planes_launch(_device(a), ops.a.shape[0], ops.a.data_ptr(), ops.bt.data_ptr(), c.data_ptr(),
                                    batch, ops.m, ops.n, ops.k_pad, ops.a.shape[1], ops.bt.shape[1],
                                    ops.a_rows_batch, ops.b_rows_batch, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "launch")
    with _count_lock:
        byte_planes.launches += 1


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
    elements apart (0: one for all), ``b`` (k, n) ones b_batch apart; both contiguous. The
    matrix kernels take a batch of at most MAX_BATCH (their grid's z); a larger one is
    launched in runs of that many."""
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    c = torch.empty((batch, m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    if k == 0:
        return c.zero_()
    kind = route(a.dtype, batch, m, n)
    if kind != "dot":
        launch = _launch_tc if kind == "tensor_cores" else _launch_planes
        a3, b3 = a.reshape(-1, m, k), b.reshape(-1, k, n)
        for z0 in range(0, batch, MAX_BATCH):
            z1 = min(batch, z0 + MAX_BATCH)
            launch(a3[z0:z1] if a_batch else a3, b3[z0:z1] if b_batch else b3, a_batch, b_batch, z1 - z0, c[z0:z1])
        return c
    lib = _lib()
    dev = _device(a)
    blocks = max(1, min(-(-k // (_DOT_THREADS * 8)), 4 * _sms(lib, dev)))
    # allocated on the stream the kernel runs on: when it is freed on return, the caching
    # allocator hands its memory only to work queued after it on that stream
    partial = torch.zeros(1, dtype=_accumulator(a.dtype), device=a.device)
    rc = lib.int_dot_launch(dev, DTYPES[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(), partial.data_ptr(), k,
                            blocks, torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "the dot's launch")
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
