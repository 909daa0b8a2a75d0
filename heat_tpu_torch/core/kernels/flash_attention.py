"""K2: the flash-attention forward, a CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``heat_tpu/core/kernels/flash_attention.py:156``
(``_kernel``, launched by ``_flash_pallas``; entry ``flash_attention``, gate
``use_flash``). O = softmax(scale·QKᵀ [+ bias]) V and its log-sum-exp, with the (Tq, Tk)
scores never reaching device memory. The source, ``csrc/flash_attention_fwd.cu``, says
what bounds it on the card and how its design answers.

The wrapper takes the plain PyTorch version, :func:`flash_attention_reference`, only for
tensors that lie on the CPU. A CUDA tensor launches the kernel or raises: there is no
fallback. ``launches`` counts the kernel's launches.

There is no backward yet (heat_tpu's K4/K5): on the card the wrapper raises when grad
mode is on and an input requires grad, since a launch through ctypes is invisible to
autograd and the gradient would be dropped without a word.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..devices import full_fp32_matmul
from . import _nvcc

__all__ = [
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_reference",
    "kernel_takes",
    "use_flash",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"

launches = 0
"""Launches of the CUDA kernel since import (or since a caller reset it to 0)."""

_NEG_INF = float(torch.finfo(torch.float32).min)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# must agree with the source: head dims up to 128 (q and the accumulator in registers)
MAX_HEAD_DIM = 128

_LIB = None


def _as_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A (Tq, Tk) mask as an additive f32 bias: bool True = attend (0), False = NEG_INF;
    floats pass through as f32 (heat_tpu's ``_as_bias``, flash_attention.py:712)."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        return torch.where(mask, zero, torch.full_like(zero, _NEG_INF))
    return mask.to(torch.float32)


def _scale(q: torch.Tensor, scale) -> float:
    return (1.0 / math.sqrt(q.shape[-1])) if scale is None else float(scale)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: (out in q's dtype, lse f32) for q (..., Tq, D) and
    k, v (..., Tk, D), in full fp32 whatever the input type.

    Mirrors heat_tpu's ``flash_attention_reference`` (flash_attention.py:118) extended to
    the kernel's whole function: the additive ``bias`` (broadcast over the leading dims)
    and the fully-masked-row rule of ``_attention_weights`` (nn/attention.py:64-84: the
    row maximum is clamped at NEG_INF/2, so such rows give 0, not NaN), and the LSE of the
    kernel's finalize (flash_attention.py:223). Causal is top-left aligned (row i attends
    columns <= i), for any Tq, Tk."""
    s = _scale(q, scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    with full_fp32_matmul():
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * s
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(~keep, _NEG_INF)
    m = torch.clamp_min(torch.amax(scores, dim=-1, keepdim=True), _NEG_INF / 2)
    p = torch.exp(scores - m)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    with full_fp32_matmul():
        out = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def kernel_takes(q, k, v, mask=None, scale=None) -> bool:
    """What K2 takes, decided from shapes and types alone (the counterpart of heat_tpu's
    ``use_flash`` less its backend test):

    - q (..., Tq, D), k and v (..., Tk, D) with equal leading dims, Tq, Tk >= 1;
    - one dtype for all three, float32, bfloat16 or float16;
    - 1 <= D <= 128: q and the output accumulator of a row live in registers;
    - a static scale (a Python number or None);
    - no mask, or an exact-shape (Tq, Tk) bool mask shared by every batch·head.

    Unlike heat_tpu's gate, any Tq and Tk pass: the kernel masks ragged edges itself,
    where the TPU kernel needs lengths that its blocks tile (``_fits``)."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        return False
    if q.dim() < 2 or k.dim() != q.dim() or v.dim() != q.dim():
        return False
    if k.shape != v.shape or q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        return False
    tq, d = q.shape[-2], q.shape[-1]
    tk = k.shape[-2]
    if tq < 1 or tk < 1 or not 1 <= d <= MAX_HEAD_DIM or q.numel() == 0:
        return False
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        return False
    if scale is not None and (isinstance(scale, bool) or not isinstance(scale, (int, float))):
        return False
    if mask is not None and (
        not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool or tuple(mask.shape) != (tq, tk)
    ):
        return False
    return True


def use_flash(q, k, v, mask=None, scale=None) -> bool:
    """True when the attention runs K2: the inputs (and the mask) are CUDA tensors of one
    card and :func:`kernel_takes` them. Everything else takes the dense path, as
    heat_tpu sends what its kernel cannot take to XLA."""
    if not kernel_takes(q, k, v, mask, scale):
        return False
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        return False
    return mask is None or mask.device == dev


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd_launch.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, f, i, p]
        lib.flash_attention_fwd_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (..., Tq, D) in q's dtype, lse (..., Tq) f32): K2 on CUDA tensors, the plain
    version on CPU tensors. ``mask`` is a (Tq, Tk) bool (True = attend) shared by every
    batch·head. Raises on what :func:`kernel_takes` refuses, and on the card when grad
    mode is on and an input requires grad (K2 has no backward yet)."""
    global launches
    if not kernel_takes(q, k, v, mask, scale):
        raise ValueError(
            "flash_attention: the kernel takes q (..., Tq, D), k/v (..., Tk, D) of one dtype "
            f"(float32, bfloat16, float16), 1 <= D <= {MAX_HEAD_DIM}, a static scale and no mask "
            f"or a (Tq, Tk) bool one; got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}, mask {None if mask is None else (tuple(mask.shape), mask.dtype)}"
        )
    s = _scale(q, scale)
    bias = _as_bias(mask)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        if bias is not None and bias.device.type != "cpu":
            raise ValueError(f"the mask is on {bias.device}, q on the CPU")
        return flash_attention_reference(q, k, v, causal, s, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: K2 has no backward on the card yet (heat_tpu's K4/K5, ROADMAP.md "
            "Queue 2); run under torch.no_grad() or torch.inference_mode()"
        )
    if not use_flash(q, k, v, mask, scale):
        raise ValueError(
            f"flash_attention runs on CUDA or CPU tensors of one device, got q on {q.device}, "
            f"k on {k.device}, v on {v.device}"
            + ("" if mask is None else f", mask on {mask.device}")
        )
    *batch, tq, d = q.shape
    tk = k.shape[-2]
    bh = math.prod(batch)
    qc = q.reshape(bh, tq, d).contiguous()
    kc = k.reshape(bh, tk, d).contiguous()
    vc = v.reshape(bh, tk, d).contiguous()
    bias_c = None if bias is None else bias.contiguous()
    lib = _lib()
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    # allocated on the stream the kernel runs on
    out = torch.empty((bh, tq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd_launch(
        dev, _DTYPES[q.dtype], qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        None if bias_c is None else bias_c.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bh, tq, tk, d, s, int(bool(causal)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd: launch failed: {lib.flash_attention_error_string(rc).decode()} ({rc})")
    launches += 1
    return out.reshape(*batch, tq, d), lse.reshape(*batch, tq)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention by the flash forward (heat_tpu's ``flash_attention``): K2 on CUDA
    tensors, the plain version on CPU tensors. Returns the output only; see
    :func:`flash_attention_fwd` for the log-sum-exp."""
    return flash_attention_fwd(q, k, v, causal, scale, mask)[0]
