"""The flash-attention forwards K2 and K3 and the backward (the D pass, K4 and K5): CUDA
C++ kernels for Hopper.

Replaces the Pallas TPU kernels of ``heat_tpu/core/kernels/flash_attention.py``: ``_kernel``
(:156) and ``_kernel_pipelined`` (:238, both launched by ``_flash_pallas``) for the forward,
and ``_dq_kernel`` (:422) and ``_dkv_kernel`` (:480, both launched by ``_flash_bwd_pallas``)
with the D pre-pass (:592-596) for the backward; entry ``flash_attention``, gate
``use_flash``. The forward gives O = softmax(scale·QKᵀ [+ bias]) V and its log-sum-exp, the
backward dQ, dK and dV from O, LSE and dO, with the (Tq, Tk) scores never reaching device
memory. K3 computes what K2 computes, with heat_tpu's one-step skew: the scores of a key
tile are formed beside the exp and P·V of the tile before it. ``HEAT_TPU_FLASH_PIPELINE=1``
selects it for every forward, as it selects ``_kernel_pipelined`` in heat_tpu; the port
reads the variable on every call. The sources, ``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_fwd_pipelined.cu`` (their bf16 and f16 kernels through
``csrc/flash_fwd_16bit.cuh``) and ``csrc/flash_attention_bwd.cu``, say what bounds each
kernel on the card and how its design answers. Every kernel computes heat_tpu's arithmetic
in every type: f32 products in 3xTF32, bf16 and f16 ones on the 16-bit tensor cores (wgmma,
fed by TMA) with P (and dS) rounded to the input type before their products, as heat_tpu's
kernels round them.

:class:`_FlashAttention` is the ``torch.autograd.Function`` around them (heat_tpu's
``custom_vjp``, flash_attention.py:722-775): K2 or K3 forward, saving q, k, v, O and LSE;
D, K4 and K5 backward, once differentiable. The wrappers take the plain PyTorch versions,
:func:`flash_attention_reference`, :func:`flash_attention_pipelined_reference` and
:func:`flash_attention_bwd_reference`, only for tensors that lie on the CPU, through the
same ``Function``. A CUDA tensor launches the kernels or raises: there is no fallback.
``launches`` counts K2's launches, ``fwd_pipelined.launches`` K3's, and
``bwd_d.launches``, ``bwd_dq.launches`` and ``bwd_dkv.launches`` those of the backward's
three kernels.

The ring attentions (``heat_tpu_torch.nn.attention``) call the kernels block by block
through :func:`block_fwd`, :func:`block_d` and :func:`block_bwd`: K2/K3, K4 and K5 then
write their outputs in f32 (a second C entry point of each source, ``*_f32_launch``), so
the blocks' merged outputs and summed gradients round once, at the end. For 2-byte inputs
K2's and K3's f32-output blocks keep P in f32 (the 3xTF32 kernels), as heat_tpu's ring does
(``_online_attend``, heat_tpu/nn/attention.py:198, :211-214).
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
import types
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..devices import full_fp32_matmul
from . import _nvcc

__all__ = [
    "bind",
    "block_bwd",
    "block_d",
    "block_fwd",
    "d_pass",
    "d_pass_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_pipelined_reference",
    "flash_attention_reference",
    "kernel_takes",
    "use_flash",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention_fwd.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
PIPELINED_SOURCE = SOURCE.with_name("flash_attention_fwd_pipelined.cu")

launches = 0
"""Launches of K2 since import (or since a caller reset it to 0)."""
# every count of this module moves under this lock: the scheduler's request threads
# launch the kernels concurrently, and a bare ``+= 1`` is a read-modify-write that
# threads may interleave
_count_lock = threading.Lock()

# the backward's kernels, each with its source and its count of launches
bwd_d = types.SimpleNamespace(SOURCE=BWD_SOURCE, launches=0)
bwd_dq = types.SimpleNamespace(SOURCE=BWD_SOURCE, launches=0)
bwd_dkv = types.SimpleNamespace(SOURCE=BWD_SOURCE, launches=0)
# K3, the pipelined forward
fwd_pipelined = types.SimpleNamespace(SOURCE=PIPELINED_SOURCE, launches=0)
tma_copies = 0
"""Inputs of the 2-byte K2, K3, K4 and K5 copied into padded or aligned tensors for TMA (see
:func:`_tma_ready`) since import."""

_NEG_INF = float(torch.finfo(torch.float32).min)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# must agree with the sources: head dims up to 128 (a row's output accumulator in registers)
MAX_HEAD_DIM = 128

_LIB = None
_BWD_LIB = None
_PIPELINED_LIB = None


def _pipeline_enabled() -> bool:
    """True when ``HEAT_TPU_FLASH_PIPELINE`` is "1": every flash forward then runs K3 in
    place of K2 (heat_tpu's ``_pipeline_enabled``, flash_attention.py:226-235, which reads
    the same variable). Read on every call: the port has no trace time."""
    return os.environ.get("HEAT_TPU_FLASH_PIPELINE") == "1"


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


def _scores(qf: torch.Tensor, kf: torch.Tensor, s: float, causal: bool, bias) -> torch.Tensor:
    """The kernels' scores in fp32: (q·kᵀ)·scale, then + ``bias``, then causal entries
    (key > query, top-left aligned) at the finite NEG_INF."""
    with full_fp32_matmul():
        scores = torch.matmul(qf, kf.transpose(-1, -2)) * s
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.arange(tq, device=qf.device)[:, None] >= torch.arange(tk, device=qf.device)[None, :]
        scores = scores.masked_fill(~keep, _NEG_INF)
    return scores


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: (out in q's dtype, lse f32) for q (..., Tq, D) and
    k, v (..., Tk, D), in fp32 with heat_tpu's rounding of P.

    heat_tpu's ``flash_attention_reference`` (flash_attention.py:118) extended to the
    kernel's whole function: the additive ``bias`` (broadcast over the leading dims), the
    fully-masked-row rule of ``_attention_weights`` (nn/attention.py:64-84: the row maximum
    is clamped at NEG_INF/2, so such rows give 0, not NaN), the LSE of the kernel's finalize
    (flash_attention.py:223), and, for 16-bit inputs, P = exp(s − m) rounded to v's type
    before P·V (to nearest even), with l the sum of the unrounded P, as the kernel rounds it
    (``_online_softmax_update``, :147-151); f32 P stays f32. Here m is the whole row's
    maximum: that is heat_tpu's kernel where one key tile covers the row, and where it walks
    several, its P is relative to a running maximum and may round the other way, one unit
    of the type. tests/test_torch_flash_fwd_bf16.py holds this to heat_tpu's interpret-mode
    kernel (``_flash_pallas``) within one unit of the type of |O| and a share of max|O|, and
    bit for bit in most elements with one key tile. heat_tpu's own
    ``flash_attention_reference`` does not round P. Causal is top-left aligned (row i
    attends columns <= i), for any Tq, Tk."""
    qf, vf = q.float(), v.float()
    scores = _scores(qf, k.float(), _scale(q, scale), causal, bias)
    m = torch.clamp_min(torch.amax(scores, dim=-1, keepdim=True), _NEG_INF / 2)
    p = torch.exp(scores - m)
    l = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    with full_fp32_matmul():
        out = torch.matmul(_rounded(p, v.dtype), vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def _pair_schedule(nq: int, nk: int, bq: int, bk: int, causal: bool):
    """heat_tpu's ``_pair_schedule`` (flash_attention.py:327-347): the flattened (i, j)
    visit list of query block i and key block j, with flag bits per step (1 = first of the
    row's sweep, 2 = last, 4 = straddles the diagonal, so masked). Causal keeps only blocks
    with some row >= col. int32 arrays (im, jm, flags)."""
    im, jm, flags = [], [], []
    for i in range(nq):
        js = [j for j in range(nk) if not causal or j * bk <= i * bq + bq - 1]
        for idx, j in enumerate(js):
            f = (1 if idx == 0 else 0) | (2 if idx == len(js) - 1 else 0)
            if causal and (j * bk + bk - 1 > i * bq):
                f |= 4
            im.append(i)
            jm.append(j)
            flags.append(f)
    return np.asarray(im, np.int32), np.asarray(jm, np.int32), np.asarray(flags, np.int32)


def _pair_schedule_pipelined(nq: int, nk: int, bq: int, bk: int, causal: bool):
    """heat_tpu's ``_pair_schedule_pipelined`` (flash_attention.py:303-324): the pairs of
    :func:`_pair_schedule` with finalize (bit 2) moved off the real pairs onto one flush
    step (bits 2|8) appended per query row; the flush repeats the row's last (i, j)."""
    out_im, out_jm, out_fl = [], [], []
    for i, j, f in zip(*(a.tolist() for a in _pair_schedule(nq, nk, bq, bk, causal))):
        out_im.append(i)
        out_jm.append(j)
        out_fl.append(f & ~2)
        if f & 2:
            out_im.append(i)
            out_jm.append(j)
            out_fl.append(2 | 8)
    return np.asarray(out_im, np.int32), np.asarray(out_jm, np.int32), np.asarray(out_fl, np.int32)


def _online_softmax_update(s, vb, acc, m, l, has_bias: bool, dtype: torch.dtype):
    """One tile of the online-softmax recurrence (heat_tpu's ``_online_softmax_update``,
    flash_attention.py:135-153) on scores ``s`` (bh, bq, bk) f32 and values ``vb`` (bh, bk,
    D) of v's type ``dtype`` widened to f32: returns the new (acc, m, l). A bias may mask a
    whole row, so with one the row maximum is clamped at NEG_INF/2 and such a row keeps
    l = 0. l sums the f32 P; for P·V, P is rounded to ``dtype`` (to nearest even) where that
    is a 16-bit type, as heat_tpu rounds it (:147-151), and the sum is f32."""
    m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
    m_safe = torch.clamp_min(m_new, _NEG_INF / 2) if has_bias else m_new
    p = torch.exp(s - m_safe)
    corr = torch.exp(m - m_safe)
    l = l * corr + torch.sum(p, dim=-1, keepdim=True)
    with full_fp32_matmul():
        acc = acc * corr + torch.matmul(_rounded(p, dtype), vb)
    return acc, m_new, l


def flash_attention_pipelined_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    bq: int = 128,
    bk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: (out in q's dtype, lse f32) for q (..., Tq, D) and k, v
    (..., Tk, D), in fp32 with heat_tpu's rounding of P, by heat_tpu's ``_kernel_pipelined``
    (flash_attention.py:238-300) walked tile by tile over ``_pair_schedule_pipelined``
    with (bq, bk) blocks: the first step of a row only forms S₀; each later step forms S_p
    and runs the online-softmax update on S_{p−1}, masked by the previous pair's flag bit
    4 (for 16-bit inputs P rounded to v's type before P·V, per tile, as heat_tpu's kernel
    rounds it); the flush step (bit 8) only updates and finalizes. Every batch·head walks
    at once.

    Any Tq and Tk: the last blocks are padded, padded keys get −inf (weight exactly 0, as
    K2 and K3 mask a ragged edge) and padded rows are dropped. Causal is top-left aligned.
    A fully masked row gives O = 0 and LSE = NEG_INF/2 + log(1e-30)."""
    *batch, tq, d = q.shape
    tk = k.shape[-2]
    bh = math.prod(batch)
    s = _scale(q, scale)
    nq, nk = -(-tq // bq), -(-tk // bk)
    pq, pk = nq * bq - tq, nk * bk - tk
    qf = torch.nn.functional.pad(q.reshape(bh, tq, d).float(), (0, 0, 0, pq))
    kf = torch.nn.functional.pad(k.reshape(bh, tk, d).float(), (0, 0, 0, pk))
    vf = torch.nn.functional.pad(v.reshape(bh, tk, d).float(), (0, 0, 0, pk))
    has_bias = bias is not None
    if has_bias:
        bias = torch.nn.functional.pad(bias.to(torch.float32), (0, pk, 0, pq))
    dead = torch.zeros(nk * bk, dtype=torch.float32, device=q.device)
    dead[tk:] = -math.inf
    out = torch.empty(bh, nq * bq, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(bh, nq * bq, dtype=torch.float32, device=q.device)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bk, device=q.device)[None, :]
    im, jm, flags = _pair_schedule_pipelined(nq, nk, bq, bk, causal)
    s_prev = acc = m = l = None
    for p, (i, j, f) in enumerate(zip(im.tolist(), jm.tolist(), flags.tolist())):
        qs, ks = slice(i * bq, (i + 1) * bq), slice(j * bk, (j + 1) * bk)
        if f & 1:
            acc = torch.zeros(bh, bq, d, dtype=torch.float32, device=q.device)
            m = torch.full((bh, bq, 1), _NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros(bh, bq, 1, dtype=torch.float32, device=q.device)
        else:
            pi, pj, pf = int(im[p - 1]), int(jm[p - 1]), int(flags[p - 1])
            if pf & 4:
                s_prev = s_prev.masked_fill(pi * bq + rows < pj * bk + cols, _NEG_INF)
            acc, m, l = _online_softmax_update(s_prev, vf[:, pj * bk:(pj + 1) * bk], acc, m, l, has_bias, v.dtype)
        if not f & 8:
            with full_fp32_matmul():
                s_prev = torch.matmul(qf[:, qs], kf[:, ks].transpose(-1, -2)) * s
            if has_bias:
                s_prev = s_prev + bias[qs, ks]
            s_prev = s_prev + dead[ks]
        if f & 2:
            lc = torch.clamp_min(l, 1e-30)
            out[:, qs] = acc / lc
            lse[:, qs] = (torch.clamp_min(m, _NEG_INF / 2) + torch.log(lc)).squeeze(-1)
    out = out[:, :tq].to(q.dtype).reshape(*batch, tq, d)
    return out, lse[:, :tq].reshape(*batch, tq)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the D pass, K4 and K5: (dq, dk, dv) in q's, k's and v's
    dtypes, for the forward's ``o`` and ``lse`` and the output gradient ``do``, in fp32
    with heat_tpu's roundings.

    The probabilities are recomputed from the saved LSE exactly as the forward formed the
    scores (heat_tpu's ``_dq_kernel``/``_dkv_kernel``, flash_attention.py:450-458 and
    :510-518): s = (q·kᵀ)·scale, then + ``bias``, masked entries at NEG_INF, P = exp(s − LSE);
    D = rowsum(dO∘O) (:592-596) and dS = P∘(dO·vᵀ − D); dq = scale·dS·k, dk = scale·dSᵀ·q,
    dv = Pᵀ·dO. For 16-bit inputs, dS is rounded to q's type before its products and P to
    dO's before Pᵀ·dO, as heat_tpu's kernels round them (:460, :520, :525); for f32 both
    stay f32. Fully masked rows (LSE = NEG_INF/2 + log(1e-30), O = 0) give P = 0 and
    contribute nothing."""
    s = _scale(q, scale)
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    scores = _scores(qf, kf, s, causal, bias)
    p = torch.exp(scores - lse.to(torch.float32).unsqueeze(-1))
    dd = d_pass_reference(o, do).unsqueeze(-1)
    with full_fp32_matmul():
        ds = _rounded(p * (torch.matmul(gf, vf.transpose(-1, -2)) - dd), q.dtype)
        dq = torch.matmul(ds, kf) * s
        dk = torch.matmul(ds.transpose(-1, -2), qf) * s
        dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to a 16-bit ``dtype`` (to nearest even) and back; ``x`` itself for
    any other type."""
    return x.to(dtype).float() if dtype in (torch.bfloat16, torch.float16) else x


def _takes(q, k, v, mask, scale, float_bias: bool) -> bool:
    """:func:`kernel_takes`, and with ``float_bias`` also a floating (Tq, Tk) mask."""
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
        not isinstance(mask, torch.Tensor)
        or not (mask.dtype == torch.bool or (float_bias and mask.dtype.is_floating_point))
        or tuple(mask.shape) != (tq, tk)
    ):
        return False
    return True


def kernel_takes(q, k, v, mask=None, scale=None) -> bool:
    """What K2 and K3 take from the attention layer, decided from shapes and types alone
    (the counterpart of heat_tpu's ``use_flash`` less its backend test):

    - q (..., Tq, D), k and v (..., Tk, D) with equal leading dims, Tq, Tk >= 1;
    - one dtype for all three, float32, bfloat16 or float16;
    - 1 <= D <= 128: the output accumulator of a row lives in registers;
    - a static scale (a Python number or None);
    - no mask, or an exact-shape (Tq, Tk) bool mask shared by every batch·head.

    Unlike heat_tpu's gate, any Tq and Tk pass: the kernels mask ragged edges themselves,
    where the TPU kernel needs lengths that its blocks tile (``_fits``). Nor does the gate
    narrow under ``HEAT_TPU_FLASH_PIPELINE`` as ``_fits`` does (flush steps and the second
    score tile in its VMEM budget): K3 takes what K2 takes. A float bias reaches the
    kernels only through :func:`flash_attention` called directly, as in heat_tpu, whose
    gate also routes only bool masks to its kernel."""
    return _takes(q, k, v, mask, scale, float_bias=False)


def _one_card(q, k, v, mask) -> bool:
    dev = q.device
    return dev.type == "cuda" and k.device == dev and v.device == dev and (mask is None or mask.device == dev)


def use_flash(q, k, v, mask=None, scale=None) -> bool:
    """True when the attention runs the flash kernels (K2, or K3 under
    ``HEAT_TPU_FLASH_PIPELINE=1``): the inputs (and the mask) are CUDA tensors of one card
    and :func:`kernel_takes` them. Everything else takes the dense path, as heat_tpu
    sends what its kernel cannot take to XLA."""
    return kernel_takes(q, k, v, mask, scale) and _one_card(q, k, v, mask)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
_DQ_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
_DKV_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P]
# the C entry points of the flash sources, each returning an error code
_ENTRY_POINTS = {
    "flash_attention_fwd_launch": _FWD_ARGS,
    "flash_attention_fwd_f32_launch": _FWD_ARGS,
    "flash_attention_fwd_pipelined_launch": _FWD_ARGS,
    "flash_attention_fwd_pipelined_f32_launch": _FWD_ARGS,
    "flash_attention_bwd_d_launch": [_I, _I, _P, _P, _P, ctypes.c_longlong, _I, _P],
    "flash_attention_bwd_dq_launch": _DQ_ARGS,
    "flash_attention_bwd_dq_f32_launch": _DQ_ARGS,
    "flash_attention_bwd_dkv_launch": _DKV_ARGS,
    "flash_attention_bwd_dkv_f32_launch": _DKV_ARGS,
}
_ERROR_STRINGS = (
    "flash_attention_error_string",
    "flash_attention_fwd_pipelined_error_string",
    "flash_attention_bwd_error_string",
)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of any of the flash sources, with the argument and result types of
    the C entry points it exports."""
    for name, args in _ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, _I
    for name in _ERROR_STRINGS:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [_I], ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(_nvcc.load(SOURCE))
    return _LIB


def _pipelined_lib() -> ctypes.CDLL:
    global _PIPELINED_LIB
    if _PIPELINED_LIB is None:
        _PIPELINED_LIB = bind(_nvcc.load(PIPELINED_SOURCE))
    return _PIPELINED_LIB


def _bwd_lib() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        _BWD_LIB = bind(_nvcc.load(BWD_SOURCE))
    return _BWD_LIB


def _on_card(q, k, v, mask) -> bool:
    """False for CPU tensors (the plain versions run), True for CUDA tensors of one card;
    raises on anything else. The caller has checked what the kernels take."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        if mask is not None and mask.device.type != "cpu":
            raise ValueError(f"the mask is on {mask.device}, q on the CPU")
        return False
    if not _one_card(q, k, v, mask):
        raise ValueError(
            f"flash_attention runs on CUDA or CPU tensors of one device, got q on {q.device}, "
            f"k on {k.device}, v on {v.device}" + ("" if mask is None else f", mask on {mask.device}")
        )
    return True


def _launch(fn, error_string, *args) -> None:
    """Call a kernel's C entry point and raise if the launch failed."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: launch failed: {error_string(rc).decode()} ({rc})")


def _card(t: torch.Tensor) -> Tuple[int, int]:
    """(device index, current stream) of a CUDA tensor: kernels and outputs share the stream."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(t.device).cuda_stream


def _forward(lib, entry: str, error_string: str, q, k, v, causal: bool, scale: float, bias, out_f32: bool):
    """One launch of K2 or K3 (``entry`` and ``error_string`` name the C entry points of
    ``lib``) on contiguous (bh, Tq, D), (bh, Tk, D) CUDA tensors: O in q's dtype, or in f32
    with ``out_f32`` (blocks that the ring attentions merge), and LSE. The 2-byte kernels
    that write O in q's type read through TMA (:func:`_tma_ready`); O's padded columns are
    cut off."""
    bh, tq, d = q.shape
    if q.dtype != torch.float32 and not out_f32:
        q, k, v = _tma_ready(q, k, v)
    dp = q.shape[-1]
    dev, stream = _card(q)
    out = torch.empty((bh, tq, dp), dtype=torch.float32 if out_f32 else q.dtype, device=q.device)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    _launch(
        getattr(lib, f"{entry}_f32_launch" if out_f32 else f"{entry}_launch"), getattr(lib, error_string), dev,
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), lse.data_ptr(), bh, tq, k.shape[1], dp, scale, int(causal), stream,
    )
    return (out if dp == d else out[..., :d].contiguous()), lse


def _k2(q, k, v, causal: bool, scale: float, bias, out_f32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 (:func:`_forward`): the 3xTF32 kernel for f32 and for ``out_f32``, the wgmma one
    for 2-byte types."""
    global launches
    out = _forward(_lib(), "flash_attention_fwd", "flash_attention_error_string", q, k, v, causal, scale, bias,
                   out_f32)
    with _count_lock:
        launches += 1
    return out


def _k3(q, k, v, causal: bool, scale: float, bias, out_f32: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 (:func:`_forward`), as :func:`_k2` by route."""
    out = _forward(_pipelined_lib(), "flash_attention_fwd_pipelined", "flash_attention_fwd_pipelined_error_string",
                   q, k, v, causal, scale, bias, out_f32)
    with _count_lock:
        fwd_pipelined.launches += 1
    return out


def d_pass_reference(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the D pass (heat_tpu's jnp pre-pass, flash_attention.py:592-596):
    D = Σ_c f32(dO)·f32(O) over the last axis, f32."""
    return torch.sum(do.float() * o.float(), dim=-1)


def d_pass(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The D pass of (bh, Tq, D) ``o`` and ``do`` of one dtype: D (bh, Tq) f32. A CUDA tensor
    launches the kernel (``flash_attention_bwd_d_kernel``); a CPU tensor takes
    :func:`d_pass_reference`."""
    if o.device.type != "cuda":
        return d_pass_reference(o, do)
    return _d_pass(o.contiguous(), do.to(o.dtype).contiguous())


def _d_pass(o, do) -> torch.Tensor:
    """The D pass on contiguous (bh, Tq, D) CUDA tensors of one dtype: D (bh, Tq) f32."""
    bh, tq, d = o.shape
    lib = _bwd_lib()
    dev, stream = _card(o)
    dd = torch.empty((bh, tq), dtype=torch.float32, device=o.device)
    _launch(lib.flash_attention_bwd_d_launch, lib.flash_attention_bwd_error_string, dev, _DTYPES[o.dtype],
            o.data_ptr(), do.data_ptr(), dd.data_ptr(), bh * tq, d, stream)
    with _count_lock:
        bwd_d.launches += 1
    return dd


def _tma_ready(*tensors) -> Tuple[torch.Tensor, ...]:
    """``tensors`` (q, k and v of the forward; q, k, v and dO of the backward) as the 2-byte
    K2, K3, K4 and K5 take them: TMA reads rows of 16-byte strides from 16-byte aligned
    tensors. A head dim that is not a multiple of 8 is padded with zero columns (they add
    nothing to a product, and the padded columns of the outputs are cut off), and a tensor
    that is not aligned is copied; ``tma_copies`` counts the copies. f32 tensors pass as
    they are (the f32 kernels read them with cp.async)."""
    global tma_copies
    if tensors[0].dtype == torch.float32:
        return tensors
    pad = -tensors[0].shape[-1] % 8
    out = tuple(torch.nn.functional.pad(t, (0, pad)) if pad else t.clone() if t.data_ptr() % 16 else t
                for t in tensors)
    copies = sum(a is not b for a, b in zip(out, tensors))
    if copies:
        with _count_lock:
            tma_copies += copies
    return out


def _k4(q, k, v, do, lse, dd, causal: bool, scale: float, bias, out_f32: bool = False) -> torch.Tensor:
    """K4 on contiguous (bh, T, D) CUDA tensors of one dtype: dQ, in q's dtype or in f32 with
    ``out_f32``."""
    bh, tq, d = q.shape
    q, k, v, do = _tma_ready(q, k, v, do)
    dp = q.shape[-1]
    lib = _bwd_lib()
    dev, stream = _card(q)
    dq = torch.empty(q.shape, dtype=torch.float32 if out_f32 else q.dtype, device=q.device)
    _launch(
        lib.flash_attention_bwd_dq_f32_launch if out_f32 else lib.flash_attention_bwd_dq_launch,
        lib.flash_attention_bwd_error_string, dev, _DTYPES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        None if bias is None else bias.data_ptr(), dq.data_ptr(), bh, tq, k.shape[1], dp, scale, int(causal), stream,
    )
    with _count_lock:
        bwd_dq.launches += 1
    return dq[..., :d]


def _k5(
    q, k, v, do, lse, dd, causal: bool, scale: float, bias, out_f32: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on contiguous (bh, T, D) CUDA tensors of one dtype: dK and dV, in k's dtype or in
    f32 with ``out_f32``."""
    bh, tq, d = q.shape
    q, k, v, do = _tma_ready(q, k, v, do)
    dp = q.shape[-1]
    lib = _bwd_lib()
    dev, stream = _card(q)
    dk, dv = (torch.empty(k.shape, dtype=torch.float32 if out_f32 else k.dtype, device=k.device) for _ in range(2))
    _launch(
        lib.flash_attention_bwd_dkv_f32_launch if out_f32 else lib.flash_attention_bwd_dkv_launch,
        lib.flash_attention_bwd_error_string, dev, _DTYPES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
        None if bias is None else bias.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, tq, k.shape[1], dp, scale,
        int(causal), stream,
    )
    with _count_lock:
        bwd_dkv.launches += 1
    return dk[..., :d], dv[..., :d]


def _backward(q, k, v, o, do, lse, causal: bool, scale: float, bias, on_card: bool):
    if not on_card:
        return flash_attention_bwd_reference(q, k, v, o, do, lse, causal, scale, bias)
    do = do.to(q.dtype).contiguous()
    dd = _d_pass(o, do)
    return (_k4(q, k, v, do, lse, dd, causal, scale, bias), *_k5(q, k, v, do, lse, dd, causal, scale, bias))


def block_fwd(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of a ring attention: (O f32, LSE f32) for contiguous (bh, Tq, D), (bh, Tk,
    D) tensors of one type. K2 (K3 under ``HEAT_TPU_FLASH_PIPELINE=1``) writes O in f32 on
    the card, so blocks merged by their LSEs round once, at the end; CPU tensors take the
    plain versions on f32 copies (exact for every input type). No autograd."""
    if _on_card(q, k, v, None):
        return (_k3 if _pipeline_enabled() else _k2)(q, k, v, causal, scale, None, out_f32=True)
    ref = flash_attention_pipelined_reference if _pipeline_enabled() else flash_attention_reference
    return ref(q.float(), k.float(), v.float(), causal, scale)


def block_d(o, do) -> Optional[torch.Tensor]:
    """The D pass of a ring attention's backward on this rank's final O and dO (contiguous
    (bh, T, D), one type): one launch on the card; None on the CPU, whose plain backward
    forms D itself from the same O and dO."""
    return _d_pass(o, do) if o.device.type == "cuda" else None


def block_bwd(q, k, v, o, do, lse, dd, causal: bool, scale: float):
    """(dQ, dK, dV) f32 of one ring block from the final O, dO, LSE and D of its query rows
    (never the block's own): K4 and K5 writing f32 on the card, so the blocks' sums round
    once, at the end; the plain backward on f32 copies on the CPU."""
    if _on_card(q, k, v, None):
        return (_k4(q, k, v, do, lse, dd, causal, scale, None, out_f32=True),
                *_k5(q, k, v, do, lse, dd, causal, scale, None, out_f32=True))
    return flash_attention_bwd_reference(*(t.float() for t in (q, k, v, o, do)), lse, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Exact attention with the flash backward (heat_tpu's ``custom_vjp`` of
    ``flash_attention``, :722-775) on (bh, Tq, D), (bh, Tk, D) contiguous tensors.

    Forward: K2, or K3 under ``HEAT_TPU_FLASH_PIPELINE=1`` (their plain versions on CPU
    tensors), giving (O, LSE); it saves q, k, v, O and LSE, and LSE is not
    differentiable. Backward: the D pass, K4 and K5 (the plain backward on CPU tensors),
    once differentiable as heat_tpu's has no double backward; causal, scale and the bool
    mask get None (heat_tpu returns a zero cotangent for a bool mask, :771). A float bias
    has a gradient that this backward does not compute, so it raises, as heat_tpu's does
    (:756-765)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, mask):
        on_card = _on_card(q, k, v, mask)
        bias = None if mask is None else _as_bias(mask).contiguous()
        if _pipeline_enabled():
            out, lse = (_k3 if on_card else flash_attention_pipelined_reference)(q, k, v, causal, scale, bias)
        else:
            out, lse = (_k2 if on_card else flash_attention_reference)(q, k, v, causal, scale, bias)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.causal, ctx.scale, ctx.on_card = causal, scale, on_card
        ctx.float_bias = mask is not None and mask.dtype != torch.bool
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dlse):
        if ctx.float_bias:
            raise NotImplementedError(
                "gradient through a float attention bias is not implemented on the flash path; boolean masks "
                "are gradient-free and fine — use the dense attention path for a learned additive bias"
            )
        q, k, v, out, lse, bias = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, dout, lse, ctx.causal, ctx.scale, bias, ctx.on_card)
        return dq, dk, dv, None, None, None


def _refuse(q, k, v, mask) -> ValueError:
    return ValueError(
        "flash_attention: the kernel takes q (..., Tq, D), k/v (..., Tk, D) of one dtype "
        f"(float32, bfloat16, float16), 1 <= D <= {MAX_HEAD_DIM}, a static scale and no mask, "
        f"a (Tq, Tk) bool one or (in the forward) a (Tq, Tk) float bias; got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
        f"v {tuple(v.shape)} {v.dtype}, mask {None if mask is None else (tuple(mask.shape), mask.dtype)}"
    )


def _flat(t: torch.Tensor, bh: int) -> torch.Tensor:
    return t.reshape(bh, t.shape[-2], t.shape[-1]).contiguous()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (..., Tq, D) in q's dtype, lse (..., Tq) f32): K2 (K3 under
    ``HEAT_TPU_FLASH_PIPELINE=1``) on CUDA tensors, the plain version on CPU tensors, both
    through :class:`_FlashAttention`, so gradients flow to q, k and v (the D pass, K4 and
    K5 on the card). ``mask`` is a (Tq, Tk) bool (True = attend) or an additive float bias
    (heat_tpu's ``flash_attention``, :712-742), shared by every batch·head; the gradient
    of a call with a float bias raises ``NotImplementedError``. Raises on what the kernels
    do not take and on tensors that are neither on the CPU nor on one card."""
    if not _takes(q, k, v, mask, scale, float_bias=True):
        raise _refuse(q, k, v, mask)
    *batch, tq, d = q.shape
    bh = math.prod(batch)
    out, lse = _FlashAttention.apply(_flat(q, bh), _flat(k, bh), _flat(v, bh), bool(causal), _scale(q, scale), mask)
    return out.reshape(*batch, tq, d), lse.reshape(*batch, tq)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the attention whose forward gave ``o`` and ``lse``, for the output
    gradient ``do`` (heat_tpu's ``_flash_bwd_pallas``): the D pass, K4 and K5 on CUDA
    tensors, :func:`flash_attention_bwd_reference` on CPU tensors. Takes what the forward
    takes; ``o`` and ``do`` are (..., Tq, D) in q's dtype and ``lse`` (..., Tq) f32."""
    if not kernel_takes(q, k, v, mask, scale):
        raise _refuse(q, k, v, mask)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:-1]:
        raise ValueError(f"o and do must be {tuple(q.shape)} and lse {tuple(q.shape[:-1])}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and {tuple(lse.shape)}")
    if any(t.device != q.device for t in (o, do, lse)):
        raise ValueError(f"o, do and lse must lie on q's device {q.device}")
    on_card = _on_card(q, k, v, mask)
    *batch, tq, d = q.shape
    bh = math.prod(batch)
    bias = None if mask is None else _as_bias(mask).contiguous()
    flat = [_flat(t, bh) for t in (q, k, v, o.to(q.dtype), do.to(q.dtype))]
    lse_c = lse.to(torch.float32).reshape(bh, tq).contiguous()
    grads = _backward(*flat, lse_c, bool(causal), _scale(q, scale), bias, on_card)
    return tuple(g.reshape(t.shape) for g, t in zip(grads, (q, k, v)))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention by the flash forward (heat_tpu's ``flash_attention``), differentiable
    by the flash backward: the kernels on CUDA tensors, the plain versions on CPU tensors.
    Returns the output only; see :func:`flash_attention_fwd` for the log-sum-exp."""
    return flash_attention_fwd(q, k, v, causal, scale, mask)[0]
