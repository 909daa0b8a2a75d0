"""Attention: heat_tpu's ``nn/attention.py`` on PyTorch, for serving, training and long context.

Scaled dot-product attention, ``MultiheadAttention`` and the Transformer family as modules
with ``forward``, under heat_tpu's names, defaults (``batch_first=True``) and parameter
names, so that a parameter tree of heat_tpu maps onto a ``state_dict`` mechanically
(``heat_tpu_torch.interop.load_jax_params``). Three strategies, as heat_tpu's:

- **dense** (:func:`_dense_attention`): inputs that the flash kernel takes
  (``kernels.flash_attention.use_flash``: CUDA tensors of one dtype, head dim <= 128, no
  mask or a (Tq, Tk) bool one) run K2, the CUDA flash forward (K3, the pipelined one, under
  ``HEAT_TPU_FLASH_PIPELINE=1``), and their gradients the flash backward (the D pass, K4
  and K5); everything else takes the dense path in full fp32, differentiated by autograd.
- **ring** (:func:`ring_attention`, :func:`ring_attention_zigzag`): q, k and v split along
  the sequence over the ranks of a communicator. Each rank attends its query chunk to every
  k/v chunk as it comes round the ring, one K2 launch a block with O written in f32, and
  merges the blocks exactly by their log-sum-exps; the backward is one D pass a rank and
  K4 and K5 a block, from the final O, LSE and D (:class:`_RingAttention`).
- **Ulysses** (:func:`ulysses_attention`): two all-to-alls turn the sequence split into a
  head split, the dense attention (K2) runs on whole sequences, one all-to-all turns back.

Causal masking is top-left aligned (query i attends keys <= i). DNDarray inputs: a split
along the batch axis is attended rank by rank; a split along the sequence takes the ring
where heat_tpu's does (q, k and v split along it, no mask, the length divisible by the
ranks), and every other layout is computed whole on every rank; the result keeps the
query's split. Train-mode dropout takes heat_tpu's PRNG key (the two uint32 words of
``jax.random.key_data``), so its masks equal heat_tpu's bit for bit; it computes the
(T, T) weights densely, and on a sequence split warns and gathers, as heat_tpu does.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import warnings
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as TF
from torch.autograd.function import once_differentiable

from ..core import devices
from ..core._operations import wrap_result
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.dndarray import DNDarray
from ..core.devices import full_fp32_matmul
from ..core.kernels import flash_attention as fa
from ..core.kernels.flash_attention import _as_bias, flash_attention, kernel_takes, use_flash
from . import functional as F
from .modules import LayerNorm, Linear, Module

__all__ = [
    "scaled_dot_product_attention",
    "ring_attention",
    "ring_attention_zigzag",
    "zigzag_order",
    "zigzag_inverse",
    "ulysses_attention",
    "MultiheadAttention",
    "TransformerEncoderLayer",
    "TransformerEncoder",
    "TransformerDecoderLayer",
    "TransformerDecoder",
    "Transformer",
]

_NEG_INF = float(torch.finfo(torch.float32).min)


def _attention_weights(q, k, mask, is_causal, scale):
    """Row-stochastic attention weights in f32, rows fully masked giving 0 (heat_tpu's
    ``_attention_weights``, nn/attention.py:64)."""
    s = (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale
    with full_fp32_matmul():
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    if is_causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.arange(tq, device=scores.device)[:, None] >= torch.arange(tk, device=scores.device)[None, :]
        scores = scores.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, _NEG_INF)
        else:
            scores = scores + mask.float()
    m = torch.clamp_min(torch.amax(scores, dim=-1, keepdim=True), _NEG_INF / 2)
    p = torch.exp(scores - m)
    return p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)


def _dense_attention(q, k, v, mask=None, is_causal=False, scale=None):
    """Exact attention on local tensors, q (..., Tq, D), k/v (..., Tk, D): K2 where
    ``use_flash`` holds, else the dense path in full fp32 (heat_tpu's XLA path)."""
    if use_flash(q, k, v, mask, scale):
        return flash_attention(q, k, v, is_causal, scale, mask)
    pw = _attention_weights(q, k, mask, is_causal, scale)
    with full_fp32_matmul():
        return torch.matmul(pw, v.float()).to(q.dtype)


def _dense_attention_dropout(q, k, v, mask, is_causal, scale, dropout_p: float, key):
    """Dense attention with torch's train-time attention dropout (heat_tpu's, :230): the
    weights dropped by heat_tpu's keyed mask over their (..., Tq, Tk) shape, kept ones
    over 1 − p; p = 1 gives zeros."""
    if dropout_p == 1.0:
        return torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype, device=q.device)
    pw = _attention_weights(q, k, mask, is_causal, scale)
    pw = F._inverted(pw, F._keep(key, pw.shape, dropout_p, pw.device), dropout_p)
    with full_fp32_matmul():
        return torch.matmul(pw, v.float()).to(q.dtype)


# ---------------------------------------------------------------------- DNDarray layout
def _whole(t):
    """All of ``t`` on this rank: a DNDarray is gathered, a tensor is taken as it is."""
    return t._relayout(None) if isinstance(t, DNDarray) else t


def _finish(out: torch.Tensor, proto, run: Optional[int], keep: Optional[int]):
    """This rank's output as the call's result: a tensor when ``proto`` is one, else a
    DNDarray like ``proto`` split along ``run`` (this rank's chunk along it) or ``keep``
    (``out`` whole, chunked)."""
    if not isinstance(proto, DNDarray):
        return out
    if run is not None:
        gshape = list(out.shape)
        gshape[run] = proto.gshape[run]
        return wrap_result(out, proto, run, tuple(gshape))
    if keep is not None and proto.comm.size > 1:
        _, _, slices = proto.comm.chunk(tuple(out.shape), keep)
        return wrap_result(out[slices], proto, keep, tuple(out.shape))
    return wrap_result(out, proto, keep)


def _dim(t) -> int:
    return -1 if t is None else t.ndim


def _batch_part(proto: DNDarray, axis: int) -> Callable:
    """``part(t, ax)``: this rank's rows of an input that extends along ``ax`` over the
    whole of ``proto``'s split axis (a negative ``ax``: it does not), else all of it."""
    comm, length = proto.comm, proto.gshape[axis]

    def part(t, ax=-1):
        if t is None:
            return None
        if ax < 0 or t.ndim <= ax or t.shape[ax] != length:
            return _whole(t)
        if isinstance(t, DNDarray):
            return t._relayout(ax)
        return t[comm.chunk(tuple(t.shape), ax)[2]]

    return part


def _layout(proto, batch_axes: Sequence[int], seq_axis: int, seq_inputs: Sequence, ring_ok: Callable[[], bool]):
    """How a call whose query-like input is ``proto`` runs on this rank: ``("batch", axis,
    part)`` for a DNDarray split over ranks along one of ``batch_axes`` (attention is
    independent along them: each rank takes its rows); ``("ring", seq_axis, comm)`` when
    ``proto`` and every DNDarray of ``seq_inputs`` are split along ``seq_axis`` and
    ``ring_ok()``; else ``("whole", None, part)``, every rank computing the whole."""
    if isinstance(proto, DNDarray) and proto.is_distributed():
        if proto.split in batch_axes:
            return "batch", proto.split, _batch_part(proto, proto.split)
        if (
            proto.split == seq_axis
            and all(isinstance(t, DNDarray) and t.split == seq_axis for t in seq_inputs)
            and ring_ok()
        ):
            return "ring", seq_axis, proto.comm
    return "whole", None, lambda t, ax=-1: None if t is None else _whole(t)


def _ring_shapes_ok(comm: TorchCommunication, dtype: torch.dtype, *shapes_and_axes) -> bool:
    """The ring's conditions on (gshape, seq axis, head dim) triples: every sequence length
    divisible by the ranks (equal chunks), and what the block kernels take."""
    return dtype in fa._DTYPES and all(g[ax] % comm.size == 0 and 1 <= d <= fa.MAX_HEAD_DIM for g, ax, d in shapes_and_axes)


# ---------------------------------------------------------------------- ring engine
# A block is (query rows, key rows, causal): slices of this rank's query chunk and of the
# k/v chunk at hand. Every block is full or a square diagonal block of equal offsets, the
# two kinds K2's top-left causal flag computes right.
_ALL = slice(None)


def _ring_schedule(my: int, causal: bool) -> Callable[[int], List[tuple]]:
    """heat_tpu's ring (:243): block (my, src) causal on the diagonal, full below it or
    when not causal; a block wholly above the diagonal is masked whole and never launched."""

    def blocks(src: int):
        if not causal or src < my:
            return [(_ALL, _ALL, False)]
        return [(_ALL, _ALL, True)] if src == my else []

    return blocks


def _zigzag_schedule(my: int, c: int) -> Callable[[int], List[tuple]]:
    """heat_tpu's zigzag ring (:337): a rank holds chunks ``my`` (rows :c) and
    ``2p − 1 − my`` (rows c:). At its own k/v: lo×lo and hi×hi diagonal, hi×lo full; at
    ``src``'s: hi×src-lo full, and lo×src-lo if ``src < my``, else hi×src-hi, full. heat_tpu
    selects the second with ``jnp.where``; here the host picks it. 2p + 1 launches, c × c."""
    lo, hi = slice(0, c), slice(c, 2 * c)

    def blocks(src: int):
        if src == my:
            return [(lo, lo, True), (hi, hi, True), (hi, lo, False)]
        return [(hi, lo, False), (lo, lo, False) if src < my else (hi, hi, False)]

    return blocks


class _Parts:
    """Contiguous row slices (along axis 1) of (bh, T, ...) tensors, each copied once and
    kept (the launchers take contiguous tensors; ``_ALL`` is the tensor itself)."""

    def __init__(self, *tensors):
        self.tensors, self.cache = tensors, {}

    def __call__(self, i: int, rows: slice):
        t = self.tensors[i]
        if t is None or rows == _ALL:
            return t
        key = (i, rows.start, rows.stop)
        if key not in self.cache:
            self.cache[key] = t[:, rows].contiguous()
        return self.cache[key]


def _ring_forward(q, chunks: Iterable, blocks_of: Callable, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank-local ring forward: (O f32, LSE f32) of q (bh, Tq, D) against the k/v
    chunks ``(k, v, src)`` (bh, Tk, D) as they arrive, one ``block_fwd`` (K2) a block of
    ``blocks_of(src)``. Blocks merge by their LSEs in f32: with w = e^(LSE_b−LSE') =
    sigmoid(LSE_b − LSE), O' = O + w·(O_b − O) (one ``lerp_`` in place) and LSE' =
    logaddexp(LSE, LSE_b). A row range's first block is its accumulator as it is."""
    acc = {}
    qp = _Parts(q)
    for k, v, src in chunks:
        kv = _Parts(k, v)
        for rows, keys, causal in blocks_of(src):
            ob, lb = fa.block_fwd(qp(0, rows), kv(0, keys), kv(1, keys), causal, scale)
            at = (rows.start or 0, rows.stop)
            if at not in acc:
                acc[at] = ob, lb
                continue
            o, la = acc[at]
            o.lerp_(ob, torch.sigmoid(lb - la)[..., None])
            acc[at] = o, torch.logaddexp(la, lb)
    parts = [acc[at] for at in sorted(acc, key=lambda a: a[0])]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([o for o, _ in parts], 1), torch.cat([lse for _, lse in parts], 1)


def _ring_backward(q, o, do, lse, chunks: Iterable, blocks_of: Callable, scale: float) -> torch.Tensor:
    """The rank-local ring backward: dQ (f32) of q, adding each block's dK and dV into the
    f32 accumulators ``acc`` that come with its k/v chunk as ``(k, v, src, acc)``. One D
    pass on this rank's final O and dO (``block_d``), then K4 and K5 a block
    (``block_bwd``), each with the final LSE and D of its query rows."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rows_of = _Parts(q, o, do, lse, fa.block_d(o, do))
    for k, v, src, acc in chunks:
        kv = _Parts(k, v)
        for rows, keys, causal in blocks_of(src):
            dqb, dkb, dvb = fa.block_bwd(
                rows_of(0, rows), kv(0, keys), kv(1, keys), rows_of(1, rows), rows_of(2, rows), rows_of(3, rows),
                rows_of(4, rows), causal, scale,
            )
            dq[:, rows] += dqb
            acc[0][:, keys] += dkb
            acc[1][:, keys] += dvb
    return dq


def _ring_kv(comm: TorchCommunication, k, v):
    """This rank's k/v chunk and then every other rank's, as ``(k, v, src)``, src = rank −
    i at step i: k and v travel as one tensor, each hop posted (``ring_shift``,
    ``async_op=True``) before the chunk at hand is attended, and none after the last."""
    kv = torch.stack((k, v))
    for src, blk in comm.ring_blocks(kv, lambda r: kv.shape):
        yield blk[0], blk[1], src


def _ring_kv_grads(comm: TorchCommunication, k, v, home: list):
    """The backward's rotation: ``(k, v, src, acc)`` as :func:`_ring_kv`, with the f32 dK
    and dV accumulators of ``src``'s chunk travelling beside it; after the last step one
    more hop brings every accumulator home, and ``home`` receives this rank's."""
    p = comm.size
    kv = torch.stack((k, v))
    acc = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    for i in range(p):
        pending = comm.ring_shift(kv, 1, async_op=True) if i < p - 1 else None
        yield kv[0], kv[1], (comm.rank - i) % p, acc
        acc = comm.ring_shift(acc, 1)
        if pending is not None:
            kv = pending.wait()
    home.append(acc)


class _RingAttention(torch.autograd.Function):
    """Ring attention of this rank's chunks q, k, v (bh, T/P, D) over ``comm``, under
    ``schedule(rank)``'s blocks: forward :func:`_ring_forward` over :func:`_ring_kv`, O in
    q's dtype; backward :func:`_ring_backward` over :func:`_ring_kv_grads`, once
    differentiable. The LSE is not an output, so not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, comm, schedule, scale: float):
        blocks = schedule(comm.rank)
        o32, lse = _ring_forward(q, _ring_kv(comm, k, v), blocks, scale)
        o = o32.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.comm, ctx.blocks, ctx.scale = comm, blocks, scale
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        home = []
        dq = _ring_backward(q, o, do.to(q.dtype).contiguous(), lse, _ring_kv_grads(ctx.comm, k, v, home), ctx.blocks,
                            ctx.scale)
        dk, dv = home[0]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _ring_call(q, k, v, comm, schedule, scale, causal: bool):
    """q (..., Tq/P, D), k and v (..., Tk/P, D) through :class:`_RingAttention`; raises on
    what the block kernels do not take, and on causal chunks of unequal lengths (whose
    diagonal blocks are not square)."""
    comm = sanitize_comm(comm)
    if not kernel_takes(q, k, v) or (causal and k.shape[-2] != q.shape[-2]):
        raise ValueError(
            "ring attention takes q, k, v (..., T/P, D) of one dtype (float32, bfloat16, float16), "
            f"D <= {fa.MAX_HEAD_DIM}, one length when causal; got q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    *batch, _, d = q.shape
    bh = math.prod(batch)
    flat = [x.reshape(bh, x.shape[-2], d).contiguous() for x in (q, k, v)]
    s = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    return _RingAttention.apply(*flat, comm, schedule, s).reshape(q.shape)


def ring_attention(q, k, v, comm: Optional[TorchCommunication] = None, is_causal: bool = False,
                   scale: Optional[float] = None):
    """Ring attention over a sequence split, heat_tpu's (nn/attention.py:243), on this
    rank's chunks q, k, v (..., T/P, D) of a global (..., T, D) whose sequence is cut into
    equal chunks over ``comm``'s ranks in rank order (the default communicator when None;
    heat_tpu's ``axis_name`` of a ``shard_map`` body). P steps: the rank attends its
    queries to the k/v chunk at hand while the next arrives from its neighbour, so no rank
    holds more than 1/P of the keys. Returns this rank's chunk of softmax(q·kᵀ·scale) v in
    q's dtype, differentiable in q, k and v (one D pass a rank, K4 and K5 a block, on the
    card). Causal: a block above the diagonal is skipped, where heat_tpu computes it masked."""
    return _ring_call(q, k, v, comm, lambda my: _ring_schedule(my, is_causal), scale, is_causal)


def zigzag_order(t: int, p: int) -> np.ndarray:
    """The zigzag layout's permutation (heat_tpu's, :312): the sequence cut into ``2p``
    chunks, rank ``i`` holding chunks ``i`` and ``2p − 1 − i``. Apply with
    ``x[..., zigzag_order(T, p), :]`` before :func:`ring_attention_zigzag`; undo with
    :func:`zigzag_inverse`. int32; raises unless ``2p`` divides ``t``."""
    if t % (2 * p):
        raise ValueError(f"zigzag layout needs the sequence length divisible by 2*p, got t={t}, p={p}")
    c = t // (2 * p)
    order = []
    for i in range(p):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * p - 1 - i) * c, (2 * p - i) * c))
    return np.asarray(order, dtype=np.int32)


def zigzag_inverse(t: int, p: int) -> np.ndarray:
    """The inverse permutation of :func:`zigzag_order`."""
    order = zigzag_order(t, p)
    inv = np.empty_like(order)
    inv[order] = np.arange(t, dtype=np.int32)
    return inv


def ring_attention_zigzag(q, k, v, comm: Optional[TorchCommunication] = None, scale: Optional[float] = None):
    """Load-balanced causal ring attention, heat_tpu's (:337), on this rank's chunks in the
    zigzag layout (:func:`zigzag_order`): (..., 2c, D), the first c rows the rank's low
    chunk and the last c its high one, over ``comm`` (heat_tpu's ``axis_name``). Every rank
    makes the same 2P + 1 launches of c × c, where the plain causal ring's last rank makes
    P. The output is in the same layout."""
    t = q.shape[-2]
    if t % 2:
        raise ValueError(f"the zigzag layout holds two equal chunks a rank, got {t} rows")
    return _ring_call(q, k, v, comm, lambda my: _zigzag_schedule(my, t // 2), scale, True)


class _AllToAll(torch.autograd.Function):
    """``comm.all_to_all`` whose backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, comm, split_axis: int, concat_axis: int):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm.all_to_all(x.contiguous(), split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return ctx.comm.all_to_all(g.contiguous(), concat_axis, split_axis), None, None, None


def ulysses_attention(q, k, v, comm: Optional[TorchCommunication] = None, is_causal: bool = False,
                      scale: Optional[float] = None):
    """All-to-all sequence parallelism, heat_tpu's (:433), on this rank's chunks q, k, v
    (B, H, T/P, D) over ``comm`` (heat_tpu's ``axis_name``), P dividing H and T: three
    all-to-alls turn the sequence split into a head split (B, H/P, T, D), the dense
    attention (K2 on the card) runs on the whole sequences, one all-to-all turns back.
    Differentiable: each all-to-all's gradient is the inverse one."""
    comm = sanitize_comm(comm)
    p = comm.size
    if q.shape[1] % p or k.shape[1] % p:
        raise ValueError(f"ulysses attention needs the head count divisible by the {p} ranks, got {q.shape[1]}")
    qh, kh, vh = (_AllToAll.apply(t, comm, 1, 2) for t in (q, k, v))
    o = _dense_attention(qh, kh, vh, is_causal=is_causal, scale=scale)
    return _AllToAll.apply(o, comm, 2, 1)


# ---------------------------------------------------------------------- the sequence ring of a layer
_SEQ_RING: contextvars.ContextVar = contextvars.ContextVar("seq_ring", default=None)


@contextlib.contextmanager
def _sequence_ring(comm: TorchCommunication):
    """Inside, the attentions of a layer run on sequence chunks by the ring over ``comm``:
    the projections, norms and feedforward around them are rank-local."""
    token = _SEQ_RING.set(comm)
    try:
        yield
    finally:
        _SEQ_RING.reset(token)


def _attend_heads(qh, kh, vh, mask, is_causal):
    """The attention of a layer on (B, H, T, hd) heads: the ring under
    :func:`_sequence_ring`, else :func:`_dense_attention`."""
    comm = _SEQ_RING.get()
    if comm is not None:
        return ring_attention(qh, kh, vh, comm, is_causal=is_causal)
    return _dense_attention(qh, kh, vh, mask=mask, is_causal=is_causal)


# ---------------------------------------------------------------------- functional
def _repeat_kv_heads(x, rep: int):
    """GQA: repeat each k/v head ``rep`` times along the head axis (-3) to match the
    query's head count (torch's ``enable_gqa``); a DNDarray keeps its split."""
    if not isinstance(x, DNDarray):
        return torch.repeat_interleave(x, rep, dim=-3)
    ax = x.ndim - 3
    gshape = list(x.gshape)
    gshape[ax] *= rep
    if x.is_distributed() and x.split == ax:
        full = torch.repeat_interleave(x._relayout(None), rep, dim=ax)
        _, _, slices = x.comm.chunk(tuple(full.shape), ax)
        local = full[slices]
    else:
        local = torch.repeat_interleave(x.larray, rep, dim=ax)
    return wrap_result(local, x, x.split, tuple(gshape))


def _warn_dropout_dense(what: str) -> None:
    warnings.warn(
        f"{what} dropout forfeits the ring-attention path on sequence-split inputs: the (T, T) weight matrix is "
        "materialized densely. Use dropout_p=0 for long-context runs.",
        stacklevel=3,
    )


def scaled_dot_product_attention(
    query,
    key,
    value,
    attn_mask=None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    enable_gqa: bool = False,
    dropout_key=None,
):
    """``torch.nn.functional.scaled_dot_product_attention`` semantics, heat_tpu's
    (nn/attention.py:104): inputs (..., T, D), typically (B, H, T, D); ``attn_mask`` is
    bool (True = attend) or an additive float bias, broadcast against the scores;
    ``enable_gqa`` repeats grouped k/v heads (Hkv dividing Hq). ``dropout_p > 0`` drops
    attention weights by heat_tpu's keyed mask and needs ``dropout_key``.

    On DNDarrays the result keeps the query's split: split along the sequence (dim -2)
    over several ranks, with key and value split alike, no mask and the lengths divisible
    by the ranks, it runs :func:`ring_attention`; other layouts compute the whole."""
    if not 0.0 <= dropout_p <= 1.0:
        raise ValueError(f"dropout_p must be in [0, 1], got {dropout_p}")
    if dropout_p and dropout_key is None:
        raise ValueError("dropout_p > 0 needs an explicit dropout_key PRNG key (heat_tpu's key, as jax has no "
                         "ambient RNG state like torch)")
    if enable_gqa:
        hq, hkv = query.shape[-3], key.shape[-3]
        if value.shape[-3] != hkv:
            raise ValueError(f"enable_gqa needs key and value to share a head count, got {hkv} and {value.shape[-3]}")
        if hq != hkv:
            if hq % hkv:
                raise ValueError(f"enable_gqa needs Hkv | Hq, got {hkv}, {hq}")
            key = _repeat_kv_heads(key, hq // hkv)
            value = _repeat_kv_heads(value, hq // hkv)
    ndim = query.ndim
    seq = ndim - 2
    keep = query.split if isinstance(query, DNDarray) else None
    if dropout_p:
        if isinstance(query, DNDarray) and query.split == seq:
            _warn_dropout_dense("scaled_dot_product_attention")
        out = _dense_attention_dropout(_whole(query), _whole(key), _whole(value), _whole(attn_mask), is_causal, scale,
                                       dropout_p, dropout_key)
        return _finish(out, query, None, keep)

    def ring_ok():
        comm = query.comm
        return (
            attn_mask is None
            and _ring_shapes_ok(comm, query.larray.dtype, (query.gshape, seq, query.gshape[-1]),
                                (key.gshape, seq, key.gshape[-1]))
            and (not is_causal or key.gshape[seq] == query.gshape[seq])
            and kernel_takes(query.larray, key.larray, value.larray)
        )

    mode, ax, part = _layout(query, range(seq), seq, (key, value), ring_ok)
    if mode == "ring":
        out = ring_attention(query.larray, key.larray, value.larray, part, is_causal=is_causal, scale=scale)
        return _finish(out, query, seq, None)
    a = -1 if ax is None else ax
    out = _dense_attention(
        part(query, a), part(key, a), part(value, a), part(attn_mask, a - (ndim - _dim(attn_mask))), is_causal, scale
    )
    return _finish(out, query, ax, None if ax is not None else keep)


def _on(device) -> torch.device:
    """Where a module's parameters are made: the port's default device unless given."""
    return devices.sanitize_device(device).torch_device


def _dropout(x, p: float, key, train: bool):
    """heat_tpu's ``_keyed_dropout``: inverted dropout by its key in training mode."""
    return F.dropout(x, p, training=train, key=key)


def _split2(key):
    return F._subkeys(key, 2) if key is not None else (None, None)


# ---------------------------------------------------------------------- modules
class MultiheadAttention(Module):
    """``torch.nn.MultiheadAttention`` semantics, heat_tpu's (nn/attention.py:452):
    ``batch_first=True`` by default, self- or cross-attention.

    Parameters under heat_tpu's names: a packed ``in_proj_weight`` (3E, E), or separate
    ``q/k/v_proj_weight`` when ``kdim``/``vdim`` differ from ``embed_dim``;
    ``in_proj_bias`` (3E,); ``out_proj_weight`` (E, E) and ``out_proj_bias`` (E,). Xavier
    uniform weights and zero biases, as torch. ``forward`` returns ``(output, None)``:
    ``need_weights=True`` raises, the weights are never formed. A bool ``attn_mask``
    follows torch's MHA convention (True = do NOT attend); ``key_padding_mask`` (B, S)
    (bool True = ignore that key, or an additive float) is merged into a (B, 1, 1, S)
    bias. Starts in eval mode; in training mode a dropout p > 0 drops attention weights by
    heat_tpu's key, ``dropout_key`` (or the share a parent layer binds), and raises without
    one. On DNDarrays split along the sequence the attention is the ring (heat_tpu's
    conditions: q, k, v split alike, no mask, no dropout, lengths divisible by the ranks)."""

    _rng_arg = "dropout_key"
    _keeps_split = False

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        bias: bool = True,
        batch_first: bool = True,
        kdim: Optional[int] = None,
        vdim: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"dropout must be in [0, 1], got {dropout}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.batch_first = batch_first
        self.kdim = embed_dim if kdim is None else kdim
        self.vdim = embed_dim if vdim is None else vdim
        self._qkv_same_embed_dim = self.kdim == embed_dim and self.vdim == embed_dim
        fk = {"device": _on(device)}
        e = embed_dim
        if self._qkv_same_embed_dim:
            self.in_proj_weight = torch.nn.Parameter(torch.empty(3 * e, e, **fk))
            self.register_parameter("q_proj_weight", None)
            self.register_parameter("k_proj_weight", None)
            self.register_parameter("v_proj_weight", None)
        else:
            self.register_parameter("in_proj_weight", None)
            self.q_proj_weight = torch.nn.Parameter(torch.empty(e, e, **fk))
            self.k_proj_weight = torch.nn.Parameter(torch.empty(e, self.kdim, **fk))
            self.v_proj_weight = torch.nn.Parameter(torch.empty(e, self.vdim, **fk))
        self.out_proj_weight = torch.nn.Parameter(torch.empty(e, e, **fk))
        if bias:
            self.in_proj_bias = torch.nn.Parameter(torch.empty(3 * e, **fk))
            self.out_proj_bias = torch.nn.Parameter(torch.empty(e, **fk))
        else:
            self.register_parameter("in_proj_bias", None)
            self.register_parameter("out_proj_bias", None)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """torch's ``_reset_parameters``: xavier_uniform_ weights, zero biases."""
        for w in (self.in_proj_weight, self.q_proj_weight, self.k_proj_weight, self.v_proj_weight, self.out_proj_weight):
            if w is not None:
                torch.nn.init.xavier_uniform_(w)
        for b in (self.in_proj_bias, self.out_proj_bias):
            if b is not None:
                torch.nn.init.zeros_(b)

    def _project(self, q_in, k_in, v_in):
        e = self.embed_dim
        b = self.in_proj_bias
        bias_of = (lambda i: None) if b is None else (lambda i: b[i * e : (i + 1) * e])
        if self._qkv_same_embed_dim:
            w = self.in_proj_weight
            return tuple(TF.linear(t, w[i * e : (i + 1) * e], bias_of(i)) for i, t in enumerate((q_in, k_in, v_in)))
        return (
            TF.linear(q_in, self.q_proj_weight, bias_of(0)),
            TF.linear(k_in, self.k_proj_weight, bias_of(1)),
            TF.linear(v_in, self.v_proj_weight, bias_of(2)),
        )

    def _mask(self, attn_mask, key_padding_mask):
        """The bias/mask the attention takes: torch MHA's bool True means "do NOT attend",
        the inverse of sdpa's (and K2's); ``key_padding_mask`` merged as (B, 1, 1, S)."""
        if attn_mask is not None and attn_mask.dtype == torch.bool:
            attn_mask = ~attn_mask
        if key_padding_mask is not None:
            kpm = key_padding_mask
            pad = (
                torch.where(kpm, torch.tensor(_NEG_INF, device=kpm.device), torch.tensor(0.0, device=kpm.device))
                if kpm.dtype == torch.bool
                else kpm.float()
            )[:, None, None, :]  # (B, 1, 1, S)
            attn_mask = pad if attn_mask is None else _as_bias(attn_mask) + pad
        return attn_mask

    def _attend(self, q_in, k_in, v_in, attn_mask, key_padding_mask, is_causal, dropout_key):
        """The attention on this rank's tensors, (B, T, E) or (T, B, E)."""
        mask = self._mask(attn_mask, key_padding_mask)
        if not self.batch_first:
            q_in, k_in, v_in = (t.transpose(0, 1) for t in (q_in, k_in, v_in))
        with full_fp32_matmul():
            q, k, v = self._project(q_in, k_in, v_in)

            def heads(t):  # (B, T, E) -> (B, H, T, hd)
                return t.reshape(t.shape[0], t.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

            if self.training and self.dropout > 0.0:
                if dropout_key is None:
                    raise ValueError("MultiheadAttention with dropout > 0 needs a PRNG key in train mode "
                                     "(dropout_key=, or a parent layer's key)")
                o = _dense_attention_dropout(heads(q), heads(k), heads(v), mask, is_causal, None, self.dropout,
                                             dropout_key)
            else:
                o = _attend_heads(heads(q), heads(k), heads(v), mask, is_causal)
            bsz, _, tlen, _ = o.shape
            o = TF.linear(o.transpose(1, 2).reshape(bsz, tlen, self.embed_dim), self.out_proj_weight, self.out_proj_bias)
        return o if self.batch_first else o.transpose(0, 1)

    def forward(
        self,
        query,
        key=None,
        value=None,
        key_padding_mask=None,
        need_weights: bool = False,
        attn_mask=None,
        average_attn_weights: bool = True,
        is_causal: bool = False,
        dropout_key=None,
    ):
        if need_weights:
            raise NotImplementedError(
                "need_weights=True would form the (T, S) attention matrix, which the flash kernel never forms"
            )
        if key is None:
            key = query
        if value is None:
            value = key
        b_ax = 0 if self.batch_first else 1
        s_ax = 1 - b_ax
        dropping = self.training and self.dropout > 0.0
        if dropping and isinstance(query, DNDarray) and query.split == s_ax:
            _warn_dropout_dense("MultiheadAttention")

        def ring_ok():
            comm = query.comm
            return (
                attn_mask is None and key_padding_mask is None and not dropping
                and _ring_shapes_ok(comm, query.larray.dtype, (query.gshape, s_ax, self.head_dim),
                                    (key.gshape, s_ax, self.head_dim))
                and (not is_causal or key.gshape[s_ax] == query.gshape[s_ax])
            )

        mode, ax, part = _layout(query, () if dropping else (b_ax,), s_ax, (key, value), ring_ok)
        keep = query.split if isinstance(query, DNDarray) and query.split in (0, 1) else None
        if mode == "ring":
            with _sequence_ring(part):
                out = self._attend(query.larray, key.larray, value.larray, None, None, is_causal, dropout_key)
            return _finish(out, query, s_ax, None), None
        a = -1 if ax is None else b_ax
        out = self._attend(
            part(query, a), part(key, a), part(value, a), part(attn_mask, _dim(attn_mask) - 4 if ax is not None else -1),
            part(key_padding_mask, 0 if ax is not None else -1), is_causal, dropout_key,
        )
        return _finish(out, query, ax, None if ax is not None else keep), None


def _resolve_activation(activation):
    """'relu' / 'gelu' (exact erf) / any callable, as torch's Transformer layers take."""
    if callable(activation):
        return activation
    if activation in ("relu", "gelu"):
        return getattr(TF, activation)
    raise ValueError(f"activation must be 'relu', 'gelu' or a callable, got {activation!r}")


def _run_layer(module, x, others, masks, run, causal_pairs=()):
    """A layer or stack on a DNDarray ``x`` (its tensors' forward ``run(x, others, masks)``
    on this rank), as heat_tpu computes it globally: a batch split over ranks runs rank by
    rank (``masks`` as (mask, batch axis) pairs, -1 for none); a sequence split over ranks
    runs rank-local under the ring (``others`` split alike, no mask, no active dropout,
    lengths divisible by the ranks, ``causal_pairs`` of equal lengths); anything else is
    computed whole and keeps ``x``'s split. Tensors go straight to ``run``."""
    if not isinstance(x, DNDarray):
        return run(x, others, [m for m, _ in masks])
    b_ax = 0 if module.batch_first else 1
    s_ax = 1 - b_ax
    dropping = module.training and module.dropout_p > 0.0
    head_dim = module.d_model // module.nhead

    def ring_ok():
        return (
            not dropping and all(m is None for m, _ in masks)
            and _ring_shapes_ok(x.comm, x.larray.dtype, *((t.gshape, s_ax, head_dim) for t in (x, *others)))
            and all(a.gshape[s_ax] == b.gshape[s_ax] for a, b in causal_pairs)
        )

    if dropping and x.split == s_ax:
        _warn_dropout_dense(type(module).__name__)
    mode, ax, part = _layout(x, () if dropping else (b_ax,), s_ax, others, ring_ok)
    if mode == "ring":
        with _sequence_ring(part):
            out = run(x.larray, [t.larray for t in others], [None] * len(masks))
        return _finish(out, x, s_ax, None)
    local = [part(t, b_ax if ax is not None else -1) for t in others]
    local_masks = [part(m, a if ax is not None else -1) for m, a in masks]
    out = run(part(x, b_ax if ax is not None else -1), local, local_masks)
    keep = x.split if x.split in (0, 1) else None
    return _finish(out, x, ax, None if ax is not None else keep)


class _FeedForwardMixin:
    """linear1 → activation → dropout → linear2 → dropout, shared by the encoder and
    decoder layers (heat_tpu's ``_ff_block``, with its key split in two)."""

    def _ff_block(self, x, key):
        k1, k2 = _split2(key)
        with full_fp32_matmul():
            h = _dropout(self.activation(self.linear1(x)), self.dropout_p, k1, self.training)
            return _dropout(self.linear2(h), self.dropout_p, k2, self.training)


class _LayerStack(Module):
    """``num_layers`` copies of a layer, each with fresh parameters (torch's
    ``_get_clones`` would copy one set), plus an optional final norm. The layers are
    children named "0", "1", ..., as heat_tpu's parameter tree names them; a key is split
    over the layers as heat_tpu's ``_run_stack`` does (:709-721)."""

    _rng_arg = "key"
    _keeps_split = False

    def __init__(self, layer: torch.nn.Module, num_layers: int, norm=None):
        super().__init__()
        for i in range(num_layers):
            clone = _fresh_copy(layer)
            self.add_module(str(i), clone)
        self.num_layers = num_layers
        self.norm = norm
        self.batch_first, self.dropout_p = layer.batch_first, layer.dropout_p
        self.d_model, self.nhead = layer.d_model, layer.nhead
        self.eval()

    @property
    def layers(self):
        return [self._modules[str(i)] for i in range(self.num_layers)]

    def _run_stack(self, x, key, call):
        ks = F._subkeys(key, self.num_layers) if key is not None else [None] * self.num_layers
        for layer, k in zip(self.layers, ks):
            x = call(layer, x, k)
        return x if self.norm is None else self.norm(x)


def _fresh_copy(layer: torch.nn.Module) -> torch.nn.Module:
    """A deep copy of ``layer`` with every submodule's parameters drawn afresh."""
    import copy

    clone = copy.deepcopy(layer)
    for m in clone.modules():
        if m is not clone and hasattr(m, "reset_parameters"):
            m.reset_parameters()
    return clone


class TransformerEncoderLayer(_FeedForwardMixin, Module):
    """``torch.nn.TransformerEncoderLayer`` semantics, heat_tpu's (nn/attention.py:724):
    self-attention and feedforward, post-norm by default, pre-norm with ``norm_first``;
    ``batch_first=True`` by default. Takes tensors and DNDarrays (:func:`_run_layer`);
    in training mode dropout takes heat_tpu's ``key`` (split as its ``apply`` splits it)."""

    _rng_arg = "key"
    _keeps_split = False

    def __init__(
        self,
        d_model: int,
        nhead: int,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        activation="relu",
        layer_norm_eps: float = 1e-5,
        batch_first: bool = True,
        norm_first: bool = False,
        bias: bool = True,
        device=None,
    ):
        super().__init__()
        fk = {"device": _on(device)}
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout, bias=bias, batch_first=batch_first, **fk)
        self.linear1 = Linear(d_model, dim_feedforward, bias=bias, **fk)
        self.linear2 = Linear(dim_feedforward, d_model, bias=bias, **fk)
        self.norm1 = LayerNorm(d_model, eps=layer_norm_eps, **fk)
        self.norm2 = LayerNorm(d_model, eps=layer_norm_eps, **fk)
        self.dropout_p = dropout
        self.norm_first = norm_first
        self.batch_first, self.d_model, self.nhead = batch_first, d_model, nhead
        self.activation = _resolve_activation(activation)

    def _sa_block(self, x, src_mask, src_key_padding_mask, is_causal, key):
        k_attn, k_drop = _split2(key)
        out = self.self_attn(
            x, x, x, attn_mask=src_mask, key_padding_mask=src_key_padding_mask, is_causal=is_causal,
            dropout_key=k_attn,
        )[0]
        return _dropout(out, self.dropout_p, k_drop, self.training)

    def _forward(self, x, src_mask, src_key_padding_mask, is_causal, key):
        k_sa, k_ff = _split2(key)
        if self.norm_first:
            x = x + self._sa_block(self.norm1(x), src_mask, src_key_padding_mask, is_causal, k_sa)
            return x + self._ff_block(self.norm2(x), k_ff)
        x = self.norm1(x + self._sa_block(x, src_mask, src_key_padding_mask, is_causal, k_sa))
        return self.norm2(x + self._ff_block(x, k_ff))

    def forward(self, src, src_mask=None, src_key_padding_mask=None, is_causal: bool = False, key=None):
        return _run_layer(
            self, src, [], [(src_mask, -1), (src_key_padding_mask, 0)],
            lambda x, _, m: self._forward(x, m[0], m[1], is_causal, key),
        )


class TransformerEncoder(_LayerStack):
    """``torch.nn.TransformerEncoder``: ``num_layers`` fresh copies of an encoder layer
    and an optional final norm. Takes tensors and DNDarrays."""

    def __init__(self, encoder_layer: TransformerEncoderLayer, num_layers: int, norm=None):
        super().__init__(encoder_layer, num_layers, norm)

    def forward(self, src, src_mask=None, src_key_padding_mask=None, is_causal: bool = False, key=None):
        def run(x, _, m):
            return self._run_stack(x, key, lambda layer, h, k: layer._forward(h, m[0], m[1], is_causal, k))

        return _run_layer(self, src, [], [(src_mask, -1), (src_key_padding_mask, 0)], run)


class TransformerDecoderLayer(_FeedForwardMixin, Module):
    """``torch.nn.TransformerDecoderLayer`` semantics, heat_tpu's (nn/attention.py:827):
    masked self-attention over the target, cross-attention into the encoder memory, then
    feedforward, each with residual and LayerNorm (post-norm by default, ``norm_first``
    pre-norm). Takes tensors and DNDarrays; dropout takes heat_tpu's ``key``."""

    _rng_arg = "key"
    _keeps_split = False

    def __init__(
        self,
        d_model: int,
        nhead: int,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        activation="relu",
        layer_norm_eps: float = 1e-5,
        batch_first: bool = True,
        norm_first: bool = False,
        bias: bool = True,
        device=None,
    ):
        super().__init__()
        fk = {"device": _on(device)}
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout, bias=bias, batch_first=batch_first, **fk)
        self.multihead_attn = MultiheadAttention(
            d_model, nhead, dropout=dropout, bias=bias, batch_first=batch_first, **fk
        )
        self.linear1 = Linear(d_model, dim_feedforward, bias=bias, **fk)
        self.linear2 = Linear(dim_feedforward, d_model, bias=bias, **fk)
        self.norm1 = LayerNorm(d_model, eps=layer_norm_eps, **fk)
        self.norm2 = LayerNorm(d_model, eps=layer_norm_eps, **fk)
        self.norm3 = LayerNorm(d_model, eps=layer_norm_eps, **fk)
        self.dropout_p = dropout
        self.norm_first = norm_first
        self.batch_first, self.d_model, self.nhead = batch_first, d_model, nhead
        self.activation = _resolve_activation(activation)

    def _attn_block(self, attn, q, kv, mask, padding_mask, is_causal, key):
        k_attn, k_drop = _split2(key)
        kv = q if kv is None else kv
        out = attn(q, kv, kv, attn_mask=mask, key_padding_mask=padding_mask, is_causal=is_causal, dropout_key=k_attn)[0]
        return _dropout(out, self.dropout_p, k_drop, self.training)

    def _forward(self, x, memory, masks, tgt_is_causal, memory_is_causal, key):
        tgt_mask, memory_mask, tgt_kpm, memory_kpm = masks
        k_sa, k_ca, k_ff = F._subkeys(key, 3) if key is not None else (None, None, None)

        def sa(h):
            return self._attn_block(self.self_attn, h, None, tgt_mask, tgt_kpm, tgt_is_causal, k_sa)

        def ca(h):
            return self._attn_block(self.multihead_attn, h, memory, memory_mask, memory_kpm, memory_is_causal, k_ca)

        if self.norm_first:
            x = x + sa(self.norm1(x))
            x = x + ca(self.norm2(x))
            return x + self._ff_block(self.norm3(x), k_ff)
        x = self.norm1(x + sa(x))
        x = self.norm2(x + ca(x))
        return self.norm3(x + self._ff_block(x, k_ff))

    def forward(
        self,
        tgt,
        memory,
        tgt_mask=None,
        memory_mask=None,
        tgt_key_padding_mask=None,
        memory_key_padding_mask=None,
        tgt_is_causal: bool = False,
        memory_is_causal: bool = False,
        key=None,
    ):
        if memory is None:
            raise ValueError("TransformerDecoderLayer needs the encoder memory")
        return _run_layer(
            self, tgt, [memory], _decoder_masks(tgt_mask, memory_mask, tgt_key_padding_mask, memory_key_padding_mask),
            lambda x, o, m: self._forward(x, o[0], m, tgt_is_causal, memory_is_causal, key),
            causal_pairs=[(tgt, memory)] if memory_is_causal else (),
        )


def _decoder_masks(tgt_mask, memory_mask, tgt_kpm, memory_kpm):
    return [(tgt_mask, -1), (memory_mask, -1), (tgt_kpm, 0), (memory_kpm, 0)]


class TransformerDecoder(_LayerStack):
    """``torch.nn.TransformerDecoder``: ``num_layers`` fresh copies of a decoder layer
    and an optional final norm. Takes tensors and DNDarrays."""

    def __init__(self, decoder_layer: TransformerDecoderLayer, num_layers: int, norm=None):
        super().__init__(decoder_layer, num_layers, norm)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, tgt_is_causal: bool = False, memory_is_causal: bool = False, key=None):
        def run(x, o, m):
            return self._run_stack(
                x, key, lambda layer, h, k: layer._forward(h, o[0], m, tgt_is_causal, memory_is_causal, k)
            )

        return _run_layer(
            self, tgt, [memory], _decoder_masks(tgt_mask, memory_mask, tgt_key_padding_mask, memory_key_padding_mask),
            run, causal_pairs=[(tgt, memory)] if memory_is_causal else (),
        )


class Transformer(Module):
    """``torch.nn.Transformer`` semantics, heat_tpu's (nn/attention.py:946): an encoder
    and a decoder sharing one set of hyperparameters, each with a final LayerNorm. The
    defaults are the base model of "Attention Is All You Need" (N = 6, d_model 512,
    d_ff 2048, 8 heads), also torch's; ``batch_first=True``.

    ``forward(src, tgt)`` runs ``decoder(tgt, encoder(src))`` with all of torch's mask
    and padding arguments. ``src`` and ``tgt`` may be DNDarrays split along the batch axis
    (rank by rank) or the sequence (ring attention, :func:`_run_layer`); the result is
    then a DNDarray like ``tgt``. Starts in eval mode; in training mode dropout takes
    heat_tpu's ``key``, split between the encoder and the decoder."""

    _rng_arg = "key"
    _keeps_split = False

    def __init__(
        self,
        d_model: int = 512,
        nhead: int = 8,
        num_encoder_layers: int = 6,
        num_decoder_layers: int = 6,
        dim_feedforward: int = 2048,
        dropout: float = 0.1,
        activation="relu",
        layer_norm_eps: float = 1e-5,
        batch_first: bool = True,
        norm_first: bool = False,
        bias: bool = True,
        device=None,
    ):
        super().__init__()
        fk = {"device": _on(device)}
        self.d_model = d_model
        self.nhead = nhead
        self.batch_first = batch_first
        self.dropout_p = dropout
        self.encoder = TransformerEncoder(
            TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation, layer_norm_eps, batch_first, norm_first, bias, **fk
            ),
            num_encoder_layers,
            norm=LayerNorm(d_model, eps=layer_norm_eps, **fk),
        )
        self.decoder = TransformerDecoder(
            TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation, layer_norm_eps, batch_first, norm_first, bias, **fk
            ),
            num_decoder_layers,
            norm=LayerNorm(d_model, eps=layer_norm_eps, **fk),
        )

    def forward(
        self,
        src,
        tgt,
        src_mask=None,
        tgt_mask=None,
        memory_mask=None,
        src_key_padding_mask=None,
        tgt_key_padding_mask=None,
        memory_key_padding_mask=None,
        src_is_causal: bool = False,
        tgt_is_causal: bool = False,
        memory_is_causal: bool = False,
        key=None,
    ):
        if tgt is None:
            raise ValueError("Transformer needs both src and tgt")
        k1, k2 = _split2(key)

        def run(x, o, m):
            memory = self.encoder(o[0], src_mask=m[0], src_key_padding_mask=m[1], is_causal=src_is_causal, key=k1)
            return self.decoder(
                x, memory, tgt_mask=m[2], memory_mask=m[3], tgt_key_padding_mask=m[4],
                memory_key_padding_mask=m[5], tgt_is_causal=tgt_is_causal, memory_is_causal=memory_is_causal, key=k2,
            )

        masks = [(src_mask, -1), (src_key_padding_mask, 0), (tgt_mask, -1), (memory_mask, -1),
                 (tgt_key_padding_mask, 0), (memory_key_padding_mask, 0)]
        return _run_layer(self, tgt, [src], masks, run, causal_pairs=[(tgt, src)] if memory_is_causal else ())

    @staticmethod
    def generate_square_subsequent_mask(sz: int, device=None) -> torch.Tensor:
        """(sz, sz) additive mask: 0 on and below the diagonal, -inf above (torch's causal
        mask helper), on the port's default device unless ``device`` is given. A float
        mask takes the dense path: the flash kernel takes bool masks only."""
        dev = _on(device)
        keep = torch.arange(sz, device=dev)[:, None] >= torch.arange(sz, device=dev)[None, :]
        zero = torch.zeros((), device=dev)
        return torch.where(keep, zero, torch.full_like(zero, -math.inf))
