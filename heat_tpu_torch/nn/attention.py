"""Attention: heat_tpu's ``nn/attention.py`` on PyTorch, for serving and training.

Scaled dot-product attention, ``MultiheadAttention`` and the Transformer family as
``torch.nn.Module``s with ``forward``, under heat_tpu's names, defaults
(``batch_first=True``) and parameter names, so that a parameter tree of heat_tpu maps onto
a ``state_dict`` mechanically (``heat_tpu_torch.interop.load_jax_params``).

Every attention goes through :func:`_dense_attention`: inputs that the flash kernel takes
(``kernels.flash_attention.use_flash``: CUDA tensors of one dtype, head dim <= 128, no
mask or a (Tq, Tk) bool one) run K2, the CUDA flash forward (K3, the pipelined one, under
``HEAT_TPU_FLASH_PIPELINE=1``), and their gradients the flash backward (the D pass, K4 and
K5); everything else takes the dense path below, in
full fp32, differentiated by autograd. Causal masking is top-left aligned (query i attends
keys <= i), for any Tq, Tk.

DNDarray inputs: a DNDarray split along the batch axis over ranks is attended rank by
rank, each rank on its own rows; any other layout is computed whole on every rank, and
the result keeps the query's split as heat_tpu's does. Not ported yet (ROADMAP.md Queue 1
item 13), each raising ``NotImplementedError``: ring, zigzag and Ulysses attention, so a
DNDarray split along the sequence over several ranks raises rather than being gathered;
and train-mode dropout. The modules start in eval mode, as heat_tpu's do; ``.train()``
trains them when their dropout is 0.0, and raises at the forward for a dropout p > 0.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import devices
from ..core._operations import wrap_result
from ..core.dndarray import DNDarray
from ..core.devices import full_fp32_matmul
from ..core.kernels.flash_attention import _as_bias, flash_attention, use_flash
from .modules import LayerNorm, Linear, Module

__all__ = [
    "scaled_dot_product_attention",
    "ring_attention",
    "ring_attention_zigzag",
    "ulysses_attention",
    "MultiheadAttention",
    "TransformerEncoderLayer",
    "TransformerEncoder",
    "TransformerDecoderLayer",
    "TransformerDecoder",
    "Transformer",
]

_NEG_INF = float(torch.finfo(torch.float32).min)
_LATER = "not ported yet (ROADMAP.md Queue 1 item 13)"


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


# ---------------------------------------------------------------------- DNDarray layout
def _whole(t):
    """All of ``t`` on this rank: a DNDarray is gathered, a tensor is taken as it is."""
    return t._relayout(None) if isinstance(t, DNDarray) else t


def _rank_layout(proto, run_axes, seq_axis: int, *seq_inputs) -> Tuple[Optional[int], Callable]:
    """How a call whose query-like input is ``proto`` runs on this rank.

    Returns ``(run, part)``: ``run`` is the axis of ``proto``'s split when ``proto`` is a
    DNDarray split over ranks along one of ``run_axes`` (attention is independent along
    them, so each rank computes its own rows), else None (every rank computes the whole).
    ``part(t, axis)`` gives this rank's tensor of an input that extends along ``axis``:
    its chunk along ``axis`` when ``run`` is set and ``t`` spans the whole of it, else all
    of ``t``; a negative ``axis`` means ``t`` does not extend along the run axis.
    Raises ``NotImplementedError`` for a sequence split over ranks (ring attention)."""
    for t in (proto, *seq_inputs):
        if isinstance(t, DNDarray) and t.is_distributed() and t.split == seq_axis:
            raise NotImplementedError(
                f"attention over a sequence split across {t.comm.size} ranks needs ring attention, {_LATER}"
            )
    if not (isinstance(proto, DNDarray) and proto.is_distributed() and proto.split in run_axes):
        return None, lambda t, axis=-1: None if t is None else _whole(t)
    run, comm, length = proto.split, proto.comm, proto.gshape[proto.split]

    def part(t, axis=-1):
        if t is None:
            return None
        if axis < 0 or t.ndim <= axis or t.shape[axis] != length:
            return _whole(t)
        if isinstance(t, DNDarray):
            return t._relayout(axis)
        return t[comm.chunk(tuple(t.shape), axis)[2]]

    return run, part


def _finish(out: torch.Tensor, proto, run: Optional[int], keep: Optional[int]):
    """This rank's output as the call's result: a tensor when ``proto`` is one, else a
    DNDarray like ``proto`` split along ``run`` (rank-by-rank rows) or ``keep``."""
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


def scaled_dot_product_attention(
    query,
    key,
    value,
    attn_mask=None,
    dropout_p: float = 0.0,
    is_causal: bool = False,
    scale: Optional[float] = None,
    enable_gqa: bool = False,
):
    """``torch.nn.functional.scaled_dot_product_attention`` semantics, heat_tpu's
    (nn/attention.py:104): inputs (..., T, D), typically (B, H, T, D); ``attn_mask`` is
    bool (True = attend) or an additive float bias, broadcast against the scores;
    ``enable_gqa`` repeats grouped k/v heads (Hkv dividing Hq).

    On DNDarrays the result keeps the query's split. ``dropout_p > 0`` raises
    ``NotImplementedError`` (train-mode dropout, ROADMAP.md Queue 1 item 13)."""
    if not 0.0 <= dropout_p <= 1.0:
        raise ValueError(f"dropout_p must be in [0, 1], got {dropout_p}")
    if dropout_p:
        raise NotImplementedError(f"attention dropout needs an explicit torch.Generator, {_LATER}")
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
    run, part = _rank_layout(query, range(ndim - 2), ndim - 2, key, value)
    ax = -1 if run is None else run
    out = _dense_attention(
        part(query, ax), part(key, ax), part(value, ax),
        part(attn_mask, ax - (ndim - _dim(attn_mask))), is_causal, scale,
    )
    return _finish(out, query, run, query.split if isinstance(query, DNDarray) else None)


def ring_attention(*args, **kwargs):
    """Ring attention over a sequence split (heat_tpu nn/attention.py:243): not ported yet."""
    raise NotImplementedError(f"ring_attention is {_LATER}")


def ring_attention_zigzag(*args, **kwargs):
    """Load-balanced causal ring attention (heat_tpu nn/attention.py:337): not ported yet."""
    raise NotImplementedError(f"ring_attention_zigzag is {_LATER}")


def ulysses_attention(*args, **kwargs):
    """All-to-all sequence parallelism (heat_tpu nn/attention.py:433): not ported yet."""
    raise NotImplementedError(f"ulysses_attention is {_LATER}")


def _no_train_dropout(module: torch.nn.Module, p: float) -> None:
    if module.training and p > 0.0:
        raise NotImplementedError(
            f"{type(module).__name__}: train-mode dropout (p={p}) needs an explicit torch.Generator, "
            f"{_LATER}; call .eval() or build the module with dropout=0.0"
        )


def _on(device) -> torch.device:
    """Where a module's parameters are made: the port's default device unless given."""
    return devices.sanitize_device(device).torch_device


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
    bias. Starts in eval mode; in train mode a dropout p > 0 raises."""

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
        self.eval()

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
            return tuple(F.linear(t, w[i * e : (i + 1) * e], bias_of(i)) for i, t in enumerate((q_in, k_in, v_in)))
        return (
            F.linear(q_in, self.q_proj_weight, bias_of(0)),
            F.linear(k_in, self.k_proj_weight, bias_of(1)),
            F.linear(v_in, self.v_proj_weight, bias_of(2)),
        )

    def _attend(self, q_in, k_in, v_in, attn_mask, key_padding_mask, is_causal):
        """The attention on this rank's tensors, (B, T, E) or (T, B, E)."""
        if attn_mask is not None and attn_mask.dtype == torch.bool:
            # torch MHA's True means "do NOT attend", the inverse of sdpa's (and K2's)
            attn_mask = ~attn_mask
        if key_padding_mask is not None:
            kpm = key_padding_mask
            pad = (
                torch.where(kpm, torch.tensor(_NEG_INF, device=kpm.device), torch.tensor(0.0, device=kpm.device))
                if kpm.dtype == torch.bool
                else kpm.float()
            )[:, None, None, :]  # (B, 1, 1, S)
            attn_mask = pad if attn_mask is None else _as_bias(attn_mask) + pad
        if not self.batch_first:
            q_in, k_in, v_in = (t.transpose(0, 1) for t in (q_in, k_in, v_in))
        with full_fp32_matmul():
            q, k, v = self._project(q_in, k_in, v_in)

            def heads(t):  # (B, T, E) -> (B, H, T, hd)
                return t.reshape(t.shape[0], t.shape[1], self.num_heads, self.head_dim).transpose(1, 2)

            o = _dense_attention(heads(q), heads(k), heads(v), mask=attn_mask, is_causal=is_causal)
            bsz, _, tlen, _ = o.shape
            o = F.linear(o.transpose(1, 2).reshape(bsz, tlen, self.embed_dim), self.out_proj_weight, self.out_proj_bias)
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
    ):
        if need_weights:
            raise NotImplementedError(
                "need_weights=True would form the (T, S) attention matrix, which the flash kernel never forms"
            )
        _no_train_dropout(self, self.dropout)
        if key is None:
            key = query
        if value is None:
            value = key
        b_ax = 0 if self.batch_first else 1
        run, part = _rank_layout(query, (b_ax,), 1 - b_ax, key, value)
        out = self._attend(
            part(query, b_ax), part(key, b_ax), part(value, b_ax),
            part(attn_mask, _dim(attn_mask) - 4), part(key_padding_mask, 0), is_causal,
        )
        keep = query.split if isinstance(query, DNDarray) and query.split in (0, 1) else None
        return _finish(out, query, run, keep), None


def _resolve_activation(activation):
    """'relu' / 'gelu' (exact erf) / any callable, as torch's Transformer layers take."""
    if callable(activation):
        return activation
    if activation in ("relu", "gelu"):
        return getattr(F, activation)
    raise ValueError(f"activation must be 'relu', 'gelu' or a callable, got {activation!r}")


class _FeedForwardMixin:
    """linear1 → activation → linear2, shared by the encoder and decoder layers (no
    dropout is applied: a layer with p > 0 raises in train mode)."""

    def _ff_block(self, x):
        with full_fp32_matmul():
            return self.linear2(self.activation(self.linear1(x)))


class _LayerStack(Module):
    """``num_layers`` copies of a layer, each with fresh parameters (torch's
    ``_get_clones`` would copy one set), plus an optional final norm. The layers are
    children named "0", "1", ..., as heat_tpu's parameter tree names them."""

    def __init__(self, layer: torch.nn.Module, num_layers: int, norm=None):
        super().__init__()
        for i in range(num_layers):
            clone = copy.deepcopy(layer)
            for m in clone.modules():
                if m is not clone and hasattr(m, "reset_parameters"):
                    m.reset_parameters()
            self.add_module(str(i), clone)
        self.num_layers = num_layers
        self.norm = norm
        self.eval()

    @property
    def layers(self):
        return [self._modules[str(i)] for i in range(self.num_layers)]

    def _run_stack(self, x, call):
        for layer in self.layers:
            x = call(layer, x)
        return x if self.norm is None else self.norm(x)


class TransformerEncoderLayer(_FeedForwardMixin, Module):
    """``torch.nn.TransformerEncoderLayer`` semantics, heat_tpu's (nn/attention.py:724):
    self-attention and feedforward, post-norm by default, pre-norm with ``norm_first``;
    ``batch_first=True`` by default. Takes tensors."""

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
        self.activation = _resolve_activation(activation)
        self.eval()

    def _sa_block(self, x, src_mask, src_key_padding_mask, is_causal):
        return self.self_attn(
            x, x, x, attn_mask=src_mask, key_padding_mask=src_key_padding_mask, is_causal=is_causal
        )[0]

    def forward(self, src, src_mask=None, src_key_padding_mask=None, is_causal: bool = False):
        _no_train_dropout(self, self.dropout_p)
        x = src
        if self.norm_first:
            x = x + self._sa_block(self.norm1(x), src_mask, src_key_padding_mask, is_causal)
            x = x + self._ff_block(self.norm2(x))
        else:
            x = self.norm1(x + self._sa_block(x, src_mask, src_key_padding_mask, is_causal))
            x = self.norm2(x + self._ff_block(x))
        return x


class TransformerEncoder(_LayerStack):
    """``torch.nn.TransformerEncoder``: ``num_layers`` fresh copies of an encoder layer
    and an optional final norm. Takes tensors."""

    def __init__(self, encoder_layer: TransformerEncoderLayer, num_layers: int, norm=None):
        super().__init__(encoder_layer, num_layers, norm)

    def forward(self, src, src_mask=None, src_key_padding_mask=None, is_causal: bool = False):
        return self._run_stack(
            src,
            lambda layer, x: layer(x, src_mask=src_mask, src_key_padding_mask=src_key_padding_mask, is_causal=is_causal),
        )


class TransformerDecoderLayer(_FeedForwardMixin, Module):
    """``torch.nn.TransformerDecoderLayer`` semantics, heat_tpu's (nn/attention.py:827):
    masked self-attention over the target, cross-attention into the encoder memory, then
    feedforward, each with residual and LayerNorm (post-norm by default, ``norm_first``
    pre-norm). Takes tensors."""

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
        self.activation = _resolve_activation(activation)
        self.eval()

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
    ):
        _no_train_dropout(self, self.dropout_p)
        if memory is None:
            raise ValueError("TransformerDecoderLayer needs the encoder memory")

        def sa(x):
            return self.self_attn(
                x, x, x, attn_mask=tgt_mask, key_padding_mask=tgt_key_padding_mask, is_causal=tgt_is_causal
            )[0]

        def ca(x):
            return self.multihead_attn(
                x, memory, memory, attn_mask=memory_mask, key_padding_mask=memory_key_padding_mask,
                is_causal=memory_is_causal,
            )[0]

        x = tgt
        if self.norm_first:
            x = x + sa(self.norm1(x))
            x = x + ca(self.norm2(x))
            x = x + self._ff_block(self.norm3(x))
        else:
            x = self.norm1(x + sa(x))
            x = self.norm2(x + ca(x))
            x = self.norm3(x + self._ff_block(x))
        return x


class TransformerDecoder(_LayerStack):
    """``torch.nn.TransformerDecoder``: ``num_layers`` fresh copies of a decoder layer
    and an optional final norm. Takes tensors."""

    def __init__(self, decoder_layer: TransformerDecoderLayer, num_layers: int, norm=None):
        super().__init__(decoder_layer, num_layers, norm)

    def forward(self, tgt, memory, **mask_kwargs):
        return self._run_stack(tgt, lambda layer, x: layer(x, memory, **mask_kwargs))


class Transformer(Module):
    """``torch.nn.Transformer`` semantics, heat_tpu's (nn/attention.py:946): an encoder
    and a decoder sharing one set of hyperparameters, each with a final LayerNorm. The
    defaults are the base model of "Attention Is All You Need" (N = 6, d_model 512,
    d_ff 2048, 8 heads), also torch's; ``batch_first=True``.

    ``forward(src, tgt)`` runs ``decoder(tgt, encoder(src))`` with all of torch's mask
    and padding arguments. ``src`` and ``tgt`` may be DNDarrays split along the batch
    axis; the result is then a DNDarray like ``tgt``. Starts in eval mode; ``.train()``
    with ``dropout=0.0`` trains it, train-mode dropout p > 0 raises (not ported yet)."""

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
        self.eval()

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
    ):
        if tgt is None:
            raise ValueError("Transformer needs both src and tgt")
        b_ax = 0 if self.batch_first else 1
        run, part = _rank_layout(tgt, (b_ax,), 1 - b_ax, src)
        src_l, tgt_l = part(src, b_ax), part(tgt, b_ax)
        memory = self.encoder(
            src_l, src_mask=part(src_mask), src_key_padding_mask=part(src_key_padding_mask, 0), is_causal=src_is_causal
        )
        out = self.decoder(
            tgt_l,
            memory,
            tgt_mask=part(tgt_mask),
            memory_mask=part(memory_mask),
            tgt_key_padding_mask=part(tgt_key_padding_mask, 0),
            memory_key_padding_mask=part(memory_key_padding_mask, 0),
            tgt_is_causal=tgt_is_causal,
            memory_is_causal=memory_is_causal,
        )
        keep = tgt.split if isinstance(tgt, DNDarray) and tgt.split in (0, 1) else None
        return _finish(out, tgt, run, keep)

    @staticmethod
    def generate_square_subsequent_mask(sz: int, device=None) -> torch.Tensor:
        """(sz, sz) additive mask: 0 on and below the diagonal, -inf above (torch's causal
        mask helper), on the port's default device unless ``device`` is given. A float
        mask takes the dense path: the flash kernel takes bool masks only."""
        dev = _on(device)
        keep = torch.arange(sz, device=dev)[:, None] >= torch.arange(sz, device=dev)[None, :]
        zero = torch.zeros((), device=dev)
        return torch.where(keep, zero, torch.full_like(zero, -math.inf))
