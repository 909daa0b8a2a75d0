"""The plain reference of the Transformer-base sequence-to-sequence configuration: the model,
its loss, its gradients and Adam written out in torch operations on a dictionary of leaves,
from the weights and batches the benchmark made.

The model (Vaswani et al. 2017, as the configuration states it): one token embedding E,
shared by the source, the target and the pre-softmax head; inputs E[token]·sqrt(d_model) plus
the sinusoidal position encodings of section 3.5; ``num_encoder_layers`` post-norm encoder
layers (self-attention, then a
ReLU feed-forward, each added to its input and layer-normed) and a final LayerNorm;
``num_decoder_layers`` post-norm decoder layers (causal self-attention, cross-attention into
the encoder's output, feed-forward) and a final LayerNorm; the head's logits y·Eᵀ; the mean
label-smoothed cross-entropy over every target token. Attention is softmax(q·kᵀ/√d_h)·v per
head, the causal one with the later keys masked.

Adam (Kingma and Ba, with bias correction): m = β1·m + (1-β1)·g, v = β2·v + (1-β2)·g²,
p -= lr · m̂ / (√v̂ + ε), at the learning rate of the paper's eq. 3.

The reference computes in float64 (``dtype``) and keeps the parameters in float32, the type
the configuration trains them in: each step computes the loss and its gradients on float64
copies of them, and rounds the updated leaves back to float32. So that it fits beside
nothing but its own state, each layer and each block of the head's tokens is recomputed in
the backward (``torch.utils.checkpoint``): one layer's score matrices are held at a time.

The keyword arguments make the control and the planted faults of the comparison:
``dtype=torch.float32`` with ``tf32`` computes in float32 with every product in TF32;
``half_batch`` trains on the first half of each batch's rows; ``altered_token`` changes one
target token of each batch; ``stale_gradient_step`` applies, at that step, the gradient of
the step before again.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint


def _linear(x, w, b):
    return x @ w.T + b


def _attention(p: dict, pre: str, q_in, kv_in, heads: int, causal: bool):
    d = q_in.shape[-1]
    w, b = p[f"{pre}.in_proj_weight"], p[f"{pre}.in_proj_bias"]
    q = _linear(q_in, w[:d], b[:d])
    k = _linear(kv_in, w[d:2 * d], b[d:2 * d])
    v = _linear(kv_in, w[2 * d:], b[2 * d:])

    def split(t):  # (B, T, d) -> (B, H, T, d_h)
        return t.reshape(t.shape[0], t.shape[1], heads, d // heads).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d // heads))
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool, device=s.device).triu(1), float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    o = o.transpose(1, 2).reshape(q_in.shape[0], q_in.shape[1], d)
    return _linear(o, p[f"{pre}.out_proj_weight"], p[f"{pre}.out_proj_bias"])


def _norm(p: dict, pre: str, x, eps: float):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p[f"{pre}.weight"], p[f"{pre}.bias"], eps)


def _feedforward(p: dict, pre: str, x):
    h = torch.relu(_linear(x, p[f"{pre}.linear1.weight"], p[f"{pre}.linear1.bias"]))
    return _linear(h, p[f"{pre}.linear2.weight"], p[f"{pre}.linear2.bias"])


def _token_losses(y, w, tgt, ls: float):
    """The label-smoothed cross-entropy of each token of ``y`` (tokens, d_model), summed."""
    logp = torch.log_softmax(y @ w.T, dim=-1)
    nll = -logp.gather(-1, tgt[:, None])[:, 0]
    return ((1.0 - ls) * nll + ls * -logp.mean(-1)).sum()


def positions(length: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """PE(pos, 2i) = sin(pos / 10000^(2i/d)), PE(pos, 2i + 1) = cos(pos / 10000^(2i/d)), in
    ``like``'s type and on its device."""
    pe = torch.empty(length, d, dtype=torch.float64, device=like.device)
    pos = torch.arange(length, dtype=torch.float64, device=like.device)[:, None]
    angle = pos / torch.pow(10000.0, torch.arange(0, d, 2, dtype=torch.float64, device=like.device) / d)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe.to(like.dtype)


def loss(p: dict, cfg: dict, src, tgt_in, tgt, head_block: int = 4096):
    """The mean label-smoothed cross-entropy of one batch."""
    heads, eps = cfg["nhead"], cfg["layer_norm_eps"]
    if cfg["activation"] != "relu" or cfg["dropout"] != 0.0:
        raise ValueError("the reference computes ReLU feed-forward layers without dropout")

    def encoder_layer(i, x):
        pre = f"core.encoder.{i}"
        x = _norm(p, f"{pre}.norm1", x + _attention(p, f"{pre}.self_attn", x, x, heads, False), eps)
        return _norm(p, f"{pre}.norm2", x + _feedforward(p, pre, x), eps)

    def decoder_layer(i, y, mem):
        pre = f"core.decoder.{i}"
        y = _norm(p, f"{pre}.norm1", y + _attention(p, f"{pre}.self_attn", y, y, heads, True), eps)
        y = _norm(p, f"{pre}.norm2", y + _attention(p, f"{pre}.multihead_attn", y, mem, heads, False), eps)
        return _norm(p, f"{pre}.norm3", y + _feedforward(p, pre, y), eps)

    emb, scale = p["embed.weight"], math.sqrt(cfg["d_model"])
    x = emb[src] * scale + positions(src.shape[1], cfg["d_model"], emb)
    for i in range(cfg["num_encoder_layers"]):
        x = checkpoint(encoder_layer, i, x, use_reentrant=False)
    mem = _norm(p, "core.encoder.norm", x, eps)
    y = emb[tgt_in] * scale + positions(tgt_in.shape[1], cfg["d_model"], emb)
    for i in range(cfg["num_decoder_layers"]):
        y = checkpoint(decoder_layer, i, y, mem, use_reentrant=False)
    y = _norm(p, "core.decoder.norm", y, eps).reshape(-1, y.shape[-1])
    tgt = tgt.reshape(-1)
    total = 0.0
    for a in range(0, y.shape[0], head_block):
        total = total + checkpoint(_token_losses, y[a:a + head_block], emb, tgt[a:a + head_block],
                                   cfg["label_smoothing"], use_reentrant=False)
    return total / y.shape[0]


def noam_lr(cfg: dict, step: int) -> float:
    return cfg["d_model"] ** -0.5 * min(step ** -0.5, step * cfg["warmup_steps"] ** -1.5)


def train(weights: Dict[str, torch.Tensor], cfg: dict, batches: List[tuple], dtype=torch.float64,
          tf32: bool = False, half_batch: bool = False, altered_token: bool = False,
          stale_gradient_step: int = 0) -> dict:
    """Adam steps from ``weights`` over ``batches``: each step's loss, each step's gradient
    of each leaf as Adam gets it, and each leaf's change after the last step (float32
    leaves, computed in ``dtype``)."""
    prior = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        leaves = {n: w.detach().float().clone() for n, w in weights.items()}
        start = {n: w.clone() for n, w in leaves.items()}
        m = {n: torch.zeros_like(w, dtype=dtype) for n, w in start.items()}
        v = {n: torch.zeros_like(w, dtype=dtype) for n, w in start.items()}
        b1, b2 = cfg["adam_betas"]
        eps = cfg["adam_eps"]
        losses, applied = [], []
        for step, (src, tgt_in, tgt) in enumerate(batches, start=1):
            if half_batch:
                src, tgt_in, tgt = (t[: t.shape[0] // 2] for t in (src, tgt_in, tgt))
            if altered_token:
                tgt = tgt.clone()
                tgt[0, 0] = tgt[0, 0] % (cfg["vocab_size"] - 1) + 1
            p = {n: w.to(dtype).requires_grad_(True) for n, w in leaves.items()}
            value = loss(p, cfg, src, tgt_in, tgt)
            grads = torch.autograd.grad(value, list(p.values()))
            if step == stale_gradient_step:
                grads = list(applied[-1].values())
            losses.append(float(value.detach()))
            applied.append(dict(zip(p, grads)))
            lr = noam_lr(cfg, step)
            with torch.no_grad():
                for n, g in zip(leaves, grads):
                    m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    m_hat = m[n] / (1.0 - b1 ** step)
                    v_hat = v[n] / (1.0 - b2 ** step)
                    leaves[n] = (leaves[n].to(dtype) - lr * m_hat / (v_hat.sqrt() + eps)).float()
            del grads, value, p
        change = {n: w - start[n] for n, w in leaves.items()}
        return {"losses": losses, "grads": applied, "changes": change}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior
