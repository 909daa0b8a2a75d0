"""The inputs of every cell, made on the device from ``--seed``: the same seed gives the same
inputs, and every seed the same sizes.

- :func:`blobs`: a clustering data set of Gaussian blobs and its initial centers;
- :func:`token_batches`: a pool of batches of a sequence-to-sequence task;
- :func:`seq2seq_layout` and :func:`seq2seq_weights`: the leaves of the encoder-decoder
  Transformer and their values, drawn in one call (one embedding, shared by the source, the
  target and the pre-softmax head, as the paper ties them).

Both sides of a comparison take their inputs from here: the program (through its own entry
points) and the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_MASK63 = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each input drawn from one run's ``seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + 7_919 * stream) & _MASK63


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def blobs(cfg: dict, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x, init)``: ``n_samples`` rows of ``n_features`` float32 around ``n_clusters`` true
    centers drawn N(0, center_spread²), each row a center plus N(0, noise²); the initial
    centers are ``n_clusters`` distinct rows of x drawn from the seed."""
    n, d, k = cfg["n_samples"], cfg["n_features"], cfg["n_clusters"]
    gen = generator(seed, 0, device)
    true = cfg["center_spread"] * torch.randn(k, d, generator=gen, device=device)
    y = torch.randint(0, k, (n,), generator=gen, device=device)
    x = torch.randn(n, d, generator=gen, device=device).mul_(cfg["noise"])
    block = 1 << 20  # rows at a time, so that no second (n, d) array is made
    for a in range(0, n, block):
        x[a:a + block] += true[y[a:a + block]]
    del y
    rows = torch.randperm(n, generator=gen, device=device)[:k]
    return x, x[rows].contiguous()


def token_batches(cfg: dict, traffic: dict, seed: int, device) -> List[Tuple[torch.Tensor, ...]]:
    """A pool of ``traffic["pool"]`` batches ``(src, tgt_in, tgt)`` of the reversal task, in
    one draw: source tokens uniform in [1, vocab_size), the target the reversed source, the
    decoder input ``bos_id`` and the target but its last token."""
    if traffic["task"] != "reverse" or traffic["src_len"] != traffic["tgt_len"]:
        raise ValueError(f"the generator makes the reversal task, with equal lengths: {traffic}")
    pool, b, t = traffic["pool"], traffic["batch"], traffic["src_len"]
    src = torch.randint(1, cfg["vocab_size"], (pool, b, t), generator=generator(seed, 1, device), device=device)
    tgt = src.flip(-1)
    tgt_in = torch.cat([torch.full((pool, b, 1), cfg["bos_id"], dtype=src.dtype, device=device), tgt[..., :-1]], -1)
    return [(src[i], tgt_in[i], tgt[i]) for i in range(pool)]


# one leaf: (name, shape, init kind, fan_in, fan_out)
Leaf = Tuple[str, Tuple[int, ...], str, int, int]


def seq2seq_layout(cfg: dict) -> List[Leaf]:
    """Every leaf of the encoder-decoder Transformer, under the names that
    ``heat_tpu_torch.nn.Transformer`` and the sequence-to-sequence model around it give
    them (``embed``, the shared embedding and head; ``core``); ``drivers/train_loop.py``
    matches them to the model's leaves by name and shape."""
    d, f, v = cfg["d_model"], cfg["dim_feedforward"], cfg["vocab_size"]
    leaves: List[Leaf] = [("embed.weight", (v, d), "embedding", d, d)]

    def attention(prefix: str) -> List[Leaf]:
        return [
            (f"{prefix}.in_proj_weight", (3 * d, d), "xavier", d, d),
            (f"{prefix}.in_proj_bias", (3 * d,), "bias", d, d),
            (f"{prefix}.out_proj_weight", (d, d), "xavier", d, d),
            (f"{prefix}.out_proj_bias", (d,), "bias", d, d),
        ]

    def feedforward(prefix: str) -> List[Leaf]:
        return [
            (f"{prefix}.linear1.weight", (f, d), "xavier", d, f),
            (f"{prefix}.linear1.bias", (f,), "bias", d, f),
            (f"{prefix}.linear2.weight", (d, f), "xavier", f, d),
            (f"{prefix}.linear2.bias", (d,), "bias", f, d),
        ]

    def norm(prefix: str) -> List[Leaf]:
        return [(f"{prefix}.weight", (d,), "ones", d, d), (f"{prefix}.bias", (d,), "zeros", d, d)]

    for i in range(cfg["num_encoder_layers"]):
        pre = f"core.encoder.{i}"
        leaves += attention(f"{pre}.self_attn") + feedforward(pre) + norm(f"{pre}.norm1") + norm(f"{pre}.norm2")
    leaves += norm("core.encoder.norm")
    for i in range(cfg["num_decoder_layers"]):
        pre = f"core.decoder.{i}"
        leaves += (attention(f"{pre}.self_attn") + attention(f"{pre}.multihead_attn") + feedforward(pre)
                   + norm(f"{pre}.norm1") + norm(f"{pre}.norm2") + norm(f"{pre}.norm3"))
    leaves += norm("core.decoder.norm")
    return leaves


def _half_width(kind: str, fan_in: int, fan_out: int) -> float:
    """The half-width a of the uniform(-a, a) draw of a leaf of this kind: xavier's
    sqrt(6 / (fan_in + fan_out)) for matrices, 1 / sqrt(fan_in) for biases (torch's Linear),
    sqrt(3 / d_model) for the shared embedding (variance 1 / d_model, so that the inputs,
    scaled by sqrt(d_model), have unit variance, and so do the tied head's logits)."""
    if kind == "xavier":
        return math.sqrt(6.0 / (fan_in + fan_out))
    if kind == "bias":
        return 1.0 / math.sqrt(fan_in)
    if kind == "embedding":
        return math.sqrt(3.0 / fan_in)
    raise ValueError(kind)


def seq2seq_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The value of every leaf of :func:`seq2seq_layout`, float32 on ``device``: one
    uniform draw for all random leaves, scaled leaf by leaf in place; LayerNorms start at
    weight 1, bias 0. The tensors are views of one buffer."""
    layout = seq2seq_layout(cfg)
    total = sum(math.prod(shape) for _, shape, kind, _, _ in layout if kind not in ("ones", "zeros"))
    flat = torch.rand(total, generator=generator(seed, 2, device), device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind, fan_in, fan_out in layout:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            a = _half_width(kind, fan_in, fan_out)
            out[name] = flat[at:at + n].view(shape).mul_(2.0 * a).sub_(a)
            at += n
    return out


def noam_lr(cfg: dict, step: int) -> float:
    """The learning rate of "Attention Is All You Need" (eq. 3) at ``step`` (from 1):
    d_model^-0.5 · min(step^-0.5, step · warmup_steps^-1.5)."""
    return cfg["d_model"] ** -0.5 * min(step ** -0.5, step * cfg["warmup_steps"] ** -1.5)
