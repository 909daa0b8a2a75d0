"""The yardstick's arithmetic: the card's peaks and the work of each kind of step, counted
from shapes alone, so that a number reads the same work whatever kernels implement it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
# float32 attention at float32's accuracy on the tensor cores: three TF32 products per
# product (3xTF32), a third of the TF32 rate; no f32 product on the card runs faster
F32_ATTENTION_FLOPS = TF32_FLOPS / 3

# products of B·H·Tq·Tk·dh in one attention: the forward's S = QKᵀ and O = PV, the
# backward's S recomputed, dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀQ
ATTENTION_PRODUCTS_FWD = 2
ATTENTION_PRODUCTS_BWD = 5


def attention_flops(b: int, h: int, tq: int, tk: int, dh: int, causal: bool, backward: bool = True) -> float:
    """FLOPs of one attention's products: 2 per multiply-add, a causal one counted as half."""
    products = ATTENTION_PRODUCTS_FWD + (ATTENTION_PRODUCTS_BWD if backward else 0)
    return 2.0 * products * b * h * tq * tk * dh * (0.5 if causal else 1.0)


def seq2seq_attentions(cfg: dict, traffic: dict) -> list:
    """Every attention of one step of the encoder-decoder Transformer as (b, h, tq, tk, dh,
    causal): encoder self-attention, causal decoder self-attention, cross-attention."""
    b, s, t = traffic["batch"], traffic["src_len"], traffic["tgt_len"]
    h, dh = cfg["nhead"], cfg["d_model"] // cfg["nhead"]
    return ([(b, h, s, s, dh, False)] * cfg["num_encoder_layers"]
            + [(b, h, t, t, dh, True), (b, h, t, s, dh, False)] * cfg["num_decoder_layers"])


def seq2seq_attention_flops(cfg: dict, traffic: dict) -> float:
    """The attention FLOPs of one training step, forward and backward."""
    return sum(attention_flops(*a) for a in seq2seq_attentions(cfg, traffic))


def seq2seq_d_bytes(cfg: dict, traffic: dict) -> float:
    """Bytes of the backward's D = rowsum(dO ∘ O) pass: O and dO read once, D written once,
    float32, for every attention of a step."""
    return sum(b * h * tq * (2 * dh + 1) * 4.0 for b, h, tq, _, dh, _ in seq2seq_attentions(cfg, traffic))


def seq2seq_dense_params(cfg: dict) -> tuple:
    """The weight matrices that one source token and one target token pass through, as
    parameter counts (biases, norms and embedding lookups left out): a source token the
    encoder and the decoder's cross-attention key and value projections, a target token
    the decoder's self-attention, query and output projections of cross-attention, its
    feed-forward layers and the output head."""
    d, f, v = cfg["d_model"], cfg["dim_feedforward"], cfg["vocab_size"]
    encoder = cfg["num_encoder_layers"] * (4 * d * d + 2 * d * f)
    source = encoder + cfg["num_decoder_layers"] * 2 * d * d
    target = cfg["num_decoder_layers"] * (4 * d * d + 2 * d * d + 2 * d * f) + d * v
    return source, target


def seq2seq_step_flops(cfg: dict, traffic: dict) -> float:
    """Model FLOPs of one training step: 6 a parameter a token (forward 2, backward 4) for
    the dense products, plus the attention's products."""
    source, target = seq2seq_dense_params(cfg)
    b = traffic["batch"]
    dense = 6.0 * b * (traffic["src_len"] * source + traffic["tgt_len"] * target)
    return dense + seq2seq_attention_flops(cfg, traffic)


def seq2seq_step_tokens(traffic: dict) -> int:
    """Source plus target tokens of one step."""
    return traffic["batch"] * (traffic["src_len"] + traffic["tgt_len"])


def lloyd_fit_bytes(cfg: dict, n_iter: int) -> float:
    """Bytes that a Lloyd fit must move at least: x (n, d) float32 read once a pass, for
    its ``n_iter`` updates and the final assignment, and the labels (int64) written once."""
    n, d = cfg["n_samples"], cfg["n_features"]
    return (n_iter + 1) * n * d * 4.0 + n * 8.0
