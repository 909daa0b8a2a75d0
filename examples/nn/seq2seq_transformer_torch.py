"""Sequence-to-sequence with ``heat_tpu_torch.nn.Transformer``: learn to reverse a token
sequence, trained data-parallel.

The PyTorch port's counterpart of ``seq2seq_transformer.py``: a token ``Embedding`` and a
learned position ``Embedding``, ``Transformer(dropout=0.0)`` with a causal target
(``tgt_is_causal=True``, the boolean causal flag that the flash kernels take), an untied
``Linear`` head and ``CrossEntropyLoss``. The batch is a split=0 DNDarray, and the model
is trained through ``DataParallel`` and ``DataParallelOptimizer("adam")``: on the card
every attention runs the flash forward K2, and its gradient the flash backward (the D
pass, K4 and K5).

Run:  python examples/nn/seq2seq_transformer_torch.py [--device cpu]   (~200 steps)
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import heat_tpu_torch as ht  # noqa: E402
from heat_tpu_torch.core.devices import sanitize_device  # noqa: E402

VOCAB, T, E, H, LAYERS = 16, 10, 32, 4, 2
BOS = 0


class Seq2Seq(torch.nn.Module):
    """Token and position embeddings, an encoder-decoder Transformer and a linear head,
    under the parameter names of heat_tpu's example (``embed``, ``pos``, ``core``,
    ``out``), so that its parameter tree loads with ``interop.load_jax_params``."""

    def __init__(self, vocab=VOCAB, max_len=T + 1, d_model=E, nhead=H, layers=LAYERS, dim_feedforward=4 * E,
                 device=None):
        super().__init__()
        dev = sanitize_device(device).torch_device
        self.embed = ht.nn.Embedding(vocab, d_model, device=dev)
        self.pos = ht.nn.Embedding(max_len, d_model, device=dev)
        self.core = ht.nn.Transformer(
            d_model=d_model, nhead=nhead, num_encoder_layers=layers, num_decoder_layers=layers,
            dim_feedforward=dim_feedforward, dropout=0.0, device=dev,
        )
        self.out = ht.nn.Linear(d_model, vocab, device=dev)

    def forward(self, src, tgt_in):
        """Logits (B, T, vocab) for source tokens ``src`` (B, S) and decoder input tokens
        ``tgt_in`` (B, T)."""
        se = self.embed(src) + self.pos(torch.arange(src.shape[1], device=src.device))
        te = self.embed(tgt_in) + self.pos(torch.arange(tgt_in.shape[1], device=tgt_in.device))
        return self.out(self.core(se, te, tgt_is_causal=True))


def reverse_batch(n, t=T, vocab=VOCAB, generator=None, device=None):
    """(src, tgt_in, tgt) of the reversal task: tokens uniform in [1, vocab), the target
    the reversed source, the decoder input BOS + target[:-1]."""
    src = torch.randint(1, vocab, (n, t), generator=generator, device=device)
    tgt = src.flip(1)
    tgt_in = torch.cat([torch.full((n, 1), BOS, dtype=src.dtype, device=device), tgt[:, :-1]], dim=1)
    return src, tgt_in, tgt


def seq2seq_loss(model, src, tgt_in, tgt):
    """Mean cross-entropy of the next-token logits over every target token."""
    logits = model(src, tgt_in)
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1))


def main(steps: int = 200, device=None) -> float:
    dev = sanitize_device(device).torch_device
    torch.manual_seed(0)
    model = Seq2Seq(device=dev).train()
    opt = ht.optim.DataParallelOptimizer("adam", lr=3e-3)
    dp = ht.nn.DataParallel(model, optimizer=opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    loss = None
    for i in range(steps):
        batch = [ht.array(t, split=0, device=device) for t in reverse_batch(64, generator=gen, device=dev)]
        loss = opt.step(seq2seq_loss, *batch)
        if i % 50 == 0:
            print(f"step {i:4d}  loss {float(loss):.4f}")
    print(f"final loss {float(loss):.4f}")

    # greedy decode one example
    model.eval()
    src, _, tgt = reverse_batch(1, generator=gen, device=dev)
    dec = torch.full((1, 1), BOS, dtype=src.dtype, device=dev)
    with torch.no_grad():
        for _ in range(T):
            nxt = dp(src, dec)[:, -1:].argmax(-1)
            dec = torch.cat([dec, nxt], dim=1)
    print("src     :", src[0].tolist())
    print("decoded :", dec[0, 1:].tolist())
    print("target  :", tgt[0].tolist())
    return float(loss)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="'gpu' (the default) or 'cpu'")
    parser.add_argument("--steps", type=int, default=200)
    args = parser.parse_args()
    main(args.steps, args.device)
