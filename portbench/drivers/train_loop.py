"""Training steps back to back: one trainer runs ``DataParallelOptimizer.step(loss_fn, src,
tgt_in, tgt)`` over an encoder-decoder ``ht.nn.Transformer`` wrapped in ``ht.nn.DataParallel``,
the next step when the last has been issued (a closed loop; the device runs the steps in
order, and the window closes when it has finished them).

The model is the paper's: one token embedding shared by the source, the target and the
pre-softmax head (an ``ht.nn.Linear`` without bias whose weight is the embedding's), the
embeddings scaled by sqrt(d_model) plus sinusoidal positions, ``ht.nn.Transformer`` with a
causal target, and cross-entropy with the configuration's label smoothing. Its leaves
take the values ``inputs.seq2seq_weights`` draws from the seed; Adam runs with the
configuration's betas and epsilon under the paper's warm-up schedule, through the port's
``DataParallelOptimizer``. The batches are a pool made on the device in set-up and cycled.

Set-up builds that one trainer and drives it through its first ``traffic["checked_steps"]``
steps (three), which also warm up every shape of the window: each step's loss, each step's
gradient as Adam got it (worked out from its first moments, g_t = (m_t - beta1·m_{t-1}) /
(1 - beta1)) and the change of every leaf after the last of them are kept; the window then
goes on from there with the same object. After the window the plain reference follows those
steps from the same weights and batches.
"""

from __future__ import annotations

import statistics
import time

import torch
from torch.profiler import record_function

from portbench.lib import compare as cmp
from portbench.lib import inputs, work

STEP_SPAN, FORWARD_SPAN = "trainer.step", "model.forward"
# a leaf whose reference gradient is below this share of the median leaf's moves under Adam
# by round-off alone, and is left out of the change's comparison
NOUGHT_GRADIENT = 1e-3


def leaf_parts(named) -> dict:
    """The leaves of ``named`` (name, tensor) pairs as the comparison counts them: a packed
    projection (``in_proj_*``, the query, key and value projections in one tensor) counts as
    its three parts, ``name[q]``, ``name[k]`` and ``name[v]``, since a key's bias has no
    gradient under softmax while the query's and the value's have."""
    out = {}
    for name, t in named:
        if ".in_proj_" in name:
            for tag, piece in zip("qkv", t.chunk(3, 0)):
                out[f"{name}[{tag}]"] = piece
        else:
            out[name] = t
    return out


def part_norms(named) -> dict:
    """The float64 norm of each of :func:`leaf_parts`, read in one copy."""
    parts = leaf_parts(named)
    return dict(zip(parts, torch.stack([t.double().norm() for t in parts.values()]).tolist()))


def readings(ref: dict) -> dict:
    """The reference's readings in the program's form: the losses, the norms of each leaf's
    gradient at each step and of its change, and the gradients themselves."""
    return {"losses": ref["losses"], "grad_norms": [part_norms(g.items()) for g in ref["grads"]],
            "change_norms": part_norms(ref["changes"].items()), "grads": ref["grads"]}


def grad_diff(got: dict, ref: dict) -> float:
    """The mean, over the leaves whose reference gradient is at least the median leaf's, of
    a gradient's distance from the reference's, relative to the reference's."""
    ref_parts = leaf_parts(ref.items())
    got_parts = leaf_parts(got.items())
    norms = {n: float(t.double().norm()) for n, t in ref_parts.items()}
    median = statistics.median(norms.values())
    large = [n for n in ref_parts if norms[n] >= median]
    return statistics.fmean(
        float((got_parts[n].to(ref_parts[n].device, torch.float64) - ref_parts[n].double()).norm()) / norms[n]
        for n in large)


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers of the checked steps: the largest relative gap of a step's loss;
    the worst leaf's gap of a step's gradient's norm (the worst step) and of the change's
    norm; and :func:`grad_diff` at the worst step, which a lower precision moves where the
    norms' gaps stay within the program's own (see PERF.md)."""
    median = statistics.median(ref["grad_norms"][0].values())
    moving = [n for n, g in ref["grad_norms"][0].items() if g >= NOUGHT_GRADIENT * median]
    return {
        "loss_gap": max(cmp.relative_gap(a, b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_gap": max(cmp.worst_leaf(g, r) for g, r in zip(got["grad_norms"], ref["grad_norms"])),
        "change_gap": cmp.worst_leaf(got["change_norms"], ref["change_norms"], moving),
        "grad_diff": max(grad_diff(g, r) for g, r in zip(got["grads"], ref["grads"])),
    }


def sinusoids(length: int, d: int, device) -> torch.Tensor:
    """The paper's position encodings (section 3.5), float32: sin(pos / 10000^(2i/d)) in
    column 2i and cos in column 2i + 1."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    angle = pos / 10000.0 ** (torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
    return torch.stack([angle.sin(), angle.cos()], -1).reshape(length, d).float()


def build_model(ht, cfg: dict, device):
    """The sequence-to-sequence model on the port's modules."""
    if (cfg["positions"], cfg["shared_embeddings"], cfg["embedding_scale"]) != ("sinusoidal", True, "sqrt_d_model"):
        raise ValueError("the model has sinusoidal positions, scaled inputs and one shared embedding")

    class Seq2Seq(torch.nn.Module):
        def __init__(self):
            super().__init__()
            d = cfg["d_model"]
            self.d, self.scale = d, d ** 0.5
            self.embed = ht.nn.Embedding(cfg["vocab_size"], d, device=device)
            self.core = ht.nn.Transformer(
                d_model=d, nhead=cfg["nhead"], num_encoder_layers=cfg["num_encoder_layers"],
                num_decoder_layers=cfg["num_decoder_layers"], dim_feedforward=cfg["dim_feedforward"],
                dropout=cfg["dropout"], activation=cfg["activation"], layer_norm_eps=cfg["layer_norm_eps"],
                device=device,
            )
            self.out = ht.nn.Linear(d, cfg["vocab_size"], bias=False, device=device)
            self.out.weight = self.embed.weight
            self.positions = {}

        def encode(self, tokens):
            t = tokens.shape[1]
            if t not in self.positions:
                self.positions[t] = sinusoids(t, self.d, tokens.device)
            return self.embed(tokens) * self.scale + self.positions[t]

        def forward(self, src, tgt_in):
            return self.out(self.core(self.encode(src), self.encode(tgt_in), tgt_is_causal=True))

    return Seq2Seq().train()


class Driver:
    spans = (STEP_SPAN, FORWARD_SPAN)

    def __init__(self, cell, seed: int, device):
        import heat_tpu_torch as ht
        from heat_tpu_torch.core import kernels

        t0 = time.perf_counter()
        self.cell, self.seed, self.device = cell, seed, device
        cfg, traffic = cell.config, cell.traffic
        self.batches = inputs.token_batches(cfg, traffic, seed, device)
        self.feed = [[ht.array(t, split=0, device=device) for t in b] for b in self.batches]
        weights = inputs.seq2seq_weights(cfg, seed, device)
        t1 = time.perf_counter()
        self.model = build_model(ht, cfg, device)
        leaves = dict(self.model.named_parameters())
        if {n: tuple(p.shape) for n, p in leaves.items()} != {n: tuple(w.shape) for n, w in weights.items()}:
            raise RuntimeError("the model's leaves are not the configuration's layout")
        with torch.no_grad():
            for n, p in leaves.items():
                p.copy_(weights[n])
        del weights
        self.names = list(leaves)
        params = list(leaves.values())
        t_opt = time.perf_counter()
        adam = torch.optim.Adam(params, lr=inputs.noam_lr(cfg, 1), betas=tuple(cfg["adam_betas"]),
                                eps=cfg["adam_eps"])
        self.opt = ht.optim.DataParallelOptimizer(adam)
        self.dp = ht.nn.DataParallel(self.model, optimizer=self.opt)
        smoothing, vocab = cfg["label_smoothing"], cfg["vocab_size"]

        def loss_fn(model, src, tgt_in, tgt):
            with record_function(FORWARD_SPAN):
                logits = model(src, tgt_in)
            return torch.nn.functional.cross_entropy(logits.reshape(-1, vocab), tgt.reshape(-1),
                                                     label_smoothing=smoothing)

        self.loss_fn = loss_fn
        self.step_no = 0
        self.losses = []
        t2 = time.perf_counter()
        # the checked steps, which warm up every shape of the window
        before = [p.detach().clone() for p in params]
        beta1 = adam.param_groups[0]["betas"][0]
        moments = [torch.zeros_like(p) for p in params]
        grads = []
        kernels.reset_launch_counts()
        for i in range(traffic["checked_steps"]):
            self.iterate()
            now = [adam.state[p].get("exp_avg", torch.zeros_like(p)) for p in params]
            grads.append({n: ((m - beta1 * m0) / (1.0 - beta1)).cpu() for n, m, m0 in zip(self.names, now, moments)})
            moments = [m.clone() for m in now]
            if i == 0:
                first = {k: v for k, v in kernels.launch_counts().items() if v}
        del moments
        self.got = {
            "losses": [float(x) for x in self.losses],
            "grad_norms": [part_norms(g.items()) for g in grads],
            "grads": grads,
            "change_norms": part_norms((n, p.detach() - b) for n, p, b in zip(self.names, params, before)),
        }
        del before
        self.losses = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.phases = {"inputs_s": t1 - t0, "model_s": t_opt - t1, "optimizer_s": t2 - t_opt,
                       "checked_steps_s": time.perf_counter() - t2, "kernel_launches_first_step": first}

    def iterate(self) -> None:
        self.step_no += 1
        self.opt.lr = inputs.noam_lr(self.cell.config, self.step_no)
        batch = self.feed[(self.step_no - 1) % len(self.feed)]
        with record_function(STEP_SPAN):
            self.losses.append(self.opt.step(self.loss_fn, *batch))

    def work(self) -> dict:
        cfg, traffic = self.cell.config, self.cell.traffic
        return {
            "tokens": work.seq2seq_step_tokens(traffic),
            "model_flops": work.seq2seq_step_flops(cfg, traffic),
            "attention_flops": work.seq2seq_attention_flops(cfg, traffic),
            "d_bytes": work.seq2seq_d_bytes(cfg, traffic),
        }

    def check(self, limits: dict) -> tuple:
        """Free the program's state, run the plain reference through the checked steps and
        hold the program's readings to it: (the compared numbers, the window's steps whose
        loss is not finite)."""
        window_losses = torch.stack(self.losses).float() if self.losses else torch.zeros(0)
        failed = int((~torch.isfinite(window_losses)).sum())
        del self.model, self.opt, self.dp, self.feed, self.loss_fn, self.losses
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        cfg = self.cell.config
        weights = inputs.seq2seq_weights(cfg, self.seed, self.device)
        steps = self.cell.traffic["checked_steps"]
        ref = readings(self.cell.reference().train(weights, cfg, self.batches[:steps]))
        return compare(self.got, ref), failed


def calibrate(cell, seed: int, device) -> dict:
    """The compared numbers of the control and of each planted fault against the reference,
    at the cell's size: the reference with every float32 product in TF32 (the control: the
    configuration states float32 with TF32 off), trained on half of each batch's rows, a step
    that leaves the leaves unchanged, a step that returns the step before's loss (its answer
    altered where it is produced), and a second step that applies the first step's gradient
    again (a stale gradient); and, as a reading only, one target token of each batch
    altered."""
    ref_mod, cfg = cell.reference(), cell.config
    steps = cell.traffic["checked_steps"]
    batches = inputs.token_batches(cfg, cell.traffic, seed, device)[:steps]
    weights = inputs.seq2seq_weights(cfg, seed, device)
    ref = readings(ref_mod.train(weights, cfg, batches))
    unchanged = dict(ref, change_norms={n: 0.0 for n in ref["change_norms"]})
    stale = dict(ref, losses=ref["losses"][:1] + ref["losses"][:-1])
    return {
        "control_tf32": compare(readings(ref_mod.train(weights, cfg, batches, dtype=torch.float32, tf32=True)), ref),
        "fault_half_batch": compare(readings(ref_mod.train(weights, cfg, batches, half_batch=True)), ref),
        "fault_unchanged": compare(unchanged, ref),
        "fault_stale_loss": compare(stale, ref),
        "fault_stale_gradient": compare(readings(ref_mod.train(weights, cfg, batches, stale_gradient_step=2)), ref),
        "reading_altered_target_token": compare(readings(ref_mod.train(weights, cfg, batches, altered_token=True)),
                                                ref),
    }
