"""Training in the PyTorch port against heat_tpu: DataParallel + DataParallelOptimizer on
the seq2seq Transformer, the learning-rate schedulers and DetectMetricPlateau, on the CPU.

The model is the seq2seq example at its small size (vocab 16, d_model 32, 4 heads, 2 + 2
layers, T = 10): heat_tpu's as in examples/nn/seq2seq_transformer.py with the boolean
causal flag, the port's from examples/nn/seq2seq_transformer_torch.py. heat_tpu's ``init``
parameters are carried across by ``interop.load_jax_params``; heat_tpu trains on its
8-device CPU test mesh, the port in one process, on the same numpy batches.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht

import heat_tpu_torch as ht
from heat_tpu_torch.interop import load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "nn"))
import seq2seq_transformer_torch as s2s  # noqa: E402

VOCAB, T, E, H, LAYERS = s2s.VOCAB, s2s.T, s2s.E, s2s.H, s2s.LAYERS
BATCH, STEPS = 16, 3


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


class JaxSeq2Seq(jht.nn.Module):
    """heat_tpu's seq2seq example model, with the causal target as the boolean flag."""

    def __init__(self):
        self.embed = jht.nn.Embedding(VOCAB, E)
        self.pos = jht.nn.Embedding(T + 1, E)
        self.core = jht.nn.Transformer(
            d_model=E, nhead=H, num_encoder_layers=LAYERS, num_decoder_layers=LAYERS, dim_feedforward=4 * E, dropout=0.0
        )
        self.out = jht.nn.Linear(E, VOCAB)

    def init(self, key):
        ks = jax.random.split(key, 4)
        return {"embed": self.embed.init(ks[0]), "pos": self.pos.init(ks[1]), "core": self.core.init(ks[2]),
                "out": self.out.init(ks[3])}

    def apply(self, params, src, tgt_in, *, key=None, train=False):
        se = self.embed.apply(params["embed"], src) + self.pos.apply(params["pos"], jnp.arange(src.shape[1]))
        te = self.embed.apply(params["embed"], tgt_in) + self.pos.apply(params["pos"], jnp.arange(tgt_in.shape[1]))
        h = self.core.apply(params["core"], se, te, key=key, train=train, tgt_is_causal=True)
        return self.out.apply(params["out"], h)


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(n_steps, batch=BATCH, seed=0):
    """Batches of the reversal task from numpy: (src, tgt_in, tgt) int64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        src = rng.integers(1, VOCAB, (batch, T))
        tgt = src[:, ::-1].copy()
        tgt_in = np.concatenate([np.full((batch, 1), s2s.BOS), tgt[:, :-1]], axis=1)
        out.append((src, tgt_in, tgt))
    return out


def _pair(seed=0):
    jm = JaxSeq2Seq()
    jm.params = jm.init(jax.random.key(seed))
    tm = load_jax_params(s2s.Seq2Seq(device="cpu"), _np_params(jm.params)).train()
    return jm, tm


def _flat_jax(params):
    return {
        ".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_leaves_with_path(params)
    }


def test_load_jax_params_transposes_linear_and_not_embedding():
    jm, tm = _pair(seed=1)
    p = _np_params(jm.params)
    np.testing.assert_array_equal(tm.embed.weight.detach().numpy(), p["embed"]["weight"])  # (num, dim) in both
    np.testing.assert_array_equal(tm.pos.weight.detach().numpy(), p["pos"]["weight"])
    np.testing.assert_array_equal(tm.out.weight.detach().numpy(), p["out"]["weight"].T)  # (in, out) -> (out, in)
    lin1 = tm.core.encoder.layers[0].linear1.weight.detach().numpy()
    np.testing.assert_array_equal(lin1, p["core"]["encoder"]["0"]["linear1"]["weight"].T)
    # and the two models agree on the logits: fp32 on both sides, 2 + 2 layers
    src, tgt_in, _ = _batches(1)[0]
    want = jm.apply(jm.params, jnp.asarray(src), jnp.asarray(tgt_in))
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt_in))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# SGD: both take p -= lr·g from gradients that agree to f32 rounding. Adam (optax.adam and
# torch.optim.Adam at their defaults compute m̂/(√v̂ + ε) alike): the same, except for the
# key-projection biases, whose gradient is zero in exact arithmetic (a shift of every
# score of a row leaves its softmax unchanged) and in f32 is rounding noise of ~1e-9 that
# Adam divides by its own magnitude plus ε = 1e-8: its step there is any value in [-lr, lr]
# on either side, so those entries are held to |Δp| <= steps·lr from their start instead
LR = {"sgd": 0.1, "adam": 1e-2}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


def _key_bias_rows(name):
    """Rows of the key projection within a packed in_proj_bias (3E,)."""
    return slice(E, 2 * E) if name.endswith("in_proj_bias") else None


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_data_parallel_training_matches_heat_tpu(opt_name):
    jm, tm = _pair(seed=2)
    start = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    jopt = jht.optim.DataParallelOptimizer(opt_name, lr=LR[opt_name])
    jht.nn.DataParallel(jm, optimizer=jopt)
    crit = jht.nn.CrossEntropyLoss()

    def jax_loss(params, src, tgt_in, tgt):
        return crit(jm.apply(params, src, tgt_in).reshape(-1, VOCAB), tgt.reshape(-1))

    topt = ht.optim.DataParallelOptimizer(opt_name, lr=LR[opt_name])
    dp = ht.nn.DataParallel(tm, optimizer=topt)
    assert isinstance(topt.local_optimizer, {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt_name])
    for src, tgt_in, tgt in _batches(STEPS):
        want = jopt.step(jax_loss, *(jht.array(a, split=0) for a in (src, tgt_in, tgt)))
        got = topt.step(s2s.seq2seq_loss, *(ht.array(a, split=0) for a in (src, tgt_in, tgt)))
        assert got.dim() == 0 and not got.requires_grad
        np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    want_params = _flat_jax(jm.params)
    for name, p in dp.module.state_dict().items():
        w = want_params[name]
        w = w.T if name.endswith(("linear1.weight", "linear2.weight")) or name == "out.weight" else w
        got = p.numpy()
        rows = _key_bias_rows(name) if opt_name == "adam" else None
        if rows is not None:
            bound = STEPS * LR[opt_name] * (1 + 1e-5)
            s0 = start[name].numpy()
            assert np.abs(got[rows] - s0[rows]).max() <= bound and np.abs(w[rows] - s0[rows]).max() <= bound, name
            got, w = np.delete(got, np.r_[rows], axis=0), np.delete(w, np.r_[rows], axis=0)
        np.testing.assert_allclose(got, w, **PARAM_TOL, err_msg=name)
    assert not torch.equal(dp.module.out.weight.detach(), start["out.weight"])  # it trained


def test_data_parallel_optimizer_api():
    model = torch.nn.Linear(3, 2)
    with pytest.raises(TypeError):
        ht.nn.DataParallel(object())
    with pytest.raises(TypeError):
        ht.optim.DataParallelOptimizer(blocking="yes")
    with pytest.raises(ValueError, match="unknown optimizer"):
        ht.optim.DataParallelOptimizer("lamb")
    # DASO's argument errors are heat_tpu's (dp_optimizer.py:202-207)
    for args, kw, err in (((-1,), {}, TypeError), ((4,), {"warmup_epochs": -1}, ValueError),
                          ((4,), {"warmup_epochs": 3, "cooldown_epochs": 2}, ValueError)):
        with pytest.raises(err):
            ht.optim.DASO(None, *args, **kw)
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.5)
    with pytest.raises(RuntimeError, match="not attached"):
        opt.step(lambda m: 0.0)
    ht.nn.DataParallelMultiGPU(model, optimizer=opt)
    with pytest.raises(TypeError, match="loss_fn"):
        opt.step()
    # the learning rate writes every parameter group
    opt.lr = 0.25
    assert opt.lr == 0.25 and all(g["lr"] == 0.25 for g in opt.local_optimizer.param_groups)
    # an optimizer instance is taken as it is, with its own rate
    sgd = torch.optim.SGD(model.parameters(), lr=0.3, momentum=0.9)
    opt2 = ht.optim.DataParallelOptimizer(sgd)
    ht.nn.DataParallel(model, optimizer=opt2)
    assert opt2.local_optimizer is sgd and opt2.torch_optimizer is sgd and opt2.lr == 0.3
    # one step of plain SGD on a split batch at world 1: p -= lr·grad of the mean loss
    x, y = torch.randn(5, 3), torch.randn(5, 2)
    w0, b0 = model.weight.detach().clone(), model.bias.detach().clone()
    wr, br = w0.clone().requires_grad_(), b0.clone().requires_grad_()
    want = torch.nn.functional.mse_loss(x @ wr.T + br, y)
    want.backward()
    loss = opt.step(lambda m, a, b: torch.nn.functional.mse_loss(m(a), b), ht.array(x, split=0), ht.array(y, split=0))
    assert loss.dim() == 0 and float(loss) == pytest.approx(want.item(), rel=1e-6)
    torch.testing.assert_close(model.weight.detach(), w0 - 0.25 * wr.grad)
    torch.testing.assert_close(model.bias.detach(), b0 - 0.25 * br.grad)
    # the optimizer package falls through to torch.optim
    assert ht.optim.AdamW is torch.optim.AdamW
    with pytest.raises(AttributeError):
        ht.optim.no_such_optimizer


def test_step_holds_tf32_off_through_the_backward():
    """The step runs the forward and the backward with TF32 off, whatever the process set."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            seen.append(("forward", torch.backends.cuda.matmul.allow_tf32))
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("backward", torch.backends.cuda.matmul.allow_tf32))
            return g

    model = torch.nn.Linear(3, 1)
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.1)
    ht.nn.DataParallel(model, optimizer=opt)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        opt.step(lambda m, a: Probe.apply(m(a)).pow(2).mean(), torch.randn(4, 3))
        assert torch.backends.cuda.matmul.allow_tf32  # restored after the step
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [("forward", False), ("backward", False)]


# ---------------------------------------------------------------------- schedulers
def _warmup(e):
    """"Attention Is All You Need" §5.3 with warmup 4000, at step e + 1."""
    return E**-0.5 * min((e + 1) ** -0.5, (e + 1) * 4000**-1.5)


SCHEDULERS = {
    "LambdaLR": ("LambdaLR", dict(lr_lambda=lambda e: 0.9**e)),
    "LambdaLR_warmup": ("LambdaLR", dict(lr_lambda=_warmup)),
    "StepLR": ("StepLR", dict(step_size=3, gamma=0.5)),
    "MultiStepLR": ("MultiStepLR", dict(milestones=[9, 2, 5], gamma=0.3)),
    "ConstantLR": ("ConstantLR", dict(factor=0.25, total_iters=4)),
    "LinearLR": ("LinearLR", dict(start_factor=0.2, end_factor=1.0, total_iters=8)),
    "ExponentialLR": ("ExponentialLR", dict(gamma=0.8)),
    "CosineAnnealingLR": ("CosineAnnealingLR", dict(T_max=7, eta_min=0.01)),
    "ReduceLROnPlateau": ("ReduceLROnPlateau", dict(factor=0.5, patience=2, cooldown=1)),
}
METRICS = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84, 0.5, 0.5, 0.5, 0.5, 0.4, 0.41, 0.42, 0.43, 0.44, 0.45]


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_lr_scheduler_sequences_match_heat_tpu(name):
    cls, kwargs = SCHEDULERS[name]
    jopt = jht.optim.DataParallelOptimizer("sgd", lr=0.5)
    topt = ht.optim.DataParallelOptimizer("sgd", lr=0.5)
    ht.nn.DataParallel(torch.nn.Linear(2, 2), optimizer=topt)
    js = getattr(jht.optim.lr_scheduler, cls)(jopt, **kwargs)
    ts = getattr(ht.optim.lr_scheduler, cls)(topt, **kwargs)
    want, got = [], []
    for metric in METRICS:
        if cls == "ReduceLROnPlateau":
            js.step(metric)
            ts.step(metric)
        else:
            js.step()
            ts.step()
        want.append(js.get_last_lr()[0])
        got.append(ts.get_last_lr()[0])
        assert all(g["lr"] == got[-1] for g in topt.local_optimizer.param_groups)
    assert got == want
    assert len(set(got)) > 1  # the schedule moved


def test_lr_scheduler_base_class_matches_heat_tpu():
    for pkg in (jht, ht):
        opt = pkg.optim.DataParallelOptimizer("sgd", lr=0.5)
        with pytest.raises(NotImplementedError):
            pkg.optim.lr_scheduler.LRScheduler(opt)
        with pytest.raises(TypeError, match="lr"):
            pkg.optim.lr_scheduler.StepLR(object(), step_size=2)
        with pytest.raises(ValueError, match="factor"):
            pkg.optim.lr_scheduler.ReduceLROnPlateau(opt, factor=1.5)
    assert ht.optim.lr_scheduler.__all__ == jht.optim.lr_scheduler.__all__ and len(ht.optim.lr_scheduler.__all__) == 9


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(mode="max", patience=1),
    dict(threshold_mode="abs", threshold=0.05, patience=2, cooldown=2),
    dict(mode="min", patience=0, cooldown=1),
])
def test_detect_metric_plateau_matches_heat_tpu(kwargs):
    jd = jht.optim.DetectMetricPlateau(**kwargs)
    td = ht.optim.DetectMetricPlateau(**kwargs)
    seq = METRICS + [-m for m in METRICS]
    assert [td.test_if_improving(m) for m in seq] == [jd.test_if_improving(m) for m in seq]
    assert td.get_state() == jd.get_state()
    td.reset()
    jd.reset()
    assert td.get_state() == jd.get_state()
    state = td.get_state()
    fresh = ht.optim.DetectMetricPlateau()
    fresh.set_state(state)
    assert fresh.get_state() == state and not math.isnan(float(fresh.best))
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(mode="mean")
