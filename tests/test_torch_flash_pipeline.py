"""K3 (the pipelined flash forward) of the PyTorch port against heat_tpu's, and the
``HEAT_TPU_FLASH_PIPELINE`` knob that selects it.

On the CPU the port runs K3's plain PyTorch version, ``flash_attention_pipelined_reference``,
which walks heat_tpu's skewed schedule tile by tile. It must agree with heat_tpu's
``_kernel_pipelined`` run in interpret mode (``_flash_pallas(..., pipelined=True)``) at the
cases of tests/test_flash_pipeline.py, and with the port's plain K2 at ragged lengths. With
the knob set, the port's ``flash_attention`` must take K3's plain version on CPU tensors,
differentiate through it, keep heat_tpu's gate decisions, and leave a small Transformer
forward and a small data-parallel training step equal to heat_tpu's. The CUDA kernel is
held against the plain version on the card by chip_smoke.py. Inputs come from a seeded
numpy generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
from heat_tpu.core.kernels import flash_attention as jfa

import heat_tpu_torch as ht
from heat_tpu_torch.core.kernels import flash_attention as k2
from heat_tpu_torch.interop import load_jax_params
from heat_tpu_torch.nn import attention as port_attention

import test_torch_training as training
from test_torch_flash_attention import GATE_SHARED, _gate_inputs

KNOB = "HEAT_TPU_FLASH_PIPELINE"
NEG_INF = float(np.finfo(np.float32).min)
# tests/test_flash_pipeline.py's tolerances: f32 O 2e-5, LSE 1e-5 (the same fp32
# arithmetic in another order)
F32_O_TOL = dict(rtol=2e-5, atol=2e-5)
LSE_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: heat_tpu rounds P to bf16 before P·V, the port keeps it f32 (tests/test_flash_pipeline.py's 2e-2)
BF16_O_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    ht.use_device("cpu")
    monkeypatch.delenv(KNOB, raising=False)


def _np(t):
    return np.array(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("bk", [64, 128, 256])
@pytest.mark.parametrize("bq", [64, 128, 256])
def test_schedules_match_heat_tpu(bq, bk, causal):
    for nq in range(1, 7):
        for nk in range(1, 7):
            for ours, theirs in ((k2._pair_schedule, jfa._pair_schedule),
                                 (k2._pair_schedule_pipelined, jfa._pair_schedule_pipelined)):
                got, want = ours(nq, nk, bq, bk, causal), theirs(nq, nk, bq, bk, causal)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype == np.int32
                    np.testing.assert_array_equal(a, b)


# tests/test_flash_pipeline.py's cases: (b, h, tq, tk, d, causal, dtype, bias)
PALLAS_CASES = {
    "causal_square": (1, 2, 512, 512, 64, True, "float32", False),
    "noncausal_square": (1, 2, 512, 512, 64, False, "float32", False),
    "cross_length_bf16": (2, 1, 256, 512, 32, True, "bfloat16", False),
    "single_pair_rows": (1, 1, 128, 256, 32, True, "float32", False),
    "bias_stream": (1, 2, 512, 512, 64, False, "float32", True),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_k3_matches_heat_tpu_interpret_kernel(case):
    b, h, tq, tk, d, causal, dtype, with_bias = PALLAS_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    bias = np.where(rng.random((tq, tk)) > 0.2, 0.0, -1e30).astype(np.float32) if with_bias else None
    scale = 0.125 if with_bias else float(1.0 / np.sqrt(d))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    o_want, lse_want = jfa._flash_pallas(jq, jk, jv, causal, scale, 128, 128, interpret=True,
                                         bias=None if bias is None else jnp.asarray(bias), pipelined=True)
    tq_, tk_, tv_ = (torch.from_numpy(_np(a)).to(tdt) for a in (jq, jk, jv))
    o, lse = k2.flash_attention_pipelined_reference(tq_, tk_, tv_, causal, scale, None if bias is None else torch.from_numpy(bias))
    assert o.dtype == tdt and o.shape == (b, h, tq, d) and lse.dtype == torch.float32 and lse.shape == (b, h, tq)
    np.testing.assert_allclose(o.float().numpy(), _np(o_want), **(BF16_O_TOL if dtype == "bfloat16" else F32_O_TOL))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **LSE_TOL)


# (bh, tq, tk, d, causal, dead row or None): lengths that no block of 128 tiles
RAGGED_CASES = {
    "cross_37x53": (3, 37, 53, 8, False, None),
    "causal_tq_lt_tk": (2, 70, 300, 16, True, None),
    "causal_tq_gt_tk": (2, 300, 61, 64, True, None),
    "dead_row": (2, 130, 97, 32, False, 3),
    "dead_row_causal_d128": (1, 150, 150, 128, True, 140),
}


@pytest.mark.parametrize("case", list(RAGGED_CASES))
def test_plain_k3_matches_plain_k2_at_ragged_lengths(case):
    bh, tq, tk, d, causal, dead = RAGGED_CASES[case]
    rng = np.random.default_rng(tq * tk)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(np.float32)) for t in (tq, tk, tk))
    bias = None
    if dead is not None:
        mask = torch.from_numpy(rng.random((tq, tk)) < 0.7)
        mask[dead] = False
        bias = k2._as_bias(mask)
    o, lse = k2.flash_attention_pipelined_reference(q, k, v, causal, 0.3, bias)
    o0, lse0 = k2.flash_attention_reference(q, k, v, causal, 0.3, bias)
    torch.testing.assert_close(o, o0, **F32_O_TOL)
    torch.testing.assert_close(lse, lse0, **F32_O_TOL)
    if dead is not None:
        # a fully masked row: O = 0 and LSE = NEG_INF/2 + log(1e-30), as in K2
        assert float(o[:, dead].abs().max()) == 0.0
        want = np.float32(NEG_INF / 2) + np.float32(np.log(np.float32(1e-30)))
        assert np.all(lse[:, dead].numpy() == want)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(k2, name)

    def spy(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(k2, name, spy)
    return calls


@pytest.mark.parametrize("knob", [None, "1", "0"])
def test_knob_selects_the_pipelined_forward(monkeypatch, knob):
    """Only HEAT_TPU_FLASH_PIPELINE=1 sends the forward to K3 (here its plain version, as
    the tensors lie on the CPU); no kernel is launched either way."""
    if knob is not None:
        monkeypatch.setenv(KNOB, knob)
    k3_calls, k2_calls = _spy(monkeypatch, "flash_attention_pipelined_reference"), _spy(monkeypatch, "flash_attention_reference")
    counts = dict(ht.core.kernels.launch_counts())
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, t, 16)).astype(np.float32)) for t in (40, 50, 50))
    o, lse = k2.flash_attention_fwd(q, k, v, True)
    assert (len(k3_calls), len(k2_calls)) == ((1, 0) if knob == "1" else (0, 1))
    o0, lse0 = k2.flash_attention_reference(q, k, v, True)
    torch.testing.assert_close(o, o0, **F32_O_TOL)
    torch.testing.assert_close(lse, lse0, **F32_O_TOL)
    assert ht.core.kernels.launch_counts() == counts


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_through_k3_matches_the_plain_forward(monkeypatch, causal):
    """With the knob set, the Function's forward is K3 and its backward the flash backward
    (D, K4 and K5 read K3's LSE): the gradients equal torch autograd through the plain
    forward."""
    monkeypatch.setenv(KNOB, "1")
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, t, 32)).astype(np.float32)) for t in (150, 140, 140))
    g = torch.from_numpy(rng.standard_normal((2, 2, 150, 32)).astype(np.float32))
    mask = torch.from_numpy(rng.random((150, 140)) < 0.8)
    mask[7] = False
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(k2.flash_attention(*leaves, causal, None, mask), leaves, g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(k2.flash_attention_reference(*ref, causal, None, k2._as_bias(mask))[0], ref, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    assert float(got[0][:, :, 7].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(GATE_SHARED))
def test_gate_agrees_with_heat_tpu_under_the_knob(monkeypatch, name):
    """heat_tpu's ``_fits`` narrows under the knob (flush steps and a second score tile in
    its VMEM budget); the port's gate stays K2's. At the shared cases the knob leaves
    heat_tpu's decision as it was, and the two gates still agree."""
    kwargs, mask_spec, scale = GATE_SHARED[name]
    q, k = _gate_inputs(**kwargs)
    mask = None if mask_spec is None else np.zeros(mask_spec[1], mask_spec[0])
    jmask = None if mask is None else jnp.asarray(mask)
    off = jfa.use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jmask, scale, interpret=True)
    monkeypatch.setenv(KNOB, "1")
    on = jfa.use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), jmask, scale, interpret=True)
    assert on == off
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    assert k2.kernel_takes(tq_, tk_, tk_, None if mask is None else torch.from_numpy(mask), scale) == on


def _flash_on_cpu(monkeypatch):
    """Send every attention that the kernels take to ``flash_attention`` although the
    tensors lie on the CPU (where the gate's device test would send it to the dense path),
    and count the calls of K3's plain version."""
    monkeypatch.setenv(KNOB, "1")
    monkeypatch.setattr(port_attention, "use_flash", k2.kernel_takes)
    return _spy(monkeypatch, "flash_attention_pipelined_reference")


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("norm_first", [False, True], ids=["post_norm", "pre_norm"])
def test_transformer_with_k3_matches_heat_tpu(monkeypatch, norm_first, activation):
    """test_torch_attention.py::test_transformer_matches_heat_tpu's 2 + 2-layer model with a
    causal target, every attention through K3's plain version: 2 encoder self-, 2 causal
    decoder self- and 2 cross-attentions."""
    calls = _flash_on_cpu(monkeypatch)
    d_model, nhead, dff = 64, 4, 128
    cfg = dict(d_model=d_model, nhead=nhead, num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=dff,
               norm_first=norm_first, activation=activation)
    jm = jht.nn.Transformer(**cfg)
    params = jm.init(jax.random.key(3))
    tm = ht.nn.Transformer(**cfg)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(4)
    src, tgt = (rng.standard_normal(s).astype(np.float32) for s in ((2, 12, d_model), (2, 7, d_model)))
    want = jm.apply(params, jnp.asarray(src), jnp.asarray(tgt), tgt_is_causal=True)
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_is_causal=True)
    assert len(calls) == 6
    # test_torch_attention.py's tolerance for a 2 + 2-layer stack
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_data_parallel_step_with_k3_matches_heat_tpu(monkeypatch, opt_name):
    """One step of test_torch_training.py::test_data_parallel_training_matches_heat_tpu's
    seq2seq model and optimizer, every attention through K3's plain version forward and
    the plain flash backward, against heat_tpu's step on its 8-device CPU mesh."""
    calls = _flash_on_cpu(monkeypatch)
    jm, tm = training._pair(seed=2)
    start = {name: t.detach().clone() for name, t in tm.state_dict().items()}
    lr = training.LR[opt_name]
    jopt = jht.optim.DataParallelOptimizer(opt_name, lr=lr)
    jht.nn.DataParallel(jm, optimizer=jopt)
    crit = jht.nn.CrossEntropyLoss()

    def jax_loss(params, src, tgt_in, tgt):
        return crit(jm.apply(params, src, tgt_in).reshape(-1, training.VOCAB), tgt.reshape(-1))

    topt = ht.optim.DataParallelOptimizer(opt_name, lr=lr)
    dp = ht.nn.DataParallel(tm, optimizer=topt)
    src, tgt_in, tgt = training._batches(1)[0]
    want = jopt.step(jax_loss, *(jht.array(a, split=0) for a in (src, tgt_in, tgt)))
    got = topt.step(training.s2s.seq2seq_loss, *(ht.array(a, split=0) for a in (src, tgt_in, tgt)))
    assert len(calls) == 3 * training.LAYERS
    np.testing.assert_allclose(float(got), float(want), **training.LOSS_TOL)
    want_params = training._flat_jax(jm.params)
    for name, p in dp.module.state_dict().items():
        w = want_params[name]
        w = w.T if name.endswith(("linear1.weight", "linear2.weight")) or name == "out.weight" else w
        got_p = p.numpy()
        rows = training._key_bias_rows(name) if opt_name == "adam" else None
        if rows is not None:  # Adam on a gradient of rounding noise: |Δp| <= lr (test_torch_training.py)
            s0 = start[name].numpy()
            bound = lr * (1 + 1e-5)
            assert np.abs(got_p[rows] - s0[rows]).max() <= bound and np.abs(w[rows] - s0[rows]).max() <= bound, name
            got_p, w = np.delete(got_p, np.r_[rows], axis=0), np.delete(w, np.r_[rows], axis=0)
        np.testing.assert_allclose(got_p, w, **training.PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("pipelined", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_float_bias_forward_matches_heat_tpu(monkeypatch, causal, pipelined):
    """``flash_attention`` takes an additive float (Tq, Tk) bias, as heat_tpu's does, and
    runs K2 or K3 with it."""
    if pipelined:
        monkeypatch.setenv(KNOB, "1")
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, 256, 32)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((256, 256)).astype(np.float32)
    bias[9] = -1e30  # a row of equal scores: uniform weights over the keys it attends
    o_want, lse_want = jfa._flash_pallas(*(jnp.asarray(a) for a in (q, k, v)), causal, 0.2, 128, 128, interpret=True,
                                         bias=jnp.asarray(bias), pipelined=pipelined)
    o, lse = k2.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal, 0.2, torch.from_numpy(bias))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), rtol=2e-4, atol=2e-4)
    o2 = k2.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal, 0.2, torch.from_numpy(bias))
    torch.testing.assert_close(o2, o, rtol=0, atol=0)


@pytest.mark.parametrize("pipelined", [False, True], ids=["k2", "k3"])
def test_float_bias_gradient_raises(monkeypatch, pipelined):
    """The flash backward does not compute a float bias's gradient: asking for any
    gradient of such a call raises, with heat_tpu's reason; a bool mask does not."""
    if pipelined:
        monkeypatch.setenv(KNOB, "1")
    q = torch.randn(2, 8, 16, requires_grad=True)
    out = k2.flash_attention(q, q, q, mask=torch.zeros(8, 8))
    with pytest.raises(NotImplementedError, match="float attention bias"):
        out.sum().backward()
    k2.flash_attention(q, q, q, mask=torch.ones(8, 8, dtype=torch.bool)).sum().backward()
    assert q.grad is not None
    # the gate of the attention layer still takes bool masks only, as heat_tpu's does
    assert not k2.kernel_takes(q, q, q, torch.zeros(8, 8))
