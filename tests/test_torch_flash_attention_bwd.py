"""The flash-attention backward (the D pass, K4 and K5) of the PyTorch port against
heat_tpu's, and the port's ``torch.autograd.Function`` around K2.

On the CPU the port runs the plain PyTorch versions of the kernels. The plain backward
must agree with heat_tpu's Pallas backward run in interpret mode (``_flash_bwd_pallas``,
on the same O and LSE from heat_tpu's forward) and with ``jax.vjp`` of heat_tpu's jnp
reference at ragged lengths; the ``Function`` on CPU tensors must give what torch
autograd gives through the plain forward. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py. Inputs come from a seeded numpy generator.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.flash_attention import _as_bias as jax_as_bias
from heat_tpu.core.kernels.flash_attention import _flash_bwd_pallas, _flash_pallas
from heat_tpu.core.kernels.flash_attention import flash_attention_reference as jax_reference

import heat_tpu_torch
from heat_tpu_torch.core import kernels
from heat_tpu_torch.core.kernels import flash_attention as k2

# both sides compute in fp32 from the same inputs, O and LSE, and differ only in the order
# of their sums (over up to 1024 keys or queries of terms up to ~|dO|·|k|)
F32_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# (bh, tq, tk, d, causal, masked): heat_tpu's backward tests (tests/test_flash_attention.py
# :119-223) at shapes of at most 2 x 512 query rows, since interpret mode is slow
PALLAS_CASES = {
    "non_causal": (2, 512, 512, 32, False, False),
    "causal": (2, 512, 512, 32, True, False),
    "cross_lengths": (1, 512, 1024, 16, False, False),
    "causal_longer_keys_zero_grads": (1, 512, 1024, 16, True, False),
    "bool_mask_dead_row": (1, 512, 512, 16, False, True),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_backward_matches_heat_tpu_interpret_kernels(case):
    bh, tq, tk, d, causal, masked = PALLAS_CASES[case]
    q, k, v, g = _arrays([(bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d)], seed=len(case))
    mask = None
    if masked:
        mask = np.random.default_rng(10).random((tq, tk)) > 0.25
        mask[7] = False  # a fully masked row
    scale = 0.125
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = _flash_pallas(jq, jk, jv, causal, scale, 512, 512, interpret=True, bias=jbias)
    want = _flash_bwd_pallas(jq, jk, jv, o, jg, lse, causal, scale, 512, 512, interpret=True, bias=jbias)
    got = k2.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(o), _t(g), _t(lse), causal, scale, None if mask is None else k2._as_bias(_t(mask))
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL, err_msg=name)
    if causal and tk > tq:
        # keys past the last query are attended by none: exact zeros in both
        assert float(got[1][:, tq:].abs().max()) == 0.0 and float(got[2][:, tq:].abs().max()) == 0.0
        assert float(jnp.max(jnp.abs(want[1][:, tq:]))) == 0.0
    if masked:
        assert float(got[0][:, 7].abs().max()) == 0.0  # the dead row's dq


# (batch dims, tq, tk, d, causal): heat_tpu's jnp reference takes any length
REFERENCE_CASES = [
    ((2, 3), 37, 53, 8, False),
    ((2, 3), 37, 53, 8, True),  # causal, Tq < Tk: top-left aligned, keys 37.. get zero
    ((4,), 61, 29, 16, True),  # causal, Tq > Tk
    ((), 17, 17, 64, True),
    ((2,), 33, 20, 100, False),  # a head dim that is no power of two
]


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda c: "x".join(map(str, (*c[0], *c[1:4]))) + ("_causal" if c[4] else ""))
def test_plain_backward_matches_vjp_of_heat_tpu_reference(case):
    batch, tq, tk, d, causal = case
    q, k, v, g = _arrays([(*batch, tq, d), (*batch, tk, d), (*batch, tk, d), (*batch, tq, d)], seed=tq * tk + d)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, causal=causal, scale=0.3), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(g))
    o, lse = k2.flash_attention_reference(_t(q), _t(k), _t(v), causal, 0.3)
    got = k2.flash_attention_bwd_reference(_t(q), _t(k), _t(v), o, _t(g), lse, causal, 0.3)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL, err_msg=name)
    # the public wrapper on CPU tensors is the plain backward, with no launch
    before = kernels.launch_counts()
    wrapped = k2.flash_attention_bwd(_t(q), _t(k), _t(v), o, _t(g), lse, causal, 0.3)
    assert kernels.launch_counts() == before
    for a, b in zip(wrapped, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (batch dims, tq, tk, d, causal, masked, dtype)
FUNCTION_CASES = {
    "self": ((2, 3), 24, 24, 16, False, False, torch.float32),
    "causal_tq_lt_tk": ((2,), 19, 31, 8, True, False, torch.float32),
    "causal_tq_gt_tk": ((3,), 31, 19, 8, True, False, torch.float32),
    "bool_mask_dead_row_causal": ((2,), 20, 20, 32, True, True, torch.float32),
    "d128": ((1,), 9, 12, 128, False, False, torch.float32),
    "bf16": ((2,), 16, 16, 16, True, False, torch.bfloat16),
}


@pytest.mark.parametrize("name", list(FUNCTION_CASES))
def test_function_on_cpu_matches_autograd_of_the_plain_forward(name):
    """The ``Function`` on CPU tensors (plain forward, plain backward) gives the gradients
    that torch autograd takes through the plain forward, and the same output."""
    batch, tq, tk, d, causal, masked, dtype = FUNCTION_CASES[name]
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _arrays([(*batch, tq, d), (*batch, tk, d), (*batch, tk, d), (*batch, tq, d)], 7))
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(8).random((tq, tk)) < 0.6)
        mask[4] = False
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = k2.flash_attention_fwd(*leaves, causal, None, mask)
    assert out.requires_grad and not lse.requires_grad  # LSE is not differentiable
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out, _ = k2.flash_attention_reference(*ref_leaves, causal, None, k2._as_bias(mask))
    want = torch.autograd.grad(ref_out, ref_leaves, g)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    # f32: the same arithmetic in another order. bf16: both round each gradient once to
    # bf16 (2⁻⁸ relative), and the Function's D uses the bf16-rounded O where autograd's
    # chain uses the f32 one before its rounding: 2⁻⁶ of the largest gradient covers both
    for a, b, t in zip(got, want, (q, k, v)):
        assert a.dtype == t.dtype and a.shape == t.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, **F32_TOL)
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=2**-6 * float(b.float().abs().max()))
    if masked:
        assert float(got[0][:, 4].abs().max()) == 0.0


def test_function_is_once_differentiable():
    """heat_tpu's custom_vjp has no double backward, nor has the port's Function."""
    q = torch.randn(2, 6, 8, requires_grad=True)
    out = k2.flash_attention(q, q, q)
    (gq,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|double backward|does not require grad"):
        torch.autograd.grad(gq.sum(), q)


def test_backward_wrapper_validates_its_inputs():
    q = torch.zeros(2, 8, 16)
    o, lse = k2.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="kernel takes"):
        k2.flash_attention_bwd(q.double(), q.double(), q.double(), o, o, lse)
    with pytest.raises(ValueError, match="lse"):
        k2.flash_attention_bwd(q, q, q, o, o, lse[:, :4])
    meta = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k2.flash_attention_bwd(meta, meta, meta, meta, meta, torch.zeros(2, 8, device="meta"))


def test_backward_kernels_are_registered():
    counts = kernels.launch_counts()
    for name in ("flash_attention_bwd_d", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert name in counts and kernels.KERNELS[name].SOURCE == k2.BWD_SOURCE
    assert k2.BWD_SOURCE.name == "flash_attention_bwd.cu" and k2.BWD_SOURCE.is_file()
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
