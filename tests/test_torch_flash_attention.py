"""K2 (the flash-attention forward) in the PyTorch port against heat_tpu's K2.

On the CPU the port's wrapper runs the plain PyTorch version of the kernel; it must agree
with heat_tpu's Pallas kernel run in interpret mode (O and LSE) and with heat_tpu's jnp
reference. The CUDA kernel itself is compared with the plain version on the card by
chip_smoke.py. Inputs come from a seeded numpy generator.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.flash_attention import _as_bias as jax_as_bias
from heat_tpu.core.kernels.flash_attention import _flash_pallas
from heat_tpu.core.kernels.flash_attention import flash_attention_reference as jax_reference
from heat_tpu.core.kernels.flash_attention import use_flash as jax_use_flash
from heat_tpu.nn.attention import _dense_attention as jax_dense

import heat_tpu_torch
from heat_tpu_torch.core.kernels import flash_attention as k2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG_INF = float(np.finfo(np.float32).min)

# f32: both sides compute in fp32 and differ only in summation order (the tolerance of
# tests/test_flash_attention.py)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 against heat_tpu's kernel: heat_tpu rounds P to bf16 before P·V (2⁻⁹ relative on
# each weight) and both round O to bf16 (2⁻⁹ relative); |O| < 0.5 here, so 2⁻⁷ absolute
# covers both roundings with room
BF16_TOL = dict(rtol=2**-7, atol=2**-7)


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def _qkv(bh, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, tq, d)).astype(np.float32)
    k = rng.standard_normal((bh, tk, d)).astype(np.float32)
    v = rng.standard_normal((bh, tk, d)).astype(np.float32)
    return q, k, v


def _mask(tq, tk, seed, dead_row=None):
    """A random (tq, tk) bool mask (True = attend), with one row fully masked."""
    rng = np.random.default_rng(seed)
    m = rng.random((tq, tk)) < 0.7
    if dead_row is not None:
        m[dead_row] = False
    return m


# (bh, tq, tk, d, causal, masked, dtype): interpret mode is slow on the CPU, so a few
# shapes of at most 2×512 rows
PALLAS_CASES = {
    "f32": (2, 512, 512, 32, False, False, np.float32),
    "f32_causal": (2, 512, 512, 32, True, False, np.float32),
    "f32_causal_tq_lt_tk": (1, 512, 1024, 16, True, False, np.float32),
    "f32_tq_gt_tk": (1, 1024, 512, 16, False, False, np.float32),
    "f32_bool_mask_dead_row": (1, 512, 512, 16, False, True, np.float32),
    "f32_bool_mask_causal": (1, 512, 512, 16, True, True, np.float32),
    "bf16_causal": (1, 512, 512, 32, True, False, "bfloat16"),
}


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_k2_matches_heat_tpu_interpret_kernel(case):
    bh, tq, tk, d, causal, masked, dtype = PALLAS_CASES[case]
    q, k, v = _qkv(bh, tq, tk, d, seed=len(case))
    mask = _mask(tq, tk, seed=3, dead_row=5) if masked else None
    scale = 1.0 / np.sqrt(d)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    bias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    o_want, lse_want = _flash_pallas(jq, jk, jv, causal, float(scale), 512, 512, interpret=True, bias=bias)
    tq_, tk_, tv_ = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (jq, jk, jv))
    o, lse = k2.flash_attention_fwd(tq_, tk_, tv_, causal, float(scale), None if mask is None else torch.from_numpy(mask))
    assert o.dtype == tdt and lse.dtype == torch.float32
    assert o.shape == (bh, tq, d) and lse.shape == (bh, tq)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want), **F32_TOL)
    if masked:
        # a fully masked row: output 0 and LSE = NEG_INF/2 + log(1e-30), finite, in both
        assert float(o[:, 5].abs().max()) == 0.0
        want = np.float32(NEG_INF / 2) + np.float32(np.log(np.float32(1e-30)))
        assert np.all(lse[:, 5].numpy() == want) and np.all(np.asarray(lse_want)[:, 5] == want)


# (batch dims, tq, tk, d, causal): the jnp reference takes any length
REFERENCE_CASES = [
    ((2, 3), 37, 53, 8, False),
    ((2, 3), 37, 53, 8, True),  # causal, Tq < Tk: top-left aligned
    ((4,), 61, 29, 16, True),  # causal, Tq > Tk
    ((), 17, 17, 64, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda c: "x".join(map(str, (*c[0], *c[1:4]))) + ("_causal" if c[4] else ""))
def test_plain_k2_matches_heat_tpu_reference(case, dtype):
    batch, tq, tk, d, causal = case
    rng = np.random.default_rng(tq * tk)
    q = rng.standard_normal((*batch, tq, d)).astype(np.float32)
    k = rng.standard_normal((*batch, tk, d)).astype(np.float32)
    v = rng.standard_normal((*batch, tk, d)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = jax_reference(jq, jk, jv, causal=causal, scale=0.3)
    o, lse = k2.flash_attention_fwd(*(torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (jq, jk, jv)), causal, 0.3)
    assert o.dtype == tdt and o.shape == (*batch, tq, d) and lse.shape == (*batch, tq)
    # both compute in f32 from the same rounded inputs; bf16 output may differ by the one
    # final rounding (2⁻⁸ relative of |O| <= max|v| < 5)
    tol = dict(rtol=2**-7, atol=5 * 2**-8) if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(o.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    if causal:
        # row 0 attends key 0 alone: its output is v[..., 0, :] and its LSE scale·q0·k0
        np.testing.assert_allclose(o[..., 0, :].float().numpy(), np.asarray(jv[..., 0, :].astype(jnp.float32)), **tol)
        q0, k0 = (np.asarray(a[..., 0, :].astype(jnp.float32)) for a in (jq, jk))
        np.testing.assert_allclose(lse[..., 0].numpy(), 0.3 * (q0 * k0).sum(-1), **F32_TOL)


def test_bool_mask_with_dead_row_matches_heat_tpu_dense_path():
    """Ragged lengths with a mask take heat_tpu's XLA path: the same function, including
    the fully masked row."""
    q, k, v = _qkv(6, 19, 23, 8, seed=7)
    mask = _mask(19, 23, seed=8, dead_row=4)
    for causal in (False, True):
        want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal, 0.5)
        o = k2.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal, 0.5, torch.from_numpy(mask))
        np.testing.assert_allclose(o.numpy(), np.asarray(want), **F32_TOL)
        assert float(o[:, 4].abs().max()) == 0.0


def test_as_bias_matches_heat_tpu():
    mask = _mask(5, 7, seed=1)
    np.testing.assert_array_equal(k2._as_bias(torch.from_numpy(mask)).numpy(), np.asarray(jax_as_bias(jnp.asarray(mask))))
    f = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    np.testing.assert_array_equal(k2._as_bias(torch.from_numpy(f)).numpy(), np.asarray(jax_as_bias(jnp.asarray(f))))
    assert k2._as_bias(None) is None


def _gate_inputs(tq=512, tk=512, d=64, dtype=np.float32):
    q = np.zeros((1, 2, tq, d), dtype)
    k = np.zeros((1, 2, tk, d), dtype)
    return q, k


# (name, q/k builder args, mask, scale): decisions that heat_tpu's gate and the port's share
GATE_SHARED = {
    "plain": ({}, None, None),
    "static_scale": ({}, None, 0.125),
    "bool_mask_exact_shape": ({}, ("bool", (512, 512)), None),
    "bool_mask_4d": ({}, ("bool", (1, 1, 1, 512)), None),
    "bool_mask_wrong_shape": ({}, ("bool", (1024, 512)), None),
    "float_mask": ({}, ("float32", (512, 512)), None),
    "float64": ({"dtype": np.float64}, None, None),
    "int32": ({"dtype": np.int32}, None, None),
    "float16": ({"dtype": np.float16}, None, None),
    "cross_lengths": ({"tk": 1024}, None, None),
}


@pytest.mark.parametrize("name", list(GATE_SHARED))
def test_gate_agrees_with_heat_tpu(name):
    kwargs, mask_spec, scale = GATE_SHARED[name]
    q, k = _gate_inputs(**kwargs)
    mask = None if mask_spec is None else np.zeros(mask_spec[1], mask_spec[0])
    want = jax_use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None if mask is None else jnp.asarray(mask), scale, interpret=True)
    tq_, tk_ = torch.from_numpy(q), torch.from_numpy(k)
    tm = None if mask is None else torch.from_numpy(mask)
    assert k2.kernel_takes(tq_, tk_, tk_, tm, scale) == want
    # the device condition: CPU tensors never take the kernel
    assert not k2.use_flash(tq_, tk_, tk_, tm, scale)


def test_gate_where_it_differs_from_heat_tpu():
    """Where the two kernels' own limits differ, so do the gates, by design."""
    # a scale that is a tensor is not static in either
    q, k = _gate_inputs()
    assert not jax_use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None, jnp.float32(0.125), interpret=True)
    assert not k2.kernel_takes(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k), None, torch.tensor(0.125))
    # ragged lengths: the TPU kernel needs lengths its blocks tile, K2 masks the edges itself
    q, k = _gate_inputs(tq=100, tk=300)
    assert not jax_use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None, interpret=True)
    assert k2.kernel_takes(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    # head dim 256: within the TPU kernel's VMEM budget, beyond K2's registers (d <= 128)
    q, k = _gate_inputs(d=256)
    assert jax_use_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None, interpret=True)
    assert not k2.kernel_takes(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    assert k2.kernel_takes(*(torch.zeros(1, 8, 128),) * 3) and not k2.kernel_takes(*(torch.zeros(1, 8, 129),) * 3)
    # K2 wants one dtype for q, k and v
    assert not k2.kernel_takes(torch.zeros(1, 8, 16), torch.zeros(1, 8, 16, dtype=torch.bfloat16), torch.zeros(1, 8, 16))


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 40, 24, 16, seed=11))
    mask = torch.from_numpy(_mask(40, 24, seed=12, dead_row=0))
    before = k2.launches
    for causal in (False, True):
        o, lse = k2.flash_attention_fwd(q, k, v, causal, None, mask)
        o0, lse0 = k2.flash_attention_reference(q, k, v, causal, 0.25, k2._as_bias(mask))
        torch.testing.assert_close(o, o0, rtol=0, atol=0)
        torch.testing.assert_close(lse, lse0, rtol=0, atol=0)
    assert k2.launches == before  # no kernel launch for CPU tensors


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="kernel takes"):
        k2.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="kernel takes"):
        k2.flash_attention(q, q, q, mask=torch.zeros(8, 9))  # a float bias of the wrong shape
    with pytest.raises(ValueError, match="kernel takes"):
        k2.flash_attention(q, q, q, mask=torch.ones(1, 8, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="kernel takes"):
        k2.flash_attention(torch.zeros(2, 8, 200), torch.zeros(2, 8, 200), torch.zeros(2, 8, 200))


def test_grad_requiring_input_goes_through_the_flash_backward():
    """K2 now has a backward: a grad-requiring input is taken in grad mode as in no-grad
    mode, so off the CPU and the card (here the meta device, which no kernel serves) both
    raise the same device error, and on the CPU the gradient flows through the plain
    backward with no kernel launch."""
    q = torch.zeros(2, 8, 16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        k2.flash_attention(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA or CPU"):
        k2.flash_attention(q, q, q)
    counts = (k2.launches, k2.bwd_d.launches, k2.bwd_dq.launches, k2.bwd_dkv.launches)
    qc = torch.randn(2, 8, 16, requires_grad=True)
    k2.flash_attention(qc, qc, qc, causal=True).sum().backward()
    assert qc.grad is not None and bool(torch.isfinite(qc.grad).all())
    ref = qc.detach().clone().requires_grad_()
    k2.flash_attention_reference(ref, ref, ref, causal=True)[0].sum().backward()
    torch.testing.assert_close(qc.grad, ref.grad, **F32_TOL)
    assert (k2.launches, k2.bwd_d.launches, k2.bwd_dq.launches, k2.bwd_dkv.launches) == counts


def test_launcher_imports_without_cuda_or_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME="", CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    code = (
        "import heat_tpu_torch.core.kernels.flash_attention as k2, torch\n"
        "assert k2._LIB is None and k2._BWD_LIB is None and k2._PIPELINED_LIB is None and k2.launches == 0\n"
        "from heat_tpu_torch.core import kernels\n"
        "assert kernels.KERNELS['flash_attention_fwd'] is k2\n"
        "assert kernels.KERNELS['flash_attention_bwd_dq'] is k2.bwd_dq and k2.bwd_dq.launches == 0\n"
        "assert kernels.KERNELS['flash_attention_fwd_pipelined'] is k2.fwd_pipelined and k2.fwd_pipelined.launches == 0\n"
        "print('ok', torch.cuda.is_available())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "False"]
