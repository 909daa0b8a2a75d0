"""The 16-bit flash backward (the D pass, and the bf16 and f16 K4 and K5 of
``csrc/flash_attention_bwd.cu`` on wgmma) of the PyTorch port against heat_tpu's, on the CPU.

heat_tpu's Pallas backward rounds dS to the input type before dS·k and dSᵀ·q, and P before
Pᵀ·dO (``_dq_kernel``/``_dkv_kernel``, flash_attention.py:460, :520, :525); the port's plain
backward and its 16-bit kernels do the same. Two parts:

(a) the plain backward against heat_tpu's ``_flash_bwd_pallas(..., interpret=True)`` in bf16
    and f16, on heat_tpu's own O and LSE, at the shapes of
    ``test_torch_flash_attention_bwd.PALLAS_CASES``; and the arithmetic the port had before
    (P and dS kept f32, the gradients rounded once) failing the same rule in bf16;
(b) the kernels' arithmetic emulated tile by tile: 16-bit operands, products summed in f32
    16 values of K at a time in the kernels' tile order (K4 walks tiles of 64 keys, K5 tiles
    of 64 queries), the softmax in log2 units (P = 2^(S·scale·log2 e + bias·log2 e − LSE·log2 e),
    the fused multiply-adds rounded once), P and dS rounded to the type as the A operand of
    their products; against the interpret-mode kernels and the plain backward.

The rule, for every element of each gradient: |got − ref| ≤ u·|ref| + s·max|ref|, with u one
unit in the last place of the type (2⁻⁷ relative for bf16, 2⁻¹⁰ for f16: the output's own
rounding may go the other way) and s a share of the gradient's largest magnitude (1e-3 for
bf16, 2.5e-4 for f16) for the terms of a sum whose P or dS rounded the other way, one unit
of the type each. chip_smoke.py's ``check_bwd`` holds the kernels on the card to the same
rule (``BWD_SHARE_16``). Inputs come from a seeded numpy generator.
"""

import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.flash_attention import _as_bias as jax_as_bias
from heat_tpu.core.kernels.flash_attention import _flash_bwd_pallas, _flash_pallas

import heat_tpu_torch
from heat_tpu_torch.core.kernels import flash_attention as k2

from test_torch_flash_attention_bwd import PALLAS_CASES

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
ULP = {"bf16": 2.0**-7, "f16": 2.0**-10}
SHARE = {"bf16": 1e-3, "f16": 2.5e-4}
TILE = 64  # keys per tile in K4, queries per tile in K5
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def err_over_tol(got, ref, name: str) -> float:
    """The worst |got − ref| / (u·|ref| + s·max|ref|) over the elements."""
    got, ref = got.float(), ref.float()
    tol = ULP[name] * ref.abs() + SHARE[name] * float(ref.abs().max()) + 1e-30
    return float(((got - ref).abs() / tol).max())


def _t(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


@functools.lru_cache(maxsize=None)
def heat_tpu_case(case: str, name: str):
    """The case's inputs in the type and heat_tpu's O, LSE and gradients from its Pallas
    kernels in interpret mode, all as torch tensors, and the bias."""
    bh, tq, tk, d, causal, masked = PALLAS_CASES[case]
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(len(case))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d))]
    mask = None
    if masked:
        mask = np.random.default_rng(10).random((tq, tk)) > 0.25
        mask[7] = False  # a fully masked row
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv, jg = (jnp.asarray(a, dtype=jdtype) for a in arrays)
    o, lse = _flash_pallas(jq, jk, jv, causal, 0.125, 512, 512, interpret=True, bias=jbias)
    want = _flash_bwd_pallas(jq, jk, jv, o, jg, lse, causal, 0.125, 512, 512, interpret=True, bias=jbias)
    inputs = tuple(_t(a, dtype) for a in (jq, jk, jv, o, jg))
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    return inputs, torch.from_numpy(np.array(lse)), tuple(_t(w, dtype) for w in want), bias


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_16bit_backward_matches_heat_tpu_interpret_kernels(case, name):
    (q, k, v, o, g), lse, want, bias = heat_tpu_case(case, name)
    _, tq, tk, _, causal, masked = PALLAS_CASES[case]
    got = k2.flash_attention_bwd_reference(q, k, v, o, g, lse, causal, 0.125, bias)
    for grad, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, grad
        assert err_over_tol(a, w, name) <= 1.0, grad
    if causal and tk > tq:  # keys past the last query: exact zeros in both
        assert float(got[1][:, tq:].abs().max()) == 0.0 and float(got[2][:, tq:].abs().max()) == 0.0
    if masked:
        assert float(got[0][:, 7].abs().max()) == 0.0  # the dead row's dq


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_the_f32_p_and_ds_of_before_fail_the_bf16_rule(case):
    """The arithmetic the port's backward had before heat_tpu's roundings (P and dS kept f32,
    each gradient rounded once to bf16) is further from heat_tpu's kernels than the rule
    allows, and further than the plain backward that rounds them."""
    (q, k, v, o, g), lse, want, bias = heat_tpu_case(case, "bf16")
    causal = PALLAS_CASES[case][4]
    before = [t.to(torch.bfloat16) for t in
              k2.flash_attention_bwd_reference(*(t.float() for t in (q, k, v, o, g)), lse, causal, 0.125, bias)]
    now = k2.flash_attention_bwd_reference(q, k, v, o, g, lse, causal, 0.125, bias)
    worst_before = max(err_over_tol(a, w, "bf16") for a, w in zip(before, want))
    worst_now = max(err_over_tol(a, w, "bf16") for a, w in zip(now, want))
    assert worst_before > 1.0 >= worst_now


# ---------------------------------------------------------------- (b) the kernels' arithmetic


def fma(a, b, c):
    """f32 a·b + c rounded once (CUDA's fmaf), by way of float64, which holds the product
    of two f32 values exactly."""
    return (a.double() * b.double() + c.double()).float()


def products(c, a, b):
    """c + a·b with f32 sums, K walked 16 at a time (one wgmma k16 step each); a and b hold
    16-bit values, whose products are exact in f32."""
    for k0 in range(0, a.shape[-1], 16):
        c = c + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return c


def probabilities(s, lse, rows, cols, causal, scale, bias, tq, tk):
    """P of a tile of raw products s (rows x cols of the score matrix), as the kernels form
    it: x = s·scale·log2 e, the bias added by an fma, P = 2^(x − LSE·log2 e) with the second
    step an fma too; causal entries (key > query) and keys or queries past the ends 0."""
    x = s * torch.tensor(scale * LOG2E, dtype=torch.float32)
    rr, cc = rows[:, None], cols[None, :]
    inside = (rr < tq) & (cc < tk)
    if bias is not None:
        b = torch.zeros(x.shape[-2:])
        b[: min(tq - int(rows[0]), len(rows)), : min(tk - int(cols[0]), len(cols))] = \
            bias[int(rows[0]):int(rows[0]) + len(rows), int(cols[0]):int(cols[0]) + len(cols)]
        x = torch.where(inside, fma(b, torch.tensor(LOG2E, dtype=torch.float32), x), x)
    p = torch.exp2(fma(lse, torch.tensor(-LOG2E, dtype=torch.float32), x))
    masked = ~inside | ((cc > rr) if causal else torch.zeros_like(inside))
    return torch.where(masked, torch.zeros(()), p)


def emulated_backward(q, k, v, do, lse, dd, causal, scale, bias):
    """dQ (K4) and dK, dV (K5) of the 2-byte kernels in their arithmetic and tile order, in
    f32, rounded once to the type at the end."""
    t = q.dtype
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf, gf = (x.float() for x in (q, k, v, do))
    rows_q, rows_k = torch.arange(tq), torch.arange(tk)
    dq = torch.zeros(bh, tq, d)
    for j0 in range(0, tk, TILE):  # K4: key tiles
        keys = torch.arange(j0, j0 + TILE)
        kt = torch.nn.functional.pad(kf[:, j0:j0 + TILE], (0, 0, 0, j0 + TILE - min(tk, j0 + TILE)))
        vt = torch.nn.functional.pad(vf[:, j0:j0 + TILE], (0, 0, 0, j0 + TILE - min(tk, j0 + TILE)))
        s = products(torch.zeros(bh, tq, TILE), qf, kt.transpose(1, 2))
        p = probabilities(s, lse[..., None], rows_q, keys, causal, scale, bias, tq, tk)
        dp = products(torch.zeros_like(p), gf, vt.transpose(1, 2))
        ds = (p * (dp - dd[..., None])).to(t).float()
        dq = products(dq, ds, kt)
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    for i0 in range(0, tq, TILE):  # K5: query tiles, Sᵀ and dPᵀ with keys as rows
        queries = torch.arange(i0, i0 + TILE)
        pad = i0 + TILE - min(tq, i0 + TILE)
        qt = torch.nn.functional.pad(qf[:, i0:i0 + TILE], (0, 0, 0, pad))
        gt = torch.nn.functional.pad(gf[:, i0:i0 + TILE], (0, 0, 0, pad))
        lt = torch.nn.functional.pad(lse[:, i0:i0 + TILE], (0, pad))
        dt = torch.nn.functional.pad(dd[:, i0:i0 + TILE], (0, pad))
        st = products(torch.zeros(bh, tk, TILE), kf, qt.transpose(1, 2))
        pt = probabilities(st.transpose(1, 2), lt[..., None], queries, rows_k, causal, scale, bias, tq, tk).transpose(1, 2)
        dpt = products(torch.zeros_like(pt), vf, gt.transpose(1, 2))
        dst = (pt * (dpt - dt[:, None, :])).to(t).float()
        dv = products(dv, pt.to(t).float(), gt)
        dk = products(dk, dst, qt)
    return (dq * scale).to(t), (dk * scale).to(t), dv.to(t)


# (bh, tq, tk, d, causal, masked, dtype): around the kernels' tiles (64-row ring tiles, 128
# own rows a block), causal both ways, a fully masked row, d of 8, 64, 100 and 128 (the
# kernels pad 100 to 104 with zeros, which add nothing), both types; heat_tpu's kernels run
# with blocks that tile the lengths
EMULATION_CASES = {
    "ragged_d8_bf16": (2, 37, 53, 8, False, False, "bf16"),
    "causal_tk_gt_tq_d64_bf16": (2, 63, 130, 64, True, False, "bf16"),
    "causal_tq_gt_tk_d100_f16": (2, 130, 61, 100, True, False, "f16"),
    "bool_mask_dead_row_d128_bf16": (1, 96, 80, 128, False, True, "bf16"),
    "tiled_causal_d64_f16": (2, 256, 256, 64, True, False, "f16"),
    "tiled_d128_bf16": (1, 128, 256, 128, False, False, "bf16"),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_emulated_16bit_kernels_match_heat_tpu_and_the_plain_backward(case):
    bh, tq, tk, d, causal, masked, name = EMULATION_CASES[case]
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(tq * tk + d)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d))]
    mask = None
    if masked:
        mask = rng.random((tq, tk)) > 0.3
        mask[3] = False  # a fully masked row
    scale = 1.0 / math.sqrt(d)
    bq, bk = (128, 128) if tq % 128 == 0 and tk % 128 == 0 else (tq, tk)
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv, jg = (jnp.asarray(a, dtype=jdtype) for a in arrays)
    o, lse = _flash_pallas(jq, jk, jv, causal, scale, bq, bk, interpret=True, bias=jbias)
    want = _flash_bwd_pallas(jq, jk, jv, o, jg, lse, causal, scale, bq, bk, interpret=True, bias=jbias)

    q, k, v, to, g = (_t(a, dtype) for a in (jq, jk, jv, o, jg))
    tlse = torch.from_numpy(np.array(lse))
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    dd = (g.float() * to.float()).sum(-1)  # the D pass: f32 products and sums of the 16-bit O and dO
    got = emulated_backward(q, k, v, g, tlse, dd, causal, scale, bias)
    plain = k2.flash_attention_bwd_reference(q, k, v, to, g, tlse, causal, scale, bias)
    for grad, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        assert err_over_tol(a, _t(w, dtype), name) <= 1.0, f"{grad} vs heat_tpu"
        assert err_over_tol(a, p, name) <= 1.0, f"{grad} vs plain"
    if causal and tk > tq:  # keys that no query attends
        assert float(got[1][:, tq:].abs().max()) == 0.0 and float(got[2][:, tq:].abs().max()) == 0.0
    if masked:
        assert float(got[0][:, 3].abs().max()) == 0.0


def test_f32_p_and_ds_stay_f32():
    """The plain backward rounds P and dS only for 16-bit inputs: in f32 nothing changes."""
    x = torch.randn(4, 5)
    assert k2._rounded(x, torch.float32) is x
    assert torch.equal(k2._rounded(x, torch.bfloat16), x.to(torch.bfloat16).float())


@pytest.mark.parametrize("d", [33, 64, 100])
def test_tma_ready_pads_the_head_dim_and_copies_what_is_not_aligned(d):
    """What the 2-byte K4 and K5 take through TMA: head dims of 8·n values, 16-byte aligned
    tensors; others are padded with zero columns or copied, and counted."""
    base = torch.randn(2, 7, d + 1).to(torch.bfloat16)
    views = [base[..., :d].contiguous() for _ in range(3)] + [base.reshape(-1)[1:1 + 2 * 7 * d].view(2, 7, d)]
    before = k2.tma_copies
    out = k2._tma_ready(*views)
    pad = -d % 8
    for t, o in zip(views, out):
        assert o.shape == (2, 7, d + pad) and o.data_ptr() % 16 == 0 and o.is_contiguous()
        assert torch.equal(o[..., :d], t) and (pad == 0 or float(o[..., d:].abs().max()) == 0.0)
    aligned = [t.data_ptr() % 16 == 0 for t in views]
    assert k2.tma_copies - before == (4 if pad else aligned.count(False))
    f32 = [torch.randn(2, 7, d) for _ in range(4)]
    assert all(a is b for a, b in zip(k2._tma_ready(*f32), f32))


def test_the_card_holds_the_kernels_to_this_rule():
    """chip_smoke.py's 16-bit rule is this file's: no looser than heat_tpu's own distance."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.BWD_SHARE_16 == {"bfloat16": SHARE["bf16"], "float16": SHARE["f16"]}
