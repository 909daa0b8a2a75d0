"""The arithmetic of the tensor-core K4 and K5 (``csrc/flash_attention_bwd.cu``), emulated on
the CPU, against heat_tpu's Pallas backward in interpret mode and the port's plain backward.

The kernels take every product in 3xTF32 (``csrc/mma_tf32x3.cuh``): an f32 operand splits
into a TF32 big part (rounded to nearest, ties away from zero, as ``cvt.rna.tf32.f32``)
and a TF32 small part (the residual, rounded the same way), and a·b is accumulated in f32
as small·big, then big·small, then big·big, one m16n8k8 product (k = 8) at a time. Here
that is done with the same split, by bit arithmetic on the f32 pattern (tests/_tf32x3.py,
shared with the forwards' test), and the same order
of partial products, tile by tile in the kernels' order: K4 walks tiles of 32 keys and K5
tiles of 32 queries, each forming S and dP over the head dim 8 columns at a time, then P
and dS in f32, then accumulating dS·K (K4) or Pᵀ·dO and dSᵀ·Q (K5) 8 keys or queries at a
time. The result must lie within chip_smoke.py's f32
tolerance, 2e-4 of each gradient's largest magnitude, of both references: the dropped
small·small terms cost fp32-level accuracy and no more. The kernels themselves are held
against the plain backward on the card by chip_smoke.py. Inputs come from a seeded numpy
generator, at most 2 x 512 rows since interpret mode is slow.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.flash_attention import _as_bias as jax_as_bias
from heat_tpu.core.kernels.flash_attention import _flash_bwd_pallas, _flash_pallas

import heat_tpu_torch
from heat_tpu_torch.core.kernels import flash_attention as k2

from _tf32x3 import chunked, round_tf32, split

REL_TOL = 2e-4  # of each gradient's largest magnitude, as chip_smoke.py's check_bwd (f32)


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


TILE = 32  # keys per tile in K4, queries per tile in K5


def scores(q, k, i0, j0, causal, scale, bias):
    """P's argument exactly as the kernels form it: the 3xTF32 product times scale, then
    the bias, then the causal mask at the finite NEG_INF."""
    s = chunked(torch.zeros(q.shape[0], q.shape[1], k.shape[1]), q, k.transpose(1, 2)) * scale
    rows = torch.arange(i0, i0 + q.shape[1])[:, None]
    cols = torch.arange(j0, j0 + k.shape[1])[None, :]
    if bias is not None:
        s = s + bias[i0:i0 + q.shape[1], j0:j0 + k.shape[1]]
    if causal:
        s = torch.where(cols > rows, torch.tensor(k2._NEG_INF), s)
    return s


def emulated_backward(q, k, v, do, lse, dd, causal, scale, bias):
    """dQ (K4) and dK, dV (K5) in the kernels' arithmetic and tile order."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    dq = torch.zeros(bh, tq, d)
    for j0 in range(0, tk, TILE):  # K4: key tiles
        kt, vt = k[:, j0:j0 + TILE], v[:, j0:j0 + TILE]
        p = torch.exp(scores(q, kt, 0, j0, causal, scale, bias) - lse[..., None])
        dp = chunked(torch.zeros_like(p), do, vt.transpose(1, 2))
        dq = chunked(dq, p * (dp - dd[..., None]), kt)
    dk, dv = torch.zeros(bh, tk, d), torch.zeros(bh, tk, d)
    for i0 in range(0, tq, TILE):  # K5: query tiles, Sᵀ and dPᵀ with keys as rows
        qt, gt = q[:, i0:i0 + TILE], do[:, i0:i0 + TILE]
        st = scores(qt, k, i0, 0, causal, scale, bias).transpose(1, 2)
        pt = torch.exp(st - lse[:, None, i0:i0 + TILE])
        dpt = chunked(torch.zeros_like(pt), v, gt.transpose(1, 2))
        dv = chunked(dv, pt, gt)
        dk = chunked(dk, pt * (dpt - dd[:, None, i0:i0 + TILE]), qt)
    return dq * scale, dk * scale, dv


# (bh, tq, tk, d, causal, masked): ragged lengths, causal both ways, a fully masked row,
# and d of 8, 64, 100 and 128; heat_tpu's kernels run with blocks that tile the lengths
CASES = {
    "ragged_d8": (2, 37, 53, 8, False, False),
    "causal_tk_gt_tq_d64": (2, 37, 90, 64, True, False),
    "causal_tq_gt_tk_d100": (2, 130, 61, 100, True, False),
    "bool_mask_dead_row_d128": (1, 96, 80, 128, False, True),
    "ragged_d100": (1, 150, 200, 100, False, False),
    "tiled_causal_d64": (2, 512, 512, 64, True, False),
    "tiled_d128": (1, 256, 512, 128, False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emulated_3xtf32_backward_matches_heat_tpu_and_the_plain_backward(case):
    bh, tq, tk, d, causal, masked = CASES[case]
    rng = np.random.default_rng(tq * tk + d)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d)))
    mask = None
    if masked:
        mask = rng.random((tq, tk)) > 0.3
        mask[3] = False  # a fully masked row
    scale = float(d) ** -0.5
    bq, bk = (128, 128) if tq % 128 == 0 and tk % 128 == 0 else (tq, tk)
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = _flash_pallas(jq, jk, jv, causal, scale, bq, bk, interpret=True, bias=jbias)
    want = _flash_bwd_pallas(jq, jk, jv, o, jg, lse, causal, scale, bq, bk, interpret=True, bias=jbias)

    tq_, tk_, tv_, tg_ = (torch.from_numpy(a) for a in (q, k, v, g))
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    dd = (tg_ * to).sum(-1)
    got = emulated_backward(tq_, tk_, tv_, tg_, tlse, dd, causal, scale, bias)
    plain = k2.flash_attention_bwd_reference(tq_, tk_, tv_, to, tg_, tlse, causal, scale, bias)
    for name, a, w, p in zip(("dq", "dk", "dv"), got, want, plain):
        w = torch.from_numpy(np.array(w))
        for ref_name, ref in (("heat_tpu", w), ("plain", p)):
            err = float((a - ref).abs().max())
            assert err <= REL_TOL * float(ref.abs().max()), f"{name} vs {ref_name}: {err}"
    if causal and tk > tq:  # keys that no query attends
        assert float(got[1][:, tq:].abs().max()) == 0.0 and float(got[2][:, tq:].abs().max()) == 0.0
    if masked:
        assert float(got[0][:, 3].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_split_is_exact_on_two_byte_values(dtype):
    """bf16 and f16 values are exact in TF32: big is the value, small is 0 (the kernels'
    2-byte instances skip the products with it)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-6, 5, 4096))
    x = x.to(dtype).float()
    tiny = torch.tensor([torch.finfo(dtype).tiny, torch.finfo(dtype).max, -torch.finfo(dtype).eps, 0.0]).to(dtype).float()
    for values in (x, tiny):
        big, small = split(values)
        assert torch.equal(big, values)
        assert torch.equal(small, torch.zeros_like(values))


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0
    half_ulp = 2.0**-11  # TF32's ulp at 1 is 2⁻¹⁰
    x = torch.tensor([one + half_ulp, -(one + half_ulp), one + half_ulp - 2.0**-23, one + 3 * half_ulp, 2.0**-130],
                     dtype=torch.float32)
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one, one + 4 * half_ulp, 2.0**-130],
                        dtype=torch.float32)
    assert torch.equal(round_tf32(x), want)


def test_split_keeps_fp32_accuracy():
    """big + small is x within 2⁻²¹ of |x|, and a 3xTF32 product within fp32's level of the
    exact one, where a single TF32 product is about 2⁻¹¹ off."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(100_000).astype(np.float32))
    big, small = split(x)
    assert float(((big.double() + small.double()) - x.double()).abs().max() / x.double().abs().max()) <= 2.0**-21
    a = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    err3 = float((chunked(torch.zeros(64, 64), a, b).double() - exact).abs().max()) / scale
    err1 = float((round_tf32(a) @ round_tf32(b)).double().sub(exact).abs().max()) / scale
    assert err3 <= 2e-6 < err1
