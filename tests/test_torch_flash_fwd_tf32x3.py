"""The arithmetic of the tensor-core K2 and K3 (``csrc/flash_attention_fwd.cu``,
``csrc/flash_attention_fwd_pipelined.cu``), emulated on the CPU, against heat_tpu's Pallas
forwards in interpret mode (``_kernel`` and ``_kernel_pipelined``) and the port's plain
versions.

The kernels take both products of a key tile in 3xTF32 (``csrc/mma_tf32x3.cuh``; the split
by bit arithmetic in tests/_tf32x3.py): S = q·kᵀ over the head dim 8 columns at a time, then
the online softmax in log2 units (x = S·scale·log2(e) + bias·log2(e), P = 2^(x − m), the
causal mask at the finite NEG_INF, keys past Tk at −inf, the maximum clamped at NEG_INF/2),
then acc·corr + P·V with P kept f32 and split into its TF32 parts like any operand, 8 keys
at a time. K2 and K3 walk tiles of 32 keys (d <= 64) or 16 (d <= 128); K3's one-step
skew reorders the work of a step but not its arithmetic. O and LSE must lie within
chip_smoke.py's f32 tolerance of both references: O within 2e-4 of its largest magnitude,
LSE within 2e-4 (absolute and relative). The same walk with single TF32 products fails
that rule. The kernels themselves are held against the plain versions on the card by
chip_smoke.py. Inputs come from a seeded numpy generator, at most 256 rows since interpret
mode is slow.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.flash_attention import _as_bias as jax_as_bias
from heat_tpu.core.kernels.flash_attention import _flash_pallas

import heat_tpu_torch
from heat_tpu_torch.core.kernels import flash_attention as k2

from _tf32x3 import chunked, mma1, mma3

REL_TOL = 2e-4  # of O's largest magnitude, and of LSE, as chip_smoke.py's f32 checks
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
NEG_INF = torch.tensor(k2._NEG_INF, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def tile_keys(d: int) -> int:
    """Keys per tile of K2 and K3: 32 for d <= 64, 16 for d <= 128."""
    return 32 if d <= 64 else 16


def emulated_forward(q, k, v, causal, scale, bias, product=mma3):
    """(O, LSE) in the kernels' arithmetic, tile by tile in their order of keys."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    tile = tile_keys(d)
    c2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    rows = torch.arange(tq)[:, None]
    acc = torch.zeros(bh, tq, d)
    m = torch.full((bh, tq, 1), float(NEG_INF))
    l = torch.zeros(bh, tq, 1)
    for j0 in range(0, tk, tile):
        kt, vt = k[:, j0:j0 + tile], v[:, j0:j0 + tile]
        x = chunked(torch.zeros(bh, tq, kt.shape[1]), q, kt.transpose(1, 2), product) * c2
        if bias is not None:  # one fma: the product bias·log2(e) is exact in f64
            b = bias[:, j0:j0 + tile].double()
            x = (b * LOG2E.double() + x.double()).float()
        cols = torch.arange(j0, j0 + kt.shape[1])[None, :]
        if causal:
            x = torch.where(cols > rows, NEG_INF, x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_safe = torch.clamp_min(m_new, float(NEG_INF) / 2)
        corr = torch.exp2(m - m_safe)
        p = torch.exp2(x - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = chunked(acc * corr, p, vt, product)
        m = m_new
    lc = torch.clamp_min(l, 1e-30)
    lse = torch.clamp_min(m * LN2, float(NEG_INF) / 2) + torch.log(lc)
    return acc / lc, lse.squeeze(-1)


def assert_close(o, lse, ro, rl, what):
    err_o = float((o - ro).abs().max())
    assert err_o <= REL_TOL * float(ro.abs().max()), f"O vs {what}: {err_o}"
    worst_lse = float(((lse - rl).abs() / (REL_TOL + REL_TOL * rl.abs())).max())
    assert worst_lse <= 1.0, f"LSE vs {what}: err/tol {worst_lse}"


# (bh, tq, tk, d, causal, mask): causal both ways, d of 33 and 100, a fully masked row
# (bool mask), a float bias with a fully masked row, and several tiles of keys at d 64
CASES = {
    "causal_tk_gt_tq_d33": (2, 37, 90, 33, True, None),
    "causal_tq_gt_tk_d100": (2, 130, 61, 100, True, None),
    "bool_mask_dead_row_d64": (1, 96, 80, 64, False, "bool"),
    "float_bias_dead_row_d33": (2, 70, 45, 33, False, "float"),
    "tiled_causal_d64": (1, 256, 256, 64, True, None),
    "tiled_d8": (1, 128, 200, 8, False, None),
}


def _case(case):
    bh, tq, tk, d, causal, mkind = CASES[case]
    rng = np.random.default_rng(tq * tk + d)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d)))
    mask = dead = None
    if mkind == "bool":
        mask = rng.random((tq, tk)) > 0.3
        dead = 3
        mask[dead] = False
    elif mkind == "float":
        mask = rng.standard_normal((tq, tk)).astype(np.float32)
        dead = 5
        mask[dead] = k2._NEG_INF
    return q, k, v, causal, mask, dead


@pytest.mark.parametrize("pipelined", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_3xtf32_forward_matches_heat_tpu_and_the_plain_version(case, pipelined):
    q, k, v, causal, mask, dead = _case(case)
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = float(d) ** -0.5
    bq, bk = (128, 128) if tq % 128 == 0 and tk % 128 == 0 else (tq, tk)
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jo, jl = _flash_pallas(*(jnp.asarray(a) for a in (q, k, v)), causal, scale, bq, bk, interpret=True, bias=jbias,
                           pipelined=pipelined)

    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    o, lse = emulated_forward(tq_, tk_, tv_, causal, scale, bias)
    plain = (k2.flash_attention_pipelined_reference if pipelined else k2.flash_attention_reference)
    for what, (ro, rl) in (("heat_tpu", (torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl)))),
                           ("plain", plain(tq_, tk_, tv_, causal, scale, bias))):
        assert_close(o, lse, ro, rl, what)
    if dead is not None:  # a fully masked row: O exactly 0, LSE exactly NEG_INF/2 + log(1e-30)
        assert float(o[:, dead].abs().max()) == 0.0
        assert bool((lse[:, dead] == NEG_INF / 2 + torch.log(torch.tensor(1e-30))).all())
    assert bool(torch.isfinite(o).all() and torch.isfinite(lse).all())


@pytest.mark.parametrize("case", ["tiled_causal_d64", "causal_tq_gt_tk_d100"])
def test_single_tf32_products_fail_the_rule(case):
    """The same walk with one TF32 product per product misses 2e-4 of O's largest
    magnitude: three decimal digits are not fp32's accuracy."""
    q, k, v, causal, _, _ = _case(case)
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    scale = float(q.shape[-1]) ** -0.5
    ro, _ = k2.flash_attention_reference(tq_, tk_, tv_, causal, scale)
    o3, _ = emulated_forward(tq_, tk_, tv_, causal, scale, None)
    o1, _ = emulated_forward(tq_, tk_, tv_, causal, scale, None, product=mma1)
    bound = REL_TOL * float(ro.abs().max())
    assert float((o3 - ro).abs().max()) <= bound < float((o1 - ro).abs().max())
