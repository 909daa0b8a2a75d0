"""The 16-bit flash forward (the bf16 and f16 K2 and K3 of ``csrc/flash_attention_fwd.cu`` and
``csrc/flash_attention_fwd_pipelined.cu`` on wgmma, ``csrc/flash_fwd_16bit.cuh``) of the PyTorch
port against heat_tpu's, on the CPU.

heat_tpu's Pallas forwards round each key tile's probabilities to v's type before P·V and sum
l over the unrounded f32 P (``_online_softmax_update``, flash_attention.py:135-152); the
port's plain versions and its 16-bit kernels do the same. Two parts:

(a) the plain K2 (P relative to the whole row's maximum) and the plain K3 (tile by tile, P
    relative to the running maximum, as heat_tpu's kernels) against heat_tpu's
    ``_flash_pallas(..., interpret=True)`` with ``pipelined`` False and True, in bf16 and
    f16, causal and not, with a bool mask with a dead row, and with Tq ≠ Tk both ways. With
    one key tile the plain K2 is heat_tpu's arithmetic and most elements are bit-equal; and
    the arithmetic the port had before (P kept f32, O rounded once) is further from
    heat_tpu's kernel than the rule allows where values of v cancel;
(b) the wgmma kernels' arithmetic emulated tile by tile: tiles of 64 keys, the softmax in
    log2 units (x = S·scale·log2 e, the bias added by an fma, P = 2^(x − m_safe)), l summed
    over the f32 P, P rounded to the type as the A operand of P·V, both products summed in
    f32 16 values of K at a time. K3 walks the same tiles in the same order as K2 (its skew
    moves when a product is issued, not what it sums), so one emulation serves both; it is
    held against the interpret-mode kernels and the plain versions.

The rule, for every element of O: |got − ref| ≤ u·|ref| + s·max|ref|, with u one unit in the
last place of the type (2⁻⁷ relative for bf16, 2⁻¹⁰ for f16: O's own rounding may go the
other way) and s a share of the largest |O| (``SHARE``) for the terms whose P rounded the
other way, no larger than heat_tpu's own kernel needs against the plain K2 (1.449e-3 in bf16,
2.187e-4 in f16: ``test_the_share_is_heat_tpus_own_largest_distance``). LSE is f32 on both
sides and agrees within 2e-4 (absolute and relative).
chip_smoke.py's ``check_k2`` and ``check_k3`` hold the kernels on the card to the same rule
(``FWD_SHARE_16``, asserted equal below). Inputs come from a seeded numpy generator, at most
2 × 512 rows a case since interpret mode is slow.
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
from heat_tpu.core.kernels.flash_attention import _flash_pallas

import heat_tpu_torch
from heat_tpu_torch.core.kernels import flash_attention as k2

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
ULP = {"bf16": 2.0**-7, "f16": 2.0**-10}
SHARE = {"bf16": 1.449e-3, "f16": 2.187e-4}
LSE_TOL = 2e-4
TILE = 64  # keys a tile of the wgmma K2 and K3
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)
LN2 = torch.tensor(math.log(2.0), dtype=torch.float32)
NEG_INF = float(k2._NEG_INF)

# (bh, tq, tk, d, causal, masked, bq, bk): heat_tpu's blocks tile the lengths; several key
# tiles a row (heat_tpu's P relative to a running maximum), one ("one_key_tile": the plain
# K2's arithmetic), causal both ways, a fully masked row
CASES = {
    "non_causal": (2, 256, 256, 32, False, False, 128, 128),
    "causal": (2, 512, 512, 32, True, False, 128, 128),
    "keys_longer": (1, 256, 512, 16, False, False, 128, 128),
    "causal_queries_longer": (1, 512, 256, 16, True, False, 128, 128),
    "bool_mask_dead_row": (1, 256, 256, 16, False, True, 128, 128),
    "one_key_tile": (2, 256, 128, 32, False, False, 128, 128),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def err_over_tol(got, ref, name: str) -> float:
    """The worst |got − ref| / (u·|ref| + s·max|ref|) over the elements."""
    got, ref = got.float(), ref.float()
    tol = ULP[name] * ref.abs() + SHARE[name] * float(ref.abs().max()) + 1e-30
    return float(((got - ref).abs() / tol).max())


def lse_err(got, ref) -> float:
    return float(((got - ref).abs() / (LSE_TOL + LSE_TOL * ref.abs())).max())


def _t(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _inputs(case: str, seed: int):
    bh, tq, tk, d, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d))]


@functools.lru_cache(maxsize=None)
def heat_tpu_case(case: str, name: str, pipelined: bool):
    """The case's inputs in the type, heat_tpu's O and LSE from its Pallas forward in
    interpret mode (``_kernel`` or ``_kernel_pipelined``) as torch tensors, and the bias."""
    bh, tq, tk, d, causal, masked, bq, bk = CASES[case]
    dtype, jdtype = DTYPES[name]
    mask = None
    if masked:
        mask = np.random.default_rng(10).random((tq, tk)) > 0.25
        mask[7] = False  # a fully masked row
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(a, dtype=jdtype) for a in _inputs(case, len(case)))
    o, lse = _flash_pallas(jq, jk, jv, causal, 0.125, bq, bk, interpret=True, bias=jbias, pipelined=pipelined)
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    return tuple(_t(a, dtype) for a in (jq, jk, jv)), _t(o, dtype), torch.from_numpy(np.array(lse)), bias


@pytest.mark.parametrize("pipelined", [False, True], ids=["k2", "k3"])
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_16bit_forward_matches_heat_tpu_interpret_kernels(case, name, pipelined):
    (q, k, v), want, want_lse, bias = heat_tpu_case(case, name, pipelined)
    _, tq, tk, _, causal, masked, bq, bk = CASES[case]
    if pipelined:
        got, lse = k2.flash_attention_pipelined_reference(q, k, v, causal, 0.125, bias, bq=bq, bk=bk)
    else:
        got, lse = k2.flash_attention_reference(q, k, v, causal, 0.125, bias)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert err_over_tol(got, want, name) <= 1.0
    assert lse_err(lse, want_lse) <= 1.0
    if masked:
        assert float(got[:, 7].abs().max()) == 0.0
        assert bool((lse[:, 7] == torch.tensor(NEG_INF / 2) + torch.log(torch.tensor(1e-30))).all())


# chip_smoke.py's 2-byte case with the largest need on the card (edge16_d128_dead_row_bf16:
# 70 queries, 300 keys, d = 128, a bool mask of density 0.7 with a dead row), over six seeds:
# heat_tpu's kernel walks keys in three tiles of 100
SWEEP = (2, 70, 300, 128, 70, 100)
SWEEP_SEEDS = range(6)


@functools.lru_cache(maxsize=None)
def heat_tpu_sweep(seed: int, name: str):
    """SWEEP's inputs from ``seed`` in the type, heat_tpu's O from its interpret-mode kernel
    and the plain K2's O."""
    bh, tq, tk, d, bq, bk = SWEEP
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d))]
    mask = rng.random((tq, tk)) < 0.7
    mask[3] = False
    jq, jk, jv = (jnp.asarray(a, dtype=jdtype) for a in arrays)
    scale = 1.0 / math.sqrt(d)
    o, _ = _flash_pallas(jq, jk, jv, False, scale, bq, bk, interpret=True, bias=jax_as_bias(jnp.asarray(mask)))
    q, k, v = (_t(a, dtype) for a in (jq, jk, jv))
    plain, _ = k2.flash_attention_reference(q, k, v, False, scale, k2._as_bias(torch.from_numpy(mask)))
    return _t(o, dtype), plain


def share_needed(got, ref, name: str) -> float:
    """The share of max|ref| that |got − ref| needs beyond each element's own ulp."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - ULP[name] * ref.abs()).max()) / float(ref.abs().max())


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("seed", list(SWEEP_SEEDS))
def test_plain_k2_holds_heat_tpu_over_seeds(seed, name):
    want, plain = heat_tpu_sweep(seed, name)
    assert err_over_tol(plain, want, name) <= 1.0


@pytest.mark.parametrize("name", list(DTYPES))
def test_the_share_is_heat_tpus_own_largest_distance(name):
    """The share s is no larger than heat_tpu's own interpret-mode kernel needs against the
    plain K2: its largest need over this file's multi-tile cases and SWEEP's seeds (heat_tpu
    rounds P against a running maximum, the plain K2 against the row's, so the two differ by
    roundings of P that a random walk over the tiles decides; measured 1.4488e-3 in bf16 at
    SWEEP's seed 4 and 2.187e-4 in f16 at ``keys_longer``). The card's K2 needed at most
    1.374e-3 and 1.67e-4 (chip_smoke.py's ``[k2_vs_plain]``)."""
    needs = []
    for case in CASES:
        (q, k, v), want, _, bias = heat_tpu_case(case, name, False)
        needs.append(share_needed(k2.flash_attention_reference(q, k, v, CASES[case][4], 0.125, bias)[0], want, name))
    needs += [share_needed(plain, want, name) for want, plain in (heat_tpu_sweep(s, name) for s in SWEEP_SEEDS)]
    assert max(needs) <= SHARE[name] <= 1.001 * max(needs)


@pytest.mark.parametrize("name", list(DTYPES))
def test_one_key_tile_is_heat_tpus_arithmetic(name):
    """With one key tile a row, heat_tpu's kernel rounds P relative to the whole row's maximum,
    as the plain K2 does: the two differ only where exp or a sum of another order moves a P
    or an O across a rounding boundary. The share of bit-equal elements of O (measured 0.9997
    in bf16 and 0.999 in f16 at this seed) must stay above 0.99."""
    (q, k, v), want, _, _ = heat_tpu_case("one_key_tile", name, False)
    got, _ = k2.flash_attention_reference(q, k, v, False, 0.125)
    equal = float((got == want).float().mean())
    assert equal >= 0.99, equal


@pytest.mark.parametrize("name", list(DTYPES))
def test_the_f32_p_of_before_differs_from_heat_tpu_where_v_cancels(name):
    """Values of v of alternating sign over near-uniform weights: O is a small difference of
    large sums, so each rounding of P shows. heat_tpu's kernel and the plain K2 round P alike
    (one key tile: bit-equal but for boundary cases); the arithmetic the port had before (P
    kept f32, O rounded once) is further from heat_tpu's kernel than the rule allows."""
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(3)
    bh, tq, tk, d = 2, 256, 128, 32
    q = 0.1 * rng.standard_normal((bh, tq, d))
    k = rng.standard_normal((bh, tk, d))
    v = np.where(np.arange(tk)[None, :, None] % 2 == 0, 1.0, -1.0) * (1 + 0.1 * np.abs(rng.standard_normal((bh, tk, d))))
    jq, jk, jv = (jnp.asarray(a.astype(np.float32), dtype=jdtype) for a in (q, k, v))
    want = _t(_flash_pallas(jq, jk, jv, False, 0.125, 128, 128, interpret=True)[0], dtype)
    tq_, tk_, tv_ = (_t(a, dtype) for a in (jq, jk, jv))
    now = k2.flash_attention_reference(tq_, tk_, tv_, False, 0.125)[0]
    before = k2.flash_attention_reference(tq_.float(), tk_.float(), tv_.float(), False, 0.125)[0].to(dtype)
    assert err_over_tol(before, want, name) > 1.0 >= err_over_tol(now, want, name)


# ---------------------------------------------------------------- (b) the kernels' arithmetic


def fma(a, b, c):
    """f32 a·b + c rounded once (CUDA's fmaf), by way of float64, which holds the product of
    two f32 values exactly."""
    return (a.double() * b.double() + c.double()).float()


def products(c, a, b):
    """c + a·b with f32 sums, K walked 16 at a time (one wgmma k16 step each); a and b hold
    16-bit values, whose products are exact in f32."""
    for k0 in range(0, a.shape[-1], 16):
        c = c + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return c


def emulated_forward(q, k, v, causal, scale, bias):
    """(O, LSE) of the 16-bit K2 and K3 in their arithmetic and tile order: S = q·kᵀ of a
    tile of 64 keys (zeros past Tk, as TMA brings them), x = S·scale·log2 e (+ the bias by an
    fma), the causal mask at the finite NEG_INF, keys past Tk at −inf, m_safe = max(m_new,
    NEG_INF/2), P = 2^(x − m_safe), l = l·corr + Σ P over the f32 P, acc = acc·corr + P·V with
    P rounded to the type; O = acc / max(l, 1e-30) rounded once, LSE in natural units."""
    t = q.dtype
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    c2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    rows = torch.arange(tq)[:, None]
    acc = torch.zeros(bh, tq, d)
    m = torch.full((bh, tq, 1), NEG_INF)
    l = torch.zeros(bh, tq, 1)
    for j0 in range(0, tk, TILE):
        pad = j0 + TILE - min(tk, j0 + TILE)
        kt = torch.nn.functional.pad(kf[:, j0:j0 + TILE], (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vf[:, j0:j0 + TILE], (0, 0, 0, pad))
        x = products(torch.zeros(bh, tq, TILE), qf, kt.transpose(1, 2)) * c2
        cols = torch.arange(j0, j0 + TILE)[None, :]
        if bias is not None:
            b = torch.zeros(tq, TILE)
            b[:, : TILE - pad] = bias[:, j0:j0 + TILE - pad]
            x = torch.where(cols < tk, fma(b, LOG2E, x), x)
        if causal:
            x = torch.where(cols > rows, torch.tensor(NEG_INF), x)
        x = torch.where(cols >= tk, torch.tensor(-math.inf), x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_safe = torch.clamp_min(m_new, NEG_INF / 2)
        corr = torch.exp2(m - m_safe)
        p = torch.exp2(x - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = products(acc * corr, p.to(t).float(), vt)
        m = m_new
    lc = torch.clamp_min(l, 1e-30)
    lse = torch.clamp_min(m * LN2, NEG_INF / 2) + torch.log(lc)
    return (acc / lc).to(t), lse.squeeze(-1)


# (bh, tq, tk, d, causal, masked, dtype): around the kernels' tiles (64 keys, 128 query rows a
# block, 64 a warpgroup), causal both ways, a fully masked row, d of 8, 64, 72 and 128 (the
# kernels pad 72 to 128 and 8 to 64 with TMA's zeros, which add nothing); heat_tpu's kernels
# run with blocks that tile the lengths
EMULATION_CASES = {
    "ragged_d8_bf16": (2, 37, 53, 8, False, False, "bf16"),
    "causal_tk_gt_tq_d64_bf16": (2, 63, 130, 64, True, False, "bf16"),
    "causal_tq_gt_tk_d72_f16": (2, 130, 61, 72, True, False, "f16"),
    "bool_mask_dead_row_d128_bf16": (1, 96, 80, 128, False, True, "bf16"),
    "tiled_causal_d64_f16": (2, 256, 256, 64, True, False, "f16"),
    "tiled_d128_bf16": (1, 128, 256, 128, False, False, "bf16"),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_emulated_16bit_kernels_match_heat_tpu_and_the_plain_versions(case):
    bh, tq, tk, d, causal, masked, name = EMULATION_CASES[case]
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(tq * tk + d)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((bh, tq, d), (bh, tk, d), (bh, tk, d))]
    mask = None
    if masked:
        mask = rng.random((tq, tk)) > 0.3
        mask[3] = False  # a fully masked row
    scale = 1.0 / math.sqrt(d)
    bq, bk = (128, 128) if tq % 128 == 0 and tk % 128 == 0 else (tq, tk)
    jbias = None if mask is None else jax_as_bias(jnp.asarray(mask))
    jq, jk, jv = (jnp.asarray(a, dtype=jdtype) for a in arrays)
    q, k, v = (_t(a, dtype) for a in (jq, jk, jv))
    bias = None if mask is None else k2._as_bias(torch.from_numpy(mask))
    got, lse = emulated_forward(q, k, v, causal, scale, bias)
    for pipelined in (False, True):
        o, jlse = _flash_pallas(jq, jk, jv, causal, scale, bq, bk, interpret=True, bias=jbias, pipelined=pipelined)
        assert err_over_tol(got, _t(o, dtype), name) <= 1.0, f"O vs heat_tpu, pipelined={pipelined}"
        assert lse_err(lse, torch.from_numpy(np.array(jlse))) <= 1.0
    plain = (k2.flash_attention_reference(q, k, v, causal, scale, bias),
             k2.flash_attention_pipelined_reference(q, k, v, causal, scale, bias, bq=128, bk=TILE))
    for po, pl in plain:
        assert err_over_tol(got, po, name) <= 1.0 and lse_err(lse, pl) <= 1.0
    # the plain K3 walking the kernels' 64-key tiles is their arithmetic but for exp's and the
    # sums' rounding: bit-equal in most elements
    assert float((got == plain[1][0]).float().mean()) >= 0.99
    if masked:
        assert float(got[:, 3].abs().max()) == 0.0
        assert bool((lse[:, 3] == torch.tensor(NEG_INF / 2) + torch.log(torch.tensor(1e-30))).all())


def test_f32_p_stays_f32_in_the_plain_versions():
    """The plain forwards round P only for 16-bit inputs: f32 gives the bits it gave before,
    the unrounded P·V (one key tile for K3 too, so the two agree)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 16)).astype(np.float32)) for _ in range(3))
    scores = k2._scores(q, k, 0.25, True, None)
    m = torch.clamp_min(scores.amax(-1, keepdim=True), NEG_INF / 2)
    p = torch.exp(scores - m)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    with k2.full_fp32_matmul():
        want = torch.matmul(p, v) / l
    assert torch.equal(k2.flash_attention_reference(q, k, v, True, 0.25)[0], want)


@pytest.mark.parametrize("d", [33, 64, 100])
def test_tma_ready_takes_the_forwards_inputs(d):
    """What the 2-byte K2 and K3 take through TMA: q, k and v with head dims of 8·n values,
    16-byte aligned; others are padded with zero columns or copied, and counted."""
    base = torch.randn(2, 7, d + 1).to(torch.float16)
    views = [base[..., :d].contiguous() for _ in range(2)] + [base.reshape(-1)[1:1 + 2 * 7 * d].view(2, 7, d)]
    before = k2.tma_copies
    out = k2._tma_ready(*views)
    pad = -d % 8
    assert len(out) == 3
    for t, o in zip(views, out):
        assert o.shape == (2, 7, d + pad) and o.data_ptr() % 16 == 0 and o.is_contiguous()
        assert torch.equal(o[..., :d], t) and (pad == 0 or float(o[..., d:].abs().max()) == 0.0)
    aligned = [t.data_ptr() % 16 == 0 for t in views]
    assert k2.tma_copies - before == (3 if pad else aligned.count(False))


def test_the_card_holds_the_kernels_to_this_rule():
    """chip_smoke.py's 16-bit forward rule is this file's: no looser than heat_tpu's own distance."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.FWD_SHARE_16 == {"bfloat16": SHARE["bf16"], "float16": SHARE["f16"]}
