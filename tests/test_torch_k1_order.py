"""K1's fp32 order, emulated on the CPU, against heat_tpu's K1 and float64.

The card's kernel (heat_tpu_torch/core/kernels/csrc/kmeans_assign.cu) cannot run here.
tests/_torch_k1_order.py replays its arithmetic in float32 on the launch the wrapper plans
and on a given grid of blocks; these tests hold that replay to what chip_smoke.py holds the
kernel to on the card: labels and counts equal to heat_tpu's Pallas kernel (interpret mode)
and to the plain version off near-ties, the sse within 1e-5 of theirs, the sums exact on
integer data and within ``kmeans.rounding_depths``'s bound of float64 on float data. They
also pin ``ordered_sums`` (the host replay chip_smoke.py compares the card's sums with, bit
for bit) to the emulation, and the kernel's gate to PR 1's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.kmeans import _fused_pallas

import heat_tpu_torch
from heat_tpu_torch.core.kernels import kmeans as k1

from _torch_k1_order import emulate

U32, U64 = 2.0**-24, 2.0**-53

# (n, d, k, blocks): the main path's d and k; n below one tile and one row past it; d = 7
# and 10 (rows that end inside a 16-byte chunk); d = 33 and 100 (the shared-memory path,
# one and two threads a row); d = 256 (four threads a row); k = 1; more clusters than the
# registers hold (k = 9); grids of one to five blocks, so that blocks take unequal tiles, and
# one of 20, whose records are folded in two groups
SHAPES = [
    (1024, 64, 8, 3),
    (200, 64, 8, 1),
    (257, 64, 8, 2),
    (1500, 7, 5, 4),
    (130, 10, 3, 1),
    (700, 33, 4, 2),
    (600, 100, 4, 3),
    (300, 256, 3, 5),
    (520, 64, 1, 2),
    (900, 48, 9, 3),
    (5200, 10, 3, 20),
]
IDS = ["x".join(map(str, s[:3])) + f"_g{s[3]}" for s in SHAPES]


def gamma(h, u=U32):
    return h * u / (1.0 - h * u)


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def _data(n, d, k, seed, integer=False):
    """Blobs around k centers (as KMeans sees them) and initial centers near them; small
    integers with ``integer``, where no product or partial sum of the kernel rounds."""
    rng = np.random.default_rng(seed)
    true = 2.0 * rng.standard_normal((k, d))
    x = true[rng.integers(0, k, n)] + rng.standard_normal((n, d))
    c = true + 0.5 * rng.standard_normal((k, d))
    if integer:
        x, c = np.round(4 * x), np.round(4 * c)
    return x.astype(np.float32), c.astype(np.float32)


def _near_ties(x, c, rel=1e-5):
    """Rows whose two smallest squared distances differ by at most rel·(|x|² + max|c|²)."""
    d2 = ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2] if c.shape[0] > 1 else np.concatenate([d2, d2 + 1e300], 1)
    scale = (x.astype(np.float64) ** 2).sum(1) + (c.astype(np.float64) ** 2).sum(1).max()
    return (two[:, 1] - two[:, 0]) <= rel * scale


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("against", ["pallas_interpret", "plain"])
def test_emulation_matches_heat_tpu(shape, against):
    n, d, k, blocks = shape
    x, c = _data(n, d, k, seed=n + d)
    got = emulate(x, c, blocks)
    if against == "plain":
        want = k1.fused_assign_update_reference(torch.from_numpy(x), torch.from_numpy(c))
    else:
        want = _fused_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True)
    labels, _, counts, sse = (np.asarray(v) for v in want)
    off = ~_near_ties(x, c)
    np.testing.assert_array_equal(got["labels"][off], labels[off])
    moved = np.bincount(got["labels"], minlength=k) - np.bincount(labels, minlength=k)
    np.testing.assert_array_equal(got["counts"] - moved, counts)
    assert abs(float(got["sse"]) - float(sse)) <= 1e-5 * abs(float(sse))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulation_exact_on_integer_data(shape):
    n, d, k, blocks = shape
    x, c = _data(n, d, k, seed=n + d + 1, integer=True)
    got = emulate(x, c, blocks)
    x64 = x.astype(np.float64)
    d2 = ((x64[:, None, :] - c[None].astype(np.float64)) ** 2).sum(-1)
    assert np.abs(x64).sum() < 2**24 and d2.max() < 2**24  # nothing can round
    np.testing.assert_array_equal(got["labels"], np.argmin(d2, axis=1))
    sums64 = np.zeros((k, d))
    np.add.at(sums64, got["labels"], x64)
    np.testing.assert_array_equal(got["sums"].astype(np.float64), sums64)
    assert float(got["sse"]) == d2.min(axis=1).sum()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_emulation_within_the_rounding_bound(shape):
    """Float data: the sums and the sse within ``rounding_depths``'s bound of float64, and
    that bound the order's own worst case (one more at most, where blocks take unequal
    tiles), not a padded one."""
    n, d, k, blocks = shape
    x, c = _data(n, d, k, seed=n + d + 2)
    got = emulate(x, c, blocks)
    h = k1.rounding_depths(n, d, k, torch.from_numpy(got["labels"]), blocks)
    assert got["depth"] <= h["h_sums"] <= got["depth"] + 1
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    sums64, abs64 = np.zeros((k, d)), np.zeros((k, d))
    np.add.at(sums64, got["labels"], x64)
    np.add.at(abs64, got["labels"], np.abs(x64))
    err = np.abs(got["sums"] - sums64)
    assert np.all(err <= (gamma(h["h_sums"]) + gamma(n, U64)) * abs64 + 1e-30)
    sse64 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1).min(axis=1).sum()
    row_err = gamma(h["h_row"]) * float(((np.linalg.norm(x64, axis=1) + np.linalg.norm(c64, axis=1).max()) ** 2).sum())
    sse_tol = row_err + (gamma(h["h_sse"]) + gamma(n, U64)) * (sse64 + row_err)
    assert abs(float(got["sse"]) - sse64) <= sse_tol


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_ordered_sums_replays_the_emulation(shape):
    """``kmeans.ordered_sums``, with which chip_smoke.py checks the card's sums bit for bit,
    equals the row-by-row emulation bit for bit."""
    n, d, k, blocks = shape
    x, c = _data(n, d, k, seed=n + d + 3)
    got = emulate(x, c, blocks)
    np.testing.assert_array_equal(k1.ordered_sums(x, got["labels"], k, blocks), got["sums"])


def _pr1_depth(labels, k, blocks):
    """PR 1 to 6's h for the sums: row r summed by warp slot r % (8 blocks), sequentially,
    then the 8 warps of a block, then the blocks (chip_smoke.py's check_k1 until PR 7)."""
    slots = 8 * blocks
    slot = np.arange(labels.size) % slots
    return int(np.bincount(slot * k + labels, minlength=slots * k).max()) + 8 + blocks


def test_rounding_bound_against_pr1_at_the_main_shape():
    """At the main path's shape the new order's h for the sums is below PR 1's: PR 1 summed a
    warp slot's rows sequentially over the whole run (n / 8448 rows a slot and cluster) and
    folded 8448 slots; the new order sums at most one tile's rows of a cluster, then a
    block's 296 tiles, then 132 blocks. Labels drawn as blobs give the counts per tile."""
    n, k = 10_000_000, 8
    labels = np.random.default_rng(0).integers(0, k, n)
    p = k1.plan(64, k)
    h_new = k1.rounding_depths(n, 64, k, torch.from_numpy(labels), 132)["h_sums"]
    h_pr1 = _pr1_depth(labels, k, 132 * 8)  # 8 blocks of 8 warps an SM on 132 SMs
    tiles = -(-n // p.rows_per_tile)
    assert h_new <= p.rows_per_tile + -(-tiles // 132) + 132
    assert h_new < h_pr1


def _pr1_fits(d, k):
    """PR 1's gate, written out: a row in one warp's registers (d <= 256) and, in shared
    memory, the centers, |c|² and one k*d + k + 1 record for each of 8 warps."""
    return 1 <= d <= 256 and k >= 1 and 4 * (k * d + k + 8 * (k * d + k + 1)) <= 232_448


def test_gate_admits_everything_pr1_admitted():
    for d in range(1, 257):
        k = 1
        while _pr1_fits(d, k):
            assert k1.fits_smem(d, k), (d, k)
            p = k1.plan(d, k)
            assert p.smem_bytes <= 232_448 and p.threads % 32 == 0 and 2 <= p.stages
            k += 1
        assert k > 1  # PR 1 admitted k = 1 at every d
    assert not k1.fits_smem(257, 1) and not k1.fits_smem(0, 1) and not k1.fits_smem(64, 0)


def test_plan_at_the_main_shape():
    p = k1.plan(64, 8)
    assert (p.reg, p.tpr, p.threads, p.stages, p.rows_per_tile, p.row_stride4) == (True, 4, 256, 3, 256, 16)
    assert p.smem_bytes == k1.smem_bytes(64, 8, 256, 3) <= 232_448  # 4 stages would not fit
    # above 8 clusters the centers leave the registers for shared memory, a thread a row
    q = k1.plan(64, 9)
    assert (q.reg, q.tpr, q.rows_per_tile) == (False, 1, 256)
