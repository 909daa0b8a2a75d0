"""K1 in the PyTorch port against heat_tpu's K1.

On the CPU the port's wrapper runs the plain PyTorch version of the kernel; it must agree
with heat_tpu's jnp reference and with heat_tpu's Pallas kernel run in interpret mode.
The CUDA kernel itself is compared with the plain version on the card by chip_smoke.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import heat_tpu  # noqa: F401 — enables x64, as every heat_tpu test process has it
from heat_tpu.core.kernels.kmeans import _fused_pallas
from heat_tpu.core.kernels.kmeans import fused_assign_update_reference as jax_reference

import heat_tpu_torch
from heat_tpu_torch.core.kernels import kmeans as k1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(1024, 64, 8), (130, 10, 3), (1500, 7, 5)]


@pytest.fixture(autouse=True)
def _on_cpu():
    heat_tpu_torch.use_device("cpu")


def _data(n, d, k, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    # labels can only be compared exactly where no row has a near-tie: the two smallest
    # squared distances differ by more than 1e-5 relative for every row at these seeds
    d2 = ((x[:, None, :].astype(np.float64) - c[None, :, :]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    assert np.all(two[:, 1] - two[:, 0] > 1e-5 * two[:, 1])
    return x, c


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("against", ["jnp_reference", "pallas_interpret"])
def test_plain_k1_matches_heat_tpu(shape, against):
    x, c = _data(*shape)
    if against == "jnp_reference":
        want = jax_reference(jnp.asarray(x), jnp.asarray(c))
    else:
        want = _fused_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True)
    l0, s0, n0, e0 = (np.asarray(v) for v in want)
    l1, s1, n1, e1 = k1.fused_assign_update_reference(torch.from_numpy(x), torch.from_numpy(c))
    assert l1.dtype == torch.int32
    np.testing.assert_array_equal(l1.numpy(), l0)
    np.testing.assert_array_equal(n1.numpy(), n0)
    # fp32 dot products summed in another order: the tolerances of tests/test_kernels.py
    np.testing.assert_allclose(s1.numpy(), s0, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(e1), float(e0), rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_wrapper_on_cpu_tensor_is_the_plain_version(shape):
    x, c = (torch.from_numpy(a) for a in _data(*shape, seed=2))
    want = k1.fused_assign_update_reference(x, c)
    before = k1.launches
    got = k1.fused_assign_update(x, c)
    assert k1.launches == before  # no kernel launch for CPU tensors
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    labels, packed = k1.fused_assign_update_packed(x, c)
    k, d = c.shape
    assert packed.shape == (k * d + k + 1,)
    sums, counts, sse = k1.unpack(packed, k, d)
    torch.testing.assert_close(labels, want[0], rtol=0, atol=0)
    torch.testing.assert_close(sums, want[1], rtol=0, atol=0)
    torch.testing.assert_close(counts, want[2], rtol=0, atol=0)
    torch.testing.assert_close(sse, want[3], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, c = (torch.from_numpy(a) for a in _data(64, 8, 3, seed=3))
    with pytest.raises(TypeError, match="float32"):
        k1.fused_assign_update(x.double(), c.double())
    with pytest.raises(TypeError, match="float32"):
        k1.fused_assign_update(x, c.double())
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_assign_update(x.T.contiguous().T, c)
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_assign_update(x, torch.cat([c, c], dim=1)[:, ::2])
    with pytest.raises(ValueError, match="features"):
        k1.fused_assign_update(x, c[:, :4].contiguous())


def test_shared_memory_gate():
    assert k1.fits_smem(64, 8)
    assert k1.fits_smem(256, 2)
    assert not k1.fits_smem(257, 2)  # beyond the kernel's largest bound on d
    assert not k1.fits_smem(64, 1000)  # the centers alone exceed shared memory
    # the layout at the main shape: a ring of 3 tiles of 256 unpadded rows of 16 chunks of 16
    # bytes, the centers in 16 chunks each; two 8-byte mbarriers a stage; a list of tile rows
    # for each of the 8 accumulating warps, a ticket a stage, |c|², the record, the counts, a
    # label slot per tile row and stage, a sum per tile row and the last-block flag in 4-byte
    # words
    assert k1.plan(64, 8).smem_bytes == (16 * (3 * 256 * 16 + 8 * 16) + 8 * 2 * 3
                                         + 4 * (8 * 256 + 3 + 8 + 8 * 64 + 8 + 3 * 256 + 256 + 1))
    # at the benchmark's shape (d = 28) a CTA hosts two blocks of the order: two records, two
    # sets of counts and of sse slots, and a ring of 4 unpadded tiles of 7 chunks a row
    assert k1.plan(28, 8).smem_bytes == k1.smem_bytes(28, 8) == (
        16 * (4 * 256 * 7 + 8 * 7) + 8 * 2 * 4 + 4 * (8 * 256 + 4 + 8 + 2 * 8 * 28 + 2 * 8 + 4 * 256 + 2 * 256 + 1))


@pytest.mark.parametrize("d, k, stages, tile_bytes", [
    (28, 8, 4, 28_672),   # the benchmark's shape: the planner's 4 stages fit
    (64, 8, 3, 65_536),   # 16 chunks a row: 4 tiles exceed shared memory, 3 fit
    (64, 1, 3, 65_536),
    (32, 8, 4, 32_768),   # 8 chunks a row
    (7, 5, 4, 8_192),     # 2 chunks a row
    (48, 12, 4, 53_248),  # the centers in shared memory, a thread a row of 13 chunks (padded)
    (100, 6, 4, 53_248),  # two threads a row, 128 rows of 26 chunks
    (256, 8, 3, 69_632),  # four threads a row, 64 rows of 68 chunks
])
def test_ring_depth_fits_shared_memory(d, k, stages, tile_bytes):
    # 4 stages, fewer where shared memory would not hold them; the deepest that fits
    p = k1.plan(d, k)
    assert 16 * p.rows_per_tile * p.row_stride4 == tile_bytes  # a stage: a tile of padded rows
    assert p.stages == stages and p.threads == 256
    assert stages == 4 or k1.smem_bytes(d, k, 256, stages + 1) > 232_448


@pytest.mark.parametrize("d", [1, 7, 28, 64, 100, 200, 256])
def test_every_admitted_plan_fits_shared_memory(d):
    # k from 1 to past the gate: every plan the gate admits fits the 227 KB an SM offers a
    # block, keeps whole warps a role (whole warpgroups with the centers in registers, whose
    # roles trade registers) and 2 to 8 stages; the gate is monotone in k
    k, admitted = 1, True
    while admitted:
        p = k1.plan(d, k)
        admitted = p is not None
        assert admitted == k1.fits_smem(d, k)
        if admitted:
            assert p.smem_bytes <= 232_448 and p.threads in (32, 64, 128, 256) and 2 <= p.stages <= 8
            assert not p.reg or p.threads in (128, 256)
            assert p.smem_bytes == k1.smem_bytes(d, k, p.threads, p.stages)
        k += 1 if k < 64 else 97
    assert k > 2  # every d admits k = 1 at least
    assert all(k1.plan(d, kk) is None for kk in (k, 2 * k))


def _one_block_ring_fits(d, k):
    """The gate of the launch before the warp roles, written out: from 256 threads and 3
    stages, fewer stages (down to 2), then half the threads (down to one warp), until a block
    of one role fits: the ring of padded rows (odd strides with the centers in registers) and
    the centers in 16-byte chunks, then in 4-byte words a list of tile rows a warp, |c|², the
    record, the counts, two sets of a mask per cluster and warp, a sum per row and a flag."""
    if not (1 <= d <= 256 and k >= 1):
        return False
    dmax = 32 if d <= 32 else 64 if d <= 64 else 128 if d <= 128 else 256
    reg = d <= 64 and k <= 8
    tpr = 4 if reg else max(1, dmax // 64)
    s = 1 if reg else tpr
    chunks = -(-d // 4)
    p4 = chunks
    while p4 % (2 * s) != s:
        p4 += 1
    threads, stages = 256, 3
    while True:
        bn, warps = (threads if reg else threads // tpr), threads // 32
        smem = (16 * (stages * bn * p4 + k * chunks)
                + 4 * (warps * bn + k + k * d + k + 2 * warps * k + bn + 1))
        if smem <= 232_448:
            return True
        if stages > 2:
            stages -= 1
        elif threads > 32:
            threads //= 2
        else:
            return False


@pytest.mark.parametrize("ds", [range(1, 65), range(65, 129), range(129, 257)], ids=["d1-64", "d65-128", "d129-256"])
def test_gate_admits_everything_the_one_block_ring_admitted(ds):
    # the largest k of each d that the launch before the warp roles took is admitted here
    # too (both gates are monotone in k), with a plan that fits
    for d in ds:
        lo, hi = 1, 1
        while _one_block_ring_fits(d, hi):
            lo, hi = hi, 2 * hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if _one_block_ring_fits(d, mid) else (lo, mid)
        for k in (lo, max(1, lo // 2), 1):
            p = k1.plan(d, k)
            assert p is not None and k1.fits_smem(d, k), (d, k)
            assert p.smem_bytes <= 232_448


def test_order_blocks_a_cta_hosts():
    # two where the launch before the TMA ring kept two blocks on an SM: the centers in
    # registers and rows of at most 7 chunks (d <= 28); the order's grid is per_cta a CTA
    assert [k1.plan(d, 8).per_cta for d in (4, 7, 10, 24, 28, 29, 32, 64)] == [2, 2, 2, 2, 2, 1, 1, 1]
    assert k1.plan(28, 9).per_cta == 1 and k1.plan(100, 4).per_cta == 1


@pytest.mark.parametrize("blocks, tiles", [
    (264, 600), (264, 300), (264, 264), (200, 200), (201, 201), (17, 17), (1, 1), (3, 2), (264, 0),
])
def test_ordered_sums_follow_ctas_that_host_two_blocks(blocks, tiles):
    # The kernel's walk at d = 28 (csrc/kmeans_assign.cu): ceil(blocks / V) CTAs, CTA c takes
    # tiles c, c + P, ... and adds its i-th tile's partials to its hosted block c + P * (i mod
    # V), V = per_cta, or 1 where no block has two tiles. The records it builds fold to
    # ordered_sums' bits, which give tile t to block t mod blocks.
    p = k1.plan(28, 8)
    v = 1 if blocks >= tiles else p.per_cta
    assert p.per_cta == 2 and blocks % v == 0  # what the launch accepts
    bn, k = p.rows_per_tile, 8
    rng = np.random.default_rng(blocks * 1000 + tiles)
    n = max(0, tiles * bn - 37)  # the last tile short
    x = (rng.standard_normal((n, 28)) * 3.0).astype(np.float32)
    labels = rng.integers(0, k, n)
    ctas = blocks // v
    records = np.zeros((blocks, k, 28), dtype=np.float32)
    for c in range(ctas):
        for i, t in enumerate(range(c, tiles, ctas)):
            b = c + ctas * (i % v)
            rows, lab = x[t * bn:(t + 1) * bn], labels[t * bn:(t + 1) * bn]
            for j in np.unique(lab):
                records[b, j] = records[b, j] + np.add.accumulate(rows[lab == j], axis=0, dtype=np.float32)[-1]
    want = k1._folded(records)
    got = k1.ordered_sums(x, labels, k, blocks, launch=p)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))


class _At:
    """A tensor-like with a given address, for :func:`kmeans.route`."""

    def __init__(self, address):
        self.address = address

    def data_ptr(self):
        return self.address


@pytest.mark.parametrize("d, k, address, want", [
    (28, 8, 4096, "bulk"),     # 7 chunks a row, unpadded: a tile is one span
    (28, 8, 4100, "words"),    # 4 bytes past a 16-byte boundary
    (64, 8, 4096, "bulk"),     # with the centers in registers rows are never padded
    (64, 8, 4104, "words"),
    (24, 8, 4096, "bulk"),
    (20, 8, 4096 + 16, "bulk"),
    (7, 5, 4096, "words"),     # d % 4 != 0
    (10, 3, 4096, "words"),
    (48, 12, 4096, "chunks"),  # 12 chunks padded to 13 (one thread a row): 16-byte cp.async
    (44, 12, 4096, "bulk"),    # 11 chunks, odd: unpadded
    (100, 6, 4096, "chunks"),  # 25 chunks padded to 26
    (256, 8, 4096, "chunks"),
])
def test_route_by_alignment_and_width(d, k, address, want):
    p = k1.plan(d, k)
    assert k1.route(p, _At(address)) == want
    assert (want == "bulk") == (address % 16 == 0 and d % 4 == 0 and p.row_stride4 == p.chunks)


def test_launcher_imports_without_cuda_or_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME="", CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    code = (
        "import heat_tpu_torch.core.kernels.kmeans as k1, torch\n"
        "assert k1._LIB is None and k1.launches == 0\n"
        "print('ok', torch.cuda.is_available())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "False"]
