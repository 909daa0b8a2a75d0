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
    # the layout at the main shape: a ring of 3 tiles of 256 rows at a stride of 17 chunks
    # of 16 bytes, the centers in 16 chunks each; a list of tile rows for each of the 8
    # warps, |c|², the record, the counts, two sets of a mask per cluster and warp, a sum per
    # tile row and the last-block flag in 4-byte words
    assert k1.smem_bytes(64, 8) == 16 * (3 * 256 * 17 + 8 * 16) + 4 * (8 * 256 + 8 + 8 * 64 + 8 + 2 * 8 * 8 + 256 + 1)


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
