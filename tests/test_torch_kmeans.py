"""cdist and KMeans in the PyTorch port against heat_tpu, on the CPU.

heat_tpu takes its generic Lloyd path on the CPU; the port takes its K1 path, whose
wrapper runs K1's plain version on CPU tensors (f32), or its generic path (f64). Both
start from the same explicit centers.
"""

import numpy as np
import pytest
import torch

import heat_tpu as ht

import heat_tpu_torch as htt
from heat_tpu_torch import interop
from heat_tpu_torch.core.kernels import kmeans as k1


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _blobs(n=600, d=4, k=3, seed=0, dtype=np.float32):
    """Well-separated Gaussian blobs (the pattern of tests/test_kernels.py) and initial
    centers near, not at, the true ones."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 10, (k, d))
    y = rng.integers(0, k, n)
    x = (centers[y] + rng.normal(0, 0.3, (n, d))).astype(dtype)
    init = (centers + rng.normal(0, 1.0, (k, d))).astype(dtype)
    return x, init


@pytest.mark.parametrize("y_split", [None, 0])
@pytest.mark.parametrize("x_split", [None, 0, 1])
def test_cdist_parity(x_split, y_split):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    y = rng.standard_normal((9, 5)).astype(np.float32)
    got = htt.spatial.cdist(htt.array(x, split=x_split), htt.array(y, split=y_split))
    want = ht.spatial.cdist(ht.array(x, split=x_split), ht.array(y, split=y_split))
    assert got.gshape == want.gshape == (40, 9)
    assert got.split == want.split
    assert got.dtype is htt.float32 and want.dtype is ht.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_cdist_f64_and_self():
    x = np.random.default_rng(8).standard_normal((30, 3))
    got = htt.spatial.cdist(htt.array(x, split=0))
    want = ht.spatial.cdist(ht.array(x, split=0))
    assert got.dtype is htt.float64 and want.dtype is ht.float64
    off = ~np.eye(30, dtype=bool)
    np.testing.assert_allclose(got.numpy()[off], want.numpy()[off], rtol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32_k1", "f64_generic"])
@pytest.mark.parametrize("split", [None, 0])
def test_kmeans_fit_parity(split, dtype):
    x, init = _blobs(dtype=dtype)
    mine = htt.cluster.KMeans(n_clusters=3, init=htt.array(init), max_iter=50)
    theirs = ht.cluster.KMeans(n_clusters=3, init=ht.array(init), max_iter=50)
    mine.fit(htt.array(x, split=split))
    theirs.fit(ht.array(x, split=split))
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_allclose(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy(), atol=1e-4)
    assert mine.labels_.dtype is htt.int64 and theirs.labels_.dtype is ht.int64
    assert mine.labels_.split == theirs.labels_.split
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-4)
    assert mine.cluster_centers_.dtype.__name__ == theirs.cluster_centers_.dtype.__name__


def test_kmeans_fit_takes_the_kernel_step_for_f32_only():
    x, init = _blobs()
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(init))
    assert km._fused_step(htt.array(x), htt.float32) is k1.fused_assign_update_packed
    assert km._fused_step(htt.array(x), htt.float64) is None
    wide = htt.cluster.KMeans(n_clusters=3)
    assert wide._fused_step(htt.zeros((4, 300)), htt.float32) is None  # beyond the gate


def test_kmeans_max_iter_and_negative_tol():
    x, init = _blobs()
    km = htt.cluster.KMeans(n_clusters=3, init=htt.array(init), max_iter=7, tol=-1.0)
    km.fit(htt.array(x, split=0))
    assert km.n_iter_ == 7


def test_predict_parity_through_interop():
    x, init = _blobs()
    theirs = ht.cluster.KMeans(n_clusters=3, init=ht.array(init), max_iter=50).fit(ht.array(x, split=0))
    state = {
        "cluster_centers": theirs.cluster_centers_.numpy(),
        "n_clusters": theirs.n_clusters,
        "n_iter": theirs.n_iter_,
        "inertia": theirs.inertia_,
    }
    mine = interop.kmeans_from_state(state)
    assert mine.n_iter_ == theirs.n_iter_ and mine.inertia_ == theirs.inertia_
    new = np.random.default_rng(9).normal(0, 10, (200, 4)).astype(np.float32)
    got = mine.predict(interop.dndarray_from_numpy(new, split=0))
    want = theirs.predict(ht.array(new, split=0))
    assert got.dtype is htt.int64 and got.split == want.split == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_interop_keeps_dtype_and_split():
    a = np.arange(12, dtype=np.float64).reshape(4, 3)
    d = interop.dndarray_from_numpy(a, split=1)
    assert d.dtype is htt.float64 and d.split == 1 and d.gshape == (4, 3)
    np.testing.assert_array_equal(d.numpy(), a)


def test_random_init_is_seeded():
    x, _ = _blobs()
    a = htt.cluster.KMeans(n_clusters=3, init="random", random_state=5, max_iter=3).fit(htt.array(x, split=0))
    b = htt.cluster.KMeans(n_clusters=3, init="random", random_state=5, max_iter=3).fit(htt.array(x, split=0))
    np.testing.assert_array_equal(a.cluster_centers_.numpy(), b.cluster_centers_.numpy())


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU, so the default device resolves")
    htt.use_device("gpu")
    try:
        assert htt.get_device().device_type == "gpu"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            htt.arange(10, split=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            htt.array(np.zeros((4, 2), np.float32))
    finally:
        htt.use_device("cpu")
    assert htt.arange(3).device.device_type == "cpu"
