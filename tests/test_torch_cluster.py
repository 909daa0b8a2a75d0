"""heat_tpu's clustering in the PyTorch port against heat_tpu, on the CPU.

The same inputs go through heat_tpu (its generic path) and through the port with
``use_device("cpu")``: the key-level random draws (bit for bit), the greedy ++ seeding
(the same rows), KMeans, KMedians and KMedoids on ``create_spherical_dataset``, the
batch-parallel estimators and Spectral. heat_tpu's ++ seeding draws from
``jnp.cumsum``, whose order on one device the port replays (``random._xla_cumsum``); the
seeding and the batch-parallel fits are therefore compared with heat_tpu on a one-device
communicator, where heat_tpu's arrays are not sharded and it solves one block, as the
port does at one rank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.cluster.batchparallelclustering import _plus_plus as jax_plus_plus
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.utils.data.spherical import create_spherical_dataset as jax_spherical

import heat_tpu_torch as htt
from heat_tpu_torch.cluster import _kcluster
from heat_tpu_torch.cluster.batchparallelclustering import _plus_plus
from heat_tpu_torch.cluster.kmedians import _medians
from heat_tpu_torch.core import random as trandom
from heat_tpu_torch.utils.data.spherical import create_spherical_dataset


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.fixture(scope="module")
def comm1():
    """heat_tpu's communicator over one device: unsharded arrays, one block."""
    return MeshCommunication(jax.devices()[:1])


@pytest.fixture(scope="module")
def spheres():
    """(heat_tpu's, the port's) spherical dataset of 4 × 150 points."""
    htt.use_device("cpu")
    return jax_spherical(150), create_spherical_dataset(150)


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, float(np.nanmax(np.abs(want)))))


# ---------------------------------------------------------------- key-level draws
SEEDS = [0, 7, 123456789, 2**31 - 2]


@pytest.mark.parametrize("num", [2, 3, 5, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), num)))
    assert np.array_equal(np.array(trandom._split(trandom._key(seed), num)), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_and_uniform_match_jax(seed):
    key, tkey = jax.random.key(seed), trandom._key(seed)
    for n in (1, 7, 600, 10_000_000):
        assert int(trandom._key_randint(tkey, (), 0, n)) == int(jax.random.randint(key, (), 0, n))
    np.testing.assert_array_equal(trandom._key_randint(tkey, (6,), 0, 300).numpy(),
                                  np.asarray(jax.random.randint(key, (6,), 0, 300)))
    for dtype, tdtype in ((jnp.float32, htt.float32), (jnp.float64, htt.float64)):
        np.testing.assert_array_equal(trandom._key_uniform(tkey, (13,), tdtype).numpy(),
                                      np.asarray(jax.random.uniform(key, (13,), dtype=dtype)))


@pytest.mark.parametrize("n", [1, 5, 16, 17, 255, 256, 1000, 4097, 100_003])
def test_xla_cumsum_order(n):
    """The port's scan replays jnp.cumsum's order on one CPU device bit for bit."""
    p = np.random.default_rng(n).random(n).astype(np.float32)
    np.testing.assert_array_equal(trandom._xla_cumsum(torch.from_numpy(p)).numpy(), np.asarray(jnp.cumsum(p)))


@pytest.mark.parametrize("n", [5, 17, 300, 5000])
@pytest.mark.parametrize("seed", SEEDS)
def test_choice_matches_jax(seed, n):
    p = np.random.default_rng(n + seed).random(n).astype(np.float32)
    p[::3] = 0  # picked rows have probability 0 in the seeding
    p /= p.sum()
    want = np.asarray(jax.random.choice(jax.random.key(seed), n, (4,), p=jnp.asarray(p)))
    np.testing.assert_array_equal(trandom._key_choice(trandom._key(seed), 4, torch.from_numpy(p)).numpy(), want)


# ---------------------------------------------------------------- ++ seeding
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("p", [1, 2])
def test_plus_plus_picks_heat_tpus_rows(spheres, p, k):
    x = spheres[1].numpy()
    want = np.asarray(jax_plus_plus(jnp.asarray(x), k, p, jax.random.key(11)))
    centers, picks = _plus_plus(torch.from_numpy(x), k, p, trandom._key(11))
    np.testing.assert_array_equal(centers.numpy(), want)
    np.testing.assert_array_equal(centers.numpy(), x[picks.numpy()])


# ---------------------------------------------------------------- the estimators
def test_spherical_dataset_matches_heat_tpu(spheres):
    """Four balls from heat_tpu's stream (its normal draws are held within 4 ulp, then
    shifted by up to 8)."""
    want, got = spheres
    assert got.gshape == want.gshape == (600, 3) and got.split == want.split == 0 and got.dtype is htt.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


FITS = {
    "kmeans++": ("KMeans", dict(init="kmeans++", max_iter=30)),
    "kmedians++": ("KMedians", dict(init="kmedians++", max_iter=30)),
    "kmedoids++": ("KMedoids", dict(init="kmedoids++")),
    "kmeans_random": ("KMeans", dict(init="random", max_iter=30)),
}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_matches_heat_tpu(spheres, name):
    """Labels, n_iter and predict equal; centers within 1e-5; inertia within 1e-5
    relative (heat_tpu on its test mesh)."""
    cls, kw = FITS[name]
    theirs = getattr(ht.cluster, cls)(n_clusters=4, random_state=1, **kw).fit(spheres[0])
    mine = getattr(htt.cluster, cls)(n_clusters=4, random_state=1, **kw).fit(spheres[1])
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    _close(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy())
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-5)
    assert mine.cluster_centers_.dtype is htt.float32 and mine.labels_.dtype is htt.int64
    np.testing.assert_array_equal(mine.predict(spheres[1]).numpy(), theirs.predict(spheres[0]).numpy())


def test_kmedians_explicit_centers_even_clusters_and_nan():
    """Even-sized clusters, where the midpoint and the lower middle differ, and a NaN."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(-5, 1, (40, 3)), rng.normal(5, 1, (36, 3))]).astype(np.float32)
    x[3, 1] = np.nan
    init = np.array([[-4, -4, -4], [4, 4, 4]], np.float32)
    theirs = ht.cluster.KMedians(n_clusters=2, init=ht.array(init), max_iter=10).fit(ht.array(x, split=0))
    mine = htt.cluster.KMedians(n_clusters=2, init=htt.array(init), max_iter=10).fit(htt.array(x, split=0))
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    np.testing.assert_array_equal(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy())
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_medians_against_nanmedian(dtype):
    """The one-sort medians against heat_tpu's masked nanmedian: even and odd clusters,
    ties, NaN (a column all NaN in one cluster) and an empty cluster, which keeps its
    old center."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (61, 5)).astype(dtype)  # many ties
    x[rng.random(x.shape) < 0.1] = np.nan
    labels = rng.integers(0, 4, 61)
    labels[labels == 2] = 1  # cluster 2 is empty
    x[labels == 3, 4] = np.nan
    x[0, 0] = -0.0
    old = rng.normal(0, 1, (4, 5)).astype(dtype)
    want = np.asarray(ht.cluster.KMedians(n_clusters=4)._update_centroids_local(
        jnp.asarray(x), jnp.asarray(labels), jnp.asarray(old)))
    got = _medians(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(old), None).numpy()
    np.testing.assert_array_equal(got, want)


def test_kmedoids_update_against_heat_tpu():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (80, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 80)
    labels[labels == 2] = 0
    old = rng.normal(0, 1, (3, 4)).astype(np.float32)
    want = np.asarray(ht.cluster.KMedoids(n_clusters=3)._update_centroids_local(
        jnp.asarray(x), jnp.asarray(labels), jnp.asarray(old)))
    est = htt.cluster.KMedoids(n_clusters=3)
    rows = _kcluster._rows_of(htt.array(x, split=0))
    got = est._update_centroids_local(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(old), rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cls", ["KMeans", "KMedians", "KMedoids"])
def test_predict_and_functional_value_use_the_estimators_metric(spheres, cls):
    theirs = getattr(ht.cluster, cls)(n_clusters=4, init="random", random_state=2, max_iter=5).fit(spheres[0])
    mine = getattr(htt.cluster, cls)(n_clusters=4, init="random", random_state=2, max_iter=5).fit(spheres[1])
    rng = np.random.default_rng(8)
    new = rng.normal(0, 6, (50, 3)).astype(np.float32)
    labels = mine._assign_to_cluster(htt.array(new, split=0), eval_functional_value=True)
    want = theirs._assign_to_cluster(ht.array(new, split=0), eval_functional_value=True)
    np.testing.assert_array_equal(labels.numpy(), want.numpy())
    np.testing.assert_allclose(mine.inertia_, theirs.inertia_, rtol=1e-5)


# ---------------------------------------------------------------- the loop on the device
def _host_reads(monkeypatch):
    """Count the reads of a tensor's value to the host."""
    reads = []
    for name in ("__bool__", "item", "__int__", "__float__", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return reads


LOOP_CASES = [(cls, tol) for cls in ("KMeans", "KMedians") for tol in (-1.0, 0.0, 1e-4)] + [("KMedoids", 0.0)]


@pytest.mark.parametrize("cls,tol", LOOP_CASES)
def test_masked_loop_equals_the_host_checked_loop(spheres, monkeypatch, cls, tol):
    """n_iter, centers, labels and inertia equal a loop that reads its flag every pass,
    and the host reads the flag at most once every CHECK_EVERY passes (never at tol < 0)."""
    x = spheres[1]
    init = htt.array(x.numpy()[[0, 1, 150, 300]])  # two starts in one ball: several passes

    def fit():
        est = getattr(htt.cluster, cls)(n_clusters=4, init=init, max_iter=20)
        est.tol = tol  # KMedoids' own is 0.0
        return est.fit(x)

    reads = _host_reads(monkeypatch)
    masked = fit()
    loop_reads = [r for r in reads if r == "__bool__"]
    monkeypatch.setattr(_kcluster._KCluster, "_check_every", 1)
    monkeypatch.setattr(htt.cluster.KMedians, "_check_every", 1)
    checked = fit()
    assert masked.n_iter_ == checked.n_iter_
    np.testing.assert_array_equal(masked.cluster_centers_.numpy(), checked.cluster_centers_.numpy())
    np.testing.assert_array_equal(masked.labels_.numpy(), checked.labels_.numpy())
    assert masked.inertia_ == checked.inertia_
    every = 1 if cls == "KMedians" else _kcluster.CHECK_EVERY
    if cls == "KMeans":
        assert len(loop_reads) == (0 if tol < 0 else -(-masked.n_iter_ // every))


def test_early_convergence_runs_idle_passes_that_move_nothing(spheres):
    x = spheres[1]
    km = htt.cluster.KMeans(n_clusters=4, init=htt.array(x.numpy()[[0, 150, 300, 450]]), max_iter=50)
    passes = []
    orig = km._pass

    def counting(*a, **kw):
        passes.append(kw.get("update", True))
        return orig(*a, **kw)

    km._pass = counting
    km.fit(x)
    # converged after n_iter updates; the flag is read before pass 8, and the final
    # assignment updates nothing
    assert km.n_iter_ < _kcluster.CHECK_EVERY and passes == [True] * _kcluster.CHECK_EVERY + [False]


# ---------------------------------------------------------------- batch-parallel
@pytest.mark.parametrize("init", ["++", "random"])
@pytest.mark.parametrize("cls", ["BatchParallelKMeans", "BatchParallelKMedians"])
def test_batch_parallel_matches_heat_tpu(spheres, comm1, cls, init):
    name = {"++": "k-means++" if cls.endswith("KMeans") else "k-medians++", "random": "random"}[init]
    x = spheres[1].numpy()
    theirs = getattr(ht.cluster, cls)(n_clusters=4, init=name, random_state=4).fit(ht.array(x, split=0, comm=comm1))
    mine = getattr(htt.cluster, cls)(n_clusters=4, init=name, random_state=4).fit(htt.array(x, split=0))
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    _close(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy())


BAD_ARGS = [
    (dict(n_clusters=2.0), TypeError), (dict(n_clusters=0), ValueError), (dict(max_iter=1.5), TypeError),
    (dict(max_iter=0), ValueError), (dict(tol=1), TypeError), (dict(tol=-1.0), ValueError),
    (dict(random_state=1.0), TypeError), (dict(n_procs_to_merge=2.0), TypeError),
    (dict(n_procs_to_merge=1), ValueError), (dict(init="kmeans++"), ValueError),
]


@pytest.mark.parametrize("cls", ["BatchParallelKMeans", "BatchParallelKMedians"])
@pytest.mark.parametrize("case", range(len(BAD_ARGS)))
def test_batch_parallel_argument_errors(cls, case):
    kwargs, error = BAD_ARGS[case]
    with pytest.raises(error):
        getattr(ht.cluster, cls)(**kwargs)
    with pytest.raises(error):
        getattr(htt.cluster, cls)(**kwargs)


def test_batch_parallel_input_errors():
    est = htt.cluster.BatchParallelKMeans(n_clusters=2)
    with pytest.raises(TypeError):
        est.fit(np.zeros((4, 2)))
    with pytest.raises(ValueError):
        est.fit(htt.zeros((4, 2), split=1))
    with pytest.raises(RuntimeError):
        est.predict(htt.zeros((4, 2), split=0))


def test_batchparallel_init_of_kmeans(spheres, comm1):
    x = spheres[1].numpy()
    theirs = ht.cluster.KMeans(n_clusters=4, init="batchparallel", random_state=3, max_iter=10).fit(
        ht.array(x, split=0, comm=comm1))
    mine = htt.cluster.KMeans(n_clusters=4, init="batchparallel", random_state=3, max_iter=10).fit(
        htt.array(x, split=0))
    assert mine.n_iter_ == theirs.n_iter_
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    _close(mine.cluster_centers_.numpy(), theirs.cluster_centers_.numpy())


# ---------------------------------------------------------------- spectral
@pytest.mark.parametrize("n_clusters", [4, None])
def test_spectral_matches_heat_tpu(n_clusters):
    """Labels equal and eigenvalues within 1e-4; the embedding matches up to column
    signs (LAPACK's eigenvectors' signs), its rbf similarity float64 as heat_tpu's."""
    xj, xt = jax_spherical(40), create_spherical_dataset(40)
    ht.random.seed(9)
    htt.random.seed(9)
    theirs = ht.cluster.Spectral(n_clusters=n_clusters, n_lanczos=60).fit(xj)
    mine = htt.cluster.Spectral(n_clusters=n_clusters, n_lanczos=60).fit(xt)
    assert mine.n_clusters == theirs.n_clusters
    np.testing.assert_array_equal(mine.labels_.numpy(), theirs.labels_.numpy())
    ev_t, emb_t = theirs._spectral_embedding(xj)
    ev_m, emb_m = mine._spectral_embedding(xt)
    assert ev_m.dtype is htt.float64 and emb_m.gshape == emb_t.gshape
    np.testing.assert_allclose(ev_m.numpy(), ev_t.numpy(), atol=1e-4)
    k = mine.n_clusters
    a, b = emb_m.numpy()[:, :k], emb_t.numpy()[:, :k]
    np.testing.assert_allclose(a * np.sign((a * b).sum(0)), b, atol=1e-4)
    with pytest.raises(NotImplementedError):
        mine.predict(xt)
