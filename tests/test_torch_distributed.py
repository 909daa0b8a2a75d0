"""The PyTorch port on three gloo ranks against heat_tpu on a three-device mesh.

One spawn of three worker processes (tests/_torch_dist_worker.py) runs every check of this
file; the tests below compare what each rank gathered with heat_tpu's values, computed
here. The ranks rendezvous through a file in the test's own temporary directory, so
concurrent test workers never share a port.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import heat_tpu as ht
from heat_tpu.core.communication import MeshCommunication

WORLD = 3
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
REDUCTIONS = ("sum", "prod", "mean", "min", "max", "argmin", "argmax")


MHA_E, MHA_H = 16, 4


def _mha_params():
    """heat_tpu's MultiheadAttention(16, 4) parameters, as numpy."""
    params = ht.nn.MultiheadAttention(MHA_E, MHA_H).init(jax.random.key(3))
    return {k: np.asarray(v) for k, v in params.items()}


def _inputs():
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 10, (3, 4))
    y = rng.integers(0, 3, 301)  # ragged over three ranks: 101, 101, 99 rows
    kpm = np.zeros((7, 5), bool)
    kpm[:, -1] = True
    kpm[4, 0] = True
    return {
        "a": rng.standard_normal((7, 3)).astype(np.float32),  # chunks 3, 3, 1 along axis 0
        "small": rng.standard_normal((2, 3)).astype(np.float32),  # rank 2 holds no rows
        "ties": rng.integers(0, 2, (6, 4)),  # equal extremes on several ranks
        "blobs": (centers[y] + rng.normal(0, 0.3, (301, 4))).astype(np.float32),
        "init": (centers + rng.normal(0, 1.0, (3, 4))).astype(np.float32),
        # attention over a batch of 7 split 3, 3, 1
        "mha_x": rng.standard_normal((7, 5, MHA_E)).astype(np.float32),
        "mha_mem": rng.standard_normal((7, 9, MHA_E)).astype(np.float32),
        "mha_kpm": kpm,
        "mha_heads": np.array(MHA_H),
        **{f"mha_param_{k}": v for k, v in _mha_params().items()},
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of three gloo ranks."""
    tmp = tmp_path_factory.mktemp("torch_dist")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(WORLD), str(tmp / "rendezvous"), str(tmp / "inputs.npz"), str(tmp)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def comm3():
    """heat_tpu's communicator over three devices of the test mesh."""
    return MeshCommunication(jax.devices()[:WORLD])


def _meta(r):
    return [r.dtype.__name__, str(r.split), str(r.gshape)]


def test_world(ranks):
    _, res = ranks
    assert [tuple(r["world"]) for r in res] == [(WORLD, i) for i in range(WORLD)]


def test_north_star_arange_sum(ranks, comm3):
    _, res = ranks
    want = ht.arange(10, split=0, comm=comm3).sum()
    for r in res:
        assert r["arange_sum"] == want.item() == 45
        assert str(r["arange_sum_dtype"]) == want.dtype.__name__ == "int64"


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["a", "small", "ties"])
def test_chunks_match_heat_tpu(ranks, comm3, name, split):
    inputs, res = ranks
    shape = inputs[name].shape
    want = comm3.lshape_map(shape, split)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r[f"{name}_s{split}_lshape_map"], want)
        np.testing.assert_array_equal(r[f"{name}_s{split}_local"], want[rank])
    if name == "small" and split == 0:
        assert want[2, 0] == 0  # the empty chunk


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("fn", REDUCTIONS)
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", ["a", "small", "ties"])
def test_reductions_match_heat_tpu(ranks, comm3, name, split, fn, axis):
    inputs, res = ranks
    want = getattr(ht, fn)(ht.array(inputs[name], split=split, comm=comm3), axis=axis)
    key = f"{name}_s{split}_{fn}_{axis}"
    for r in res:
        assert list(r[key + "_meta"]) == _meta(want)
        np.testing.assert_allclose(r[key], want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "pow"])
def test_binary_across_splits(ranks, comm3, op):
    inputs, res = ranks
    a0 = ht.array(inputs["a"], split=0, comm=comm3)
    a1 = ht.array(inputs["a"], split=1, comm=comm3)
    want = getattr(ht, op)(a0, a1)
    for r in res:
        assert list(r[f"binary_{op}_meta"]) == [want.dtype.__name__, str(want.split)]
        np.testing.assert_allclose(r[f"binary_{op}"], want.numpy(), rtol=1e-5)


def test_resplit(ranks, comm3):
    inputs, res = ranks
    want = comm3.lshape_map(inputs["a"].shape, 0)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["resplit_1_0"], inputs["a"])
        np.testing.assert_array_equal(r["resplit_1_0_local"], want[rank])


def test_kmeans_fit_ragged(ranks, comm3):
    inputs, res = ranks
    km = ht.cluster.KMeans(n_clusters=3, init=ht.array(inputs["init"], comm=comm3), max_iter=50)
    km.fit(ht.array(inputs["blobs"], split=0, comm=comm3))
    for r in res:
        assert int(r["km_n_iter"]) == km.n_iter_
        np.testing.assert_allclose(r["km_centers"], km.cluster_centers_.numpy(), atol=1e-4)
        np.testing.assert_array_equal(r["km_labels"], km.labels_.numpy())
        np.testing.assert_allclose(float(r["km_inertia"]), km.inertia_, rtol=1e-4)
        np.testing.assert_array_equal(r["km_predict"], km.labels_.numpy())
        # one all_reduce per Lloyd iteration plus the final assignment, each of the
        # packed k*d + k + 1 record
        assert r["km_allreduce_shapes"].tolist() == [[3 * 4 + 3 + 1]] * (km.n_iter_ + 1)


@pytest.mark.parametrize("name", ["self", "cross"])
def test_mha_batch_split(ranks, comm3, name):
    """MultiheadAttention on a batch split over three ranks: each rank attends its own
    rows of the batch (3, 3, 1); the result keeps the split and matches heat_tpu."""
    inputs, res = ranks
    mha = ht.nn.MultiheadAttention(MHA_E, MHA_H)
    params = {k: jnp.asarray(v) for k, v in _mha_params().items()}
    x = ht.array(inputs["mha_x"], split=0, comm=comm3)
    if name == "self":
        want = mha.apply(params, x, key_padding_mask=jnp.asarray(inputs["mha_kpm"]))
    else:
        mem = jnp.asarray(inputs["mha_mem"])
        want = mha.apply(params, (x, mem, mem), is_causal=True)
    lmap = comm3.lshape_map(want.gshape, 0)
    for rank, r in enumerate(res):
        assert list(r[f"mha_{name}_meta"]) == ["0", str(want.gshape)] and want.split == 0
        np.testing.assert_array_equal(r[f"mha_{name}_local"], lmap[rank])
        # fp32 on both sides, summed in another order
        np.testing.assert_allclose(r[f"mha_{name}"], want.numpy(), rtol=2e-5, atol=2e-5)


def test_mha_sequence_split_raises(ranks):
    """A sequence split over several ranks needs ring attention, not ported yet: it
    raises rather than gathering."""
    _, res = ranks
    for r in res:
        assert str(r["mha_seq_split"]) == "NotImplementedError"
