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
from heat_tpu.core import _executor
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.core.linalg import comm_plan as jplan

import heat_tpu_torch as htt
from heat_tpu_torch.cluster._kcluster import CHECK_EVERY
from heat_tpu_torch.interop import load_jax_params
from heat_tpu_torch.testing import assert_record_equal

WORLD = 3
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
REDUCTIONS = ("sum", "prod", "mean", "min", "max", "argmin", "argmax")


MHA_E, MHA_H = 16, 4
DP_LR = 0.3


class _JaxMLP(ht.nn.Module):
    """The data-parallel test model: Linear(4, 8), ReLU, Linear(8, 3), as ``fc1``, ``fc2``."""

    def __init__(self):
        self.fc1 = ht.nn.Linear(4, 8)
        self.fc2 = ht.nn.Linear(8, 3)

    def init(self, key):
        k1, k2 = jax.random.split(key)
        return {"fc1": self.fc1.init(k1), "fc2": self.fc2.init(k2)}

    def apply(self, params, x, *, key=None, train=False):
        return self.fc2.apply(params["fc2"], jnp.maximum(self.fc1.apply(params["fc1"], x), 0.0))


def _nested_mlp_params():
    return jax.tree_util.tree_map(np.asarray, _JaxMLP().init(jax.random.key(5)))


def _mlp_params():
    return {f"{m}.{k}": v for m, sub in _nested_mlp_params().items() for k, v in sub.items()}


def _mha_params():
    """heat_tpu's MultiheadAttention(16, 4) parameters, as numpy."""
    params = ht.nn.MultiheadAttention(MHA_E, MHA_H).init(jax.random.key(3))
    return {k: np.asarray(v) for k, v in params.items()}


def _with_nan(rows, cols=None):
    """``np.arange(7)`` as float32 (or a (7, cols) ramp) with NaN at the given
    (row[, column]) positions: 7 rows split 3, 3, 1 over the three ranks."""
    a = np.arange(7 * (cols or 1), dtype=np.float32).reshape((7, cols) if cols else (7,))
    for at in rows:
        a[at] = np.nan
    return a


NAN_CASES = {  # a NaN in rank 0's chunk, rank 1's, rank 2's, and in columns 1 and 2 only
    "nan_r0": _with_nan([1]),
    "nan_r1": _with_nan([4]),
    "nan_r2": _with_nan([6]),
    "nan_cols": _with_nan([(1, 1), (6, 2)], cols=3),
}


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
        # one data-parallel SGD step on a batch of 7 split 3, 3, 1 and of 2 split 1, 1, 0
        "dp_x7": rng.standard_normal((7, 4)).astype(np.float32),
        "dp_y7": rng.integers(0, 3, 7),
        "dp_x2": rng.standard_normal((2, 4)).astype(np.float32),
        "dp_y2": rng.integers(0, 3, 2),
        "dp_lr": np.array(DP_LR),
        **{f"dp_param_{k}": v for k, v in _mlp_params().items()},
        **NAN_CASES,
        **_linalg_inputs(rng),
        **_cluster_inputs(rng),
        **_domain_inputs(rng),
        **_nn_inputs(rng),
        # the threaded requests of the runtime: 10 rows split 4, 4, 2
        "rt_x": rng.standard_normal((10, 6)).astype(np.float32),
        "rt_y": rng.standard_normal((10, 6)).astype(np.float32),
        # the same chain on more inputs, each from a generator of its own seed
        **{f"rt_{v}_seed{seed}": np.random.default_rng(seed).standard_normal((2, 10, 6)).astype(np.float32)[j]
           for seed in RT_SEEDS for j, v in enumerate(("x", "y"))},
    }


# the chain's extra seeds: where heat_tpu's chain leaves the stepwise float32 one most (0, 9:
# 108 and 80 ulp for the multiplier 3) and least (1: 10 ulp)
RT_SEEDS = (0, 1, 9)


def _chain_f32(x, y, k: float, fused: bool):
    """The runtime's chain c = ((c·k + y) − 0.5) four times from c = x in float32: each
    operation rounded (``fused`` False, the port's), or c·k + y rounded once, as one fused
    multiply-add (c·k is exact in float64, and so is its sum with y at these magnitudes)."""
    c = x.copy()
    for _ in range(4):
        if fused:
            c = (c.astype(np.float64) * k + y.astype(np.float64)).astype(np.float32)
        else:
            c = (c * np.float32(k)).astype(np.float32) + y
        c = (c - np.float32(0.5)).astype(np.float32)
    return c


NN_KEY = jax.random.key(21)


def _nn_inputs(rng):
    """Ring inputs (B, H, T, D) = (2, 3, 12, 8): chunks of 4 over three ranks, 2 + 2 in the
    zigzag layout, H divisible by 3 for Ulysses; sequences of 12 (the ring) and 10 (ragged:
    gathered) for sdpa and MultiheadAttention; dropout inputs of 7 rows; BatchNorm and the
    losses on 7 rows (3, 3, 1)."""
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    out = {f"ring_{n}": f32(2, 3, 12, 8) for n in ("q", "k", "v", "g")}
    for tag, t in (("even", 12), ("ragged", 10)):
        out.update({f"seq_{tag}_{n}": f32(2, 2, t, 8) for n in "qkv"})
        out[f"seq_{tag}_x"] = f32(2, t, MHA_E)
    out.update(
        drop_key=np.asarray(jax.random.key_data(NN_KEY)),
        drop_x=f32(7, 5),
        drop_x4=f32(7, 3, 2, 2),
        bn_x2=f32(7, 5) * 3 + 1,
        bn_x4=f32(7, 3, 4, 4) * 2 - 1,
        loss_pred=f32(7, 4),
        loss_target=f32(7, 4),
        loss_prob=rng.uniform(0.02, 0.98, (7, 4)).astype(np.float32),
        loss_binary=(rng.random((7, 4)) < 0.5).astype(np.float32),
        loss_logits=f32(7, 4),
        loss_labels=rng.integers(0, 4, 7),
        loss_weight=rng.uniform(0.5, 2.0, 4).astype(np.float32),
        tr_src=f32(2, 12, 16),
        tr_tgt=f32(2, 9, 16),
    )
    # the data-parallel dropout step's batch, from a generator of its own so that the
    # inputs drawn after these stay as they were
    own = np.random.default_rng(23)
    out.update(dpdrop_x=own.standard_normal((7, 5, 8)).astype(np.float32),
               dpdrop_y=own.standard_normal((7, 5, 8)).astype(np.float32))
    tree = ht.nn.Transformer(**TRANSFORMER).init(jax.random.key(4))
    out.update({f"tr_param_{k}": v for k, v in _dotted(tree).items()})
    out.update({f"dpdrop_param_{k}": v for k, v in _dotted(_dp_dropout_params()).items()})
    return out


TRANSFORMER = dict(d_model=16, nhead=4, num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=32, dropout=0.0)
# the train-mode layer of the data-parallel dropout step (tests/_torch_dist_worker.py's)
DP_DROPOUT_LAYER = dict(d_model=8, nhead=2, dim_feedforward=16, dropout=0.1)


def _dp_dropout_params():
    return ht.nn.TransformerEncoderLayer(**DP_DROPOUT_LAYER).init(jax.random.key(9))


def _dotted(tree, prefix=""):
    """heat_tpu's parameter tree as {dotted path: numpy array}."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in _dotted(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _domain_inputs(rng):
    """The FFT inputs (7 rows: 3, 3, 1), sparse matrices of 7 and 2 rows (2: the third rank
    holds none), the flowers table cut to 148 rows (50, 50, 48) with weights and 31
    queries, and the sugar table with an intercept column (148, 148, 146)."""
    import heat_tpu_torch.datasets as data

    t = data.tables()
    sparse = lambda shape, density: (rng.standard_normal(shape) * (rng.random(shape) < density)).astype(np.float32)  # noqa: E731
    return {
        "fx": rng.standard_normal((7, 6)).astype(np.float32),
        "fcube": rng.standard_normal((5, 4, 6)).astype(np.float32),
        "sp_a": sparse((7, 5), 0.4),
        "sp_a_b": sparse((7, 5), 0.4),
        "sp_small": sparse((2, 5), 0.5),
        "sp_small_b": sparse((2, 5), 0.5),
        "flowers": t["flowers"][1:149],
        "flowers_y": t["flowers_labels"][1:149],
        "flowers_w": rng.uniform(0.1, 2.0, 148),
        "flowers_q": (t["flowers"][::5] + rng.normal(0, 0.2, (30, 4))).astype(np.float32)[:31],
        "sugar_x": np.hstack([np.ones((442, 1), np.float32), t["sugar_x"]]),
        "sugar_y": t["sugar_y"],
    }


def _cluster_inputs(rng):
    """heat_tpu's spherical datasets (its stream left as it was), and even-sized clusters
    with a NaN for KMedians."""
    from heat_tpu.utils.data.spherical import create_spherical_dataset

    state = ht.random.get_state()
    sph, small = create_spherical_dataset(100).numpy(), create_spherical_dataset(40).numpy()
    ht.random.set_state(state)
    med = np.concatenate([rng.normal(-5, 1, (40, 3)), rng.normal(5, 1, (36, 3))]).astype(np.float32)
    med[3, 1] = np.nan
    return {"sph": sph, "sph_small": small, "med_x": med, "med_init": np.array([[-4] * 3, [4] * 3], np.float32)}


def _linalg_inputs(rng):
    low = rng.standard_normal((16, 3)) @ rng.standard_normal((3, 31))
    noisy = rng.standard_normal((16, 5)) @ rng.standard_normal((5, 31)) + 1e-3 * rng.standard_normal((16, 31))
    return {
        "la_a": rng.standard_normal((7, 5)).astype(np.float32),  # every plan: 3, 3, 1 and 2, 2, 1
        "la_b": rng.standard_normal((5, 4)).astype(np.float32),
        "rs_x": rng.standard_normal((4, 7, 5)).astype(np.float32),  # 4 rows: 2, 2, 0
        "rs_bool": rng.standard_normal((4, 7, 5)) > 0,
        "c2_a": rng.standard_normal((10, 8)).astype(np.float32),  # config #2, ragged
        "c2_b": rng.standard_normal((8, 11)).astype(np.float32),
        "bt_a": rng.standard_normal((3, 6, 4)).astype(np.float32),
        "bt_b": rng.standard_normal((4, 5)).astype(np.float32),
        "v": rng.standard_normal(8).astype(np.float32),
        "hsvd_a": low.astype(np.float32),  # 31 columns: 11, 11, 9
        "hsvd_at": np.ascontiguousarray(low.T).astype(np.float32),
        "hsvd_noisy": noisy,
        "tall": rng.standard_normal((60, 4)).astype(np.float32),
        "cd_x": rng.standard_normal((7, 4)).astype(np.float32),
        "cd_y": rng.standard_normal((8, 4)).astype(np.float32),
        "cd_y2": rng.standard_normal((2, 4)).astype(np.float32),
        # integer products that wrap (int8 entries near 100, int32 near 2**20) and bool ones
        "la_i8_a": rng.integers(60, 128, (7, 5)).astype(np.int8),
        "la_i8_b": rng.integers(60, 128, (5, 4)).astype(np.int8),
        "la_i32_a": rng.integers(2**19, 2**21, (7, 5)).astype(np.int32),
        "la_i32_b": rng.integers(2**19, 2**21, (5, 4)).astype(np.int32),
        "la_bool_a": rng.standard_normal((7, 5)) > 0.8,
        "la_bool_b": rng.standard_normal((5, 4)) > 0.8,
        "v_i64": rng.integers(2**30, 2**31, 8).astype(np.int64) * 2**20,
        "v_bool": rng.standard_normal(8) > 1.0,
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of three gloo ranks."""
    inputs = _inputs()
    tmp = tmp_path_factory.mktemp("torch_dist")
    res = _spawn(tmp, WORLD, inputs)
    for r in (0, 1):  # the survivors of the supervised-restart case
        res[r]["sup"] = dict(np.load(tmp / f"sup{r}.npz"))
    return inputs, res


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """The sorting and selection cases' results, from one spawn of four gloo ranks."""
    return _spawn(tmp_path_factory.mktemp("torch_dist4"), 4, {})


def _spawn(tmp, world, inputs):
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(tmp / "rendezvous"), str(tmp / "inputs.npz"), str(tmp)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(world)
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
        # at world 3 the supervised-restart case, which runs last, kills rank 2 through
        # the peer-dead fault (exit status 43, resilience.PEER_DEAD_EXIT_STATUS)
        want = 43 if world == WORLD and r == 2 else 0
        assert p.returncode == want, f"rank {r} exited {p.returncode}:\n{log}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


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


def _without_nan_shards(data, fn, axis):
    """heat_tpu's split=0 min/max of ``data`` on three devices: the shards (3, 3, 1 rows)
    holding a NaN drop out, per column for ``axis=0`` (ROADMAP Queue 3, the reference's
    recorded difference from numpy)."""
    shards = np.split(data, [3, 6])
    if axis is None:
        return getattr(np, fn)(np.concatenate([s.ravel() for s in shards if not np.isnan(s).any()]))
    cols = data.reshape(7, -1)
    keep = [np.concatenate([s[:, c] for s in np.split(cols, [3, 6]) if not np.isnan(s[:, c]).any()])
            for c in range(cols.shape[1])]
    return np.array([getattr(np, fn)(k) for k in keep], dtype=data.dtype).reshape(data.shape[1:])


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("fn", ["min", "max"])
@pytest.mark.parametrize("name", list(NAN_CASES))
def test_split_min_max_propagate_nan(ranks, comm3, name, fn, axis):
    """min and max over the split axis give numpy's result, NaN where a NaN lies on any
    rank, as heat_tpu does at split=None; heat_tpu's split=0 result, which drops the
    shard holding a NaN, is pinned as the reference's own difference."""
    inputs, res = ranks
    data = inputs[name]
    want = getattr(np, fn)(data, axis=axis)
    assert np.isnan(want).any()
    unsplit = getattr(ht, fn)(ht.array(data, split=None, comm=comm3), axis=axis).numpy()
    np.testing.assert_array_equal(unsplit, want)
    for r in res:
        np.testing.assert_array_equal(r[f"{name}_{fn}_{axis}"], want)
    split = getattr(ht, fn)(ht.array(data, split=0, comm=comm3), axis=axis).numpy()
    np.testing.assert_array_equal(split, _without_nan_shards(data, fn, axis))
    assert not np.isnan(split).any()


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
        # one all_reduce per Lloyd pass plus the final assignment, each of the packed
        # k*d + k + 1 record; the host reads the loop's flag every CHECK_EVERY passes, so
        # the loop runs on to the next multiple of it after converging
        passes = min(50, -(-km.n_iter_ // CHECK_EVERY) * CHECK_EVERY)
        assert r["km_allreduce_shapes"].tolist() == [[3 * 4 + 3 + 1]] * (passes + 1)


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


def test_mha_sequence_split_raises(ranks, comm3):
    """A sequence split of 5 over three ranks (not the ring's equal chunks) no longer
    raises: it is computed whole, keeps the split and matches heat_tpu."""
    inputs, res = ranks
    mha = ht.nn.MultiheadAttention(MHA_E, MHA_H)
    params = {k: jnp.asarray(v) for k, v in _mha_params().items()}
    want = mha.apply(params, ht.array(inputs["mha_x"], split=1, comm=comm3))
    for r in res:
        assert list(r["mha_seq_split_meta"]) == ["1", str(want.gshape)] and want.split == 1
        np.testing.assert_allclose(r["mha_seq_split"], want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("batch", [7, 2])
def test_data_parallel_step_matches_heat_tpu(ranks, comm3, batch):
    """One DataParallelOptimizer step on a batch split 3, 3, 1 (B = 7) and 1, 1, 0 (B = 2:
    rank 2 holds no rows and runs no forward): the global loss and the updated parameters
    equal heat_tpu's step on its three-device mesh on every rank, after one packed
    all-reduce; the ranks started from unequal parameters, made equal by the broadcast
    of rank 0's."""
    inputs, res = ranks
    model = _JaxMLP()
    model.params = {m: {k: jnp.asarray(v) for k, v in sub.items()} for m, sub in _nested_mlp_params().items()}
    opt = ht.optim.DataParallelOptimizer("sgd", lr=DP_LR)
    ht.nn.DataParallel(model, comm=comm3, optimizer=opt)
    crit = ht.nn.CrossEntropyLoss()
    x = ht.array(inputs[f"dp_x{batch}"], split=0, comm=comm3)
    y = ht.array(inputs[f"dp_y{batch}"], split=0, comm=comm3)
    loss = opt.step(lambda params, xb, yb: crit(model.apply(params, xb), yb), x, y)
    lmap = comm3.lshape_map((batch, 4), 0)
    for rank, r in enumerate(res):
        assert int(r[f"dp{batch}_rows"]) == lmap[rank, 0]
        assert int(r[f"dp{batch}_packed_calls"]) == 1  # one collective for the step
        # fp32 on both sides, summed in another order
        np.testing.assert_allclose(float(r[f"dp{batch}_loss"]), float(loss), rtol=1e-6, atol=1e-6)
        for m, sub in model.params.items():
            for k, v in sub.items():
                want = np.asarray(v).T if k == "weight" else np.asarray(v)
                np.testing.assert_allclose(r[f"dp{batch}_param_{m}.{k}"], want, rtol=1e-5, atol=1e-6)
    assert lmap[2, 0] == (1 if batch == 7 else 0)



# ---------------------------------------------------------------- linear algebra
KNOBS = ("auto", "xla", "ring", "rs")
PAIRS = [(sa, sb) for sa in (None, 0, 1) for sb in (None, 0, 1)]


@pytest.fixture
def jknob(monkeypatch):
    """``HEAT_TPU_LINALG_PLAN`` for heat_tpu, which memoises it; its executor compiles at
    the first sighting, so a ring or rs plan runs as planned (the suite's threshold of 2
    would send a first sighting to the XLA plan)."""

    def set_(value):
        monkeypatch.setenv("HEAT_TPU_LINALG_PLAN", value)
        monkeypatch.setenv("HEAT_TPU_JIT_THRESHOLD", "1")
        _executor.reload_env_knobs()

    yield set_
    monkeypatch.undo()
    _executor.reload_env_knobs()


def _rec(r, key):
    prefix = key + "__"
    return {k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}


def _f32_atol(want):
    return 1e-5 * max(np.abs(np.asarray(want.numpy(), np.float64)).max(), 1.0)


@pytest.mark.parametrize("pair", PAIRS, ids=str)
@pytest.mark.parametrize("knob", KNOBS)
def test_matmul_plans_match_heat_tpu(ranks, comm3, jknob, knob, pair):
    """Every split pair under every knob value: the port's Plan equals heat_tpu's, and the
    product (ring rA/rB/rC, rs s10/sN0/s1N, or the general path) equals heat_tpu's in
    values, dtype, split and lshape map; the executed plan is counted."""
    inputs, res = ranks
    jknob(knob)
    sa, sb = pair
    a = ht.array(inputs["la_a"], split=sa, comm=comm3)
    b = ht.array(inputs["la_b"], split=sb, comm=comm3)
    plan = jplan.plan_matmul(a, b)
    want = ht.matmul(a, b)
    for r in res:
        assert str(r[f"plan_{knob}_{sa}_{sb}"]) == ("None" if plan is None else repr(tuple(plan)))
        assert_record_equal(_rec(r, f"mm_{knob}_{sa}_{sb}"), want, rtol=0, atol=_f32_atol(want))
        counted = str(r[f"mm_{knob}_{sa}_{sb}_counted"])
        assert (plan is None) == (counted == "[]")
        if plan is not None:
            assert f"('linalg.plan.{plan.kind}', 1)" in counted
            assert f"('linalg.bytes.{plan.kind}', {plan.nbytes})" in counted
    if knob == "rs" and pair in ((1, 0), (None, 0), (1, None)):
        assert plan.kind == "rs" and want.split == 0
    if knob in ("auto", "ring") and pair in ((0, 0), (1, 1), (0, 1)):
        assert plan.kind == "ring"


INT_DTYPES = ("i8", "i32", "bool")


@pytest.mark.parametrize("dt", INT_DTYPES)
@pytest.mark.parametrize("pair", PAIRS, ids=str)
@pytest.mark.parametrize("knob", KNOBS)
def test_int_matmul_plans_match_heat_tpu(ranks, comm3, jknob, knob, pair, dt):
    """Integer and bool products under every knob value and split pair, through the ring,
    rs and general paths (each product by the integer kernel's plain version on the CPU):
    exactly heat_tpu's, wrapping modulo 2^bits, bool the OR of ANDs; the plan executed is
    heat_tpu's (bool is never planned)."""
    inputs, res = ranks
    jknob(knob)
    sa, sb = pair
    a = ht.array(inputs[f"la_{dt}_a"], split=sa, comm=comm3)
    b = ht.array(inputs[f"la_{dt}_b"], split=sb, comm=comm3)
    plan = jplan.plan_matmul(a, b)
    want = ht.matmul(a, b)
    for r in res:
        assert_record_equal(_rec(r, f"imm_{knob}_{dt}_{sa}_{sb}"), want, rtol=0)
        counted = str(r[f"imm_{knob}_{dt}_{sa}_{sb}_counted"])
        assert (plan is None) == (counted == "[]")
        if plan is not None:
            assert f"('linalg.plan.{plan.kind}', 1)" in counted
    if dt == "bool":
        assert plan is None


@pytest.mark.parametrize("dt", ["i64", "bool"])
def test_int_dot_split(ranks, comm3, dt):
    """The 1-D dot of two split integer or bool vectors: partial dots all-reduced, exact."""
    inputs, res = ranks
    v = inputs[f"v_{dt}"]
    want = ht.dot(ht.array(v, split=0, comm=comm3), ht.array(v, split=0, comm=comm3))
    for r in res:
        assert_record_equal(_rec(r, f"idot_{dt}"), want, rtol=0)


def test_failing_ring_plan_raises(ranks):
    """A ring plan whose ring_shift fails raises on every rank; nothing falls back."""
    _, res = ranks
    for r in res:
        assert str(r["ring_failure"]) == "ring_shift failed"


@pytest.mark.parametrize("dst", [None, 0, 1, 2])
@pytest.mark.parametrize("src", [None, 0, 1, 2])
@pytest.mark.parametrize("data", ["rs_x", "rs_bool"])
@pytest.mark.parametrize("knob", ["auto", "xla"])
def test_resplit_every_pair(ranks, comm3, knob, data, src, dst):
    """resplit_ between every pair of splits of a (4, 7, 5) array (rank 2 holds no rows
    along axis 0) equals heat_tpu's; split→split moves by one all-to-all and gathers
    nothing, except under ``HEAT_TPU_LINALG_PLAN=xla``."""
    inputs, res = ranks
    want = ht.array(inputs[data], split=src, comm=comm3).resplit_(dst)
    for r in res:
        assert_record_equal(_rec(r, f"resplit_{knob}_{data}_{src}_{dst}"), want, rtol=0)
        gathers = int(r[f"resplit_{knob}_{data}_{src}_{dst}_gathers"])
        if src is not None and dst is not None and src != dst:
            assert gathers == (0 if knob == "auto" else 1)
        elif dst is not None:
            assert gathers == 0  # None→split keeps the rank's chunk
    if data == "rs_x" and dst == 0:
        assert comm3.lshape_map((4, 7, 5), 0)[2, 0] == 0


def test_collectives_with_an_empty_rank(ranks):
    """ring_shift both ways, all_to_all and reduce_scatter (even and ragged) where rank 2
    holds no rows."""
    inputs, res = ranks
    x = inputs["rs_x"]
    chunks = np.split(x, [2, 4])  # 2, 2, 0 rows
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["ring_shift_empty"], chunks[(rank - 1) % WORLD])
        np.testing.assert_array_equal(r["ring_shift_back"], chunks[(rank + 1) % WORLD])
        np.testing.assert_array_equal(r["a2a_empty"], np.split(x, [2, 4], axis=2)[rank])
        for n in (4, 6):
            total = np.arange(n * 3, dtype=np.float32).reshape(n, 3) * 6
            c = -(-n // WORLD)
            np.testing.assert_array_equal(r[f"reduce_scatter_{n}"], total[rank * c : (rank + 1) * c])


def test_config2_matmul_ragged(ranks, comm3):
    """North-star config #2 at small size: split-0 × split-1 f32 on ragged chunks, by the
    ring (rC), against heat_tpu's three-device product."""
    inputs, res = ranks
    want = ht.matmul(ht.array(inputs["c2_a"], split=0, comm=comm3), ht.array(inputs["c2_b"], split=1, comm=comm3))
    for r in res:
        assert_record_equal(_rec(r, "config2"), want, rtol=0, atol=_f32_atol(want))
        assert "('linalg.plan.ring', 1)" in str(r["config2_counted"])


@pytest.mark.parametrize("key", ["matmul_batch", "matmul_batch_contract", "dot_split"])
def test_general_products(ranks, comm3, key):
    """The general path: a batch split, a contraction-dim split all-reduced, a split dot."""
    inputs, res = ranks
    a, b, v = (inputs[k] for k in ("bt_a", "bt_b", "v"))
    want = {
        "matmul_batch": lambda: ht.matmul(ht.array(a, split=0, comm=comm3), ht.array(b, comm=comm3)),
        "matmul_batch_contract": lambda: ht.matmul(ht.array(a, split=2, comm=comm3), ht.array(b, split=0, comm=comm3)),
        "dot_split": lambda: ht.dot(ht.array(v, split=0, comm=comm3), ht.array(v, split=0, comm=comm3)),
    }[key]()
    for r in res:
        assert_record_equal(_rec(r, key), want, rtol=0, atol=_f32_atol(want))


def _subspace(u):
    u = np.asarray(u, np.float64)
    return u @ u.T


@pytest.mark.parametrize("name,split", [("hsvd_a", 1), ("hsvd_at", 0)])
def test_hsvd_rank_ragged(ranks, comm3, name, split):
    """hsvd_rank of a rank-3 matrix on column blocks of 11, 11 and 9 (and of its transpose
    split 0): U's subspace, σ and V against heat_tpu's three-device tree; every rank holds
    the same bits."""
    inputs, res = ranks
    A = ht.array(inputs[name], split=split, comm=comm3)
    jU, jerr = ht.linalg.hsvd_rank(A, 3)
    _, js, jV, _ = ht.linalg.hsvd_rank(A, 3, compute_sv=True)
    for r in res:
        U = _rec(r, f"{name}_U")
        assert U["gshape"].tolist() == list(jU.gshape) and int(U["split"]) == (-1 if jU.split is None else jU.split)
        np.testing.assert_allclose(_subspace(U["value"]), _subspace(jU.numpy()), atol=1e-5)
        err = float(_rec(r, f"{name}_err")["value"])
        assert err < 1e-5 and float(jerr.item()) < 1e-5
        np.testing.assert_allclose(_rec(r, f"{name}_sv_sigma")["value"], js.numpy(), rtol=1e-5)
        np.testing.assert_allclose(_subspace(_rec(r, f"{name}_sv_V")["value"]), _subspace(jV.numpy()), atol=1e-5)
        assert_record_equal(_rec(r, f"{name}_sv_sigma"), js, rtol=1e-5)
        np.testing.assert_array_equal(U["value"], _rec(res[0], f"{name}_U")["value"])


def test_hsvd_rtol_ragged(ranks, comm3):
    """hsvd_rtol of a noisy rank-5 matrix in f64: the rank, subspace and error estimate of
    heat_tpu's three-device tree."""
    inputs, res = ranks
    jU, jerr = ht.linalg.hsvd_rtol(ht.array(inputs["hsvd_noisy"], split=1, comm=comm3), 1e-2)
    for r in res:
        U = _rec(r, "hsvd_rtol_U")
        assert U["gshape"].tolist() == list(jU.gshape)
        np.testing.assert_allclose(_subspace(U["value"]), _subspace(jU.numpy()), atol=1e-10)
        np.testing.assert_allclose(float(_rec(r, "hsvd_rtol_err")["value"]), float(jerr.item()), rtol=1e-10)


def _signs_like(x, ref, axis):
    s = np.sign(np.sum(x * ref, axis=1 - axis, keepdims=True))
    s[s == 0] = 1
    return x * (s if axis == 0 else s.reshape(1, -1))


def test_tsqr_and_svd(ranks, comm3):
    """TSQR of a 60 × 4 split-0 matrix (two panels a rank) and the SVD on it: R's rows and
    Q's and U's columns up to signs, σ, splits and lshape maps as heat_tpu's."""
    inputs, res = ranks
    a = ht.array(inputs["tall"], split=0, comm=comm3)
    q, r_ = ht.linalg.qr(a)
    u, s, _ = ht.linalg.svd(a)
    for r in res:
        for key, want, axis in (("tsqr_Q", q, 1), ("tsqr_R", r_, 0), ("tsvd_U", u, 1)):
            got = _rec(r, key)
            got["value"] = _signs_like(got["value"], want.numpy(), axis)
            assert_record_equal(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want.numpy()).max()))
        assert_record_equal(_rec(r, "tsvd_S"), s, rtol=1e-5)


@pytest.mark.parametrize("name", ["cd_y", "cd_y2", "self"])
def test_ring_cdist(ranks, comm3, name):
    """cdist of two row-split arrays by the ring over ``ring_shift`` (Y of 8 rows: 3, 3,
    2; of 2 rows: 1, 1, 0; and Y = X) against heat_tpu's, in split and lshape map, and in
    squared distances within 1e-5 of |x|² + |y|² (the quadratic expansion's rounding,
    which the square root magnifies near zero)."""
    inputs, res = ranks
    x = inputs["cd_x"]
    y = x if name == "self" else inputs[f"{name}"]
    X = ht.array(x, split=0, comm=comm3)
    want = ht.spatial.cdist(X) if name == "self" else ht.spatial.cdist(X, ht.array(y, split=0, comm=comm3))
    scale = 1e-5 * ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :])
    for r in res:
        got = _rec(r, f"cdist_{name}")
        assert_record_equal(got, want, rtol=0, atol=np.inf)
        assert np.all(np.abs(got["value"] ** 2 - want.numpy() ** 2) <= scale)


# ---------------------------------------------------------------- the array API
from _torch_array_cases import AT_NONE, CASES, INPUTS, Arrays, rtol_of, splits_of  # noqa: E402

from heat_tpu_torch.testing import tpu_record  # noqa: E402

ARRAY_CASES = [(name, split) for name in CASES for split in splits_of(name)]


@pytest.mark.parametrize("name,split", ARRAY_CASES, ids=[f"{n}-{s}" for n, s in ARRAY_CASES])
def test_array_api_matches_heat_tpu(ranks, comm3, name, split):
    """Every array-API case (tests/_torch_array_cases.py) on three gloo ranks against
    heat_tpu's three-device mesh: values, dtype, gshape, split and lshape map, exact but
    for the cases in FLOAT and TOLERANCES (``rtol_of``); the cases in AT_NONE against
    heat_tpu's split=None answer, whose split layouts differ from it."""
    _, res = ranks
    previous = ht.get_comm()
    ht.use_comm(comm3)  # heat_tpu's KMeans draws its init on the default communicator
    try:
        want = CASES[name](ht, Arrays(ht, comm=comm3), None if name in AT_NONE else split)
    finally:
        ht.use_comm(previous)
    want = want if isinstance(want, tuple) else (want,)
    for r in res:
        assert f"case_{name}_{split}_error" not in r, str(r.get(f"case_{name}_{split}_error"))
        for i, w in enumerate(want):
            if name in AT_NONE:  # heat_tpu's split=None answer: values, dtype, gshape
                w = {k: v for k, v in tpu_record(w).items() if k in ("value", "dtype", "gshape")}
            assert_record_equal(_rec(r, f"case_{name}_{split}_{i}"), w, rtol=rtol_of(name), what=name)


REDISTRIBUTE_PAIRS = [([3, 3, 1], [0, 7, 0]), ([0, 7, 0], [2, 2, 3]), ([1, 0, 6], [5, 2, 0]), ([7, 0, 0], [0, 0, 7])]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("pair", range(len(REDISTRIBUTE_PAIRS)))
def test_redistribute_arbitrary_counts(ranks, pair, axis):
    """TorchCommunication.redistribute between arbitrary chunkings (empty ranks included):
    each rank receives exactly the slices of its destination range."""
    _, res = ranks
    src, dst = REDISTRIBUTE_PAIRS[pair]
    data = np.arange(21.0).reshape(7, 3) if axis == 0 else np.arange(28).reshape(4, 7)
    for rank, r in enumerate(res):
        lo = sum(dst[:rank])
        np.testing.assert_array_equal(r[f"redistribute_{pair}_{axis}"], np.take(data, range(lo, lo + dst[rank]), axis=axis))


@pytest.mark.parametrize("name,h", [("small", 1), ("a", 2)])
def test_halos(ranks, name, h):
    """get_halo: the h rows before and after each rank's chunk, from whichever ranks hold
    them, as heat_tpu's global slices (an empty last rank gets the rows before its
    offset and none after)."""
    _, res = ranks
    data = INPUTS[name]
    n = data.shape[0]
    c = -(-n // WORLD)
    for rank, r in enumerate(res):
        start, end = min(rank * c, n), min((rank + 1) * c, n)
        prev = data[max(start - h, 0):start] if start > 0 else None
        nxt = data[end:min(end + h, n)] if end < n else None
        for side, want in (("prev", prev), ("next", nxt)):
            got = r[f"halo_{name}_{side}"]
            if want is None:
                assert got.size == 0
            else:
                np.testing.assert_array_equal(got, want)


def test_is_split_non_canonical(ranks, comm3):
    """is_split with chunks of 1, 5 and 1 rows is rebalanced to the canonical 3, 3, 1."""
    _, res = ranks
    want = ht.array(INPUTS["a"], split=0, comm=comm3)
    for r in res:
        assert_record_equal(_rec(r, "is_split"), want, rtol=0)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_duplicate_keys_keep_the_last_write(ranks, comm3, split):
    """Integer keys that write one element two or three times with different values (a
    column twice, a row as 2, −5 and 2 of 7) keep the last write at three ranks, as the
    whole array's assignment does on the CPU and as heat_tpu's does on its three-device mesh
    (on CUDA torch leaves the winner undefined)."""
    _, res = ranks
    want = ht.array(INPUTS["a"], split=split, comm=comm3)
    want[:, [-1, 0, 0]] = ht.array(INPUTS["a"][:, 0:3], comm=comm3)
    want[[2, -5, 2]] = ht.array(INPUTS["a"][4:7], comm=comm3)
    for r in res:
        assert_record_equal(_rec(r, f"dup_set_{split}"), want, rtol=0)


@pytest.mark.parametrize("dtype,ulps", [("float32", 4), ("float64", 32)])
def test_normal_stream(ranks, comm3, dtype, ulps):
    """randn on three ranks against heat_tpu's on three devices: within 4 ulp in float32
    and 32 in float64 (the inverse error function's logarithm is torch's); the state
    advances as heat_tpu's."""
    _, res = ranks
    ht.random.seed(11)
    want = ht.random.randn(7, 5, dtype=getattr(ht, dtype), split=0, comm=comm3)
    w = want.numpy()
    for r in res:
        got = _rec(r, f"randn_{dtype}")
        assert_record_equal(got, want, rtol=0, atol=np.inf)
        assert np.all(np.abs(got["value"] - w) <= ulps * np.spacing(np.abs(w)))
        assert r[f"randn_{dtype}_state"].tolist() == list(ht.random.get_state()[1:3])


NO_GATHER = ["reshape_new_split", "reshape_flat", "concatenate_1_none_1", "resplit", "sort", "sort_desc", "topk",
             "unique", "percentile", "median", "slice", "slice_neg", "mask", "setitem", "flip", "cumsum", "diff",
             "nonzero", "nonzero_split1", "row_take", "permutation", "convolve", "print"]

# the split-axis forms, and what the moves (redistribute, take, fetch, ring_shift, all_to_all,
# exchange) may hand a rank beside L, its share of the result in bytes, from P ranks and the
# result's bytes R: nothing for the forms that fetch only their share (a roll's two ranges,
# tile's and the copy pads' source rows, diag's and a vector triangle's elements, the
# integer keys' elements) or move nothing (the triangles, trace, vdot of one layout, the
# norms, cov with the observations split, the assignments)
MOVED = {name: lambda P, L, R: L for name in (
    "roll_0", "roll_1", "roll_flat_0", "tile_0", "tile_1", "pad_reflect_0", "pad_wrap_1", "pad_mean_0",
    "pad_maximum_1", "diagonal_0", "diagonal_1", "diag_0", "trace_0", "trace_1", "trace_batch_2", "tril_0", "triu_1",
    "tril_vec_0", "vdot_0", "vector_norm_1_0", "vector_norm_inf_1", "matrix_norm_1_0", "matrix_norm_ninf_1",
    "matrix_norm_fro_1", "norm_batch_0", "cov_obs_1", "cov_obs_0", "get_int_keys_0", "get_int_keys_cols_0",
    "get_int_keys_1", "set_int_keys_0", "set_int_keys_1")}
MOVED.update({
    # a flat roll of split 1: the relayout to split 0 and the roll there each hand a rank a
    # split-0 chunk of "a" (at most 3 of its 7 rows), then the relayout back its share
    "roll_flat_1": lambda P, L, R: L + 2 * (3 * R // 7),
    # linear_ramp: the two edge planes along the split axis (of the 9 padded columns)
    "pad_linear_ramp_1": lambda P, L, R: L + 2 * (R // 9),
    # median: the distributed sort's P rounds of a chunk (at most 3 rows of 5 float32 values
    # and their int64 indices), then the two middle planes (5 float32)
    "pad_median_0": lambda P, L, R: L + P * 3 * 5 * (4 + 8) + 2 * 5 * 4,
    # vdot of two layouts: the second operand's split-0 chunk (3 of 7 rows of 5 int32)
    "vdot_0_1": lambda P, L, R: L + 3 * 5 * 4,
    # cov with the variables split: the other ranks' centred blocks around the ring (at most
    # 3 of 7 rows of 5 float32 each), and with y first the joined variables' chunk (4 of 10
    # rows of 7 float32, by concatenate)
    "cov_vars_0": lambda P, L, R: L + (P - 1) * 3 * 5 * 4,
    "cov_vars_1_y": lambda P, L, R: L + P * 4 * 7 * 4,
})
NO_GATHER += list(MOVED)

# what the small gathers may bring a rank beside the counts, by design, from P ranks and
# the result's bytes R: topk's P·k candidates (a float32 value and an int64 index each,
# k = 5), cumsum's exscan of one plane of totals a rank (5 float32), convolve's two
# halos of m - 1 = 2 float64 a rank, and the selection of the mask, unique and nonzero
# along axis 1 (each rank's piece padded to the largest: at most P·R; nonzero sends the
# flat and the 2-D indices, 1.5·P·R); every other function gathers counts alone
SMALL_GATHERS = {"topk": lambda P, R: P * 5 * (4 + 8), "cumsum": lambda P, R: P * 5 * 4,
                 "convolve": lambda P, R: 2 * P * 2 * 8, "mask": lambda P, R: P * R, "unique": lambda P, R: P * R,
                 "nonzero_split1": lambda P, R: 3 * P * R // 2,
                 # the hits of each of the mask's 7 rows a rank, and the P·P request counts
                 "set_mask_split_value": lambda P, R: P * 7 * 8 + P * P * 8,
                 # the pieces of a result whole on every rank, each padded to the largest
                 # (at most P·R): the diagonals' pieces, a batch split's norms, cov's block rows
                 **{n: lambda P, R: P * R for n in ("diagonal_0", "diagonal_1", "norm_batch_0", "cov_vars_0",
                                                    "cov_vars_1_y")}}


@pytest.mark.parametrize("name", NO_GATHER)
def test_no_whole_array_gather(ranks, name):
    """The benchmark's paths and the split-axis forms run on split arrays with
    TorchCommunication.all_gather (the whole-array gather) made to raise, and what the small
    gathers bring a rank is counted: at most four gathers of one count a rank, and beside
    them only candidates, halos, totals or the result's own selection (SMALL_GATHERS), never
    the array. For the split-axis forms the moves are counted too: a rank's share of the
    result and what the form needs beside it (MOVED)."""
    _, res = ranks
    P = len(res)
    for r in res:
        assert str(r[f"no_gather_{name}"]) == "ok"
        counts, rest, result, moved, local = r[f"no_gather_{name}_bytes"].tolist()
        assert counts <= 4 * P * 8
        assert rest <= SMALL_GATHERS.get(name, lambda P, R: 0)(P, result)
        if name in MOVED:
            assert moved <= MOVED[name](P, local, result), (moved, local, result)


SORT_CASES = [(n, s) for n in ("sort0", "sort1", "sort_ties", "sort_ties_desc", "sort_ties2d", "sort_ints",
                               "sort_small", "topk", "topk_small", "topk_ties", "unique", "unique_inverse",
                               "unique_ties", "percentile", "percentile_axis0", "percentile_nan", "median",
                               "median_all", "reshape_new_split1", "concatenate1", "get_neg_step", "get_mask", "rand",
                               "randint", "randperm", "permutation", "kmeans_random", "edge_sort_complex",
                               "edge_sort_complex_nan", "edge_unique_complex") for s in splits_of(n)]


@pytest.fixture(scope="module")
def comm4():
    """heat_tpu's communicator over four devices of the test mesh."""
    return MeshCommunication(jax.devices()[:4])


@pytest.mark.parametrize("name,split", SORT_CASES, ids=[f"{n}-{s}" for n, s in SORT_CASES])
def test_sorting_at_four_ranks(ranks4, comm4, name, split):
    """At four ranks the distributed sort takes Batcher's bitonic network: the sorting,
    selection and random cases against heat_tpu's four-device mesh."""
    assert [tuple(r["world"]) for r in ranks4] == [(4, i) for i in range(4)]
    previous = ht.get_comm()
    ht.use_comm(comm4)
    try:
        want = CASES[name](ht, Arrays(ht, comm=comm4), split)
    finally:
        ht.use_comm(previous)
    want = want if isinstance(want, tuple) else (want,)
    for r in ranks4:
        for i, w in enumerate(want):
            assert_record_equal(_rec(r, f"case_{name}_{split}_{i}"), w, rtol=rtol_of(name), what=name)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_printing_at_three_ranks(ranks, comm3, split):
    """A large split array prints from its edge items as heat_tpu's does on three
    devices, a small one whole."""
    _, res = ranks
    big = np.arange(40 * 50, dtype=np.float32).reshape(40, 50) / 7
    for key, data in ((f"print_{split}", big), (f"print_small_{split}", INPUTS["a"])):
        want = str(ht.array(data, split=split, comm=comm3))
        want = want[: want.rindex(", dtype=")]
        for r in res:
            got = str(r[key])
            assert got[: got.rindex(", dtype=")] == want


# ---------------------------------------------------------------- clustering
from _torch_dist_worker import CLUSTER_FITS, SPECTRAL, SPECTRAL_SEED  # noqa: E402

SPLIT_PAIRS = [(xs, ys) for xs in (None, 0, 1) for ys in (None, 0)]


@pytest.mark.parametrize("xs,ys", SPLIT_PAIRS)
def test_manhattan_and_rbf_at_three_ranks(ranks, comm3, xs, ys):
    """manhattan within 1e-5 and rbf within 1e-4 (1e-6 absolute) of heat_tpu's, with its
    split and lshape map, at every split pair (both row-split: the ring)."""
    inputs, res = ranks
    X, Y = ht.array(inputs["cd_x"], split=xs, comm=comm3), ht.array(inputs["cd_y"], split=ys, comm=comm3)
    for r in res:
        assert_record_equal(_rec(r, f"manhattan_{xs}_{ys}"), ht.spatial.manhattan(X, Y), rtol=1e-5)
        assert_record_equal(_rec(r, f"rbf_{xs}_{ys}"), ht.spatial.rbf(X, Y, sigma=1.5), rtol=1e-4, atol=1e-6)
        if ys is None:
            assert_record_equal(_rec(r, f"manhattan_self_{xs}"), ht.spatial.manhattan(X), rtol=1e-5)


def test_spherical_dataset_at_three_ranks(ranks, comm3):
    """Drawn on three ranks: heat_tpu's balls within 1e-5 (normal draws within 4 ulp)."""
    inputs, res = ranks
    for r in res:
        got = _rec(r, "spherical")
        np.testing.assert_allclose(got["value"], inputs["sph"], rtol=0, atol=1e-5)
        assert got["gshape"].tolist() == [400, 3] and int(got["split"]) == 0
        assert got["lshape_map"].tolist() == comm3.lshape_map((400, 3), 0).tolist()


def _check_fit(r, key, theirs, x):
    assert int(r[f"{key}_n_iter"]) == theirs.n_iter_
    np.testing.assert_array_equal(r[f"{key}_labels"], theirs.labels_.numpy())
    want = theirs.cluster_centers_.numpy()
    np.testing.assert_allclose(r[f"{key}_centers"], want, rtol=1e-5, atol=1e-5 * max(1.0, np.nanmax(np.abs(want))))
    if hasattr(theirs, "inertia_"):
        np.testing.assert_allclose(float(r[f"{key}_inertia"]), theirs.inertia_, rtol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(r[f"{key}_predict"], theirs.predict(x).numpy())


@pytest.mark.parametrize("name", list(CLUSTER_FITS))
def test_cluster_fits_at_three_ranks(ranks, comm3, name):
    """Every estimator on heat_tpu's spherical dataset, row-split 134, 134, 132 (the ++
    seeding's scan and draws across ranks, the distributed medians and medoids, a
    batch-parallel block a rank and the merge tree) against heat_tpu's fit on its
    three-device mesh: labels, n_iter and predict equal, centers within 1e-5, inertia
    within 1e-5 relative."""
    inputs, res = ranks
    cls, kw = CLUSTER_FITS[name]
    x = ht.array(inputs["sph"], split=0, comm=comm3)
    theirs = getattr(ht.cluster, cls)(**kw).fit(x)
    for r in res:
        _check_fit(r, name, theirs, x)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kmedians_nan_at_three_ranks(ranks, comm3, dtype):
    """Even-sized clusters (midpoint, not the lower middle) and a NaN: float32 by the
    distributed sort of the (cluster, value) keys, float64 by one sort a cluster."""
    inputs, res = ranks
    key = "kmedians_nan" if dtype == "float32" else "kmedians_nan_f64"
    x = ht.array(inputs["med_x"].astype(dtype), split=0, comm=comm3)
    init = ht.array(inputs["med_init"].astype(dtype), comm=comm3)
    theirs = ht.cluster.KMedians(n_clusters=2, init=init, max_iter=10).fit(x)
    for r in res:
        _check_fit(r, key, theirs, x)
        np.testing.assert_array_equal(r[f"{key}_centers"], theirs.cluster_centers_.numpy())
        assert r[f"{key}_centers"].dtype == np.dtype(dtype)


@pytest.mark.parametrize("definition", ["simple", "norm_sym"])
def test_laplacian_at_three_ranks(ranks, comm3, definition):
    inputs, res = ranks
    lap = ht.graph.Laplacian(lambda a: ht.spatial.rbf(a, sigma=1.5), definition=definition, mode="eNeighbour",
                             threshold_key="lower", threshold_value=0.2)
    want = lap.construct(ht.array(inputs["cd_x"], split=0, comm=comm3))
    for r in res:
        assert_record_equal(_rec(r, f"laplacian_{definition}"), want, rtol=1e-5, atol=1e-6)


def test_spectral_at_three_ranks(ranks, comm3):
    """Spectral on a row-split similarity (Lanczos by rows, one gather of the product
    vector a step): labels equal, eigenvalues within 1e-4."""
    inputs, res = ranks
    x = ht.array(inputs["sph_small"], split=0, comm=comm3)
    previous = ht.get_comm()
    ht.use_comm(comm3)
    try:
        ht.random.seed(SPECTRAL_SEED)
        theirs = ht.cluster.Spectral(**SPECTRAL).fit(x)
        evals = theirs._spectral_embedding(x)[0].numpy()
    finally:
        ht.use_comm(previous)
    for r in res:
        np.testing.assert_array_equal(r["spectral_labels"], theirs.labels_.numpy())
        np.testing.assert_allclose(r["spectral_eigenvalues"], evals, atol=1e-4)


# what the fits' small gathers may bring a rank beside one count a gather: the merge's
# P·k·d float32 centers, or Lanczos' product vector each step (P·ceil(n/P) float64, m of
# them) and the degree vector
FIT_GATHERS = {
    "kmeans_bp_init": lambda P: P * 4 * 3 * 4,
    "bp_kmeans": lambda P: P * 4 * 3 * 4,
    "bp_kmedians": lambda P: P * 4 * 3 * 4,
    "spectral": lambda P: (SPECTRAL["n_lanczos"] + 1) * P * -(-160 // P) * 8,
}


@pytest.mark.parametrize("name", list(CLUSTER_FITS) + ["spectral"])
def test_no_whole_array_gather_in_fits(ranks, name):
    """Each fit on three ranks with TorchCommunication.all_gather made to raise: the ++
    seeding gathers one total a rank a step, the merge the ranks' centers, Lanczos its
    product vector, never the array."""
    _, res = ranks
    P = len(res)
    for r in res:
        assert str(r[f"no_gather_fit_{name}"]) == "ok"
        counts, rest = r[f"no_gather_fit_{name}_bytes"].tolist()
        assert counts <= 4 * P * 8
        assert rest <= FIT_GATHERS.get(name, lambda P: 0)(P)


# ---------------------------------------------------------------- the L7 estimators, fft, sparse

FFT_CASES = {
    "fft_split_axis": ("fft", dict(axis=0), "fx", 0),
    "fft_other_axis": ("fft", dict(axis=1), "fx", 0),
    "ifft_split_axis_n": ("ifft", dict(axis=1, n=9), "fx", 1),
    "rfft_split_axis": ("rfft", dict(axis=0), "fx", 0),
    "irfft_split_axis": ("irfft", dict(axis=1), "fx", 1),
    "fft2_all_axes": ("fft2", dict(), "fx", 0),
    "rfftn_all_axes": ("rfftn", dict(), "fcube", 1),
    "fftn_pencil": ("fftn", dict(axes=(0, 2)), "fcube", 0),
    "ihfftn_pencil": ("ihfftn", dict(axes=(1, 2)), "fcube", 1),
    "hfft2_pencil": ("hfft2", dict(axes=(0, 1)), "fcube", 0),
    "fftshift_split_axis": ("fftshift", dict(axes=0), "fx", 0),
    "ifftshift_all": ("ifftshift", dict(), "fcube", 1),
}


def _scaled(want) -> float:
    w = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    return float(np.abs(w).max()) if w.size else 0.0


@pytest.mark.parametrize("key", list(FFT_CASES))
def test_fft_at_three_ranks(ranks, comm3, key):
    """The pencil transforms along the split axis (7 rows: 3, 3, 1; a rank without any
    along axis 1 of the cube), those along other axes, and the shifts of the split axis
    against heat_tpu's three-device mesh: values within 1e-5 of the largest magnitude,
    dtype, gshape, split and lshape map."""
    inputs, res = ranks
    fn, kw, name, split = FFT_CASES[key]
    want = getattr(ht.fft, fn)(ht.array(inputs[name], split=split, comm=comm3), **kw)
    for r in res:
        assert_record_equal(_rec(r, f"fft_{key}"), want, rtol=0, atol=1e-5 * max(1.0, _scaled(want)), what=key)


def _heat_dcsr(inputs, comm3, name, key):
    """heat_tpu's DCSR_matrix for the worker's case ``key`` on the three-device mesh."""
    a, mk = inputs[name], ht.sparse.sparse_csr_matrix
    dense = mk(a, split=0, comm=comm3)
    whole = mk(a, comm=comm3)
    other = lambda split: mk(inputs[f"{name}_b"], split=split, comm=comm3)  # noqa: E731
    return {
        "dense": lambda: dense,
        "dndarray": lambda: mk(ht.array(a, split=0, comm=comm3), split=0, comm=comm3),
        "whole": lambda: whole,
        "is_split": lambda: mk(a, is_split=0, comm=comm3),
        "resplit": lambda: mk(whole, split=0, comm=comm3),
        "gathered": lambda: mk(dense, comm=comm3),
        "add": lambda: dense + other(0),
        "mul": lambda: dense * other(0),
        "add_whole": lambda: ht.sparse.add(dense, other(None)),
        "scalar": lambda: dense * 3.0,
    }[key]()


DCSR_CASES = [(name, key) for name in ("sp_a", "sp_small")
              for key in ("dense", "dndarray", "whole", "is_split", "resplit", "gathered", "add", "mul", "add_whole",
                          "scalar")
              if not (key == "is_split" and name == "sp_small")]


@pytest.mark.parametrize("name,key", DCSR_CASES, ids=[f"{n}-{k}" for n, k in DCSR_CASES])
def test_dcsr_at_three_ranks(ranks, comm3, name, key):
    """The DCSR matrix on three ranks (2 rows: the third rank holds none; is_split from
    chunks of 1, 5 and 1 rows) against heat_tpu's on its mesh: the stored-value counts,
    each rank's chunk, row pointer, column indices and values, the global views, the
    counts and offsets, and the dense matrix; the union patterns of add and mul."""
    inputs, res = ranks
    want = _heat_dcsr(inputs, comm3, name, key)
    indptr, indices, data = (np.asarray(getattr(want, v)) for v in ("indptr", "indices", "data"))
    counts = want.counts_displs_nnz()[0] if want.split is not None else None
    for rank, r in enumerate(res):
        k = f"dcsr_{name}_{key}"
        _, lshape, slices = comm3.chunk(want.gshape, want.split, rank=rank)
        lo, hi = slices[0].start or 0, slices[0].stop
        lnnz = counts[rank] if counts is not None else want.nnz
        assert r[f"{k}_meta"].tolist() == [want.nnz, lnnz, -1 if want.split is None else want.split, *lshape]
        np.testing.assert_array_equal(r[f"{k}_indptr"], indptr)
        np.testing.assert_array_equal(r[f"{k}_indices"], indices)
        np.testing.assert_array_equal(r[f"{k}_data"], data)
        np.testing.assert_array_equal(r[f"{k}_lindptr"], indptr[lo:hi + 1] - indptr[lo])
        np.testing.assert_array_equal(r[f"{k}_lindices"], indices[indptr[lo]:indptr[hi]])
        np.testing.assert_array_equal(r[f"{k}_ldata"], data[indptr[lo]:indptr[hi]])
        if counts is not None:
            np.testing.assert_array_equal(r[f"{k}_counts_displs"], np.array(want.counts_displs_nnz()))
        assert_record_equal(_rec(r, f"{k}_dense"), want.todense(), rtol=0)


SCALER_FITS = {
    "standard": ("StandardScaler", {}, ("mean_", "var_")),
    "minmax": ("MinMaxScaler", {"feature_range": (-1.0, 2.0)}, ("data_min_", "data_max_", "scale_", "min_")),
    "normalizer": ("Normalizer", {"norm": "l1"}, ()),
    "maxabs": ("MaxAbsScaler", {}, ("max_abs_", "scale_")),
    "robust": ("RobustScaler", {"quantile_range": (10.0, 60.0)}, ("center_", "iqr_")),
}


@pytest.mark.parametrize("key", list(SCALER_FITS))
def test_scalers_at_three_ranks(ranks, comm3, key):
    """Each scaler fitted on 148 rows split 50, 50, 48 (RobustScaler on the distributed
    sort): its statistics and transform within 1e-5 of heat_tpu's (of the largest
    magnitude), with dtype, gshape, split and lshape map."""
    inputs, res = ranks
    cls, kw, attrs = SCALER_FITS[key]
    X = ht.array(inputs["flowers"], split=0, comm=comm3)
    est = getattr(ht.preprocessing, cls)(**kw).fit(X)
    for r in res:
        for attr in attrs:
            want = getattr(est, attr)
            assert_record_equal(_rec(r, f"scaler_{key}_{attr}"), want, rtol=1e-5, atol=1e-5 * _scaled(want))
        want = est.transform(X)
        assert_record_equal(_rec(r, f"scaler_{key}_transform"), want, rtol=1e-5, atol=1e-5 * _scaled(want))


def test_gaussian_nb_at_three_ranks(ranks, comm3):
    """GaussianNB with sample weights on 148 rows split 50, 50, 48: the float64 moments
    within 1e-10 (relative, and of the largest magnitude), the classes and predictions
    equal, the probabilities within 1e-10."""
    inputs, res = ranks
    X = ht.array(inputs["flowers"], split=0, comm=comm3)
    nb = ht.naive_bayes.GaussianNB().fit(X, ht.array(inputs["flowers_y"], split=0, comm=comm3),
                                         sample_weight=ht.array(inputs["flowers_w"], split=0, comm=comm3))
    for r in res:
        for attr in ("theta_", "var_", "class_count_", "class_prior_"):
            want = np.asarray(getattr(nb, attr))
            np.testing.assert_allclose(r[f"nb_{attr}"], want, rtol=1e-10, atol=1e-10 * _scaled(want), err_msg=attr)
        assert float(r["nb_epsilon"]) == pytest.approx(nb.epsilon_, rel=1e-12)
        assert_record_equal(_rec(r, "nb_classes"), nb.classes_, rtol=0)
        assert_record_equal(_rec(r, "nb_predict"), nb.predict(X), rtol=0)
        assert_record_equal(_rec(r, "nb_proba"), nb.predict_proba(X), rtol=1e-10, atol=1e-12)


def test_lasso_at_three_ranks(ranks, comm3):
    """Lasso on the sugar table split 148, 148, 146 (one all-reduce a coordinate): the
    sweeps and θ within 1e-10 of the largest coefficient."""
    inputs, res = ranks
    lasso = ht.regression.Lasso(lam=0.1)
    lasso.fit(ht.array(inputs["sugar_x"], split=0, comm=comm3), ht.array(inputs["sugar_y"], split=0, comm=comm3))
    for r in res:
        assert int(r["lasso_n_iter"]) == lasso.n_iter
        assert_record_equal(_rec(r, "lasso_theta"), lasso.theta, rtol=0, atol=1e-10 * _scaled(lasso.theta))


@pytest.mark.parametrize("st,sq", [(0, 0), (0, None), (None, 0)])
def test_knn_at_three_ranks(ranks, comm3, st, sq):
    """KNN with the training set split 50, 50, 48 (its nearest rows taken from other
    ranks) or whole, queries split 11, 11, 9 or whole: heat_tpu's labels and layout."""
    inputs, res = ranks
    knn = ht.classification.KNeighborsClassifier(5).fit(ht.array(inputs["flowers"], split=st, comm=comm3),
                                                        ht.array(inputs["flowers_y"], split=st, comm=comm3))
    want = knn.predict(ht.array(inputs["flowers_q"], split=sq, comm=comm3))
    for r in res:
        assert_record_equal(_rec(r, f"knn_{st}_{sq}"), want, rtol=0)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_partition_interface_at_three_ranks(ranks, comm3, split):
    """``__partitioned__`` on three ranks: heat_tpu's positions, starts, shapes,
    locations and dtype; each rank's ``locals`` its own position; ``from_partitioned``
    gives the array back; nbytes, gnbytes and each rank's lnbytes as heat_tpu counts them
    on its mesh."""
    inputs, res = ranks
    a = ht.array(inputs["fx"], split=split, comm=comm3)
    parts = a.__partitioned__
    meta = str(sorted((pos, p["start"], p["shape"], p["location"], str(p["dtype"]))
                      for pos, p in parts["partitions"].items()))
    for rank, r in enumerate(res):
        assert str(r[f"partitioned_{split}_meta"]) == meta
        own = tuple(rank if i == split else 0 for i in range(a.ndim))
        assert str(r[f"partitioned_{split}_locals"]) == str([own])
        assert_record_equal(_rec(r, f"partitioned_{split}_round_trip"), a, rtol=0)
        lnumel = int(np.prod(comm3.chunk(a.gshape, split, rank=rank)[1]))
        assert r[f"partitioned_{split}_bytes"].tolist() == [a.nbytes, a.gnbytes, lnumel * 4]


# ---------------------------------------------------------------------- heat_tpu.nn at three ranks
def _gather_seq(res, key):
    """The ranks' sequence chunks (axis 2) of ``key``, in rank order."""
    return np.concatenate([r[key] for r in res], axis=2)


def _jax_ring(comm, name):
    """heat_tpu's function of ``name`` under shard_map on the three-device mesh."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from heat_tpu.nn import attention as jatt

    fn = {
        "ring": partial(jatt.ring_attention, is_causal=False),
        "ring_causal": partial(jatt.ring_attention, is_causal=True),
        "zigzag": jatt.ring_attention_zigzag,
        "ulysses": partial(jatt.ulysses_attention, is_causal=False),
        "ulysses_causal": partial(jatt.ulysses_attention, is_causal=True),
    }[name]
    spec = P(None, None, comm.axis_name, None)
    return shard_map(partial(fn, axis_name=comm.axis_name), mesh=comm.mesh, in_specs=(spec,) * 3, out_specs=spec)


@pytest.mark.parametrize("name", ["ring", "ring_causal", "zigzag", "ulysses", "ulysses_causal"])
def test_sequence_parallel_attention_at_three_ranks(ranks, comm3, name):
    """Ring (full and causal), zigzag and Ulysses attention on three gloo ranks against
    heat_tpu's under shard_map on a three-device mesh: the forward within 1e-5 and the
    q, k, v gradients (jax.grad of <out, g>) within 1e-4 of their largest magnitude, f32.
    Zigzag in its layout (the port's zigzag_order)."""
    from heat_tpu.nn.attention import zigzag_order

    inputs, res = ranks
    lay = (lambda x: x[:, :, zigzag_order(12, WORLD)]) if name == "zigzag" else (lambda x: x)
    q, k, v, g = (jnp.asarray(lay(inputs[f"ring_{n}"])) for n in ("q", "k", "v", "g"))
    fn = _jax_ring(comm3, name)

    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)

    want, grads = fwd_bwd(q, k, v, g)
    got = _gather_seq(res, f"nn_{name}")
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5 * float(np.abs(want).max()))
    for n, gw in zip("qkv", grads):
        gw = np.asarray(gw)
        np.testing.assert_allclose(_gather_seq(res, f"nn_{name}_d{n}"), gw, rtol=0, atol=1e-4 * float(np.abs(gw).max()))


@pytest.mark.parametrize("tag", ["even", "ragged"])
def test_sequence_split_sdpa_and_mha_at_three_ranks(ranks, comm3, tag):
    """sdpa and MultiheadAttention on DNDarrays split along the sequence: T = 12 takes the
    ring (one ring_attention call, seen by a spy), T = 10 (ragged) the gathered path (no
    call); both equal heat_tpu's on the three-device mesh and keep the split."""
    from heat_tpu.nn.attention import scaled_dot_product_attention as jsdpa

    inputs, res = ranks
    want = jsdpa(*(ht.array(inputs[f"seq_{tag}_{n}"], split=2, comm=comm3) for n in "qkv"), is_causal=True)
    mha = ht.nn.MultiheadAttention(MHA_E, MHA_H)
    params = {k: jnp.asarray(v) for k, v in _mha_params().items()}
    want_mha = mha.apply(params, ht.array(inputs[f"seq_{tag}_x"], split=1, comm=comm3), is_causal=True)
    calls = "1" if tag == "even" else "0"
    for r in res:
        assert list(r[f"nn_sdpa_{tag}_meta"]) == ["2", calls] and want.split == 2
        np.testing.assert_allclose(r[f"nn_sdpa_{tag}"], want.numpy(), rtol=1e-5, atol=1e-5)
        assert list(r[f"nn_mha_{tag}_meta"]) == ["1", calls] and want_mha.split == 1
        np.testing.assert_allclose(r[f"nn_mha_{tag}"], want_mha.numpy(), rtol=2e-5, atol=2e-5)


def test_data_parallel_step_with_keyed_dropout_matches_heat_tpu(ranks, comm3):
    """One DataParallelOptimizer("sgd") step of a train-mode TransformerEncoderLayer
    (dropout 0.1 on the attention weights, the feed-forward and both residuals, one key)
    on a batch of 7 split 3, 3, 1, from heat_tpu's ``init`` parameters: heat_tpu's one
    program draws every mask over the whole batch, and each rank's loss draws its rows of
    those masks, so the global loss and every reduced gradient equal heat_tpu's step on its
    three-device mesh within 1e-5 (fp32 summed in other orders). A rank that drew its masks
    over its own rows alone would differ wherever its rows are not the batch's first."""
    inputs, res = ranks
    params = _dp_dropout_params()
    layer = ht.nn.TransformerEncoderLayer(**DP_DROPOUT_LAYER)
    layer.params = params
    opt = ht.optim.DataParallelOptimizer("sgd", lr=DP_LR)
    ht.nn.DataParallel(layer, comm=comm3, optimizer=opt)
    x = ht.array(inputs["dpdrop_x"], split=0, comm=comm3)
    y = ht.array(inputs["dpdrop_y"], split=0, comm=comm3)

    def loss_fn(p, xb, yb):
        return jnp.mean((layer.apply(p, xb, key=NN_KEY, train=True) - yb) ** 2)

    _, grads = jax.value_and_grad(loss_fn)(params, x.larray, y.larray)  # the values heat_tpu's step takes
    loss = opt.step(loss_fn, x, y)
    htt.use_device("cpu")
    by_name = load_jax_params(htt.nn.TransformerEncoderLayer(**DP_DROPOUT_LAYER), _dotted(grads))
    want = {n: p.detach().numpy() for n, p in by_name.named_parameters()}
    lmap = comm3.lshape_map((7, 5, 8), 0)
    for rank, r in enumerate(res):
        assert int(r["nn_dpdrop_rows"]) == lmap[rank, 0]
        np.testing.assert_allclose(float(r["nn_dpdrop_loss"]), float(loss), rtol=1e-5, atol=1e-5)
        for name, g in want.items():
            np.testing.assert_allclose(r[f"nn_dpdrop_grad_{name}"], g, rtol=1e-5, atol=1e-5, err_msg=name)
    assert list(lmap[:, 0]) == [3, 3, 1]


@pytest.mark.parametrize("name", ["dropout_s0", "dropout_s1", "dropout2d"])
def test_keyed_dropout_masks_at_three_ranks(ranks, comm3, name):
    """Train-mode dropout on an array split over three ranks: each rank draws its chunk of
    heat_tpu's global mask, so the result equals heat_tpu's bit for bit; the split follows
    heat_tpu's rule (any for dropout, the batch axis for dropout2d)."""
    from heat_tpu.nn import functional as jF

    inputs, res = ranks
    if name == "dropout2d":
        want = jF.dropout2d(ht.array(inputs["drop_x4"], split=0, comm=comm3), 0.5, key=NN_KEY)
    else:
        split = int(name[-1])
        want = jF.dropout(ht.array(inputs["drop_x"], split=split, comm=comm3), 0.3, key=NN_KEY)
    for r in res:
        assert str(r[f"nn_{name}_split"]) == str(want.split)
        np.testing.assert_array_equal(r[f"nn_{name}"], want.numpy())


@pytest.mark.parametrize("name", ["bn1", "bn2"])
def test_batch_norm_ragged_batch_split(ranks, comm3, name):
    """BatchNorm in training mode on a batch of 7 split 3, 3, 1: the moments are global
    (one all_reduce), the output and the running statistics equal heat_tpu's."""
    inputs, res = ranks
    x = inputs["bn_x2" if name == "bn1" else "bn_x4"]
    bn = (ht.nn.BatchNorm1d if name == "bn1" else ht.nn.BatchNorm2d)(x.shape[1])
    want = bn.apply(bn.init(jax.random.key(0)), jnp.asarray(x), train=True)
    for r in res:
        assert str(r[f"nn_{name}_split"]) == "0"
        np.testing.assert_allclose(r[f"nn_{name}"], np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"nn_{name}_running"], np.stack([bn.running_mean, bn.running_var]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("name", ["mse", "l1", "smooth_l1", "huber", "bce", "bce_logits", "nll", "ce"])
def test_losses_ragged_batch_split(ranks, comm3, name, reduction):
    """The losses on a batch of 7 split 3, 3, 1: global means and sums (the weighted mean of
    nll and cross_entropy over the kept targets' global weight), 'none' per element."""
    from heat_tpu.nn import functional as jF

    inputs, res = ranks
    arr = lambda n: ht.array(inputs[n], split=0, comm=comm3)  # noqa: E731
    w = jnp.asarray(inputs["loss_weight"])
    want = {
        "mse": lambda: jF.mse_loss(arr("loss_pred"), arr("loss_target"), reduction),
        "l1": lambda: jF.l1_loss(arr("loss_pred"), arr("loss_target"), reduction),
        "smooth_l1": lambda: jF.smooth_l1_loss(arr("loss_pred"), arr("loss_target"), reduction, beta=0.5),
        "huber": lambda: jF.huber_loss(arr("loss_pred"), arr("loss_target"), reduction, delta=0.7),
        "bce": lambda: jF.binary_cross_entropy(arr("loss_prob"), arr("loss_binary"), reduction=reduction),
        "bce_logits": lambda: jF.binary_cross_entropy_with_logits(arr("loss_pred"), arr("loss_binary"),
                                                                 reduction=reduction),
        "nll": lambda: jF.nll_loss(jF.log_softmax(arr("loss_logits"), 1), arr("loss_labels"), weight=w,
                                   reduction=reduction),
        "ce": lambda: jF.cross_entropy(arr("loss_logits"), arr("loss_labels"), weight=w, ignore_index=2,
                                       reduction=reduction, label_smoothing=0.1),
    }[name]()
    want = want.numpy() if isinstance(want, ht.DNDarray) else np.asarray(want)
    for r in res:
        np.testing.assert_allclose(r[f"nn_loss_{name}_{reduction}"], want, rtol=1e-5, atol=1e-6)


def test_transformer_sequence_split_at_three_ranks(ranks):
    """A 1 + 1-layer Transformer on src (12) and tgt (9) split along the sequence over three
    ranks: projections, norms and feedforward rank-local, its three attentions (encoder
    self, causal decoder self, cross) by the ring (three ring_attention calls); the result
    keeps the split and equals heat_tpu's."""
    inputs, res = ranks
    tm = ht.nn.Transformer(**TRANSFORMER)
    want = tm.apply(tm.init(jax.random.key(4)), jnp.asarray(inputs["tr_src"]), jnp.asarray(inputs["tr_tgt"]),
                    tgt_is_causal=True)
    for r in res:
        assert list(r["nn_transformer_meta"]) == ["1", "3"]
        np.testing.assert_allclose(r["nn_transformer"], np.asarray(want), rtol=1e-4, atol=1e-4)


RT_THREADS = 4


def test_threaded_requests_match_heat_tpu(ranks, comm3):
    """Several threads per rank issue tagged requests mixing deferred chains with
    split-axis reductions and scans: nothing hangs, nothing falls back, and every
    rank's results equal heat_tpu's on its three-device mesh."""
    inputs, res = ranks
    x = ht.array(inputs["rt_x"], split=0, comm=comm3)
    y = ht.array(inputs["rt_y"], split=0, comm=comm3)
    for r in res:
        assert int(r["rt_alive"]) == 0 and str(r["rt_errors"]) == ""
        misses, hits, reexecuted, fallbacks = r["rt_stats"]
        assert misses >= 1 and reexecuted == 0 and fallbacks == 0
        assert int(r["rt_requests"]) == RT_THREADS
    for i in range(RT_THREADS):
        c = x
        for _ in range(4):
            c = c * float(i + 1)
            c = c + y
            c = c - 0.5
        want = {
            "chain": c.numpy(),
            "sum0": ht.sum(c, axis=0).numpy(),
            "cumsum0": ht.cumsum((c * 2.0) + y, axis=0).numpy(),
            "max": np.array(ht.max(c).item()),
        }
        for r in res:
            np.testing.assert_array_max_ulp(r[f"rt{i}_chain"], want["chain"], maxulp=4)
            for key in ("sum0", "cumsum0", "max"):
                np.testing.assert_allclose(r[f"rt{i}_{key}"], want[key], rtol=1e-5, atol=1e-5)
    # more seeds: the port's chain is the stepwise float32 chain bit for bit on every rank;
    # heat_tpu's is the chain with c·k + y fused (XLA contracts the multiply and the add into
    # one FMA), within one ulp, and for k = 3 (not a power of two, so c·3 rounds) it leaves
    # the stepwise chain by more than the 4 ulp held above (ROADMAP Queue 3, the reference's
    # own differences)
    for seed in RT_SEEDS:
        xs, ys = inputs[f"rt_x_seed{seed}"], inputs[f"rt_y_seed{seed}"]
        for i in range(RT_THREADS):
            stepwise, fused = _chain_f32(xs, ys, float(i + 1), False), _chain_f32(xs, ys, float(i + 1), True)
            for r in res:
                np.testing.assert_array_equal(r[f"rt_seed{seed}_{i}"], stepwise)
            c = ht.array(xs, split=0, comm=comm3)
            for _ in range(4):
                c = c * float(i + 1)
                c = c + ht.array(ys, split=0, comm=comm3)
                c = c - 0.5
            np.testing.assert_array_max_ulp(c.numpy(), fused, maxulp=1)
            if i == 2:
                assert np.max(np.abs(c.numpy().view(np.int32).astype(np.int64)
                                     - stepwise.view(np.int32).astype(np.int64))) > 4


def test_supervised_restart_after_a_dead_peer(ranks):
    """Rank 2 dies at step 3 (the peer-dead fault); the survivors raise PeerFailed typed
    and run_supervised resumes at world 2 from the latest step, bit-equal to an
    uninterrupted world-2 run from that step and, within float32 rounding of the
    global sums' order, to heat_tpu's single-process run of the same six steps."""
    _, res = ranks
    w = ht.array(np.arange(12.0, dtype=np.float32), split=0)
    for step in range(6):
        w = w * 0.5 + w.sum() * 1e-3 + float(step)
    want = np.asarray(w.numpy())
    for r in (0, 1):
        sup = res[r]["sup"]
        assert sup["world_after"].tolist() == [2, r]
        assert sup["steps_restarts"].tolist() == [6, 1]
        assert sup["cause"].tolist() == ["PeerFailed"]
        assert int(sup["latest_step"]) == 5
        np.testing.assert_array_equal(sup["w"], sup["w_plain"])
        np.testing.assert_allclose(sup["w"], want, rtol=1e-6)
    np.testing.assert_array_equal(res[0]["sup"]["w"], res[1]["sup"]["w"])
