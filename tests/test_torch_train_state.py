"""The training job's state across ranks: DASO, the checkpoint, HDF5 slabs and write
faults on four gloo ranks against heat_tpu, and DASO's phase machine at one rank.

One spawn of four worker processes (tests/_torch_train_state_worker.py, rendezvous by a
file in the test's own temporary directory) runs:

- DASO at 2 nodes x 2 ranks (``TorchCommunication.hierarchical(2)``) on
  tests/test_daso.py's model and data against heat_tpu's ``MeshCommunication.hierarchical(2,
  devices=jax.devices()[:4])``: every node replica after every step within ``PARAM_TOL``,
  the losses within ``LOSS_TOL`` (tests/test_torch_training.py), the same steps synced and
  the same phase, skips and wait after each epoch; the re-averaging of de-synchronised
  replicas, the sub-ulp case, the divergence between syncs, dropout under one key (each
  node's mask over its own batch), and a ragged batch (held to heat_tpu at one device a
  node, which gives the same node batches);
- a checkpoint saved at 4 ranks, restored at 4 onto other splits, at one rank here and by
  heat_tpu on a 4-device mesh, byte-equal to heat_tpu's 4-device checkpoint of the same
  tree; heat_tpu's checkpoint restored at 4 ranks; a manager over 4 ranks;
- HDF5 saves of per-rank slabs (rank by rank) and a read that touches only the local slab;
  NPY and CSV at 4 ranks;
- a fault on rank 2's chunk writes (every rank degrades to v1 together, recorded) and on
  rank 2's chunk metadata (every rank raises, none hangs).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as jht
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as ht
from heat_tpu_torch.core import checkpoint as ckpt

WORLD = 4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_train_state_worker.py")
NAMES = ("0.weight", "0.bias", "2.weight", "2.bias")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_training.py:114-115
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


# ------------------------------------------------------------------ heat_tpu's side
def _jax_daso(comm, **kw):
    model = jht.nn.Sequential(jht.nn.Linear(8, 16), jht.nn.ReLU(), jht.nn.Linear(16, 4))
    model.reset_parameters(seed=0)
    opt = jht.optim.DataParallelOptimizer("sgd", lr=0.05)
    jht.nn.DataParallel(model, optimizer=opt)
    kw.setdefault("total_epochs", 4)
    kw.setdefault("warmup_epochs", 1)
    kw.setdefault("cooldown_epochs", 1)
    daso = jht.optim.DASO(opt, comm=comm, **kw)
    crit = jht.nn.CrossEntropyLoss()
    return daso, model, (lambda params, x, y: crit(model.apply(params, x), y))


def _named(tree) -> dict:
    """heat_tpu's Sequential parameters (or their node stacks) under the port's names, the
    weights' last two axes swapped to torch's (out, in)."""
    out = {}
    for i in (0, 2):
        out[f"{i}.weight"] = np.swapaxes(np.asarray(tree[i]["weight"]), -1, -2)
        out[f"{i}.bias"] = np.asarray(tree[i]["bias"])
    return out


def _record(rec, tag, daso, loss_fn, steps, batch):
    for _ in range(steps):
        rec.setdefault(f"{tag}_loss", []).append(float(daso.step(loss_fn, *batch)))
        for n, v in _named(daso.stacked_params).items():
            rec.setdefault(f"{tag}_p_{n}", []).append(v)


def _jax_reference(inputs) -> dict:
    comm = MeshCommunication.hierarchical(2, devices=jax.devices()[:4])
    x, y = jnp.asarray(inputs["x16"]), jnp.asarray(inputs["y16"])
    rec = {}
    daso, _, loss_fn = _jax_daso(comm, total_epochs=6, warmup_epochs=1, cooldown_epochs=1, max_global_skips=4)
    syncs, states = [], []
    orig = daso._global_sync
    daso._global_sync = lambda: (syncs.append(daso._batch_in_epoch), orig())[1]

    def state():
        states.append([daso.epoch, {"warmup": 0, "cycling": 1, "cooldown": 2}[daso._phase], daso.global_skip,
                       daso.local_skip, daso.batches_to_wait])

    _record(rec, "cad", daso, loss_fn, 3, (x, y))
    daso.epoch_end()
    state()
    _record(rec, "cad", daso, loss_fn, 8, (x, y))
    for _ in range(4):
        daso.epoch_end()
        state()
    _record(rec, "cad", daso, loss_fn, 2, (x, y))
    rec["cad_syncs"], rec["cad_states"] = syncs, states
    daso, _, loss_fn = _jax_daso(comm)
    daso.step(loss_fn, jnp.zeros((8, 8), jnp.float32), jnp.zeros((8,), jnp.int32))

    def desync(p):
        n = p.shape[0]
        return jnp.broadcast_to(jnp.arange(1, n + 1, dtype=p.dtype).reshape((n,) + (1,) * (p.ndim - 1)), p.shape)

    daso.stacked_params = jax.tree.map(desync, daso.stacked_params)
    daso._global_sync()
    rec.update({f"desync_p_{n}": v for n, v in _named(daso.stacked_params).items()})

    def setv(p):
        n = p.shape[0]
        return jnp.full(p.shape, 1000.0, p.dtype) + (jnp.arange(n, dtype=p.dtype) * 1e-3).reshape((n,) + (1,) * (p.ndim - 1))

    daso.stacked_params = jax.tree.map(setv, daso.stacked_params)
    daso._global_sync()
    rec.update({f"subulp_p_{n}": v for n, v in _named(daso.stacked_params).items()})
    daso, _, loss_fn = _jax_daso(comm, warmup_epochs=0, max_global_skips=8)
    daso._batch_in_epoch = 1
    _record(rec, "div", daso, loss_fn, 3, (x, y))
    daso._global_sync()
    rec.update({f"divsync_p_{n}": v for n, v in _named(daso.stacked_params).items()})
    cons = _named(daso.consolidated_params())
    rec["div_consolidated"] = np.concatenate([cons[n].ravel() for n in NAMES])
    # dropout 0.1 under one key: heat_tpu maps one program over the node batches
    daso, _, _ = _jax_daso(comm)
    lin1, lin2, crit = jht.nn.Linear(8, 16), jht.nn.Linear(16, 4), jht.nn.CrossEntropyLoss()
    key = jax.random.wrap_key_data(jnp.asarray(inputs["drop_key"]))

    def dropout_loss(params, xb, yb):
        h = jht.nn.functional.dropout(jnp.maximum(lin1.apply(params[0], xb), 0.0), 0.1, key=key)
        return crit(lin2.apply(params[2], h), yb)

    _record(rec, "drop", daso, dropout_loss, 2, (x, y))
    # the ragged batch: one device a node gives heat_tpu the port's node batches
    daso, _, loss_fn = _jax_daso(MeshCommunication.hierarchical(2, devices=jax.devices()[:2]))
    xr, yr = jnp.asarray(inputs["x10"]), jnp.asarray(inputs["y10"])
    _record(rec, "rag", daso, loss_fn, 2, (xr, yr))
    daso.epoch_end()
    _record(rec, "rag", daso, loss_fn, 2, (xr, yr))
    return {k: (np.stack(v) if isinstance(v, list) and isinstance(v[0], np.ndarray) else v) for k, v in rec.items()}


def _ckpt_values():
    rng = np.random.default_rng(5)
    return {
        "ck_f32": rng.standard_normal((7, 6)).astype(np.float32),
        "ck_f64": rng.standard_normal((5, 9)),
        "ck_i32": rng.integers(-100, 100, (11, 3)).astype(np.int32),
        "ck_bf": (np.round(rng.standard_normal((9, 4)) * 8) / 8).astype(np.float32),
    }


def _jax_ckpt_tree(v, comm):
    return {
        "f32": jht.array(v["ck_f32"], split=0, comm=comm), "f64": jht.array(v["ck_f64"], split=1, comm=comm),
        "i32": jht.array(v["ck_i32"], comm=comm),
        "bf16": jht.array(v["ck_bf"], split=0, comm=comm).astype(jht.bfloat16),
        "numpy": np.arange(6, dtype=np.int64).reshape(2, 3), "count": 17,
    }


# ------------------------------------------------------------------ the spawn
@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_state")
    model = jht.nn.Sequential(jht.nn.Linear(8, 16), jht.nn.ReLU(), jht.nn.Linear(16, 4))
    model.reset_parameters(seed=0)
    rng = np.random.default_rng(17)
    inputs = {
        **{f"param_{n}": v.astype(np.float32) for n, v in _named(model.params).items()},
        "x16": rng.standard_normal((16, 8)).astype(np.float32), "y16": rng.integers(0, 4, 16),
        "x10": rng.standard_normal((10, 8)).astype(np.float32), "y10": rng.integers(0, 4, 10),
        "drop_key": np.asarray(jax.random.key_data(jax.random.key(23))),
        **_ckpt_values(),
    }
    jax_ckpt = str(tmp / "j4")
    comm4 = MeshCommunication(devices=jax.devices()[:4])
    jht.save_checkpoint(_jax_ckpt_tree(inputs, comm4), jax_ckpt)
    inputs["jax_ckpt"] = np.array(jax_ckpt)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("HEAT_TPU_FAULT_PLAN", None)
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(tmp / "rendezvous"), str(tmp / "inputs.npz"),
                          str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    return tmp, inputs, ranks, _jax_reference(inputs)


def test_hierarchical_communicator(spawned):
    _, _, ranks, _ = spawned
    # n_nodes, node_size, node, local_rank, node group size, cross group size, hierarchical
    assert [r["hier"].tolist() for r in ranks] == [[2, 2, r // 2, r % 2, 2, 2, 1] for r in range(WORLD)]
    with pytest.raises(ValueError, match="equal node groups"):
        ht.TorchCommunication.hierarchical(3)  # one rank here: 3 does not divide it
    flat = ht.TorchCommunication.hierarchical(1)
    assert flat.is_hierarchical and flat.n_nodes == 1 and flat.node_size == 1 and flat.cross_comm.size == 1
    assert not ht.TorchCommunication().is_hierarchical and ht.TorchCommunication().n_nodes == 1
    with pytest.raises(ValueError):
        MeshCommunication.hierarchical(len(jax.devices()) + 1)


@pytest.mark.parametrize("tag", ["cad", "div", "rag", "drop"])
def test_daso_steps_match_heat_tpu(spawned, tag):
    """Every node replica after every step and the losses, at 2 nodes x 2 ranks; "drop" with
    dropout under one key, whose mask heat_tpu draws over each node's batch: a rank draws its
    rows of it."""
    _, _, ranks, want = spawned
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}_loss"], want[f"{tag}_loss"], **LOSS_TOL)
        for n in NAMES:
            assert r[f"{tag}_p_{n}"].shape == want[f"{tag}_p_{n}"].shape
            np.testing.assert_allclose(r[f"{tag}_p_{n}"], want[f"{tag}_p_{n}"], **PARAM_TOL, err_msg=f"{tag} {n}")


def test_daso_cadence_and_phase_machine_match_heat_tpu(spawned):
    _, _, ranks, want = spawned
    assert want["cad_syncs"] == [0, 1, 2, 0, 4, 0, 1]  # warmup every step, cycling every 4th, cooldown every step
    for r in ranks:
        assert r["cad_syncs"].tolist() == want["cad_syncs"]
        assert r["cad_states"].tolist() == want["cad_states"]


@pytest.mark.parametrize("case", ["desync", "subulp", "divsync"])
def test_daso_global_sync_matches_heat_tpu(spawned, case):
    """The re-averaging: replicas 1, 2 averaged through the bf16 wire; 1000 + j·1e-3 keeps
    its sub-ulp offsets; diverged replicas re-joined, every replica equal after a sync."""
    _, _, ranks, want = spawned
    for r in ranks:
        for n in NAMES:
            got = r[f"{case}_p_{n}"]
            np.testing.assert_allclose(got, want[f"{case}_p_{n}"], **PARAM_TOL)
            np.testing.assert_array_equal(got[0], got[1])
    if case == "subulp":
        np.testing.assert_allclose(ranks[0]["subulp_p_0.bias"], 1000.0 + 0.5e-3, atol=2e-4)


def test_daso_replicas_diverge_between_syncs(spawned):
    _, _, ranks, want = spawned
    for r in ranks:
        last = {n: r[f"div_p_{n}"][-1] for n in NAMES}
        assert any(not np.allclose(v[0], v[1]) for v in last.values())
        np.testing.assert_allclose(r["div_consolidated"], want["div_consolidated"], **PARAM_TOL)


def test_daso_batch_not_divisible_by_nodes_and_loss_averaging(spawned):
    _, _, ranks, _ = spawned
    assert all("not divisible by n_nodes=2" in str(r["odd_batch"]) for r in ranks)
    assert [float(r["loss_logic_best"]) for r in ranks] == [1.5] * WORLD  # the mean of 0, 1, 2, 3


def test_checkpoint_at_four_ranks_restores_onto_other_splits(spawned):
    _, inputs, ranks, _ = spawned
    for r in ranks:
        for k, split in (("f32", 1), ("f64", 0), ("i32", 0), ("bf16", -1)):
            want = inputs[f"ck_{'bf' if k == 'bf16' else k}"]
            np.testing.assert_array_equal(r[f"ck_back_{k}"], want.astype(np.float64))
            assert int(r[f"ck_back_{k}_split"]) == split
            np.testing.assert_array_equal(r[f"ck_jback_{k}"], want.astype(np.float64))
        assert int(r["ck_count"]) == 17
        assert r["mgr_steps"].tolist() == [2, 3]
        np.testing.assert_array_equal(r["mgr_latest"], np.arange(9, dtype=np.float32) * 3.0)
    # each rank read about its own rows, never the whole state
    whole = sum(inputs[k].nbytes for k in ("ck_f32", "ck_f64", "ck_i32")) + inputs["ck_bf"].size * 2
    assert all(int(r["ck_read_bytes"]) < whole for r in ranks)


def test_checkpoint_at_four_ranks_read_here_and_by_heat_tpu(spawned):
    tmp, inputs, _, _ = spawned
    path = str(tmp / "ck4")
    back = ht.load_checkpoint({"f32": ht.zeros((7, 6), split=0), "f64": ht.zeros((5, 9), dtype=ht.float64, split=1),
                               "i32": ht.zeros((11, 3), dtype=ht.int32), "bf16": ht.zeros((9, 4), dtype=ht.bfloat16),
                               "numpy": np.zeros((2, 3), np.int64), "count": 0}, path)
    comm4 = MeshCommunication(devices=jax.devices()[:4])
    jback = jht.load_checkpoint(_jax_ckpt_tree({k: np.zeros_like(v) for k, v in _ckpt_values().items()}, comm4), path)
    for k in ("f32", "f64", "i32", "bf16"):
        want = inputs[f"ck_{'bf' if k == 'bf16' else k}"].astype(np.float64)
        np.testing.assert_array_equal(back[k].astype(ht.float64).numpy(), want)
        np.testing.assert_array_equal(np.asarray(jback[k].numpy()).astype(np.float64), want)
    assert back["count"] == 17 and int(jback["count"]) == 17
    # heat_tpu's 4-device grid is the port's 4-rank grid: the same manifest and bytes
    jm, tm = ckpt.read_manifest(str(inputs["jax_ckpt"])), ckpt.read_manifest(path)
    assert jm["leaves"] == tm["leaves"]
    for f, _, _ in ckpt._manifest_files(tm):
        assert open(os.path.join(path, f), "rb").read() == open(os.path.join(str(inputs["jax_ckpt"]), f), "rb").read()
    assert tm["processes"] == WORLD and len(tm["leaves"][2]["chunks"]) == 4  # f32: 7 rows, chunks 2, 2, 2, 1


def test_hdf5_slabs_at_four_ranks(spawned):
    import h5py

    tmp, _, ranks, _ = spawned
    n = 15
    ref = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    c = -(-n // WORLD)
    for r, res in enumerate(ranks):
        lo, hi = min(r * c, n), min((r + 1) * c, n)
        assert res["h5_writes"].tolist() == [[lo, hi]]  # rank r wrote its own slab only
        assert res["h5_reads"].tolist() == [[lo, hi]]  # and read only it back
        np.testing.assert_array_equal(res["h5_local"], ref[lo:hi])
        cols = -(-3 // WORLD)
        np.testing.assert_array_equal(res["npy_local"], ref[:, min(r * cols, 3):min((r + 1) * cols, 3)])
        np.testing.assert_array_equal(res["csv_local"], ref[lo:hi])
    for split in (0, 1, None):
        with h5py.File(str(tmp / f"slab{split}.h5"), "r") as fh:
            np.testing.assert_array_equal(np.asarray(fh["data"]), ref)
        np.testing.assert_array_equal(jht.load_hdf5(str(tmp / f"slab{split}.h5"), "data", split=0).numpy(), ref)
    with h5py.File(str(tmp / "slab0.h5"), "r") as fh:
        np.testing.assert_array_equal(np.asarray(fh["b"]), np.arange(6) * 2)


def test_write_faults_on_rank_two(spawned):
    """A chunk-write fault on rank 2 degrades every rank to v1 together (one recorded
    fallback each) and the save commits; a hard fault there raises on every rank: the
    original error on rank 2, CheckpointWriteFailed on the others; nothing commits."""
    _, _, ranks, _ = spawned
    for r, res in enumerate(ranks):
        assert str(res["fault_degrade"]) == "committed"
        assert str(res["fault_degrade_schema"]) == ckpt.SCHEMA_V1 and int(res["fault_degrade_events"]) == 1
        np.testing.assert_array_equal(res["fault_degrade_value"], np.arange(40, dtype=np.float32).reshape(10, 4))
        assert str(res["fault_hard"]) == ("FaultInjected" if r == 2 else "CheckpointWriteFailed")
        assert int(res["fault_hard_exists"]) == 0


# ------------------------------------------------------------------ one rank, no spawn
def _port_daso(**kw):
    model = torch.nn.Linear(3, 2)
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.1)
    ht.nn.DataParallel(model, optimizer=opt)
    kw.setdefault("total_epochs", 4)
    kw.setdefault("warmup_epochs", 1)
    kw.setdefault("cooldown_epochs", 1)
    return ht.optim.DASO(opt, **kw), model


def _jax_flat_daso(**kw):
    daso, model, _ = _jax_daso(MeshCommunication(), **kw)
    return daso


def _machine(d):
    return [d.epoch, d._phase, d.global_skip, d.local_skip, d.batches_to_wait, d._batch_in_epoch]


@pytest.mark.parametrize("losses", [
    [1.0] * 12 + [0.9, 0.8, 0.7],  # plateaus halve the skips, then cycle up at 1 (test_daso.py)
    [5.0, 4.0, 3.5, 3.4, 3.39, 3.389, 3.3889, 3.0, 3.0, 3.0, 3.0],
    list(np.linspace(2.0, 1.0, 9)),
])
def test_phase_machine_matches_heat_tpu_at_one_rank(losses):
    for kw in ({"warmup_epochs": 0, "max_global_skips": 8}, {"warmup_epochs": 1, "max_global_skips": 4,
                                                              "total_epochs": 20, "cooldown_epochs": 2}):
        port, _ = _port_daso(**kw)
        ref = _jax_flat_daso(**kw)
        for i, v in enumerate(losses):
            port.epoch_loss_logic(torch.tensor(v))
            ref.epoch_loss_logic(v)
            assert _machine(port) == _machine(ref), (i, kw)
            if i % 3 == 2:
                port.epoch_end()
                ref.epoch_end()
                assert _machine(port) == _machine(ref) and port._should_global_sync() == ref._should_global_sync()


def test_daso_one_rank_is_the_data_parallel_step():
    """At one node DASO's step is the local optimizer's (heat_tpu's dp_optimizer.py:433-441):
    the same loss and parameters as a plain DataParallelOptimizer from the same start."""
    torch.manual_seed(0)
    x, y = ht.array(torch.randn(6, 3), split=0), ht.array(torch.randn(6, 2), split=0)
    daso, model = _port_daso()
    plain = torch.nn.Linear(3, 2)
    plain.load_state_dict(model.state_dict())
    opt = ht.optim.DataParallelOptimizer("sgd", lr=0.1)
    ht.nn.DataParallel(plain, optimizer=opt)
    mse = lambda m, a, b: torch.nn.functional.mse_loss(m(a), b)  # noqa: E731
    for _ in range(2):
        assert float(daso.step(mse, x, y)) == float(opt.step(mse, x, y))
    assert daso._batch_in_epoch == 2
    assert torch.equal(model.weight, plain.weight) and torch.equal(model.bias, plain.bias)


def test_daso_api_matches_heat_tpu():
    port, model = _port_daso(warmup_epochs=0, max_global_skips=8)
    ref = _jax_flat_daso(warmup_epochs=0, max_global_skips=8)
    for d in (port, ref):
        for _ in range(2):
            d.epoch_end()
        assert d.epoch == 2
        d.reset()
        assert d.epoch == 0 and d._batch_in_epoch == 0 and d._phase == "cycling"
        d.add_scaler("amp-scaler-placeholder")
        assert d.scaler == "amp-scaler-placeholder"
        d.last_batch()
        assert d.global_skip == 0
    assert _machine(port) == _machine(ref)
    port.set_model(port.local_optimizer._model)
    assert port.local_optimizer._model.module is model and port.n_nodes == 1
    port.lr = 0.25
    assert port.lr == 0.25 and port.local_optimizer.local_optimizer.param_groups[0]["lr"] == 0.25
    assert set(port.stacked_params) == {"weight", "bias"} and port.stacked_params["weight"].shape == (1, 2, 3)
    torch.testing.assert_close(port.consolidated_params()["weight"], model.weight.detach())
    with pytest.raises(TypeError, match="loss_fn"):
        port.step()
    for args, kw, err in (((0,), {}, TypeError), ((4,), {"warmup_epochs": -1}, ValueError),
                          ((4,), {"warmup_epochs": 3, "cooldown_epochs": 2}, ValueError)):
        with pytest.raises(err):
            ht.optim.DASO(None, *args, **kw)
        with pytest.raises(err):
            jht.optim.DASO(None, *args, **kw)


def test_wire_deltas_and_synced_params_are_heat_tpus_sync():
    """The sync's rank-local body on virtual replicas (as chip_smoke.py runs it on the card)
    equals heat_tpu's ``avg`` of a stacked leaf: ref + mean(bf16(p − ref)) in float32."""
    from heat_tpu_torch.optim.dp_optimizer import synced_params, wire_deltas

    rng = np.random.default_rng(3)
    for n in (2, 4):
        base = rng.standard_normal((5, 7)).astype(np.float32) * 100
        reps = [base] + [base + rng.standard_normal((5, 7)).astype(np.float32) * 10.0 ** -k for k in range(1, n)]
        stacked = jnp.asarray(np.stack(reps))
        ref = stacked[0:1]
        delta = (stacked - ref).astype(jnp.bfloat16)
        want = np.asarray(ref[0] + jnp.mean(delta.astype(jnp.float32), axis=0))
        refs = [torch.from_numpy(base)]
        got = synced_params(refs, torch.stack([wire_deltas([torch.from_numpy(r)], refs, torch.bfloat16) for r in reps]))
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=np.abs(want).max() * 2e-7)


def test_resilience_stats_reach_the_report():
    from heat_tpu_torch.core import diagnostics, resilience

    rep = diagnostics.report()
    assert rep["schema"] == "heat-tpu-diagnostics/1" and "resilience" in rep
    assert set(rep["resilience"]) == {"armed", "plan", "site_calls", "faults_fired", "policies", "breakers"}
    assert json.loads(json.dumps(rep))["schema"] == rep["schema"]
    assert callable(resilience.run_supervised)  # delegates to the supervision plane
