"""The port's checkpoint (heat_tpu_torch/core/checkpoint.py) against heat_tpu's: the
counterparts of tests/test_checkpoint.py and tests/test_checkpoint_v2.py (round trips, the
template's split winning, manager retention, torn and bit-flipped chunks, a missing
manifest, an incomplete grid, write faults retried under a policy, the stale-temp sweep,
atomicity under a mid-write crash, the crash matrix, the degradation ladder, prune events,
restore holds, the gauges), and the cross-package round trip in both directions: heat_tpu
on its 8-device CPU test mesh (and on a one-device mesh, whose chunk grid is the port's at
one rank) writes and the port restores, the port writes and heat_tpu restores, for split
DNDarrays of float32, float64, int32 and bfloat16 at splits 0, 1 and None, ragged, with
numpy and integer leaves. The 4-rank saves and restores run in
tests/test_torch_train_state.py.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import heat_tpu as jht
from heat_tpu.core import checkpoint as jckpt
from heat_tpu.core import resilience as jres
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as ht
from heat_tpu_torch.core import checkpoint as ckpt
from heat_tpu_torch.core import diagnostics, resilience


@pytest.fixture(autouse=True)
def _clean():
    ht.use_device("cpu")
    for r in (resilience, jres):
        r.disarm_fault_plan()
        r.reset(clear_breakers=True)
    yield
    for r in (resilience, jres):
        r.disarm_fault_plan()
        r.reset(clear_breakers=True)


def _tree(scale: float = 1.0):
    return {
        "a": ht.array((np.arange(42, dtype=np.float32) * scale).reshape(7, 6), split=0),
        "b": ht.array(np.full((5,), 2.0 * scale, np.float32)),
        "step": np.int64(int(scale)),
    }


def _template():
    return {"a": ht.zeros((7, 6), split=0), "b": ht.zeros((5,)), "step": np.int64(0)}


def _values(tree):
    return tree["a"].numpy(), tree["b"].numpy(), int(tree["step"])


def _save(tmp_path, name, value):
    path = str(tmp_path / name)
    ht.save_checkpoint({"x": ht.array(value, split=0)}, path)
    return path


def _first_chunk(path):
    return os.path.join(path, ckpt.read_manifest(path)["leaves"][0]["chunks"][0]["file"])


# ------------------------------------------------------------------ round trips
def test_roundtrip_mixed_tree(tmp_path):
    x = ht.arange(24, dtype=ht.float32, split=0).reshape((6, 4))
    w = ht.array(np.ones((4, 2), np.float32))
    t = torch.arange(6, dtype=torch.int32)
    tree = {"x": x, "w": w, "step": np.int64(7), "k": 3, "lr": 0.5, "flag": True, "t": t, "none": None, "name": "adam"}
    ht.save_checkpoint(tree, str(tmp_path / "c"))
    zeros = {"x": ht.zeros((6, 4), split=0), "w": ht.zeros((4, 2)), "step": np.int64(0), "k": 0, "lr": 0.0,
             "flag": False, "t": torch.zeros(6, dtype=torch.int32), "none": None, "name": "sgd"}
    back = ht.load_checkpoint(zeros, str(tmp_path / "c"))
    np.testing.assert_array_equal(back["x"].numpy(), x.numpy())
    assert back["x"].split == 0 and back["w"].split is None
    assert int(back["step"]) == 7 and back["k"] == 3 and back["lr"] == 0.5 and back["flag"] is True
    assert torch.equal(back["t"], t) and back["none"] is None and back["name"] == "sgd"  # strings: the template's


@pytest.mark.parametrize("split", [None, 0, 1])
def test_split_metadata_restored(tmp_path, split):
    y = ht.array(np.arange(20, dtype=np.float32).reshape(4, 5), split=split)
    ht.save_checkpoint({"y": y}, str(tmp_path / "s"))
    back = ht.load_checkpoint({"y": ht.zeros((4, 5), split=split)}, str(tmp_path / "s"))
    assert back["y"].split == split
    np.testing.assert_array_equal(back["y"].numpy(), y.numpy())


def test_template_split_wins(tmp_path):
    y = ht.array(np.arange(20, dtype=np.float32).reshape(4, 5), split=None)
    ht.save_checkpoint({"y": y}, str(tmp_path / "t"))
    back = ht.load_checkpoint({"y": ht.zeros((4, 5), split=0)}, str(tmp_path / "t"))
    assert back["y"].split == 0
    np.testing.assert_array_equal(back["y"].numpy(), y.numpy())


def test_leaf_order_follows_jax(tmp_path):
    """The port numbers the leaves as jax.tree.flatten does: sorted dict keys, OrderedDict
    in insertion order, None no leaf."""
    import collections

    tree = {"b": 1, "a": [2, None, (3, 4)], "c": collections.OrderedDict(z=5, y=6), "d": None}
    leaves, _ = ckpt._flatten(tree)
    assert leaves == jax.tree.leaves(tree)
    again = ckpt._unflatten(ckpt._flatten(tree)[1], leaves)
    assert again == tree and type(again["c"]) is collections.OrderedDict


def test_manager_retention_and_latest(tmp_path):
    x = ht.arange(12, dtype=ht.float32, split=0)
    mgr = ht.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": x * float(s)})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step == 3
    r = mgr.restore({"x": ht.zeros((12,), split=0)})
    np.testing.assert_array_equal(r["x"].numpy(), (x * 3.0).numpy())
    mgr.close()
    with pytest.raises(FileNotFoundError):
        ht.CheckpointManager(str(tmp_path / "empty")).restore({"x": ht.zeros(3)})


def test_training_resume_bit_identical(tmp_path):
    """Parameters, Adam's state and the random counter in one tree: a resumed run
    continues bit for bit, the next random draws included."""
    rng = np.random.default_rng(0)
    x = ht.array(rng.standard_normal((64, 4)).astype(np.float32), split=0)
    y = ht.array(rng.integers(0, 2, 64), split=0)

    def pipeline():
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
        opt = ht.optim.DataParallelOptimizer("adam", lr=0.05)
        ht.nn.DataParallel(model, optimizer=opt)
        return model, opt

    def loss_fn(m, xb, yb):
        return torch.nn.functional.cross_entropy(m(xb), yb)

    model, opt = pipeline()
    ht.random.seed(1234)
    for _ in range(3):
        opt.step(loss_fn, x, y)
    ht.random.rand(10, split=0)
    state = {"model": model.state_dict(), "opt": opt.local_optimizer.state_dict(), "rng": list(ht.random.get_state())}
    ht.save_checkpoint(state, str(tmp_path / "resume"))
    continued = [float(opt.step(loss_fn, x, y)) for _ in range(2)]
    draw = ht.random.rand(6, split=0).numpy()

    model2, opt2 = pipeline()
    opt2.step(loss_fn, x, y)  # makes Adam's state, the template's shapes
    ht.random.seed(99)
    back = ht.load_checkpoint({"model": model2.state_dict(), "opt": opt2.local_optimizer.state_dict(),
                               "rng": list(ht.random.get_state())}, str(tmp_path / "resume"))
    model2.load_state_dict(back["model"])
    opt2.local_optimizer.load_state_dict(back["opt"])
    ht.random.set_state(tuple(back["rng"]))
    assert [float(opt2.step(loss_fn, x, y)) for _ in range(2)] == continued
    np.testing.assert_array_equal(ht.random.rand(6, split=0).numpy(), draw)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ across packages
def _mixed(pkg, comm=None):
    """The cross-package tree: split DNDarrays of four dtypes at splits 0, 1 and None,
    ragged (7 rows on 8 devices), a numpy leaf and an integer."""
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((7, 6)).astype(np.float32)
    f64 = rng.standard_normal((5, 9))
    i32 = rng.integers(-100, 100, (11, 3)).astype(np.int32)
    bf = np.round(rng.standard_normal((9, 4)) * 8) / 8  # exact in bfloat16
    kw = {"comm": comm} if comm is not None else {}
    bf_arr = pkg.array(bf.astype(np.float32), split=0, **kw).astype(pkg.bfloat16)
    return {
        "f32": pkg.array(f32, split=0, **kw), "f64": pkg.array(f64, split=1, **kw),
        "i32": pkg.array(i32, split=None, **kw), "bf16": bf_arr,
        "numpy": np.arange(6, dtype=np.int64).reshape(2, 3), "count": 17,
    }, {"f32": f32, "f64": f64, "i32": i32, "bf16": bf}


def _mixed_template(pkg, splits=(1, 0, 0, 1), comm=None):
    kw = {"comm": comm} if comm is not None else {}
    return {
        "f32": pkg.zeros((7, 6), split=splits[0], **kw), "f64": pkg.zeros((5, 9), dtype=pkg.float64, split=splits[1], **kw),
        "i32": pkg.zeros((11, 3), dtype=pkg.int32, split=splits[2], **kw),
        "bf16": pkg.zeros((9, 4), dtype=pkg.bfloat16, split=splits[3], **kw),
        "numpy": np.zeros((2, 3), np.int64), "count": 0,
    }


def _check_mixed(back, want, dtypes):
    for k, v in want.items():
        got = np.asarray(back[k].numpy()).astype(np.float64)
        np.testing.assert_array_equal(got, v, err_msg=k)
        assert str(back[k].dtype.__name__) == dtypes[k], (k, back[k].dtype)
    np.testing.assert_array_equal(np.asarray(back["numpy"]), np.arange(6).reshape(2, 3))
    assert int(back["count"]) == 17


DTYPES = {"f32": "float32", "f64": "float64", "i32": "int32", "bf16": "bfloat16"}


@pytest.mark.parametrize("parallel", [True, False])
def test_heat_tpu_writes_port_restores(tmp_path, parallel):
    tree, want = _mixed(jht)
    path = str(tmp_path / "j")
    jht.save_checkpoint(tree, path, parallel=parallel)
    manifest = ckpt.read_manifest(path)
    assert manifest["schema"] == (ckpt.SCHEMA if parallel else ckpt.SCHEMA_V1)
    if parallel:
        # the leaves in jax's order: bf16, count, f32, f64, i32, numpy; f32's 7 rows on 8
        # devices make 7 chunks (ragged, the last device's empty)
        assert len(manifest["leaves"][2]["chunks"]) == 7 and manifest["leaves"][2]["shape"] == [7, 6]
    back = ht.load_checkpoint(_mixed_template(ht), path)
    _check_mixed(back, want, DTYPES)
    assert back["bf16"].larray.dtype == torch.bfloat16 and back["f32"].split == 1
    assert ckpt.verify_checkpoint(path) == [] and ckpt.last_restore_stats()["read_bytes"] > 0


@pytest.mark.parametrize("parallel", [True, False])
def test_port_writes_heat_tpu_restores(tmp_path, parallel):
    tree, want = _mixed(ht)
    path = str(tmp_path / "p")
    ht.save_checkpoint(tree, path, parallel=parallel)
    assert jckpt.verify_checkpoint(path) == []
    back = jht.load_checkpoint(_mixed_template(jht), path)
    _check_mixed(back, want, DTYPES)
    assert back["f32"].split == 1 and back["f64"].split == 0


@pytest.mark.parametrize("parallel", [True, False])
def test_payloads_byte_equal_where_grids_agree(tmp_path, parallel):
    """heat_tpu on a one-device mesh and the port at one rank write the same chunk grid
    (v2) or leaf files (v1): the same files, byte for byte, and the same manifest entries,
    0-d leaves included."""
    one = MeshCommunication(devices=jax.devices()[:1])
    jtree, _ = _mixed(jht, comm=one)
    ttree, _ = _mixed(ht)
    jtree["scalar"] = ttree["scalar"] = np.float32(2.5)
    jp, tp = str(tmp_path / "j1"), str(tmp_path / "t1")
    jht.save_checkpoint(jtree, jp, parallel=parallel)
    ht.save_checkpoint(ttree, tp, parallel=parallel)
    jm, tm = ckpt.read_manifest(jp), ckpt.read_manifest(tp)
    assert jm.get("processes") == tm.get("processes") and jm["schema"] == tm["schema"]
    assert jm["leaves"] == tm["leaves"]
    for f, _, _ in ckpt._manifest_files(tm):
        assert open(os.path.join(jp, f), "rb").read() == open(os.path.join(tp, f), "rb").read()


# ------------------------------------------------------------------ integrity
def test_manifest_is_written_and_verifies(tmp_path):
    value = np.arange(20, dtype=np.float32)
    path = _save(tmp_path, "ok", value)
    leaf = ckpt.read_manifest(path)["leaves"][0]
    assert leaf["split"] == 0 and leaf["shards"] == 1
    assert sum(c["nbytes"] for c in leaf["chunks"]) == value.nbytes
    assert ckpt.verify_checkpoint(path) == []


@pytest.mark.parametrize("fraction", [0.5, 0.25])
def test_torn_write_restore_rejects_and_reports(tmp_path, fraction):
    resilience.arm_fault_plan([{"site": "checkpoint.chunk_write", "on_call": 1, "kind": "torn-write",
                                "fraction": fraction}])
    path = _save(tmp_path, "torn", np.arange(32, dtype=np.float32))
    resilience.disarm_fault_plan()
    problems = ckpt.verify_checkpoint(path)
    assert len(problems) == 1 and "torn write" in problems[0]
    with pytest.raises(ht.CheckpointCorrupt, match="leaf_0.c"):
        ht.load_checkpoint({"x": ht.zeros((32,), split=0)}, path)
    assert jckpt.verify_checkpoint(path) == problems  # heat_tpu reads the same verdict


def test_hand_truncated_and_bitflipped_chunks_detected(tmp_path):
    path = _save(tmp_path, "trunc", np.arange(16, dtype=np.float32))
    leaf = _first_chunk(path)
    with open(leaf, "r+b") as fh:
        fh.truncate(os.path.getsize(leaf) // 2)
    with pytest.raises(ht.CheckpointCorrupt):
        ht.load_checkpoint({"x": ht.zeros((16,), split=0)}, path)
    path = _save(tmp_path, "flip", np.arange(16, dtype=np.float32))
    leaf = _first_chunk(path)
    with open(leaf, "r+b") as fh:
        fh.seek(3)
        byte = fh.read(1)
        fh.seek(3)
        fh.write(bytes([byte[0] ^ 0xFF]))
    assert any("sha256 mismatch" in p for p in ckpt.verify_checkpoint(path))
    with pytest.raises(ht.CheckpointCorrupt):
        ht.load_checkpoint({"x": ht.zeros((16,), split=0)}, path)


def test_incomplete_chunk_grid_is_corrupt_even_unverified(tmp_path):
    """A manifest that lost a chunk entry (heat_tpu's 8 chunks) raises with verify=False too."""
    path = str(tmp_path / "grid")
    jht.save_checkpoint({"x": jht.array(np.arange(24, dtype=np.float32).reshape(8, 3), split=0)}, path)
    mpath = os.path.join(path, ckpt.MANIFEST_NAME)
    manifest = json.load(open(mpath))
    del manifest["leaves"][0]["chunks"][1]
    json.dump(manifest, open(mpath, "w"))
    assert "chunk grid incomplete" in ckpt.verify_checkpoint(path)[0]
    for verify in (True, False):
        with pytest.raises(ht.CheckpointCorrupt, match="chunk grid incomplete"):
            ht.load_checkpoint({"x": ht.zeros((8, 3), split=0)}, path, verify=verify)


def test_v1_torn_leaf_is_typed_even_unverified(tmp_path):
    path = str(tmp_path / "v1torn")
    ht.save_checkpoint({"x": ht.array(np.arange(16, dtype=np.float32), split=0)}, path, parallel=False)
    leaf = os.path.join(path, ckpt.read_manifest(path)["leaves"][0]["file"])
    with open(leaf, "r+b") as fh:
        fh.truncate(os.path.getsize(leaf) // 2)
    with pytest.raises(ht.CheckpointCorrupt, match="torn read"):
        ht.load_checkpoint({"x": ht.zeros((16,), split=0)}, path, verify=False)


def test_missing_or_foreign_manifest_is_corrupt_not_crash(tmp_path):
    path = str(tmp_path / "empty")
    os.makedirs(path)
    with pytest.raises(ht.CheckpointCorrupt, match="manifest.json missing"):
        ht.load_checkpoint({"x": ht.zeros(3)}, path)
    with open(os.path.join(path, ckpt.MANIFEST_NAME), "w") as fh:
        json.dump({"schema": "other/1", "leaves": []}, fh)
    with pytest.raises(ht.CheckpointCorrupt, match="unknown manifest schema"):
        ht.load_checkpoint({"x": ht.zeros(3)}, path)
    with open(os.path.join(path, ckpt.MANIFEST_NAME), "w") as fh:
        fh.write("{not json")
    with pytest.raises(ht.CheckpointCorrupt, match="unparseable"):
        ht.load_checkpoint({"x": ht.zeros(3)}, path)


def test_write_fault_retried_under_policy(tmp_path):
    resilience.arm_fault_plan([{"site": "checkpoint.chunk_write", "on_call": 1, "count": 2, "kind": "raise"}])
    value = np.arange(12, dtype=np.float32)
    path = _save(tmp_path, "retried", value)  # two injected failures, the third lands
    assert ckpt.read_manifest(path)["schema"] == ckpt.SCHEMA
    np.testing.assert_array_equal(ht.load_checkpoint({"x": ht.zeros((12,), split=0)}, path)["x"].numpy(), value)
    assert resilience.resilience_stats()["faults_fired"] == 2


def test_latest_step_skips_corrupt_step_directory(tmp_path):
    mgr = ht.CheckpointManager(str(tmp_path / "run"), max_to_keep=5)
    x = ht.arange(12, dtype=ht.float32, split=0)
    for s in (1, 2, 3):
        mgr.save(s, {"x": x * float(s)})
    os.unlink(str(tmp_path / "run" / "step_3" / "manifest.json"))
    assert mgr.all_steps() == [1, 2] and mgr.latest_step == 2
    np.testing.assert_array_equal(mgr.restore({"x": ht.zeros((12,), split=0)})["x"].numpy(), (x * 2.0).numpy())
    with open(str(tmp_path / "run" / "step_2" / "manifest.json"), "w") as fh:
        fh.write("{not json")
    assert mgr.all_steps() == [1]
    leaf = _first_chunk(str(tmp_path / "run" / "step_1"))
    with open(leaf, "r+b") as fh:
        fh.truncate(4)
    assert mgr.all_steps() == [1]
    with pytest.raises(ht.CheckpointCorrupt):
        mgr.restore({"x": ht.zeros((12,), split=0)}, step=1)
    assert any(e["kind"] == "corrupt-step" for e in diagnostics.report()["resilience_events"])


def test_retention_gcs_corrupt_step_dirs(tmp_path):
    mgr = ht.CheckpointManager(str(tmp_path / "gc"), max_to_keep=2)
    x = ht.arange(6, dtype=ht.float32, split=0)
    mgr.save(1, {"x": x})
    os.unlink(str(tmp_path / "gc" / "step_1" / "manifest.json"))
    mgr.save(2, {"x": x * 2.0})
    assert not os.path.exists(str(tmp_path / "gc" / "step_1")) and mgr.all_steps() == [2]


def test_stale_tmp_and_old_dirs_swept_by_next_save(tmp_path):
    value = np.arange(8, dtype=np.float32)
    path = _save(tmp_path, "sweep", value)
    os.rename(path, path + ".old.999999")
    os.makedirs(path + ".tmp.999999")
    ht.save_checkpoint({"x": ht.array(value * 2.0, split=0)}, path)
    assert not os.path.exists(path + ".old.999999") and not os.path.exists(path + ".tmp.999999")
    np.testing.assert_array_equal(ht.load_checkpoint({"x": ht.zeros((8,), split=0)}, path)["x"].numpy(), value * 2.0)


def test_save_is_atomic_under_midwrite_crash(tmp_path):
    value = np.arange(8, dtype=np.float32)
    path = _save(tmp_path, "atomic", value)
    resilience.arm_fault_plan([{"site": "checkpoint.manifest", "on_call": 1, "count": 999, "kind": "raise"}])
    with pytest.raises(resilience.FaultInjected):
        ht.save_checkpoint({"x": ht.array(value * 9.0, split=0)}, path)
    resilience.disarm_fault_plan()
    np.testing.assert_array_equal(ht.load_checkpoint({"x": ht.zeros((8,), split=0)}, path)["x"].numpy(), value)
    assert ckpt.verify_checkpoint(path) == []


# ------------------------------------------------------------------ the crash matrix (heat_tpu's points)
CRASH_POINTS = [
    ("mid-chunk-write", [{"site": "checkpoint.chunk_write", "on_call": 1, "count": 9999, "kind": "raise"},
                         {"site": "checkpoint.write", "on_call": 1, "count": 9999, "kind": "raise"}], True, True),
    ("between-chunks", [{"site": "checkpoint.chunk_write", "on_call": 3, "count": 9999, "kind": "raise"},
                        {"site": "checkpoint.write", "on_call": 2, "count": 9999, "kind": "raise"}], True, True),
    ("pre-manifest", [{"site": "checkpoint.manifest", "on_call": 1, "count": 9999, "kind": "raise"}], True, True),
    ("commit-first-rename", [{"site": "checkpoint.commit", "on_call": 1, "count": 1, "kind": "raise"}], True, True),
    ("commit-between-renames", [{"site": "checkpoint.commit", "on_call": 2, "count": 1, "kind": "raise"}], False, True),
]


@pytest.mark.parametrize("point", [c[0] for c in CRASH_POINTS])
@pytest.mark.parametrize("overwrite", [False, True])
def test_crash_matrix(tmp_path, point, overwrite):
    _, plan, fail_fresh, fail_over = next(c for c in CRASH_POINTS if c[0] == point)
    must_fail = fail_over if overwrite else fail_fresh
    path = str(tmp_path / "ckpt")
    old = _tree(1.0)
    if overwrite:
        ht.save_checkpoint(old, path)
    resilience.reset(clear_breakers=True)
    resilience.arm_fault_plan(plan)
    new = _tree(5.0)
    failed = False
    try:
        ht.save_checkpoint(new, path)
    except Exception:
        failed = True
    resilience.disarm_fault_plan()
    assert failed == must_fail
    if failed and not overwrite:
        with pytest.raises(ht.CheckpointCorrupt):
            ht.load_checkpoint(_template(), path)
    else:
        expect = _values(old) if failed else _values(new)
        assert ckpt.verify_checkpoint(path) == []
        a, b, step = _values(ht.load_checkpoint(_template(), path))
        np.testing.assert_array_equal(a, expect[0])
        np.testing.assert_array_equal(b, expect[1])
        assert step == expect[2]
    resilience.reset(clear_breakers=True)
    ht.save_checkpoint(_tree(9.0), path)
    np.testing.assert_array_equal(_values(ht.load_checkpoint(_template(), path))[0], _values(_tree(9.0))[0])
    base = os.path.basename(path)
    assert [n for n in os.listdir(str(tmp_path)) if n.startswith(f"{base}.tmp.") or n.startswith(f"{base}.old.")] == []


def test_chunk_read_fault_is_typed_not_hang(tmp_path):
    path = str(tmp_path / "rd")
    ht.save_checkpoint(_tree(2.0), path)
    resilience.arm_fault_plan([{"site": "checkpoint.chunk_read", "on_call": 1, "count": 9999, "kind": "raise"}])
    with pytest.raises(resilience.FaultInjected):
        ht.load_checkpoint(_template(), path)


def test_degrades_to_v1_with_recorded_fallback(tmp_path):
    diagnostics.enable()
    try:
        diagnostics.reset()
        path = str(tmp_path / "deg")
        resilience.arm_fault_plan([{"site": "checkpoint.chunk_write", "on_call": 1, "count": 9999, "kind": "raise"}])
        ht.save_checkpoint(_tree(4.0), path)
        resilience.disarm_fault_plan()
        assert ckpt.read_manifest(path)["schema"] == ckpt.SCHEMA_V1
        np.testing.assert_array_equal(_values(ht.load_checkpoint(_template(), path))[0], _values(_tree(4.0))[0])
        report = diagnostics.report()
        events = [e for e in report["resilience_events"] if e["site"] == "checkpoint.save" and e["kind"] == "fallback"]
        assert events and "serialized v1" in events[-1]["detail"]
        assert report["counters"]["fallback.checkpoint.save"] == 1
        assert report["fallback_events"][-1]["site"] == "checkpoint.save"
        assert report["resilience"]["breakers"]["checkpoint.chunk_write"]["failures"] >= 1
        # heat_tpu restores the degraded (v1) checkpoint too
        back = jht.load_checkpoint({"a": jht.zeros((7, 6), split=0), "b": jht.zeros((5,)), "step": np.int64(0)}, path)
        np.testing.assert_array_equal(back["a"].numpy(), _values(_tree(4.0))[0])
    finally:
        diagnostics.disable()


def test_open_breaker_short_circuits_to_v1_until_cooldown(tmp_path):
    clock = [0.0]
    br = resilience.breaker("checkpoint.chunk_write", failure_threshold=3, cooldown_s=60.0, clock=lambda: clock[0])
    for _ in range(3):
        br.record_failure("disk went away")
    assert br.state == resilience.OPEN
    path = str(tmp_path / "bro")
    ht.save_checkpoint(_tree(6.0), path)
    assert ckpt.read_manifest(path)["schema"] == ckpt.SCHEMA_V1
    clock[0] = 61.0
    ht.save_checkpoint(_tree(6.0), path)
    assert ckpt.read_manifest(path)["schema"] == ckpt.SCHEMA and br.state == resilience.CLOSED


@pytest.mark.parametrize("strict_case", ["same", "split", "shards", "v1", "replicated"])
def test_strict_layout(tmp_path, strict_case):
    path = str(tmp_path / "strict")
    if strict_case == "shards":
        # heat_tpu's 8-chunk grid against the port's one rank
        jht.save_checkpoint({"x": jht.array(np.arange(12, dtype=np.float32), split=0)}, path)
        with pytest.raises(ht.CheckpointLayoutMismatch):
            ht.load_checkpoint({"x": ht.zeros((12,), split=0)}, path, strict="layout")
        return
    split = None if strict_case == "replicated" else 0
    src = ht.array(np.arange(12, dtype=np.float32).reshape(4, 3), split=split)
    ht.save_checkpoint({"x": src}, path, parallel=strict_case != "v1")
    same = ht.load_checkpoint({"x": ht.zeros((4, 3), split=split)}, path, strict="layout")
    np.testing.assert_array_equal(same["x"].numpy(), src.numpy())
    if strict_case in ("split", "v1"):
        with pytest.raises(ht.CheckpointLayoutMismatch):
            ht.load_checkpoint({"x": ht.zeros((4, 3), split=1)}, path, strict="layout")
        moved = ht.load_checkpoint({"x": ht.zeros((4, 3), split=1)}, path)
        assert moved["x"].split == 1
        np.testing.assert_array_equal(moved["x"].numpy(), src.numpy())
    with pytest.raises(ValueError, match="strict"):
        ht.load_checkpoint({"x": ht.zeros((4, 3))}, path, strict="loose")


def test_restore_reads_only_the_target_rows(tmp_path):
    """Restoring heat_tpu's 8-chunk split-0 leaf onto each rank of 3 reads only the byte
    ranges of that rank's rows (at most one target chunk's bytes of the widest leaf)."""
    from heat_tpu_torch.core.communication import TorchCommunication

    class _Sized(TorchCommunication):
        def __init__(self, size, rank):
            super().__init__()
            self._size, self._rank = size, rank

        size = property(lambda self: self._size)
        rank = property(lambda self: self._rank)

    n = 64 * 8
    a = np.arange(n * 8, dtype=np.float32).reshape(n, 8)
    path = str(tmp_path / "peak")
    jht.save_checkpoint({"a": jht.array(a, split=0)}, path)
    parts = []
    for r in range(3):
        comm = _Sized(3, r)
        back = ht.load_checkpoint({"a": ht.zeros((n, 8), split=0, comm=comm)}, path)
        _, lshape, _ = comm.chunk((n, 8), 0)
        stats = ckpt.last_restore_stats()
        assert stats["read_bytes"] == lshape[0] * 8 * 4 and stats["host_bytes_peak"] <= -(-n // 3) * 8 * 4
        parts.append(back["a"].larray.numpy())
    np.testing.assert_array_equal(np.concatenate(parts), a)


def test_verify_false_skips_digests_but_checks_lengths(tmp_path):
    path = _save(tmp_path, "nv", np.arange(32, dtype=np.float32))
    chunk = _first_chunk(path)
    with open(chunk, "r+b") as fh:
        fh.seek(1)
        fh.write(b"\xff")
    ht.load_checkpoint({"x": ht.zeros((32,), split=0)}, path, verify=False)
    with open(chunk, "r+b") as fh:
        fh.truncate(4)
    with pytest.raises(ht.CheckpointCorrupt):
        ht.load_checkpoint({"x": ht.zeros((32,), split=0)}, path, verify=False)


# ------------------------------------------------------------------ the manager's pruning
def test_prune_records_events(tmp_path):
    mgr = ht.CheckpointManager(str(tmp_path / "run"), max_to_keep=1)
    x = ht.arange(12, dtype=ht.float32, split=0)
    mgr.save(1, {"x": x})
    mgr.save(2, {"x": x * 2.0})
    assert mgr.all_steps() == [2]
    events = [e for e in diagnostics.report()["resilience_events"] if e["site"] == "checkpoint.prune"
              and e["kind"] == "pruned"]
    assert events and "step_1" in events[-1]["detail"]


@pytest.mark.parametrize("hold", ["local", "sentinel"])
def test_prune_deferred_while_a_restore_holds_then_retried(tmp_path, hold):
    mgr = ht.CheckpointManager(str(tmp_path / "hold"), max_to_keep=1)
    x = ht.arange(8, dtype=ht.float32, split=0)
    mgr.save(1, {"x": x})
    step1 = str(tmp_path / "hold" / "step_1")
    if hold == "local":
        with ckpt._hold_restore(step1):
            mgr.save(2, {"x": x * 2.0})
            assert os.path.exists(step1)
    else:
        sentinel = f"{step1}.hold.p1.99999.1"
        open(sentinel, "w").write("in-flight restore hold\n")
        mgr.save(2, {"x": x * 2.0})
        assert os.path.exists(step1)
        os.unlink(sentinel)
    assert [e for e in diagnostics.report()["resilience_events"] if e["kind"] == "prune-deferred"
            and "step_1" in e["detail"]]
    mgr.save(3, {"x": x * 3.0})
    assert not os.path.exists(step1) and mgr.all_steps() == [3]


def test_prune_failure_is_loud(tmp_path):
    mgr = ht.CheckpointManager(str(tmp_path / "loud"), max_to_keep=1)
    x = ht.arange(8, dtype=ht.float32, split=0)
    mgr.save(1, {"x": x})
    resilience.arm_fault_plan([{"site": "checkpoint.prune", "on_call": 1, "count": 9999, "kind": "raise"}])
    with pytest.raises(resilience.FaultInjected):
        mgr.save(2, {"x": x * 2.0})
    resilience.disarm_fault_plan()
    assert [e for e in diagnostics.report()["resilience_events"] if e["kind"] == "prune-failed"]


def test_gathered_and_written_bytes_recorded(tmp_path):
    diagnostics.enable()
    try:
        diagnostics.reset()
        ht.save_checkpoint({"x": ht.array(np.ones((16, 4), np.float32), split=0)}, str(tmp_path / "gauge"))
        counters = diagnostics.report()["counters"]
        assert counters["checkpoint.gathered_bytes"] == counters["checkpoint.written_bytes"] == 16 * 4 * 4
    finally:
        diagnostics.disable()


def test_writer_merges_peer_sidecars_into_manifest(tmp_path):
    import hashlib

    tmpdir, target = str(tmp_path / "asm.tmp.v2"), str(tmp_path / "asm")
    os.makedirs(tmpdir)
    entry = {"shape": [8], "dtype": "float32", "split": 0, "shards": 2}
    metas = {}
    for off in (0, 4):
        payload = np.arange(off, off + 4, dtype=np.float32).tobytes()
        fname = ckpt._chunk_file(0, off // 4)
        open(os.path.join(tmpdir, fname), "wb").write(payload)
        metas[off] = {"file": fname, "offset": off, "rows": 4, "nbytes": len(payload),
                      "sha256": hashlib.sha256(payload).hexdigest()}
    json.dump({"0": [metas[4]]}, open(os.path.join(tmpdir, "chunkmeta.p1.json"), "w"))
    ckpt._assemble_and_commit_v2(target, tmpdir, [entry], {0: [metas[0]]})
    assert [c["offset"] for c in ckpt.read_manifest(target)["leaves"][0]["chunks"]] == [0, 4]
    np.testing.assert_array_equal(ht.load_checkpoint({"x": ht.zeros((8,), split=0)}, target)["x"].numpy(),
                                  np.arange(8, dtype=np.float32))
    tmpdir2 = str(tmp_path / "inc.tmp.v2")
    os.makedirs(tmpdir2)
    with pytest.raises(ckpt.CheckpointWriteFailed):
        ckpt._assemble_and_commit_v2(str(tmp_path / "inc"), tmpdir2, [entry], {})
    assert not os.path.exists(str(tmp_path / "inc"))


def test_resilience_and_diagnostics_match_heat_tpu():
    """The port's copies keep heat_tpu's surface and behaviour: the names, a policy's
    retry ladder, a breaker's transitions, a plan's parse errors and rank targeting."""
    assert resilience.__all__ == jres.__all__
    from heat_tpu.core import diagnostics as jdiag

    assert diagnostics.__all__ == jdiag.__all__
    for mod in (resilience, jres):
        sleeps = []
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert mod.Policy(max_attempts=3, backoff_base=0.5).run("t.site", flaky, sleep=sleeps.append) == "ok"
        assert sleeps == [0.5, 1.0]
        clock = [0.0]
        br = mod.CircuitBreaker("t.br", failure_threshold=2, cooldown_s=10.0, clock=lambda: clock[0])
        br.record_failure()
        br.record_failure()
        assert br.state == mod.OPEN and not br.allows()
        clock[0] = 11.0
        assert br.allows() and not br.allows()
        br.record_success()
        assert br.state == mod.CLOSED
        with pytest.raises(ValueError):
            mod.arm_fault_plan([{"site": "x", "kind": "melt"}])
        mod.set_fault_rank(1)
        mod.arm_fault_plan([{"site": "t.rank", "rank": 2}, {"site": "t.any"}])
        assert mod.fault_signal("t.rank") is None and mod.fault_signal("t.any") is not None
        mod.disarm_fault_plan()
        mod.set_fault_rank(None)


def test_env_canned_plan_fires_at_v2_sites(tmp_path):
    """A HEAT_TPU_FAULT_PLAN from the environment arms the port at import and fires at its
    checkpoint sites, in a child process."""
    import subprocess
    import sys

    plan = json.dumps([{"site": "checkpoint.chunk_write", "on_call": 2, "count": 1, "kind": "raise"},
                       {"site": "checkpoint.commit", "on_call": 1, "count": 1, "kind": "raise"}])
    code = (
        "import json, sys, numpy as np\n"
        "import heat_tpu_torch as ht\n"
        "from heat_tpu_torch.core import resilience\n"
        "ht.use_device('cpu')\n"
        "assert resilience._armed\n"
        "failed = 0\n"
        "try:\n"
        "    ht.save_checkpoint({'x': ht.arange(24, split=0), 'y': ht.ones(3)}, sys.argv[1] + '/c')\n"
        "except Exception:\n"
        "    failed = 1\n"
        "s = resilience.resilience_stats()\n"
        "print(json.dumps({'failed': failed, 'fired': s['faults_fired'], 'calls': s['site_calls']}))\n"
    )
    env = dict(os.environ, HEAT_TPU_FAULT_PLAN=plan)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=120,
                          env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["fired"] >= 1 and "checkpoint.chunk_write" in rec["calls"]
    assert glob.glob(str(tmp_path / "c.*")) == [] or rec["failed"] == 1
    shutil.rmtree(str(tmp_path / "c"), ignore_errors=True)
