"""The port's replay manifest and warmup (heat_tpu_torch/core/_compile_cache.py,
``executor_warmup``/``executor_save_warmup``, ``linalg.comm_plan.replay_warmup``)
against heat_tpu's.

For staged ``l``/``r``/``c``/``mm`` signatures and deferred chains at split 0 and
None, on layouts that pad nowhere (heat_tpu on a one-device mesh), the port's
``_Program.spec`` and ``fingerprint`` equal heat_tpu's; a manifest saved by heat_tpu is
replayed by the port with ``failed == 0`` and the reverse works too; a corrupt index is
a typed rejection and serving continues. The port has no compiled artifact:
``artifacts`` and ``aot_loaded`` are 0. Nothing is excluded from the spec comparisons.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.core import _compile_cache as jcc
from heat_tpu.core import _executor as jexec
from heat_tpu.core import _operations as jops

import heat_tpu_torch as htt
from heat_tpu_torch.core import _compile_cache, _executor, _operations, diagnostics
from heat_tpu_torch.core.linalg import comm_plan

SHAPES = ((12,), (6, 4))


@pytest.fixture(autouse=True)
def _threshold_one(monkeypatch):
    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_JIT_THRESHOLD", "1")
    for ex in (_executor, jexec):
        ex.clear_executor_cache()
    yield
    monkeypatch.undo()
    for ex in (_executor, jexec):
        ex.clear_executor_cache()


@pytest.fixture(scope="module")
def comm1():
    return ht.MeshCommunication(jax.devices()[:1])


def _specs(ex):
    with ex._lock:
        return {e.label: e.spec for e in ex._programs.values() if e is not ex.UNSUPPORTED and e.spec is not None}


def _by_fp(ex):
    out = {}
    with ex._lock:
        for e in ex._programs.values():
            if e is not ex.UNSUPPORTED and e.spec is not None:
                out[_compile_cache.fingerprint(e.spec)] = e.spec
    return out


def _traffic(mod, split, comm=None, shape=(12,)):
    """heat_tpu's test_compile_cache workload: a fused fan-out chain (interior output)
    plus a staged reduction and scan, and a 4-op elementwise chain with a transcendental."""
    kw = {} if comm is None else {"comm": comm}
    n = int(np.prod(shape))
    np_a = np.arange(n, dtype=np.float32).reshape(shape)
    a = mod.array(np_a, split=split, **kw)
    b = mod.array(np_a + 1.0, split=split, **kw)
    t = a + b
    u = t * 2.0
    v = t * 3.0
    vals = [u.numpy(), v.numpy(), t.numpy(), mod.sum(a).numpy(), mod.cumsum(a, axis=0).numpy(),
            mod.sum(a, axis=0).numpy()]
    c = mod.tanh(mod.exp(a * 0.01) - b) / 3.0
    vals.append(c.numpy())
    return vals


@pytest.mark.parametrize("split", (0, None))
@pytest.mark.parametrize("shape", SHAPES)
def test_specs_and_fingerprints_equal_heat_tpus(comm1, split, shape):
    want = _traffic(ht, split, comm1, shape)
    got = _traffic(htt, split, None, shape)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=4e-7, atol=0)
    mine, theirs = _by_fp(_executor), _by_fp(jexec)
    assert len(mine) >= 6
    assert mine == theirs
    fams = {s["family"] for s in mine.values()}
    assert {"defer", "r", "c"} <= fams
    with _executor._lock:
        for e in _executor._programs.values():
            if e is not _executor.UNSUPPORTED and e.spec is not None:
                assert e.fingerprint is None or e.fingerprint == _compile_cache.fingerprint(e.spec)


@pytest.mark.parametrize("split", (0, None))
def test_staged_local_spec_equals_heat_tpus(comm1, split):
    x = ht.array(np.linspace(0.1, 2.0, 12, dtype=np.float32), split=split, comm=comm1)
    jops._local_jit(jnp.exp, x, None, {})
    xt = htt.array(np.linspace(0.1, 2.0, 12, dtype=np.float32), split=split)
    with _operations.staged_only():
        htt.exp(xt)
    mine = [s for s in _specs(_executor).values() if s["family"] == "l"]
    theirs = [s for s in _specs(jexec).values() if s["family"] == "l"]
    assert mine == theirs and len(mine) == 1 and mine[0]["op"] == "exp"


class _Sized(htt.TorchCommunication):
    """A communicator that reports three ranks without a process group (for specs)."""

    @property
    def size(self):
        return 3

    @property
    def rank(self):
        return 0


@pytest.mark.parametrize("pair", ((0, 0), (1, 1), (0, 1)))
def test_mm_spec_equals_heat_tpus(pair):
    from heat_tpu.core.linalg import comm_plan as jplan

    comm3 = ht.MeshCommunication(jax.devices()[:3])
    rng = np.random.default_rng(3)
    an, bn = rng.standard_normal((6, 9)).astype(np.float32), rng.standard_normal((9, 12)).astype(np.float32)
    a = ht.array(an, split=pair[0], comm=comm3)
    b = ht.array(bn, split=pair[1], comm=comm3)
    seen = {}
    real = jexec.lookup

    def spy(key, build, label=None, spec=None):
        if spec is not None and label and label.startswith("mm."):
            seen["spec"] = spec()
        return real(key, build, label=label, spec=spec)

    jplan._executor.lookup, old = spy, jplan._executor.lookup
    try:
        ht.matmul(a, b)
    finally:
        jplan._executor.lookup = old
    comm = _Sized()
    dev = htt.get_device()
    da = htt.DNDarray(torch_zeros((2, 9) if pair[0] == 0 else (6, 3)), (6, 9), htt.float32, pair[0], dev, comm, True)
    db = htt.DNDarray(torch_zeros((3, 12) if pair[1] == 0 else (9, 4)), (9, 12), htt.float32, pair[1], dev, comm,
                      True)
    plan = comm_plan.plan_matmul(da, db)
    assert plan.kind == "ring"
    mine = comm_plan._mm_spec(plan, da, db)
    assert mine == seen["spec"]


def torch_zeros(shape):
    import torch

    return torch.zeros(shape, dtype=torch.float32)


def _save_replay(saver, warmer, saver_traffic, warm_traffic, tmp_path):
    d = str(tmp_path / "manifest")
    saver_traffic()
    res = saver.executor_save_warmup(d, top=16)
    assert res["saved"] >= 6
    doc = json.load(open(os.path.join(d, "index.json")))
    assert doc["schema"] == "heat-tpu-compile-cache/1" and len(doc["entries"]) == res["saved"]
    warmer.clear_executor_cache()
    stats = warmer.executor_warmup(d)
    assert stats["failed"] == 0, stats
    assert stats["replayed"] == res["saved"], stats
    warmer.reset_executor_stats()
    warm_traffic()
    st = warmer.executor_stats()
    assert st["misses"] == 0 and st["retraces"] == 0, st
    return res, stats


def test_heat_tpu_manifest_replays_in_the_port(comm1, tmp_path):
    res, stats = _save_replay(jexec, _executor, lambda: _traffic(ht, 0, comm1), lambda: _traffic(htt, 0), tmp_path)
    assert stats["aot_loaded"] == 0


def test_port_manifest_replays_in_heat_tpu(comm1, tmp_path):
    # heat_tpu's warmup rebuilds on its default communicator: give it the one-device mesh
    # for the test, and the test mesh back after it
    from heat_tpu.core import communication as jcomm

    prior = jcomm.get_comm()
    jcomm.use_comm(comm1)
    try:
        res, stats = _save_replay(_executor, jexec, lambda: _traffic(htt, 0), lambda: _traffic(ht, 0, comm1),
                                  tmp_path)
    finally:
        jcomm.use_comm(prior)
    assert res["artifacts"] == 0


def test_warmup_removes_the_cold_build_and_stays_bit_equal(tmp_path):
    cold = _traffic(htt, 0)
    d = str(tmp_path / "m")
    _executor.executor_save_warmup(d)
    _executor.clear_executor_cache()
    assert _executor.executor_warmup(d)["replayed"] >= 6
    _executor.reset_executor_stats()
    warm = _traffic(htt, 0)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(cold, warm))
    st = htt.executor_stats()
    assert (st["misses"], st["retraces"]) == (0, 0)


def test_ragged_heat_tpu_spec_is_skipped_never_wrong(tmp_path):
    comm8 = ht.MeshCommunication(jax.devices())
    d = str(tmp_path / "ragged")
    x = ht.array(np.arange(13, dtype=np.float32), split=0, comm=comm8)
    ht.sum(x).numpy()
    jexec.executor_save_warmup(d)
    stats = _executor.executor_warmup(d)
    assert stats["failed"] == 0 and stats["replayed"] == 0 and stats["skipped"] >= 1


def test_corrupt_index_is_typed_and_serving_continues(tmp_path, monkeypatch):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "index.json").write_text("{not json")
    monkeypatch.setenv("HEAT_TPU_EXEC_CACHE", str(d))
    _executor.reload_env_knobs()

    def corrupt():
        with diagnostics._lock:
            return [e for e in diagnostics._resilience_events if e.get("kind") == "cache-corrupt"]

    n0 = len(corrupt())
    stats = _executor.executor_warmup()
    assert stats["replayed"] == 0 and stats["failed"] == 0
    assert len(corrupt()) == n0 + 1 and "CompileCacheCorrupt" in corrupt()[-1]["detail"]
    vals = _traffic(htt, 0)  # the boot still serves
    np.testing.assert_array_equal(vals[3], np.float32(66.0))
    with pytest.raises(ValueError):
        monkeypatch.delenv("HEAT_TPU_EXEC_CACHE")
        _executor.reload_env_knobs()
        _executor.executor_warmup(None)


def test_a_heat_tpu_blob_is_verified_and_never_loaded(comm1, tmp_path, monkeypatch):
    d = str(tmp_path / "blobs")
    _traffic(ht, 0, comm1)
    res = jexec.executor_save_warmup(d, top=16)
    assert res["artifacts"] >= 1
    doc = json.load(open(os.path.join(d, "index.json")))
    sha = next(e["blob"] for e in doc["entries"].values() if e.get("blob"))
    with open(os.path.join(d, "blobs", f"{sha}.bin"), "r+b") as f:
        f.truncate(16)  # a torn artifact
    monkeypatch.setenv("HEAT_TPU_EXEC_CACHE", d)
    _executor.reload_env_knobs()
    stats = _executor.executor_warmup()
    assert stats["failed"] == 0 and stats["aot_loaded"] == 0
    kinds = [e["kind"] for e in diagnostics._resilience_events if e.get("site") == "executor.compile_cache"]
    assert "cache-corrupt" in kinds and "artifact-incompatible" in kinds
    assert _compile_cache.__all__ == jcc.__all__
