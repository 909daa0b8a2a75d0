"""The port's supervision plane (heat_tpu_torch/core/supervision.py and
``resilience.run_supervised``) against heat_tpu's.

- ``Monitor`` over a ``LocalCoordinator`` with an injected clock: scripted beats,
  departures and silences give heat_tpu's scan verdicts and abort payloads.
- ``watch`` raises ``CollectiveTimeout``; a collective that fails on a dead peer while
  the plane is armed raises the typed abort error.
- The store-backed coordinator (``ClientCoordinator`` over a ``torch.distributed``
  ``FileStore``): directory listings, ``kv_wait``, ``kv_barrier``, the sentinel.
- ``run_supervised`` restores and resumes, as heat_tpu's, on one process; the
  multi-process case (three gloo ranks, rank 2 killed by the ``peer-dead`` fault, the
  survivors resuming at world 2) runs in the three-rank spawn of
  ``tests/test_torch_distributed.py``.

Excluded from comparisons: the ``last_seen_s``/``elapsed_s`` ages (clock arithmetic,
compared within 1e-9), nothing else.
"""

import datetime
import json
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

import heat_tpu as ht
from heat_tpu.core import resilience as jres
from heat_tpu.core import supervision as jsup

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, checkpoint, resilience, supervision


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_FLIGHT_DIR", str(tmp_path / "flight"))  # the aborts' post-mortems
    yield
    for sup, res in ((supervision, resilience), (jsup, jres)):
        sup.disarm()
        sup.reset_abort()
        res.disarm_fault_plan()
        res.reset(clear_breakers=True)
        sup.reload_env_knobs()


def _scan_script(sup):
    """Drive one monitor through beats, a stall, a departure and a silence; return the
    verdict after each step and the final abort payload."""
    co = sup.LocalCoordinator()
    clock = [0.0]
    mon = sup.arm(co, rank=0, nprocs=4, peer_timeout_s=5.0, clock=lambda: clock[0], start_thread=False)
    ns = f"heat_tpu/sup/{mon.generation}"
    verdicts = []
    rng = np.random.default_rng(2)
    for t in (0.0, 2.0, 4.0, 6.0):
        clock[0] = t
        co.set(f"{ns}/hb/1", f"beat-{t}", True)       # rank 1 beats
        if t < 3.0:
            co.set(f"{ns}/hb/2", f"beat-{t}", True)   # rank 2 beats, then stalls
        if t == 2.0:
            co.set(f"{ns}/bye/3", "1", True)          # rank 3 departs cleanly
        mon.step(t + float(rng.uniform(0, 1e-3)))
        verdicts.append(sup.aborted())
    clock[0] = 8.5
    mon.step(8.5)
    verdicts.append(sup.aborted())
    return verdicts


def test_monitor_scan_verdicts_match_heat_tpu():
    mine, theirs = _scan_script(supervision), _scan_script(jsup)
    assert [v is None for v in mine] == [v is None for v in theirs] == [True, True, True, True, False]
    m, t = mine[-1], theirs[-1]
    assert set(m) == set(t)
    for k in m:
        if k == "last_seen_s":
            assert abs(m[k] - t[k]) < 1e-9
        else:
            assert m[k] == t[k], k
    assert m["kind"] == "peer-failed" and m["rank"] == 2
    with pytest.raises(resilience.PeerFailed) as exc:
        supervision.poll("unit.site")
    assert exc.value.rank == 2 and exc.value.detected_by == 0


def test_sentinel_adoption_and_abort_payload_kinds():
    for sup in (supervision, jsup):
        co = sup.LocalCoordinator()
        mon = sup.arm(co, rank=0, nprocs=2, peer_timeout_s=50.0, start_thread=False)
        co.set(mon.sentinel_key, json.dumps({"kind": "collective-timeout", "site": "comm.x", "elapsed_s": 3.0,
                                             "by": 1}), False)
        mon.step(0.1)
    assert supervision.aborted() == jsup.aborted()
    with pytest.raises(resilience.CollectiveTimeout):
        supervision.poll("x")
    assert supervision.__all__ == jsup.__all__


def test_watch_raises_collective_timeout(monkeypatch, tmp_path):
    monkeypatch.setenv("HEAT_TPU_COLLECTIVE_TIMEOUT_S", "0.25")
    monkeypatch.setenv("HEAT_TPU_FLIGHT_DIR", str(tmp_path))
    supervision.reload_env_knobs()
    clock = [0.0]
    mon = supervision.arm(supervision.LocalCoordinator(), rank=0, nprocs=1, peer_timeout_s=100.0,
                          clock=lambda: clock[0], start_thread=False)
    with pytest.raises(resilience.CollectiveTimeout) as exc:
        with supervision.watch("comm.stuck"):
            clock[0] = 1.0
            mon.watchdog_scan(1.0)
    assert exc.value.site == "comm.stuck" and exc.value.elapsed_s >= 1.0
    assert supervision.aborted()["kind"] == "collective-timeout"
    with pytest.raises(resilience.CollectiveTimeout):
        htt.get_comm().barrier()  # the chokepoint polls the sentinel


def test_a_failing_collective_on_a_dead_peer_surfaces_typed():
    co = supervision.LocalCoordinator()
    mon = supervision.arm(co, rank=0, nprocs=2, peer_timeout_s=0.2, start_thread=False)

    def dead_peer():
        time.sleep(0.05)
        mon.step(time.monotonic() + 1.0)  # the monitor's verdict: rank 1 is silent

    threading.Thread(target=dead_peer).start()
    with pytest.raises(resilience.PeerFailed) as exc:
        with supervision.watch("comm.all_reduce"):
            raise RuntimeError("Connection closed by peer")  # gloo, peer gone
    assert isinstance(exc.value.__cause__, RuntimeError)
    supervision.reset_abort()
    with pytest.raises(ValueError):  # an error that is not a peer failure stays itself
        with supervision.watch("comm.all_reduce"):
            raise ValueError("shape mismatch")


@pytest.fixture
def store_co(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    store.set_timeout(datetime.timedelta(seconds=5))
    return supervision.ClientCoordinator(store)


def test_store_coordinator_directory_semantics(store_co):
    co, local = store_co, supervision.LocalCoordinator()
    for c in (co, local):
        c.set("ns/abort", "exact")
        c.set("ns/abort/0", "child")
        c.set("ns/hb/1", "7")
        c.set("ns/hb/10", "8")
        c.set("ns/hb/1", "9")  # overwrite
    for prefix in ("ns/abort", "ns/abort/", "ns/hb", "ns", "nothing"):
        assert co.get_dir(prefix) == local.get_dir(prefix), prefix
    for c in (co, local):
        c.delete("ns/abort")
    assert co.get_dir("ns/abort") == local.get_dir("ns/abort") == []
    assert co.wait("ns/hb/1", 100) == "9"
    co.set("ns/once", "a", False)
    with pytest.raises(ValueError):
        co.set("ns/once", "b", False)


def test_store_coordinator_kv_wait_and_barrier(store_co):
    co = store_co
    threading.Timer(0.1, lambda: co.set("k", "v42")).start()
    assert supervision.kv_wait("k", 5_000, site="t.kv", coordinator=co) == "v42"
    with pytest.raises(resilience.CoordinationTimeout) as exc:
        supervision.kv_wait("missing/key", 200, site="t.kv", coordinator=co)
    assert exc.value.key == "missing/key" and exc.value.timeout_ms == 200
    co.set("bar/x/2", "1")
    with pytest.raises(resilience.CoordinationTimeout) as exc:
        supervision.kv_barrier("bar/x", nprocs=4, rank=0, timeout_ms=250, site="t.bar", coordinator=co)
    assert exc.value.waiting_on == [1, 3]
    for r in (1, 2):
        co.set(f"bar/y/{r}", "1")
    supervision.kv_barrier("bar/y", nprocs=3, rank=0, timeout_ms=5_000, site="t.bar", coordinator=co)


def test_store_coordinator_carries_the_monitor(store_co):
    co = store_co
    mon = supervision.arm(co, rank=0, nprocs=2, peer_timeout_s=0.5, clock=lambda: 0.0,
                          start_thread=False)
    mon.step(0.0)
    assert co.get_dir(f"{mon.ns}/hb") == [(f"{mon.ns}/hb/0", "1")]
    mon.step(1.0)  # rank 1 never beat: past the budget
    assert supervision.aborted()["rank"] == 1
    assert len(co.get_dir(mon.abort_key)) == 1
    supervision.reset_abort()
    assert co.get_dir(mon.abort_key) == []


def test_checkpoint_waits_run_through_the_store(store_co, monkeypatch):
    co = store_co
    monkeypatch.setattr(checkpoint, "_world", lambda: type("W", (), {"size": 2, "rank": 0})())
    supervision.arm(co, rank=0, nprocs=2, peer_timeout_s=60.0, start_thread=False)
    checkpoint._reset_coordination()
    co.set("heat_tpu/ckpt/1/agree/1", "0")  # the "other rank" agrees on 0
    assert checkpoint._agree_min(1) == 0
    co.set("heat_tpu/ckpt/2/barrier/1", "1")
    checkpoint._barrier("unit")
    with pytest.raises(resilience.CoordinationTimeout):
        monkeypatch.setenv("HEAT_TPU_COORD_TIMEOUT_MS", "200")
        supervision.reload_env_knobs()
        checkpoint._barrier("never")


def test_supervised_bootstrap_and_teardown_at_world_one(tmp_path):
    supervision.bootstrap_distributed(f"file://{tmp_path / 'rdv'}", 1, 0, backend="gloo")
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert isinstance(supervision.default_coordinator(), supervision.ClientCoordinator)
        supervision.post_abort("peer-failed", rank=1, last_seen_s=1.0)
    finally:
        supervision.teardown_distributed()  # dirty: the abort is installed
    assert not dist.is_initialized()
    assert supervision.supervision_stats()["graveyard"] >= 1


def _manager(tmp_path, pkg):
    return pkg.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=8)


@pytest.mark.parametrize("pkg", ("port", "heat_tpu"))
def test_run_supervised_restores_and_resumes(tmp_path, pkg):
    mod, res = (htt, resilience) if pkg == "port" else (ht, jres)
    fail_once = [True]

    def step_fn(step, state):
        if step == 3 and fail_once[0]:
            fail_once[0] = False
            raise res.PeerFailed(1, 2.0)
        return {"w": state["w"] * 0.5 + float(step)}

    out = res.run_supervised(step_fn, _manager(tmp_path, mod), template={"w": mod.zeros((12,), split=0)},
                             state={"w": mod.ones((12,), split=0)}, max_steps=6)
    assert out["steps"] == 6 and out["restarts"] == 1
    w = np.ones(12)
    for s in range(6):
        w = w * 0.5 + s
    np.testing.assert_array_equal(out["state"]["w"].numpy(), w.astype(np.float32))


def test_run_supervised_budget_and_unrelated_errors(tmp_path):
    def always_fails(step, state):
        raise resilience.CollectiveTimeout("comm.x", 9.0)

    with pytest.raises(resilience.CollectiveTimeout):
        resilience.run_supervised(always_fails, _manager(tmp_path, htt), template={"w": htt.zeros((4,), split=0)},
                                  state={"w": htt.zeros((4,), split=0)}, max_steps=4,
                                  policy=resilience.Policy(max_attempts=2, backoff_base=0.01))

    def boom(step, state):
        raise ValueError("not a supervision failure")

    with pytest.raises(ValueError):
        resilience.run_supervised(boom, _manager(tmp_path, htt), template={"w": htt.zeros((4,), split=0)},
                                  state={"w": htt.zeros((4,), split=0)}, max_steps=2)


def test_peer_dead_fires_the_silence_hook(monkeypatch):
    calls = []
    monkeypatch.setattr(resilience, "_peer_dead_exit", lambda status: calls.append(status))
    supervision.arm(supervision.LocalCoordinator(), rank=0, nprocs=2, start_thread=False)
    resilience.arm_fault_plan([{"site": "train.step", "kind": "peer-dead", "on_call": 1}])
    with pytest.raises(resilience.FaultInjected):
        resilience.maybe_fault("train.step")
    assert calls == [resilience.PEER_DEAD_EXIT_STATUS]
    assert not supervision.armed()  # the hook stopped the heartbeats first


def test_knobs_reload_through_the_executor(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_COORD_TIMEOUT_MS", "12345")
    _executor.reload_env_knobs()
    assert supervision.coord_timeout_ms() == 12345
