"""The port's serving plane (heat_tpu_torch/serving.py: ``ModelPool``, ``swap_state``,
``on_peer_failure``) against heat_tpu's, and the surface of the plane's modules.

- load, swap and rollback on a corrupt generation, with exact accounting under 8
  threads (``admitted + failed == offered``, no untyped error) and every served value
  from one whole generation;
- the ledger fields equal heat_tpu's for the same script;
- no stale result-cache hit after a swap;
- ``on_peer_failure`` with a silent virtual peer;
- a generation saved by heat_tpu served by the port's pool;
- every name in the ``__all__`` of heat_tpu's seven plane modules exists in the port,
  and the two ``__version__``s are equal.

Excluded from comparisons: the ledger's ``t`` (wall time), ``drain_s``/``total_s``
(durations) and ``from``/``to``/``generation`` (checkpoint paths, one per package);
their presence is compared; the checkpoint directory inside the rollback's ``error``
text is replaced by a placeholder.
"""

import glob
import os
import threading

import jax
import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.core import _executor as jexec
from heat_tpu.core import resilience as jres
from heat_tpu.core import supervision as jsup

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, _result_cache, diagnostics, resilience, supervision, telemetry

N = 1024
SCALES = {"a": 1.0, "b": 3.0}
TIMED = ("t", "drain_s", "total_s", "from", "to", "generation")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_FLIGHT_DIR", str(tmp_path / "flight"))  # the rollbacks' post-mortems
    yield
    for sup, res, ex in ((supervision, resilience, _executor), (jsup, jres, jexec)):
        sup.disarm()
        sup.reset_abort()
        res.disarm_fault_plan()
        sched = ex._get_scheduler()
        sched.resume()
        sched.reopen()


def _generations(mod, tmp, comm=None):
    kw = {} if comm is None else {"comm": comm}
    gen = {}
    for name, scale in SCALES.items():
        gen[name] = os.path.join(tmp, f"gen_{name}")
        mod.save_checkpoint({"w": mod.array(np.full(N, scale, np.float32), split=0, **kw)}, gen[name])
    bad = os.path.join(tmp, "gen_bad")
    mod.save_checkpoint({"w": mod.array(np.full(N, 9.0, np.float32), split=0, **kw)}, bad)
    chunk = sorted(glob.glob(os.path.join(bad, "leaf_0.c*.bin")))[0]
    with open(chunk, "r+b") as fh:
        fh.truncate(4)
    gen["bad"] = bad
    return gen


def _script(mod, res, tmp, comm=None):
    """load a, swap to b, swap to the corrupt generation (rolls back), swap to a."""
    kw = {} if comm is None else {"comm": comm}
    gen = _generations(mod, tmp, comm)
    pool = mod.serving.ModelPool({"w": mod.zeros((N,), split=0, **kw)}, name="unit").load(gen["a"])
    x = mod.array(np.arange(N, dtype=np.float32), split=0, **kw)
    served = [float((x * pool.state["w"]).sum().item())]
    mod.serving.swap_state(pool, gen["b"])
    served.append(float((x * pool.state["w"]).sum().item()))
    with pytest.raises(res.SwapFailed) as exc:
        mod.serving.swap_state(pool, gen["bad"])
    assert exc.value.stage == "stage"
    served.append(float((x * pool.state["w"]).sum().item()))
    mod.serving.swap_state(pool, gen["a"])
    served.append(float((x * pool.state["w"]).sum().item()))
    return pool, served


def _untimed(ledger, root):
    def field(k, v):
        if k in TIMED:
            return True
        return v.replace(root, "<dir>") if isinstance(v, str) else v

    return [{k: field(k, v) for k, v in e.items()} for e in ledger]


def test_ledger_and_values_match_heat_tpu(tmp_path):
    comm1 = ht.MeshCommunication(jax.devices()[:1])
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jpool, jserved = _script(ht, jres, str(tmp_path / "j"), comm1)
    pool, served = _script(htt, resilience, str(tmp_path / "p"))
    assert served == jserved
    base = float(np.arange(N, dtype=np.float32).sum())
    assert served == [base, 3 * base, 3 * base, base]
    assert _untimed(pool.swap_ledger(), str(tmp_path / "p")) == _untimed(jpool.swap_ledger(), str(tmp_path / "j"))
    assert [e["ok"] for e in pool.swap_ledger()] == [True, False, True]
    assert pool.generation.endswith("gen_a")
    events = [e for e in diagnostics.report()["resilience_events"]
              if e["site"] == "serving.swap" and e["kind"] == "swap-failed"]
    assert events
    assert any(e["site"] == "serving.swap" for e in telemetry.flight_events())


def test_swap_under_eight_threads_accounts_exactly(tmp_path):
    gen = _generations(htt, str(tmp_path))
    pool = htt.serving.ModelPool({"w": htt.zeros((N,), split=0)}, name="hammer").load(gen["a"])
    x = htt.array(np.arange(N, dtype=np.float32), split=0)
    base = float(np.arange(N, dtype=np.float32).sum())
    valid = {base * s for s in SCALES.values()}
    offered, served, typed, untyped = [0], [], [], []
    lock = threading.Lock()
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            with lock:
                offered[0] += 1
            try:
                with htt.profiler.request("tenantH"):
                    w = pool.state["w"]  # one read a request: one whole generation
                    v = float((x * w).sum().item())
                with lock:
                    served.append(v)
            except (resilience.Shed, resilience.DeadlineExceeded, resilience.RequestCancelled,
                    resilience.DrainTimeout) as exc:
                with lock:
                    typed.append(exc)
            except Exception as exc:
                with lock:
                    untyped.append(exc)

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        htt.serving.swap_state(pool, gen["b"], drain_timeout_s=30.0)
        with pytest.raises(resilience.SwapFailed):
            htt.serving.swap_state(pool, gen["bad"])
        htt.serving.swap_state(pool, gen["a"], drain_timeout_s=30.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert untyped == []
    assert len(served) + len(typed) == offered[0]
    assert set(served) <= valid, set(served) - valid
    assert [e["ok"] for e in pool.swap_ledger()] == [True, False, True]


def test_no_stale_result_cache_hit_after_a_swap(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("HEAT_TPU_JIT_THRESHOLD", "1")
    _executor.clear_executor_cache()
    try:
        gen = _generations(htt, str(tmp_path))
        pool = htt.serving.ModelPool({"w": htt.zeros((N,), split=0)}, name="rc").load(gen["a"])
        slots = []
        for s in range(3):
            v = htt.array(np.full(N, float(s + 1), np.float32), split=0)
            _result_cache.register_generation(v.larray, f"rc:x:{s}", 1)
            slots.append(v)

        def serve(s):
            w = pool.state["w"]
            return float((slots[s] * w + w).numpy()[0])

        for _ in range(2):
            assert [serve(s) for s in range(3)] == [1.0 * (s + 2) for s in range(3)]
        st = htt.executor_stats()["result_cache"]
        assert st["hits"] > 0
        htt.serving.swap_state(pool, gen["b"])
        assert [serve(s) for s in range(3)] == [3.0 * (s + 2) for s in range(3)]
        assert htt.executor_stats()["result_cache"]["invalidations"] > st["invalidations"]
    finally:
        monkeypatch.undo()
        _executor.clear_executor_cache()


def test_on_peer_failure_with_a_silent_virtual_peer():
    pool = htt.serving.ModelPool({"w": htt.zeros((8,), split=0)}, name="failover")
    pool._rebind({"w": htt.ones((8,), split=0)}, None)
    clock = [0.0]
    co = supervision.LocalCoordinator()
    mon = supervision.arm(co, rank=0, nprocs=2, peer_timeout_s=1.0, clock=lambda: clock[0], start_thread=False)
    co.set(f"{mon.ns}/hb/1", "1")  # the virtual peer beats once...
    mon.step(0.0)
    clock[0] = 2.0
    mon.step(2.0)  # ...then goes silent past its budget
    payload = supervision.aborted()
    assert payload["kind"] == "peer-failed" and payload["rank"] == 1
    with pytest.raises(resilience.PeerFailed):
        (pool.state["w"] * 2.0).numpy()  # a force is refused typed while the sentinel is up
    entry = pool.on_peer_failure(resilience.PeerFailed(1, 2.0), drain_timeout_s=5.0)
    assert entry["kind"] == "peer-failover"
    assert supervision.aborted() is None
    assert not _executor._get_scheduler().draining()
    clock[0] = 10.0
    mon.step(10.0)  # the handled peer is forgotten: no second abort
    assert supervision.aborted() is None
    assert float(pool.state["w"].sum().item()) == 8.0
    assert pool.swap_ledger()[-1]["kind"] == "peer-failover"


def test_a_heat_tpu_generation_is_served_by_the_port(tmp_path):
    comm1 = ht.MeshCommunication(jax.devices()[:1])
    rng = np.random.default_rng(9)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    path = str(tmp_path / "jgen")
    ht.save_checkpoint({"w": ht.array(w, split=0, comm=comm1), "b": ht.array(b, comm=comm1)}, path)
    pool = htt.serving.ModelPool({"w": htt.zeros((16, 8), split=0), "b": htt.zeros((8,))}, name="cross").load(path)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    got = (htt.matmul(htt.array(x), pool.state["w"]) + pool.state["b"]).numpy()
    np.testing.assert_allclose(got, x @ w + b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["telemetry", "ops", "forensics", "supervision", "_result_cache",
                                  "_compile_cache", "serving"])
def test_every_heat_tpu_name_exists_in_the_port(name):
    import importlib

    theirs = importlib.import_module(f"heat_tpu.{name}" if name == "serving" else f"heat_tpu.core.{name}")
    mine = importlib.import_module(f"heat_tpu_torch.{name}" if name == "serving" else f"heat_tpu_torch.core.{name}")
    names = getattr(theirs, "__all__", None) or [
        n for n in vars(theirs) if not n.startswith("_") and callable(getattr(theirs, n))
        and getattr(getattr(theirs, n), "__module__", "") == theirs.__name__
    ]
    missing = [n for n in names if not hasattr(mine, n)]
    assert not missing, missing
    for pkg_name in ("forensics", "ops", "supervision", "telemetry", "serving", "explain",
                     "executor_warmup", "executor_save_warmup", "__version__"):
        assert hasattr(htt, pkg_name), pkg_name
    assert htt.__version__ == ht.__version__
    from heat_tpu import telemetry as jalias
    from heat_tpu_torch import telemetry as alias

    assert set(alias.__all__) == set(jalias.__all__)
