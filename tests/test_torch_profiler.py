"""The port's profiler (heat_tpu_torch/core/profiler.py) against heat_tpu's: the same
observations give the same histogram snapshots, the same call sequences give the same
report keys, request tallies and force-boundary samples, and the exported trace holds
matched, properly nested B/E pairs with one track per request. Mirrors
tests/test_profiler.py."""

import json
import math
import os
import threading

import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.core import _executor as heat_executor
from heat_tpu.core import profiler as heat_profiler

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, profiler, resilience


@pytest.fixture(autouse=True, scope="module")
def _production_threshold():
    # the suite's conftest raises the warm-up threshold; these tests, like
    # heat_tpu's executor tests, hold the production default (build on first miss)
    old = os.environ.get("HEAT_TPU_JIT_THRESHOLD")
    os.environ["HEAT_TPU_JIT_THRESHOLD"] = "1"
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()
    yield
    if old is None:
        os.environ.pop("HEAT_TPU_JIT_THRESHOLD", None)
    else:
        os.environ["HEAT_TPU_JIT_THRESHOLD"] = old
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()


@pytest.fixture(autouse=True)
def _fresh():
    htt.use_device("cpu")
    for p in (profiler, heat_profiler):
        p.disable()
        p.reset()
    yield
    for p in (profiler, heat_profiler):
        p.disable()
        p.reset()


def _chain64(x, y):
    for _ in range(16):
        x = x + y
        x = x * 0.5
        x = x - y
        x = x + 1.0
    return x


def _validate_trace(obj):
    """Schema-check one dump_trace object (heat_tpu's rules); returns its events."""
    assert obj["schema"] == profiler.TRACE_SCHEMA
    events = obj["traceEvents"]
    stacks, last_ts = {}, None
    for ev in events:
        assert ev["ph"] in ("B", "E", "M", "C")
        if ev["ph"] == "M":
            continue
        for key in ("name", "pid", "tid", "ts"):
            assert key in ev
        if ev["ph"] in ("B", "E"):
            if last_ts is not None:
                assert ev["ts"] >= last_ts
            last_ts = ev["ts"]
        if ev["ph"] == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        elif ev["ph"] == "E":
            stack = stacks.get((ev["pid"], ev["tid"]))
            assert stack, f"E without open B: {ev}"
            top = stack.pop()
            assert top["name"] == ev["name"] and top.get("cat") == ev.get("cat")
    assert not {k: v for k, v in stacks.items() if v}, "unmatched B events"
    return events


SAMPLE_SETS = {
    "lognormal": lambda rng: np.exp(rng.normal(-7.0, 1.5, 4000)),
    "uniform": lambda rng: rng.uniform(1e-5, 3e-2, 2500),
    "with_zeros_and_huge": lambda rng: np.concatenate([np.zeros(7), rng.uniform(0, 1e-6, 50), [5e4, 1e9]]),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_histogram_snapshot_equals_heat_tpu(name):
    samples = SAMPLE_SETS[name](np.random.default_rng(3))
    mine, theirs = profiler.Histogram(), heat_profiler.Histogram()
    for v in samples:
        mine.observe(float(v))
        theirs.observe(float(v))
    assert mine.snapshot() == theirs.snapshot()
    for q in (0.5, 0.9, 0.99, 1.0):
        assert mine.percentile(q) == theirs.percentile(q)
    for thr in (1e-4, 1e-3, 0.01):
        assert mine.count_over(thr) == theirs.count_over(thr)


def test_histogram_merge_delta_and_roundtrip_equal_heat_tpu():
    rng = np.random.default_rng(5)
    a, b = rng.uniform(1e-6, 1e-2, 300), rng.uniform(1e-4, 1.0, 200)
    snaps = []
    for mod in (profiler, heat_profiler):
        h1, h2 = mod.Histogram(), mod.Histogram()
        for v in a:
            h1.observe(float(v))
        prefix = h1.snapshot()
        for v in b:
            h2.observe(float(v))
            h1.observe(float(v))
        union = mod.Histogram().merge(mod.Histogram.from_snapshot(prefix)).merge(h2)
        window = h1.delta(prefix)
        assert union.buckets == h1.buckets and union.count == h1.count
        assert mod.Histogram.from_snapshot(h1.snapshot()).snapshot() == h1.snapshot()
        with pytest.raises(ValueError):
            h1.merge(mod.Histogram(growth=1.1))
        with pytest.raises(ValueError):
            h2.delta(h1)
        snaps.append((h1.snapshot(), window.snapshot(), union.snapshot()))
    assert snaps[0] == snaps[1]


def test_bounded_buckets_and_empty_snapshot():
    h = profiler.Histogram()
    assert h.snapshot() == heat_profiler.Histogram().snapshot()
    for i in range(100000):
        h.observe(1e-6 * (1.0001 ** i))
    assert len(h.buckets) < 600
    assert h.percentile(0.5) is not None and math.isfinite(h.percentile(0.99))


def _sequence(mod, prof):
    """The same request sequence on either package: a 64-op chain in one request,
    a reduction in a second, two observations, one counter."""
    prof.enable()
    with prof.request("alpha"):
        x = mod.array(np.arange(29, dtype=np.float32), split=0)
        y = mod.array(np.full(29, 0.5, dtype=np.float32), split=0)
        z = _chain64(x, y)
        zn = z.numpy()
    with prof.request("beta"):
        s = (x * 2.0).sum().item()
    prof.observe("custom.latency", 0.25)
    prof.observe("custom.latency", 0.5)
    prof.record_counter("gauge", 3.0)
    return prof.report(), zn, s


def test_report_keys_and_tallies_equal_heat_tpu():
    _executor.clear_executor_cache()
    heat_executor.clear_executor_cache()
    mine, zn, s = _sequence(htt, profiler)
    theirs, zn_ref, s_ref = _sequence(ht, heat_profiler)
    assert set(mine) == set(theirs)
    assert mine["schema"] == theirs["schema"]
    assert mine["requests_total"] == theirs["requests_total"] == 2
    assert [r["tag"] for r in mine["recent_requests"]] == [r["tag"] for r in theirs["recent_requests"]]
    assert set(mine["memory"]) == set(theirs["memory"])
    assert mine["memory"]["forces"] == theirs["memory"]["forces"] >= 1
    assert mine["counters"]["gauge"] == theirs["counters"]["gauge"] == 3.0
    for name in ("request.alpha", "request.beta", "custom.latency"):
        assert mine["histograms"][name]["count"] == theirs["histograms"][name]["count"]
    assert mine["histograms"]["custom.latency"] == theirs["histograms"]["custom.latency"]
    np.testing.assert_array_max_ulp(zn, zn_ref, maxulp=4)
    assert s == pytest.approx(s_ref)


def test_trace_has_matched_pairs_and_request_tracks(tmp_path):
    _executor.clear_executor_cache()
    profiler.enable()
    with profiler.request("alpha") as rid_a:
        x = htt.array(np.arange(29, dtype=np.float32), split=0)
        y = htt.array(np.full(29, 0.5, dtype=np.float32), split=0)
        _chain64(x, y).larray
    with profiler.request("beta") as rid_b:
        (x * 2.0).sum().numpy()
    path = os.path.join(tmp_path, "trace.json")
    obj = profiler.dump_trace(path)
    with open(path) as f:
        assert json.load(f) == obj
    events = _validate_trace(obj)
    names = {ev["pid"]: ev["args"]["name"] for ev in events if ev["ph"] == "M" and ev["name"] == "process_name"}
    assert "alpha" in names[rid_a] and "beta" in names[rid_b]
    cats = {ev.get("cat") for ev in events}
    for expected in ("request", "dispatch", "force", "compile", "collective"):
        assert expected in cats, f"no {expected!r} slice"
    for rid in (rid_a, rid_b):
        assert any(ev["ph"] == "B" and ev["pid"] == rid for ev in events)
    counters = {ev["name"] for ev in events if ev["ph"] == "C"}
    assert "force_live_bytes" in counters


def test_disable_enable_keeps_one_time_origin():
    profiler.enable()
    with profiler.request("first"):
        pass
    profiler.disable()
    profiler.enable()
    with profiler.request("second"):
        pass
    events = _validate_trace({"schema": profiler.TRACE_SCHEMA, "traceEvents": profiler._trace_events_locked()})
    reqs = sorted((ev["ts"], ev["name"]) for ev in events if ev.get("cat") == "request" and ev["ph"] == "B")
    assert [n for _, n in reqs] == ["first", "second"]


def test_deferred_chain_forced_from_two_threads_attributes_once(tmp_path):
    _executor.clear_executor_cache()
    profiler.enable()
    with profiler.request("deferred-chain") as rid:
        x = htt.array(np.arange(32, dtype=np.float32), split=0)
        y = htt.array(np.full(32, 0.25, dtype=np.float32), split=0)
        z = _chain64(x, y)
    results = []
    threads = [threading.Thread(target=lambda: results.append(z.numpy())) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(results) == 2
    np.testing.assert_array_equal(results[0], results[1])
    obj = profiler.dump_trace(os.path.join(tmp_path, "prop.json"))
    forces = [ev for ev in obj["traceEvents"] if ev.get("cat") == "force" and ev["ph"] == "B"]
    assert len(forces) == 1 and forces[0]["pid"] == rid
    execs = [ev for ev in obj["traceEvents"]
             if ev.get("cat") in ("compile", "execute") and ev["ph"] == "B" and ev["pid"] == rid]
    assert execs


def test_concurrent_requests_attribute_disjointly():
    profiler.enable()
    barrier = threading.Barrier(4)
    rids = {}

    def work(i):
        barrier.wait(timeout=30)
        with profiler.request(f"tenant{i}") as rid:
            rids[i] = rid
            a = htt.array(np.full(16, float(i), np.float32), split=0)
            (a * 2.0 + 1.0).sum().item()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(set(rids.values())) == 4
    snap = profiler.trace_snapshot()
    for i, rid in rids.items():
        dispatch = [s for s in snap["slices"] if s[0] == rid and s[2] == "dispatch"]
        assert dispatch, f"tenant{i} has no dispatch slice"
    rep = profiler.report()
    assert rep["requests_total"] == 4
    assert all(rep["histograms"][f"request.tenant{i}"]["count"] == 1 for i in range(4))


def test_chain_carries_deadline_to_a_force_on_another_thread():
    x = htt.array(np.arange(16, dtype=np.float32), split=0)
    y = htt.array(np.ones(16, dtype=np.float32), split=0)
    with profiler.request("slow", deadline_s=0.0):
        pass
    assert profiler._deadline_seen
    with profiler.request("far", deadline_s=60.0):
        z = _chain64(x, y)
        assert profiler.current_deadline() is not None
    assert profiler.current_deadline() is None
    got = []
    t = threading.Thread(target=lambda: got.append(z.numpy()))
    t.start()
    t.join(timeout=60)
    assert got and got[0].shape == (16,)


def test_expired_deadline_at_force_time_is_typed():
    x = htt.array(np.arange(16, dtype=np.float32), split=0)
    with profiler.request("expiring", deadline_s=0.05):
        z = x * 2.0 + 1.0
        import time

        time.sleep(0.08)
        with pytest.raises(resilience.DeadlineExceeded):
            z.numpy()
    # the rejection consumed the deadline: a later force outside the scope works
    np.testing.assert_array_equal(z.numpy(), np.arange(16, dtype=np.float32) * 2.0 + 1.0)


def test_force_boundary_memory_samples():
    profiler.enable()
    x = htt.array(np.arange(64, dtype=np.float32), split=0)
    (x + 1.0).numpy()
    mem = profiler.report()["memory"]
    assert mem["forces"] >= 1
    assert mem["peak_force_live_bytes"] >= mem["last_force_live_bytes"] > 0


def test_disabled_records_nothing():
    x = htt.array(np.arange(8, dtype=np.float32), split=0)
    with profiler.request("off") as rid:
        (x + 1.0).sum().item()
    assert rid is None
    rep = profiler.report()
    assert rep["slices_recorded"] == 0 and rep["requests_total"] == 0 and not rep["histograms"]


def test_hammer_exact_histogram_counts():
    profiler.enable()
    n_threads, per_thread = 8, 25

    def work(i):
        a = htt.array(np.full(8, float(i), np.float32), split=0)
        for _ in range(per_thread):
            with profiler.request("hammer"):
                (a + 1.0).sum().item()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert profiler.report()["histograms"]["request.hammer"]["count"] == n_threads * per_thread


def test_report_is_a_diagnostics_section():
    from heat_tpu_torch.core import diagnostics

    profiler.enable()
    with profiler.request("diag"):
        pass
    rep = diagnostics.report()
    assert rep["profiler"]["requests_total"] == 1
    assert "hits" in rep["executor"]
