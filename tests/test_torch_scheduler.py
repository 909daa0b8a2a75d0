"""The port's async dispatch path (heat_tpu_torch/core/_scheduler.py and the async half
of _executor.py) against heat_tpu's (tests/test_executor.py's TestAsyncExecutor,
TestAsyncFailureDelivery, TestRequestLifecycle, TestShardedScheduler,
TestStagedOpBatching and TestAdaptiveBatchWindow).

Timing-dependent cases stay deterministic: forces are parked with ``pause()`` and
released with ``resume()``, deadlines are ones that have already passed, and every
thread is joined with a timeout so a case fails rather than hangs. Where a scenario
is deterministic on both packages (paused queues), its lifecycle ledger and batch
counters are held equal to heat_tpu's."""

import contextlib
import os
import threading
import time

import numpy as np
import pytest
import torch

import heat_tpu as ht
from heat_tpu.core import _executor as heat_executor
from heat_tpu.core import profiler as heat_profiler
from heat_tpu.core import resilience as heat_resilience

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, _scheduler, profiler, resilience

_EVEN = (8, 4)


@pytest.fixture(autouse=True, scope="module")
def _production_threshold():
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


def _settle(ex):
    sched = ex._dispatch_scheduler
    if sched is not None:
        sched.reopen()
        sched.resume()
        assert sched.wait_idle(30.0), "scheduler stuck busy"


@pytest.fixture(autouse=True)
def _clean():
    htt.use_device("cpu")
    for ex in (_executor, heat_executor):
        _settle(ex)
        ex.clear_executor_cache()
    yield
    for ex in (_executor, heat_executor):
        _settle(ex)
    for p in (profiler, heat_profiler):
        p.disable()
        p.reset()


PACKAGES = {
    "port": (htt, _executor, profiler, resilience, lambda x: x.larray),
    "heat_tpu": (ht, heat_executor, heat_profiler, heat_resilience, lambda x: x.parray),
}


@contextlib.contextmanager
def env(name, value):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
        _executor.reload_env_knobs()
        heat_executor.reload_env_knobs()


def _np_pair(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(dtype), (rng.standard_normal(shape) + 1.5).astype(dtype)


def _wait_depth(sched, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while sched.depth() < n and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sched.depth() >= n, "work never queued"


def _queue(ex, thunks, min_depth):
    """Pause the scheduler, run each thunk on its own thread (every force parks in the
    queue: a paused scheduler refuses the inline path), wait for ``min_depth`` queued
    items, resume and join. Returns the results."""
    sched = ex._get_scheduler()
    results = [None] * len(thunks)
    errors = []

    def runner(i, fn):
        try:
            results[i] = fn()
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=runner, args=(i, fn), daemon=True) for i, fn in enumerate(thunks)]
    sched.pause()
    try:
        for t in threads:
            t.start()
        _wait_depth(sched, min_depth)
    finally:
        sched.resume()
    for t in threads:
        t.join(timeout=60.0)
        assert not t.is_alive(), "a force hung"
    assert not errors, errors
    return results


def _force_under_request(pkg, tag, deadline_s, np_a, outcomes, scalar=2.0):
    m, ex, prof, res, force = PACKAGES[pkg]
    with prof.request(tag, deadline_s=deadline_s):
        try:
            x = m.array(np_a, split=0)
            outcomes[tag] = ("ok", ((x + 1.0) * scalar).numpy())
        except BaseException as exc:
            outcomes[tag] = ("err", exc)


# ---------------------------------------------------------------------- async executor
def test_async_vs_serialized_vs_eager_bit_parity():
    np_a, np_b = _np_pair((7, 5))

    def chain():
        a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
        t = a + b
        return (t * 2.0).numpy(), (t * 3.0).numpy(), t.numpy()

    async_res = chain()
    with env("HEAT_TPU_ASYNC_DISPATCH", "0"):
        sync_res = chain()
    with env("HEAT_TPU_EAGER_DISPATCH", "1"):
        eager_res = chain()
    for a, s, e in zip(async_res, sync_res, eager_res):
        assert a.tobytes() == s.tobytes() == e.tobytes()


def test_concurrency_hammer_shared_and_disjoint():
    datas = [np.random.default_rng(100 + i).standard_normal(_EVEN).astype(np.float32) for i in range(8)]
    arrs = [htt.array(d, split=0) for d in datas]
    expected = [((arrs[i] * 1.5) + 0.25).numpy() for i in range(8)]
    np_a, np_b = _np_pair(_EVEN)
    a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
    t = a + b
    u, v = t * 2.0, t * 3.0
    shared = {"u": ((a + b) * 2.0).numpy(), "v": ((a + b) * 3.0).numpy()}
    errors = []

    def worker(i):
        try:
            for _ in range(10):
                got = ((arrs[i] * 1.5) + 0.25).numpy()
                assert got.tobytes() == expected[i].tobytes()
            key = "u" if i % 2 else "v"
            assert (u if i % 2 else v).numpy().tobytes() == shared[key].tobytes()
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120.0)
    assert not errors, errors
    assert htt.executor_stats()["reexecuted"] == 0


@pytest.mark.parametrize("width", [2, 4])
def test_cross_request_batching_deterministic(width):
    datas = [np.full(_EVEN, float(i + 1), np.float32) for i in range(width)]
    stats = {}
    for pkg in ("port", "heat_tpu"):
        m, ex, _, _, force = PACKAGES[pkg]
        arrs = [m.array(d, split=0) for d in datas]
        for arr in arrs:
            force(arr * 2.0 + 1.0)  # warm: the batches replay
        ex.reset_executor_stats()
        results = _queue(ex, [lambda i=i: (arrs[i] * 2.0 + 1.0).numpy() for i in range(width)], width)
        for i, got in enumerate(results):
            np.testing.assert_array_equal(got, datas[i] * 2.0 + 1.0)
        stats[pkg] = ex.executor_stats()
    for key in ("batched_requests", "batch_width_hist", "queue_depth_peak", "queued_dispatches", "reexecuted"):
        assert stats["port"][key] == stats["heat_tpu"][key], key
    assert stats["port"]["batch_width_hist"] == {width: 1}


def test_batched_results_bit_equal_to_single_dispatch():
    datas = [np.random.default_rng(7 + i).standard_normal((5, 3)).astype(np.float32) for i in range(4)]
    arrs = [htt.array(d, split=0) for d in datas]
    singles = [((a - 0.5) * 3.0 + a).numpy() for a in arrs]
    results = _queue(_executor, [lambda i=i: ((arrs[i] - 0.5) * 3.0 + arrs[i]).numpy() for i in range(4)], 4)
    for got, want in zip(results, singles):
        assert got.tobytes() == want.tobytes()
    assert htt.executor_stats()["batched_requests"] >= 4


def test_distinct_scalars_never_share_a_batch():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    (x * 2.0).larray
    (x * 3.0).larray
    htt.reset_executor_stats()
    results = _queue(_executor, [lambda: (x * 2.0).numpy(), lambda: (x * 3.0).numpy()], 2)
    np.testing.assert_array_equal(results[0], np_a * 2.0)
    np.testing.assert_array_equal(results[1], np_a * 3.0)
    assert htt.executor_stats()["batched_requests"] == 0


def test_queue_full_backpressure_executes_inline():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    (x + 1.0).larray
    with env("HEAT_TPU_DISPATCH_QUEUE", "1"):
        sched = _executor._get_scheduler()
        results, errors = [None] * 3, []

        def w(i):
            try:
                results[i] = (x + 1.0).numpy()
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=w, args=(i,), daemon=True) for i in range(3)]
        sched.pause()
        try:
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30.0
            while sum(r is not None for r in results) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            sched.resume()
        for t in threads:
            t.join(timeout=60)
    assert not errors
    for r in results:
        np.testing.assert_array_equal(r, np_a + 1.0)
    st = htt.executor_stats()
    assert st["queue_full_events"] >= 1 and st["queue_depth_peak"] <= 1


def test_donation_refused_while_another_call_reads_the_buffer():
    leaf = torch.arange(8.0)
    read = [leaf]
    granted = _executor._acquire_buffers(read, [])
    before = htt.executor_stats()["donation_refusals"]
    other_read = []
    assert _executor._acquire_buffers(other_read, [leaf]) == []  # an in-flight reader
    assert htt.executor_stats()["donation_refusals"] == before + 1
    _executor._release_buffers(read, granted)
    _executor._release_buffers(other_read, [])
    mine = []
    assert _executor._acquire_buffers(mine, [leaf]) == [leaf]
    refused = []
    assert _executor._acquire_buffers(refused, [leaf]) == []  # a standing claim
    assert refused == [leaf]  # demoted to a plain read
    _executor._release_buffers(refused, [])
    _executor._release_buffers(mine, [leaf])
    assert not _executor._inflight_reads and not _executor._donation_claims


def test_per_thread_tallies_are_exact_under_contention():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    (x * 2.0).larray
    htt.reset_executor_stats()
    n_threads, per = 8, 50

    def work():
        for _ in range(per):
            (x * 2.0).larray

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    st = htt.executor_stats()
    assert st["hits"] == n_threads * per and st["misses"] == 0


def test_serialized_mode_keeps_scheduler_idle():
    np_a, _ = _np_pair(_EVEN)
    with env("HEAT_TPU_ASYNC_DISPATCH", "0"):
        x = htt.array(np_a, split=0)
        htt.reset_executor_stats()
        np.testing.assert_array_equal(((x + 1.0) * 2.0).numpy(), (np_a + 1.0) * 2.0)
        st = htt.executor_stats()
    assert st["queued_dispatches"] == 0 and st["inline_dispatches"] == 0


# ---------------------------------------------------------------------- failure delivery
def test_terminal_dispatch_failure_raises_then_retries_clean():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    ((x + 1.0) * 2.0).larray  # warm
    resilience.arm_fault_plan([{"site": "executor.execute", "on_call": 1, "count": 99, "kind": "raise"}])
    try:
        y = (x + 1.0) * 2.0
        np.testing.assert_array_equal(y.numpy(), (np_a + 1.0) * 2.0)  # eager replay: no data loss
    finally:
        resilience.disarm_fault_plan()
    st = htt.executor_stats()
    assert st["eager_fallbacks"] >= 1
    z = (x + 1.0) * 2.0
    np.testing.assert_array_equal(z.numpy(), (np_a + 1.0) * 2.0)


def test_quarantine_after_repeated_failures():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    (x * 5.0).larray
    resilience.arm_fault_plan([{"site": "executor.execute", "on_call": 1, "count": 99, "kind": "raise"}])
    try:
        for _ in range(3):
            np.testing.assert_array_equal((x * 5.0).numpy(), np_a * 5.0)
    finally:
        resilience.disarm_fault_plan()
    st = htt.executor_stats()
    assert st["eager_fallbacks"] == 3 and len(st["quarantined"]) == 1
    np.testing.assert_array_equal((x * 5.0).numpy(), np_a * 5.0)


def test_pending_leaf_resolved_before_a_warmup_replay():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    (x + 1.0).larray
    sched = _executor._get_scheduler()
    with env("HEAT_TPU_JIT_THRESHOLD", "3"):
        t = x + 1.0
        out = {}

        def first():
            out["t"] = t.numpy()

        sched.pause()
        th = threading.Thread(target=first, daemon=True)
        th.start()
        try:
            time.sleep(0.05)
        finally:
            sched.resume()
        th.join(timeout=30)
        u = t * 4.0  # t is memoised (or pending) — consumed as a leaf
        np.testing.assert_array_equal(u.numpy(), (np_a + 1.0) * 4.0)
    np.testing.assert_array_equal(out["t"], np_a + 1.0)


# ---------------------------------------------------------------------- request lifecycle
def test_admission_expired_is_typed_and_plans_nothing():
    np_a, _ = _np_pair((7, 5))
    profiler.enable()
    with profiler.request("adm", deadline_s=0.1):
        z = (htt.array(np_a, split=0) + 1.0) * 2.0
    time.sleep(0.15)
    before = htt.executor_stats()
    with pytest.raises(resilience.DeadlineExceeded):
        z.larray
    after = htt.executor_stats()
    assert after["misses"] == before["misses"] and after["retraces"] == before["retraces"]
    assert after["expired_requests"] == before["expired_requests"] + 1
    np.testing.assert_allclose(z.numpy(), (np_a + 1.0) * 2.0, rtol=1e-6)


def test_defer_time_admission_kills_expired_request_at_first_op():
    x = htt.array(np.ones(4, np.float32), split=0)
    with profiler.request("defer-adm", deadline_s=-1.0):
        with pytest.raises(resilience.DeadlineExceeded):
            x + 1.0


def test_lifecycle_ledger_equals_heat_tpu():
    """Expired-in-queue, cancelled and batched peers: the same paused sequence on both
    packages gives the same typed errors and the same ledger."""
    datas = [np.full(_EVEN, float(i + 1), np.float32) for i in range(4)]
    ledgers = {}
    for pkg in ("port", "heat_tpu"):
        m, ex, prof, res, force = PACKAGES[pkg]
        prof.enable()
        for d in datas:
            force((m.array(d, split=0) + 1.0) * 2.0)
        ex.reset_executor_stats()
        sched = ex._get_scheduler()
        outcomes = {}
        sched.pause()
        try:
            threads = [threading.Thread(target=_force_under_request,
                                        args=(pkg, f"b{i}", 0.15 if i == 0 else 60.0, datas[i], outcomes),
                                        daemon=True) for i in range(4)]
            for t in threads:
                t.start()
            _wait_depth(sched, 4)
            assert sched.cancel("b3") == 1
            time.sleep(0.3)  # b0's deadline passes in the queue
        finally:
            sched.resume()
        for t in threads:
            t.join(30.0)
        assert outcomes["b0"][0] == "err" and isinstance(outcomes["b0"][1], res.DeadlineExceeded)
        assert outcomes["b3"][0] == "err" and isinstance(outcomes["b3"][1], res.RequestCancelled)
        for i in (1, 2):
            assert outcomes[f"b{i}"][0] == "ok"
            np.testing.assert_array_equal(outcomes[f"b{i}"][1], (datas[i] + 1.0) * 2.0)
        st = ex.executor_stats()
        ledgers[pkg] = {k: st[k] for k in ("expired_requests", "cancelled_requests", "shed_requests",
                                           "batched_requests", "batch_width_hist", "lifecycle_by_tenant")}
        prof.disable()
        prof.reset()
    assert ledgers["port"] == ledgers["heat_tpu"]
    assert ledgers["port"]["batch_width_hist"] == {2: 1}


def test_queue_full_shed_mode_delivers_typed_shed():
    np_a, _ = _np_pair(_EVEN)
    ((htt.array(np_a, split=0) + 1.0) * 2.0).larray
    with env("HEAT_TPU_SHED", "1"), env("HEAT_TPU_DISPATCH_QUEUE", "1"):
        sched = _executor._get_scheduler()
        outcomes = {}
        sched.pause()
        try:
            threads = [threading.Thread(target=_force_under_request, args=("port", f"qf{i}", 30.0, np_a, outcomes),
                                        daemon=True) for i in range(3)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 30.0
            while len(outcomes) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            sched.resume()
        for t in threads:
            t.join(30.0)
    sheds = [v for v in outcomes.values() if v[0] == "err" and isinstance(v[1], resilience.Shed)]
    oks = [v for v in outcomes.values() if v[0] == "ok"]
    assert sheds and len(sheds) + len(oks) == 3
    for _, got in oks:
        np.testing.assert_array_equal(got, (np_a + 1.0) * 2.0)
    st = htt.executor_stats()
    assert st["shed_requests"] == len(sheds)


def test_ewma_infeasible_admission_shed():
    np_a, _ = _np_pair(_EVEN)
    for _ in range(3):
        ((htt.array(np_a, split=0) + 1.0) * 2.0).larray
    progs = [p for p in _executor._programs.values()
             if p is not _executor.UNSUPPORTED and (p.label or "").startswith("defer:")]
    assert progs
    for p in progs:
        p.ewma_s = 10.0
    with env("HEAT_TPU_SHED", "1"):
        with profiler.request("ewma", deadline_s=0.5):
            v = (htt.array(np_a, split=0) + 1.0) * 2.0
            with pytest.raises(resilience.Shed):
                v.larray
    assert htt.executor_stats()["shed_requests"] >= 1
    with profiler.request("ewma2", deadline_s=30.0):
        np.testing.assert_array_equal(((htt.array(np_a, split=0) + 1.0) * 2.0).numpy(), (np_a + 1.0) * 2.0)


def test_drain_timeout_raises_typed_error_naming_futures():
    np_a, _ = _np_pair(_EVEN)
    ((htt.array(np_a, split=0) + 1.0) * 2.0).larray
    sched = _executor._get_scheduler()
    outcomes = {}
    sched.pause()
    threads = [threading.Thread(target=_force_under_request, args=("port", f"d{i}", None, np_a, outcomes),
                                daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    _wait_depth(sched, 2)
    with pytest.raises(resilience.DrainTimeout) as info:
        sched.drain(timeout=0.0)
    assert len(info.value.undelivered) == 2 and all("#" in n for n in info.value.undelivered)
    for t in threads:
        t.join(30.0)
    for tag, (status, err) in outcomes.items():
        assert status == "err" and isinstance(err, resilience.DrainTimeout)
    assert sched.draining()
    np.testing.assert_array_equal(((htt.array(np_a, split=0) + 1.0) * 2.0).numpy(), (np_a + 1.0) * 2.0)
    sched.reopen()
    assert not sched.draining()
    st = htt.executor_stats()
    assert st["shed_requests"] == 2


def test_drain_flushes_quietly_and_quiesce_reopens():
    np_a, _ = _np_pair(_EVEN)
    ((htt.array(np_a, split=0) + 1.0) * 2.0).larray
    sched = _executor._get_scheduler()
    outcomes = {}
    sched.pause()
    t = threading.Thread(target=_force_under_request, args=("port", "flush", None, np_a, outcomes), daemon=True)
    t.start()
    _wait_depth(sched, 1)
    assert sched.drain(timeout=30.0)["flushed"]
    t.join(30.0)
    assert outcomes["flush"][0] == "ok"
    sched.reopen()
    with sched.quiesce(timeout=5.0) as q:
        assert q.draining()
    assert not sched.draining()


def test_deadline_off_requests_untouched():
    np_a, np_b = _np_pair((7, 5))
    before = htt.executor_stats()
    got = ((htt.array(np_a, split=0) + htt.array(np_b, split=0)) * 2.0).numpy()
    after = htt.executor_stats()
    np.testing.assert_array_equal(got, (np_a + np_b) * 2.0)
    for key in ("expired_requests", "shed_requests", "cancelled_requests"):
        assert after[key] == before[key]


def test_drain_under_sixteen_threads_settles_every_future():
    datas = [np.full(_EVEN, float(i), np.float32) for i in range(16)]
    arrs = [htt.array(d, split=0) for d in datas]
    (arrs[0] * 2.0 - 1.0).larray
    outcomes = [None] * 16

    def w(i):
        try:
            outcomes[i] = ("ok", (arrs[i] * 2.0 - 1.0).numpy())
        except Exception as exc:
            outcomes[i] = ("err", exc)

    sched = _executor._get_scheduler()
    sched.pause()
    threads = [threading.Thread(target=w, args=(i,), daemon=True) for i in range(16)]
    for t in threads:
        t.start()
    _wait_depth(sched, 8)
    try:
        sched.drain(timeout=10.0)
    except resilience.DrainTimeout:
        pass
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    sched.reopen()
    for i, (status, got) in enumerate(outcomes):
        assert status == "ok" or isinstance(got, resilience.DrainTimeout)
        if status == "ok":
            np.testing.assert_array_equal(got, datas[i] * 2.0 - 1.0)


# ---------------------------------------------------------------------- sharded scheduler
@contextlib.contextmanager
def sharded(n, window_us=None):
    """Rebuild the port's scheduler at ``n`` shards (and a batch window), restoring the
    suite's after."""
    old = os.environ.get("HEAT_TPU_SCHED_SHARDS")
    old_win = os.environ.get("HEAT_TPU_BATCH_WINDOW_US")
    os.environ["HEAT_TPU_SCHED_SHARDS"] = str(n)
    if window_us is not None:
        os.environ["HEAT_TPU_BATCH_WINDOW_US"] = str(window_us)
    _executor.reload_env_knobs()
    sched = _executor.rebuild_scheduler()
    try:
        yield sched
    finally:
        sched.resume()
        assert sched.wait_idle(30.0)
        for name, value in (("HEAT_TPU_SCHED_SHARDS", old), ("HEAT_TPU_BATCH_WINDOW_US", old_win)):
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        _executor.reload_env_knobs()
        _executor.rebuild_scheduler()


def test_shard_knob_applied_at_construction():
    with sharded(4) as sched:
        assert sched.shards == 4
        assert htt.executor_stats()["sched_shards"] == 4 and len(htt.executor_stats()["per_shard"]) == 4


def test_tenant_affinity_equals_heat_tpu():
    from heat_tpu.core import _scheduler as heat_scheduler

    for tag in ("alpha", "beta", "kmeans_assign", "t123", "x" * 40):
        for n in (1, 2, 4, 7):
            assert _scheduler.shard_index_for(tag, n) == heat_scheduler.shard_index_for(tag, n)
    hit = {_scheduler.shard_index_for(f"tenant{i}", 4) for i in range(64)}
    assert hit == {0, 1, 2, 3}


def test_steal_batchable_moves_live_and_cancels_expired():
    with sharded(2) as sched:
        sh = sched._shards[1]
        sched.pause()
        now = time.monotonic()
        items = []
        for i, dl in enumerate((now - 1.0, None, None)):
            failed = []
            it = _scheduler.WorkItem(f"s{i}", lambda: None, batch_key=("k",), deadline=dl,
                                     fail=failed.append)
            items.append((it, failed))
            assert sh.submit(it, 16)
        live, expired, depth = sh.steal_batchable(("k",), 1, time.monotonic())
        assert len(live) == 1 and len(expired) == 1 and depth == 1
        assert sh.lifecycle["deadline_expired"] == 1
        sh.cancel = None
        with sh._cv:
            left = sh._pop_one_locked()
        assert left is items[2][0]


def test_sharded_forces_bit_identical():
    datas = [np.random.default_rng(i).standard_normal(_EVEN).astype(np.float32) for i in range(8)]
    with sharded(4):
        arrs = [htt.array(d, split=0) for d in datas]
        singles = [(a * 1.5 + 0.25).numpy() for a in arrs]
        results = _queue(_executor, [lambda i=i: (arrs[i] * 1.5 + 0.25).numpy() for i in range(8)], 8)
        st = htt.executor_stats()
    for got, want in zip(results, singles):
        assert got.tobytes() == want.tobytes()
    assert st["batched_requests"] >= 2


def test_drain_timeout_fans_out_exactly_once():
    np_a, _ = _np_pair(_EVEN)
    with sharded(4) as sched:
        ((htt.array(np_a, split=0) + 1.0) * 2.0).larray
        outcomes = {}
        sched.pause()
        threads = [threading.Thread(target=_force_under_request, args=("port", f"f{i}", None, np_a, outcomes),
                                    daemon=True) for i in range(6)]
        for t in threads:
            t.start()
        _wait_depth(sched, 6)
        with pytest.raises(resilience.DrainTimeout) as info:
            sched.drain(timeout=0.0)
        for t in threads:
            t.join(30.0)
        assert len(info.value.undelivered) == 6
        assert htt.executor_stats()["shed_requests"] == 6
        sched.reopen()


# ---------------------------------------------------------------------- staged batching
def _batch_staged(make_call, n, min_depth):
    return _queue(_executor, [lambda i=i: make_call(i) for i in range(n)], min_depth)


def test_staged_reduce_and_cum_batch_bit_identical():
    datas = [np.random.default_rng(40 + i).standard_normal(10).astype(np.float32) for i in range(4)]
    arrs = [htt.array(d, split=0) for d in datas]
    sums = [htt.sum(a).numpy() for a in arrs]
    cums = [htt.cumsum(a, axis=0).numpy() for a in arrs]
    htt.reset_executor_stats()
    got = _batch_staged(lambda i: htt.sum(arrs[i]).numpy(), 4, 4)
    for g, w in zip(got, sums):
        assert g.tobytes() == w.tobytes()
    st = htt.executor_stats()
    assert st["batched_requests"] >= 4 and 4 in st["batch_width_hist"]
    got = _batch_staged(lambda i: htt.cumsum(arrs[i], axis=0).numpy(), 4, 4)
    for g, w in zip(got, cums):
        assert g.tobytes() == w.tobytes()


def test_staged_idle_path_stays_inline():
    x = htt.array(_np_pair(_EVEN)[0], split=0)
    htt.sum(x).numpy()
    htt.reset_executor_stats()
    htt.sum(x).numpy()
    st = htt.executor_stats()
    assert st["queued_dispatches"] == 0 and st["inline_dispatches"] >= 1


def test_staged_fault_falls_back_without_data_loss():
    datas = [np.random.default_rng(80 + i).standard_normal(10).astype(np.float32) for i in range(3)]
    arrs = [htt.array(d, split=0) for d in datas]
    expected = [htt.sum(a).numpy() for a in arrs]
    htt.reset_executor_stats()
    resilience.arm_fault_plan([{"site": "executor.execute", "on_call": 1, "count": 99, "kind": "raise"}])
    try:
        results = _batch_staged(lambda i: htt.sum(arrs[i]).numpy(), 3, 2)
    finally:
        resilience.disarm_fault_plan()
    for g, w in zip(results, expected):
        np.testing.assert_array_equal(g, w)
    assert htt.executor_stats()["eager_fallbacks"] > 0


def test_staged_queued_expiry_typed_and_counted_once():
    x = htt.array(_np_pair(_EVEN)[0], split=0)
    htt.sum(x).numpy()
    htt.reset_executor_stats()
    sched = _executor._get_scheduler()
    caught = []

    def worker():
        try:
            with profiler.request("expiring", deadline_s=0.15):
                htt.sum(x).numpy()
        except Exception as exc:
            caught.append(exc)

    sched.pause()
    th = threading.Thread(target=worker, daemon=True)
    th.start()
    _wait_depth(sched, 1)
    time.sleep(0.25)
    sched.resume()
    th.join(timeout=30.0)
    assert len(caught) == 1 and isinstance(caught[0], resilience.DeadlineExceeded)
    assert htt.executor_stats()["expired_requests"] == 1


# ---------------------------------------------------------------------- adaptive window
def test_window_off_by_default_no_holds():
    assert _executor.batch_window_s() == 0.0
    x = htt.array(_np_pair(_EVEN)[0], split=0)
    (x + 1.0).larray
    (x + 1.0).larray
    assert htt.executor_stats()["window_holds"] == 0


def test_window_widens_batch_for_late_arrival():
    datas = [np.full(8, float(i + 1), np.float32) for i in range(2)]
    with sharded(1, window_us=500000) as sched:
        _executor.clear_executor_cache()
        arrs = [htt.array(d, split=0) for d in datas]
        expected = [htt.sum(a).numpy() for a in arrs]
        other = htt.array(np.arange(8.0, dtype=np.float32), split=0)
        htt.cumsum(other, axis=0).numpy()
        htt.reset_executor_stats()
        results, errors = [None] * 3, []

        def w(i, fn):
            try:
                results[i] = fn()
            except Exception as exc:
                errors.append(exc)

        t1 = threading.Thread(target=w, args=(0, lambda: htt.sum(arrs[0]).numpy()))
        t2 = threading.Thread(target=w, args=(1, lambda: htt.cumsum(other, axis=0).numpy()))
        sched.pause()
        t1.start()
        time.sleep(0.03)
        t2.start()
        _wait_depth(sched, 2, 10.0)
        sched.resume()
        time.sleep(0.02)
        assert not sched.wait_idle(0.0), "shard must read busy while holding the window"
        t3 = threading.Thread(target=w, args=(2, lambda: htt.sum(arrs[1]).numpy()))
        t3.start()
        for th in (t1, t2, t3):
            th.join(timeout=60.0)
        assert not errors
        assert results[0].tobytes() == expected[0].tobytes()
        assert results[2].tobytes() == expected[1].tobytes()
        st = htt.executor_stats()
        assert st["window_holds"] >= 1 and st["window_widened"] >= 1 and st["batched_requests"] >= 2


def test_window_hold_never_expires_a_request_with_headroom():
    np_a, _ = _np_pair(_EVEN)
    with sharded(1, window_us=10_000_000) as sched:
        _executor.clear_executor_cache()
        x = htt.array(np_a, split=0)
        expected = htt.sum(x).numpy()
        htt.reset_executor_stats()
        got, errors = [], []

        def w():
            try:
                with profiler.request("headroom", deadline_s=0.4):
                    got.append(htt.sum(x).numpy())
            except Exception as exc:
                errors.append(exc)

        other = htt.array(np_a * 2.0, split=0)
        htt.cumsum(other, axis=0).numpy()
        t2 = threading.Thread(target=lambda: htt.cumsum(other, axis=0).numpy())
        t1 = threading.Thread(target=w)
        sched.pause()
        t1.start()
        time.sleep(0.02)
        t2.start()
        _wait_depth(sched, 2, 10.0)
        t0 = time.monotonic()
        sched.resume()
        t1.join(timeout=30.0)
        t2.join(timeout=30.0)
        assert not errors and len(got) == 1 and got[0].tobytes() == expected.tobytes()
        assert time.monotonic() - t0 < 5.0
        assert htt.executor_stats()["expired_requests"] == 0
