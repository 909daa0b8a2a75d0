"""The program's phases and counters on the port's timeline plane (heat_tpu_torch/core/
profiler.py: ``phase``, ``part``, ``count``, ``phases``): the Lloyd loop's and the training
step's spans, recorded with their counts and nesting while a ``torch.profiler`` session runs
or the profiler is enabled, and nothing otherwise; results bit-identical either way; no span
a ``torch.profiler`` annotation; device times from CUDA event pairs resolved only when read;
and one clock shared by the device trace's export and the profiler's dump."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import heat_tpu_torch as htt
from heat_tpu_torch.core import profiler

LLOYD = ("fit.entry", "lloyd.pass", "lloyd.assign", "lloyd.update", "lloyd.check", "fit.readback")
STEP = ("step.forward", "step.backward", "step.reduce", "step.update")


@pytest.fixture(autouse=True)
def _fresh():
    htt.use_device("cpu")
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _blobs(n=240, d=4, k=3, seed=5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, d)) + 4.0 * np.repeat(np.arange(k), -(-n // k))[:n, None]).astype(np.float32)
    return htt.array(x, split=0), htt.array(x[:: n // k][:k].copy())


def _fit(estimator=htt.cluster.KMeans, max_iter=5, tol=-1.0):
    x, init = _blobs()
    return estimator(n_clusters=3, init=init, max_iter=max_iter, tol=tol).fit(x)


def _slices():
    """The recorded phase slices, (name, t0, t1) in start order."""
    return sorted(((s[3], s[4], s[5]) for s in profiler.trace_snapshot()["slices"] if s[2] == "phase"),
                  key=lambda s: (s[1], -s[2]))


def _counts():
    return {name: t["count"] for name, t in profiler.phases()["spans"].items()}


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("estimator", [htt.cluster.KMeans, htt.cluster.KMedians], ids=lambda e: e.__name__)
def test_lloyd_phases_at_tol_minus_one(estimator):
    with _session():
        km = _fit(estimator, max_iter=5, tol=-1.0)
    assert km.n_iter_ == 5
    assert _counts() == {"fit.entry": 1, "lloyd.pass": 5, "lloyd.assign": 5, "lloyd.update": 5, "fit.readback": 1}
    assert profiler.phases()["counters"] == {"lloyd.host_reads": 2.0}
    slices = _slices()
    by = {name: [s for s in slices if s[0] == name] for name in LLOYD}
    entry, readback = by["fit.entry"][0], by["fit.readback"][0]
    assert entry[2] <= by["lloyd.pass"][0][1] and by["lloyd.pass"][-1][2] <= readback[1]
    for p, a, u in zip(by["lloyd.pass"], by["lloyd.assign"], by["lloyd.update"]):
        # the pass splits into its assignment, then its update, which lasts to the pass's end
        assert _inside(a, p) and _inside(u, p) and a[2] <= u[1] and u[2] == p[2]
    # the final assignment is the readback's, no part of a pass
    assert not any(_inside(s, readback) for s in by["lloyd.assign"] + by["lloyd.update"])
    for t in profiler.phases()["spans"].values():
        assert t["host_s"] > 0 and t["device_s"] is None


def test_lloyd_checks_count_as_host_reads(monkeypatch):
    with _session():
        km = _fit(max_iter=30, tol=0.0)
    counts, reads = _counts(), profiler.phases()["counters"]["lloyd.host_reads"]
    passes, checks = counts["lloyd.pass"], counts["lloyd.check"]
    # a check every 8 passes, the loop's condition read at each; then the two results
    assert checks == passes // 8 >= 1 and reads == checks + 2 and km.n_iter_ <= passes
    monkeypatch.setattr(htt.cluster.KMeans, "_check_every", 1)
    profiler.reset()
    with _session():
        km = _fit(max_iter=30, tol=0.0)
    counts = _counts()
    # converged: every pass after the first checked, the last check stopping the loop
    assert counts["lloyd.check"] == counts["lloyd.pass"] == km.n_iter_ < 30
    assert profiler.phases()["counters"]["lloyd.host_reads"] == counts["lloyd.check"] + 2


def _trainer(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.Tanh(), torch.nn.Linear(8, 2))
    opt = htt.optim.DataParallelOptimizer(torch.optim.Adam(model.parameters(), lr=0.01))
    htt.nn.DataParallel(model, optimizer=opt)
    return model, opt


def _batch():
    g = torch.Generator().manual_seed(3)
    return htt.array(torch.randn(10, 3, generator=g), split=0), htt.array(torch.randn(10, 2, generator=g), split=0)


def _loss(model, a, b):
    return torch.nn.functional.mse_loss(model(a), b)


def test_step_phases_in_order():
    model, opt = _trainer()
    with _session():
        opt.step(_loss, *_batch())
    # world 1: no reduction
    assert _counts() == {"step.forward": 1, "step.backward": 1, "step.update": 1}
    f, b, u = (next(s for s in _slices() if s[0] == name) for name in ("step.forward", "step.backward", "step.update"))
    assert f[2] <= b[1] and b[2] <= u[1]
    for t in profiler.phases()["spans"].values():
        assert t["host_s"] > 0 and t["device_s"] is None  # CPU tensors: timed on the host alone


def test_nothing_recorded_off_and_outside_a_session():
    model, opt = _trainer()
    _fit()
    opt.step(_loss, *_batch())
    htt.get_comm().all_reduce(torch.ones(3), "sum")
    assert profiler.phases() == {"spans": {}, "counters": {}}
    assert profiler.trace_snapshot()["slices"] == [] and profiler.trace_snapshot()["counter_events"] == []
    with _session():
        _fit()
    recorded = _counts()
    _fit()  # after the session: nothing more
    assert _counts() == recorded


def test_enabled_profiler_records_without_a_session():
    profiler.enable()
    _fit()
    model, opt = _trainer()
    opt.step(_loss, *_batch())
    assert set(_counts()) == {"fit.entry", "lloyd.pass", "lloyd.assign", "lloyd.update", "fit.readback",
                              "step.forward", "step.backward", "step.update"}


def test_collective_scope_records_in_a_session():
    with _session():
        htt.get_comm().all_reduce(torch.ones(3), "sum")
    assert [s[2:4] for s in profiler.trace_snapshot()["slices"]] == [["collective", "comm.all_reduce"]]


def test_results_are_bit_identical_with_recording_on_and_off():
    off = _fit(max_iter=12, tol=0.0)
    with _session():
        on = _fit(max_iter=12, tol=0.0)
    assert torch.equal(on.cluster_centers_.larray, off.cluster_centers_.larray)
    assert torch.equal(on.labels_.larray, off.labels_.larray)
    assert on.n_iter_ == off.n_iter_ and on.inertia_ == off.inertia_
    model_off, opt_off = _trainer()
    model_on, opt_on = _trainer()
    losses_off = [opt_off.step(_loss, *_batch()) for _ in range(2)]
    with _session():
        losses_on = [opt_on.step(_loss, *_batch()) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(losses_on, losses_off))
    for a, b in zip(model_on.parameters(), model_off.parameters()):
        assert torch.equal(a, b)


def test_no_phase_is_a_profiler_annotation():
    model, opt = _trainer()
    with _session() as prof:
        _fit(max_iter=10, tol=0.0)
        opt.step(_loss, *_batch())
    names = {e.name for e in prof.events()}
    assert set(_counts()) and not names & (set(LLOYD) | set(STEP))


def _stand_in_events(monkeypatch, made):
    """``torch.cuda.Event`` replaced by stand-ins with the methods the profiler calls: each
    ``record`` on a stream (a dict) advances the stream's clock 2.5 ms; one stream completes
    its events in order, up to its ``done`` mark."""

    class Event:
        def record(self, s):
            s["clock"] += 2.5
            self.s, self.at = s, s["clock"]

        def query(self):
            return self.at <= self.s["done"]

        def synchronize(self):
            self.s["done"] = max(self.s["done"], self.at)

        def elapsed_time(self, end):
            return end.at - self.at

    def new_event(enable_timing):
        made.append(Event())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", new_event)


def test_device_times_resolve_when_read(monkeypatch):
    """A phase on a device stream records one CUDA event at each edge, from a pool; its
    device seconds stay unread until ``phases()`` folds them, after waiting for the
    stream. Parts share their edges' events and tile the phase's device time."""
    made, stream = [], {"done": 0.0, "clock": 0.0}
    _stand_in_events(monkeypatch, made)
    for _ in range(3):
        with profiler._Phase("step.update", stream, False):
            pass
    tally = profiler._phase_tallies["step.update"]
    assert len(made) == 6 and tally[2] is None and len(tally[3]) == 3  # recorded, not read
    spans = profiler.phases()["spans"]
    assert spans["step.update"]["count"] == 3 and spans["step.update"]["device_s"] == pytest.approx(3 * 2.5e-3)
    assert len(profiler._event_pool) == 6 and tally[3] == []
    with profiler._Phase("step.update", stream, False):
        pass
    assert len(made) == 6  # the read events were reused
    assert profiler.phases()["spans"]["step.update"]["device_s"] == pytest.approx(4 * 2.5e-3)
    profiler.enable()  # part() records only while recording
    with profiler._Phase("lloyd.pass", stream, True):
        profiler.part("lloyd.assign")
        profiler.part("lloyd.update")
    spans = profiler.phases()["spans"]
    # four edges: the pass's start, the assignment's, the update's, the pass's end
    assert spans["lloyd.pass"]["device_s"] == pytest.approx(3 * 2.5e-3)
    assert spans["lloyd.assign"]["device_s"] == spans["lloyd.update"]["device_s"] == pytest.approx(2.5e-3)


def test_pending_pairs_fold_when_many(monkeypatch):
    monkeypatch.setattr(profiler, "_MAX_PENDING", 4)
    made, stream = [], {"done": 1e9, "clock": 0.0}  # every event already complete
    _stand_in_events(monkeypatch, made)
    for _ in range(9):
        with profiler._Phase("step.forward", stream, False):
            pass
    tally = profiler._phase_tallies["step.forward"]
    assert len(tally[3]) == 1 and tally[0] == 9 and tally[2] == pytest.approx(8 * 2.5e-3)
    assert len(made) == 8  # the folded events were reused


def test_one_clock_for_the_device_trace_and_the_dump(tmp_path):
    """A phase opened inside a ``record_function`` that sleeps 5 ms before and after it lies
    inside that annotation's interval on both exported timelines, 3 ms or more from each
    edge: the two clocks agree to better than 2 ms."""
    with _session() as prof:
        with record_function("outer"):
            time.sleep(0.005)
            with profiler.phase("clock.probe"):
                pass
            time.sleep(0.005)
    path = os.path.join(tmp_path, "device.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        device = json.load(f)
    outer = next(e for e in device["traceEvents"] if e.get("name") == "outer" and e.get("ph") == "X")
    base = device["baseTimeNanoseconds"]
    o0 = base + outer["ts"] * 1e3
    o1 = o0 + outer["dur"] * 1e3

    def probe(dump):
        edges = {e["ph"]: e["ts"] for e in dump["traceEvents"] if e.get("name") == "clock.probe"}
        return edges["B"], edges["E"]

    mine = profiler.dump_trace(os.path.join(tmp_path, "program.json"))
    b, e = probe(mine)
    p0, p1 = mine["baseTimeNanoseconds"] + b * 1e3, mine["baseTimeNanoseconds"] + e * 1e3
    assert o0 + 3e6 < p0 <= p1 < o1 - 3e6
    # written on the device trace's time base, the two files' timestamps share one axis
    merged = profiler.dump_trace(os.path.join(tmp_path, "merged.json"), base_ns=base)
    b, e = probe(merged)
    assert merged["baseTimeNanoseconds"] == base
    assert outer["ts"] + 3e3 < b <= e < outer["ts"] + outer["dur"] - 3e3


def test_enable_keeps_the_clock_origin():
    origin = profiler._T0_NS
    profiler.reset()
    profiler.enable()
    with profiler.phase("x"):
        pass
    assert profiler._T0_NS == origin
    (slice_,) = profiler.trace_snapshot()["slices"]
    # microseconds since the import-time origin, on CLOCK_REALTIME
    assert abs((origin + slice_[4] * 1e3) - time.time_ns()) < 60e9


def test_parts_outside_a_parted_phase_are_ignored():
    profiler.enable()
    profiler.part("orphan")
    with profiler.phase("whole"):
        profiler.part("ignored")
    with profiler.phase("outer", parts=True):
        profiler.part("one")
        with profiler.phase("inner"):
            profiler.part("ignored")
        profiler.part("two")
    assert _counts() == {"whole": 1, "outer": 1, "one": 1, "inner": 1, "two": 1}
    one, two, outer = (next(s for s in _slices() if s[0] == n) for n in ("one", "two", "outer"))
    assert one[2] <= two[1] and two[2] == outer[2]



def test_threads_record_every_phase_while_others_read():
    """Under a short switch interval, eight threads record phases in parts while two others
    read the tallies and export the timeline, and no record is lost or torn."""
    import sys
    import threading

    threads_n, phases_n = 8, 1500
    profiler.enable()
    errors, stop = [], threading.Event()

    def write():
        try:
            for _ in range(phases_n):
                with profiler.phase("stress.pass", parts=True):
                    profiler.part("stress.first")
                    profiler.part("stress.second")
        except Exception as exc:  # collected, and asserted below
            errors.append(exc)

    def read():
        try:
            while not stop.is_set():
                profiler.phases()
                for s in profiler.trace_snapshot()["slices"]:
                    assert len(s) == 6 and s[4] <= s[5]
        except Exception as exc:  # collected, and asserted below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [threading.Thread(target=write) for _ in range(threads_n)]
        readers = [threading.Thread(target=read) for _ in range(2)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in readers:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in writers + readers) and errors == []
    assert _counts() == {"stress.pass": threads_n * phases_n, "stress.first": threads_n * phases_n,
                         "stress.second": threads_n * phases_n}
    assert profiler._open == {}
