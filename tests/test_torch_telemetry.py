"""The port's telemetry plane (heat_tpu_torch/core/telemetry.py and the
``heat_tpu_torch.telemetry`` CLI) against heat_tpu's.

A telemetry shard is written by each package after the same scripted counters, spans,
histograms and collective windows; the shards share heat_tpu's schema, so either
package's ``merge`` folds them, and the two merges agree. Excluded from comparisons:
``generated_at`` (a timestamp), ``per_process.*.pid``/``host``/``generated_at``, the
``clock`` anchors (monotonic instants), span times and window enter/exit instants and
durations (wall time), and the provider sections that report machine state (the executor's).
"""

import json
import os
import time

import numpy as np
import pytest

from heat_tpu.core import diagnostics as jdiag
from heat_tpu.core import profiler as jprof
from heat_tpu.core import telemetry as jtel

import heat_tpu_torch as htt
from heat_tpu_torch.core import diagnostics, profiler, resilience, telemetry

EXCLUDED = ("generated_at", "pid", "host", "clock", "executor", "skew", "per_process", "total_s", "max_s")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for diag, prof, tel in ((diagnostics, profiler, telemetry), (jdiag, jprof, jtel)):
        diag.reset()
        diag.enable()
        prof.reset()
        tel.reset()
        tel.enable()
        with tel._lock:  # the auto-dump rate limit is per process: other files' dumps count
            tel._auto_dumps = 0
            tel._last_auto_ns.clear()
    yield
    for diag, prof, tel in ((diagnostics, profiler, telemetry), (jdiag, jprof, jtel)):
        tel.disable()
        tel.reset()
        tel.set_process_info(0, 1)
        with tel._lock:
            tel._clock.update(anchors_ns=None, aligned=False)
        prof.disable()
        prof.reset()
        diag.disable()
        diag.reset()


def _script(diag, prof, tel, rank):
    """The same counters, span, histograms and collective windows in either package."""
    rng = np.random.default_rng(7 + rank)
    tel.set_process_info(rank, 2)
    for i in range(5):
        diag.counter("serving.requests", 1 + i)
    diag.counter("serving.bytes", 4096)
    with diag.span("serving.phase"):
        pass
    prof.enable()
    for v in rng.uniform(1e-4, 5e-2, size=40):
        prof.observe("request.tenantA", float(v))
    for v in rng.uniform(1e-3, 1e-1, size=10):
        prof.observe("service.defer", float(v))
    prof.disable()
    for _ in range(3):
        with tel.collective_window("comm.all_reduce"):
            pass
    with tel.collective_window("comm.barrier"):
        pass


def _strip(tree):
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items() if k not in EXCLUDED}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


def test_shards_merge_across_packages(tmp_path):
    d = tmp_path / "shards"
    anchor = time.monotonic_ns()  # one clock for both "ranks": the handshake's result
    for tel in (jtel, telemetry):
        tel.record_clock_anchor(anchor, [anchor, anchor])
    _script(jdiag, jprof, jtel, 0)
    jpath = jtel.dump_shard(str(d))
    _script(diagnostics, profiler, telemetry, 1)
    path = telemetry.dump_shard(str(d))
    assert os.path.basename(jpath) == "telemetry-shard-p0000.json"
    assert os.path.basename(path) == "telemetry-shard-p0001.json"
    jshard, shard = (json.load(open(p)) for p in (jpath, path))
    assert shard["schema"] == jshard["schema"] == "heat-tpu-telemetry/1"
    assert set(shard) == set(jshard)
    # the same script gives the same counters, spans and histograms in either shard
    assert shard["diagnostics"]["counters"] == jshard["diagnostics"]["counters"]
    assert _strip(shard["diagnostics"]["spans"]) == _strip(jshard["diagnostics"]["spans"])
    hp, jhp = shard["diagnostics"]["profiler"]["histograms"], jshard["diagnostics"]["profiler"]["histograms"]
    assert set(hp) == set(jhp)
    for name in hp:
        assert hp[name]["count"] == jhp[name]["count"]
    # either package's merge folds both shards, and the two reports agree
    mine, theirs = telemetry.merge(str(d)), jtel.merge(str(d))
    assert mine["schema"] == theirs["schema"] == "heat-tpu-telemetry-merged/1"
    assert _strip(mine) == _strip(theirs)
    assert mine["counters"]["serving.requests"] == 2 * 15
    assert mine["counters"]["serving.bytes"] == 2 * 4096
    assert mine["histograms"]["request.tenantA"]["count"] == 80
    assert mine["sequence"] == theirs["sequence"]
    assert mine["sequence"]["consistent"] is True
    assert set(mine["skew"]["sites"]) == set(theirs["skew"]["sites"]) == {"comm.all_reduce", "comm.barrier"}


def test_one_shard_merge_reproduces_its_counters(tmp_path):
    _script(diagnostics, profiler, telemetry, 0)
    telemetry.set_process_info(0, 1)
    telemetry.dump_shard(str(tmp_path))
    rep = telemetry.merge(str(tmp_path))
    assert rep["counters"] == diagnostics.report()["counters"]
    assert rep["processes"] == 1


def test_cli_merge_and_alias(tmp_path, capsys):
    from heat_tpu_torch import telemetry as alias

    _script(diagnostics, profiler, telemetry, 0)
    telemetry.set_process_info(0, 1)
    telemetry.dump_shard(str(tmp_path / "s"))
    out = tmp_path / "merged.json"
    assert alias.main(["merge", "--dir", str(tmp_path / "s"), "--out", str(out)]) == 0
    rep = json.load(open(out))
    assert rep["counters"]["serving.requests"] == 15
    assert set(alias.__all__) == set(jtel.__all__)


def test_guarded_chokepoint_records_collective_windows():
    comm = htt.get_comm()
    x = htt.array(np.arange(6.0), split=0)
    telemetry.reset()
    comm.barrier()
    comm.all_reduce(x.larray.clone())
    sites = [w[0] for w in telemetry.windows()]
    assert sites == ["comm.barrier", "comm.all_reduce"]
    telemetry.disable()
    comm.barrier()
    assert len(telemetry.windows()) == 2  # off: one flag read, nothing recorded


def test_flight_ring_is_bounded_and_swap_failed_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("HEAT_TPU_FLIGHT_EVENTS", "16")
    telemetry.reset()
    for i in range(40):
        telemetry.flight_record("lifecycle", "test.site", f"event {i}")
    events = telemetry.flight_events()
    assert len(events) == 16 and events[-1]["detail"] == "event 39"
    before = len(telemetry.flight_dumps())
    diagnostics.record_resilience_event("serving.swap", "swap-failed", "pool=x stage=stage")
    deadline = time.monotonic() + 10.0
    while len(telemetry.flight_dumps()) == before and time.monotonic() < deadline:
        time.sleep(0.02)
    dumps = telemetry.flight_dumps()
    assert len(dumps) == before + 1
    dump = json.load(open(dumps[-1]))
    assert dump["schema"] == "heat-tpu-flight/1"
    assert any(e.get("kind") == "swap-failed" for e in dump["events"])


def test_fault_firing_reaches_the_ring():
    telemetry.reset()
    resilience.arm_fault_plan([{"site": "unit.site", "kind": "raise", "on_call": 1}])
    try:
        with pytest.raises(resilience.FaultInjected):
            resilience.maybe_fault("unit.site")
    finally:
        resilience.disarm_fault_plan()
    assert any(e["site"] == "unit.site" for e in telemetry.flight_events())
