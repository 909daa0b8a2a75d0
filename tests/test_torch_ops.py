"""The port's live operations plane (heat_tpu_torch/core/ops.py) against heat_tpu's.

From the same scripted cumulative snapshots (request histograms and lifecycle ledgers,
hand-built as heat_tpu's tests/test_ops.py builds them, values from a seeded numpy
generator) both packages compute the same windowed samples, burn rates and alert
states, and ``render_openmetrics`` gives the same families, labels and values; the
parse round-trips. ``healthz`` and the HTTP exporter on an ephemeral localhost port
work. Excluded from comparisons: the sample's ``t``/``generated_at`` wall stamps and
``ht_ops_sample_timestamp_seconds`` (wall time).
"""

import json
import urllib.request

import numpy as np
import pytest

from heat_tpu.core import ops as jops
from heat_tpu.core import profiler as jprof
from heat_tpu.core import telemetry as jtel

import heat_tpu_torch as htt
from heat_tpu_torch.core import diagnostics, ops, profiler, resilience, supervision, telemetry

EXCLUDED = ("t", "generated_at")


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for o in (ops, jops):
        o.disarm()
        o.reset()
    yield
    for o in (ops, jops):
        o.disarm()
        o.reset()
    resilience.reset(clear_breakers=True)
    supervision.reset_abort()


def _cum(hist_cls, mono, *, admitted=0, shed=0, failed=0, hists=None, lifecycle=None):
    return {
        "mono": float(mono), "t": "2026-08-07T00:00:00Z",
        "admitted": admitted, "shed": shed, "failed": failed,
        "cache_hits": 3 * admitted, "cache_misses": admitted,
        "compile_hits": 0, "compile_misses": 0, "queue_depth": 0, "draining": False,
        "pressure": {"per_shard": [{"shard": 0, "depth_ewma": 0.5}], "service_ewma_s": {"defer": 0.001}},
        "tenant_lifecycle": lifecycle or {},
        "request_hists": {k: v.snapshot() for k, v in (hists or {}).items()},
        "breakers": {}, "supervision": {"armed": False, "aborted": None},
    }


def _feeds(hist_cls):
    """Healthy windows, then a 10x latency regression for tenantE and failures for
    tenantS: the alert flips on both tenants."""
    rng = np.random.default_rng(5)
    he, hs = hist_cls(), hist_cls()
    feeds = [_cum(hist_cls, 0.0, hists={"tenantE": he, "tenantS": hs})]
    admitted = failed = 0
    for w in range(6):
        slow = w >= 3
        for v in rng.uniform(0.0005, 0.002, size=20):
            he.observe(float(v) * (10.0 if slow else 1.0))
        for v in rng.uniform(0.0005, 0.002, size=20):
            hs.observe(float(v))
        admitted += 40
        failed += 6 if slow else 0
        feeds.append(_cum(hist_cls, 10.0 * (w + 1), admitted=admitted, failed=failed,
                          hists={"tenantE": he, "tenantS": hs},
                          lifecycle={"tenantS": {"deadline_expired": failed, "shed": 0, "cancelled": 0}}))
    return feeds


def _drive(o, prof, monkeypatch):
    o.set_slo("tenantE", p99_ms=5.0)
    o.set_slo("tenantS", success_ratio=0.99)
    it = iter(_feeds(prof.Histogram))
    monkeypatch.setattr(o, "_collect_cumulative", lambda: next(it))
    return [o.sample_once() for _ in range(7)]


def _strip(tree):
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items() if k not in EXCLUDED}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


def _page_families(text):
    return {
        name: {k: v for k, v in fam.items() if k != "samples"} | {
            "samples": sorted((n, tuple(sorted(labels.items())), v) for n, labels, v in fam["samples"]
                              if n != "ht_ops_sample_timestamp_seconds")
        }
        for name, fam in ops.parse_openmetrics(text).items()
    }


def test_burn_rates_and_alerts_match_heat_tpu(monkeypatch):
    theirs = _drive(jops, jprof, monkeypatch)
    mine = _drive(ops, profiler, monkeypatch)
    assert _strip(mine) == _strip(theirs)
    assert ops.slo_status() == jops.slo_status()
    status = ops.slo_status()
    assert status["tenantE"]["alert"] and status["tenantS"]["alert"]
    burns = [e for e in telemetry.flight_events() if e["kind"] == "slo-burn"]
    assert {e["site"] for e in burns} == {"ops.slo.tenantE", "ops.slo.tenantS"}


def test_openmetrics_page_matches_heat_tpu_and_round_trips(monkeypatch):
    _drive(jops, jprof, monkeypatch)
    _drive(ops, profiler, monkeypatch)
    page, jpage = ops.render_openmetrics(), jops.render_openmetrics()
    assert page.endswith("# EOF\n")
    assert _page_families(page) == _page_families(jpage)
    parsed = ops.parse_openmetrics(page)
    assert parsed == jops.parse_openmetrics(page)
    assert "ht_slo_burn_rate" in parsed
    labels = {tuple(sorted(lab.items())) for _n, lab, _v in parsed["ht_slo_burn_rate"]["samples"]}
    assert (("tenant", "tenantE"), ("window", "1m")) in labels
    with pytest.raises(ValueError):
        ops.parse_openmetrics(page.replace("# EOF\n", ""))


def test_live_sample_reads_the_port_executor():
    x = htt.array(np.arange(12.0, dtype=np.float32), split=0)
    with profiler.request("tenantL"):
        (x * 2.0).numpy()
    ops.sample_once()
    s = ops.sample_once()
    assert s is not None and "tenants" in s
    assert "ops" in diagnostics.report()


def test_healthz_follows_breakers_and_the_abort_sentinel():
    ok, payload = ops.healthz()
    assert ok and payload["ok"]
    supervision.arm(supervision.LocalCoordinator(), rank=0, nprocs=2, start_thread=False)
    try:
        supervision.post_abort("peer-failed", rank=1, last_seen_s=2.0)
        ok, payload = ops.healthz()
        assert not ok and payload["abort"]["kind"] == "peer-failed"
    finally:
        supervision.disarm()
        supervision.reset_abort()
    br = resilience.breaker("unit.breaker", failure_threshold=1)
    br.record_failure("x")
    ok, payload = ops.healthz()
    assert not ok and payload["open_breakers"] == ["unit.breaker"]


def test_http_exporter_on_an_ephemeral_localhost_port(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_OPS_PORT", "0")
    ops.reload()
    ops.arm(interval_s=60.0)
    try:
        host, port = ops.http_address()
        assert host in ("127.0.0.1", "localhost")
        ops.sample_once()
        page = urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=10).read().decode()
        assert "ht_samples" in ops.parse_openmetrics(page) and page.endswith("# EOF\n")
        body = json.loads(urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10).read().decode())
        assert body["ok"] is True
    finally:
        ops.disarm()
        monkeypatch.delenv("HEAT_TPU_OPS_PORT")
        ops.reload()
    assert ops.http_address() is None


def test_beat_prefix_and_cluster_snapshot_over_a_local_coordinator():
    assert ops.BEAT_PREFIX == telemetry.OPS_BEAT_PREFIX == jtel.OPS_BEAT_PREFIX
    co = supervision.LocalCoordinator()
    ops.publish_beat(co, "heat_tpu/sup/9", 0)
    ops.publish_beat(co, "heat_tpu/sup/9", 1)
    snap = ops.cluster_snapshot(co, "heat_tpu/sup/9")
    assert sorted(snap["ranks"]) == ["0", "1"]
    assert ops.__all__ == jops.__all__
