"""``ht.ops`` (the port's own copy of heat_tpu/core/ops.py, stdlib-only at load) — the
live operations plane: continuous metrics export, cluster
health beats, and per-tenant SLO burn-rate alerts.

Every observability surface before this one is post-hoc: :mod:`diagnostics` /
:mod:`profiler` dump on exit, ``telemetry merge`` folds shards offline, and the
flight recorder fires only after a fault. This module is the *live* half — the
signal plane an autoscaler (or a human watching a dashboard) consumes while
traffic is in flight — built from four coupled parts:

- **Continuous sampler.** An opt-in daemon (``HEAT_TPU_OPS=1``, cadence
  ``HEAT_TPU_OPS_INTERVAL_S``, default 5 s) snapshots ``executor_stats()``
  (admission / shed / expiry ledger, per-shard pressure EWMAs, result- and
  compile-cache counters), ``resilience.breakers()``, the supervision abort
  state, and the per-tenant ``request.<tag>`` latency histograms into a
  bounded ring of **windowed deltas**: each ring entry is the difference
  between two cumulative snapshots (counters subtract exactly; histograms via
  :meth:`profiler.Histogram.delta`), so rates — rps, shed rate, cache hit
  rate, per-shard queue-depth EWMA — are first-class values, not cumulative
  counters a consumer has to differentiate. A mid-run stats reset makes the
  previous snapshot a non-prefix; the sampler detects the ``ValueError``,
  marks the sample ``delta_reset`` and re-baselines instead of exporting
  garbage negative rates.

- **Exporter.** :func:`render_openmetrics` emits a strict OpenMetrics text
  page from the latest sample (``# TYPE``/``# HELP`` metadata per family,
  counter samples suffixed ``_total``, escaped label values, terminating
  ``# EOF``); :func:`parse_openmetrics` is the matching strict parser the
  tests and CI gates validate the page with. ``HEAT_TPU_OPS_PORT`` starts a
  localhost-only stdlib ``http.server`` on a daemon thread serving
  ``/metrics`` (the page) and ``/healthz`` (JSON; 503 while draining, while
  any circuit breaker is open, or while a supervision abort sentinel is up —
  exactly the states a load balancer must route around).
  ``HEAT_TPU_OPS_SCRAPE`` additionally writes the page to a file via
  ``resilience.atomic_write`` every sample, and ``HEAT_TPU_OPS_BEAT_DIR``
  writes the compact beat as ``ops-beat-r<rank>.json`` (the file-mode input
  of ``python -m heat_tpu_torch.telemetry top --dir`` and ``merge --from-ops``).

- **Cluster health beats.** When the supervision plane is armed, every
  monitor tick also publishes this rank's compact beat under
  ``<monitor.ns>/ops/<rank>`` on the torch.distributed coordination KV channel
  — piggybacking the existing heartbeat cadence: no new collectives, no
  thread, nothing on the card. Keys sit strictly *under* the prefix (the
  ``get_dir`` directory-semantics contract), so :func:`cluster_snapshot`
  folds all ranks with ONE non-blocking KV sweep — a rank that is mid-drain
  or dead simply has a stale/absent beat; nothing waits on it. ``python -m
  heat_tpu_torch.telemetry top`` renders the fold as a per-rank / per-tenant
  terminal table.

- **SLO trackers.** :func:`set_slo` declares per-tenant objectives
  (``p99_ms`` and/or ``success_ratio``); the sampler computes multi-window
  (1 m / 5 m) **burn rates** from the ring's windowed deltas — burn =
  bad-fraction ÷ error-budget, the standard SRE form, where a p99 objective
  budgets 1% of requests over the threshold (counted bucket-exactly via
  :meth:`profiler.Histogram.count_over`) and a success objective budgets
  ``1 - success_ratio`` of requests failing (shed + expired + cancelled from
  the exact lifecycle ledger). The alert is up while BOTH windows burn above
  1.0 (the fast window trips quickly, the slow window keeps one spike from
  paging); the OFF->ON transition is a typed ``slo-burn`` event on the
  always-on resilience stream — which auto-dumps a flight-recorder
  post-mortem carrying the offending window's per-shard pressure breakdown —
  and every burn is exported as the ``ht_slo_burn_rate{tenant,window}``
  series.

Zero-cost contract (same discipline as every sibling plane)
-----------------------------------------------------------
This module adds **no hook to any dispatch or compute path**: the sampler
reads the same cross-module report surfaces the end-of-run dumps read, on its
own daemon thread, at human cadence. Idle (the default) nothing runs at all;
armed, the only foreign code touched per sample is ``executor_stats()`` et
al. — host-side report folds that never touch what the card runs. The supervision beat piggyback is one
relaxed ``ops._armed`` attribute read per monitor tick.

Thread-safety
-------------
All module state (the ring, the previous cumulative snapshot, SLO/alert
tables, server/thread handles) mutates under the one module ``_lock``, which
is a strict LEAF of the lock graph: cross-module snapshots are gathered
*before* taking it and alert events are emitted *after* releasing it, so no
code ever holds ``ops._lock`` while calling into another locking module.
``_armed`` is the relaxed observer gate, read bare like
``diagnostics._enabled``.

Env knobs (read by :func:`reload`, chained from
``_executor.reload_env_knobs``)
------------------------------------------------------------------------
- ``HEAT_TPU_OPS=1``             — arm the plane at import (sampler daemon).
- ``HEAT_TPU_OPS_INTERVAL_S=F``  — sample cadence, seconds (default 5).
- ``HEAT_TPU_OPS_PORT=N``        — serve ``/metrics`` + ``/healthz`` on
  localhost:N (0 picks a free port; see :func:`http_address`).
- ``HEAT_TPU_OPS_SCRAPE=path``   — write the OpenMetrics page here each
  sample (atomic; for file-based scrapers).
- ``HEAT_TPU_OPS_BEAT_DIR=dir``  — write ``ops-beat-r<rank>.json`` here each
  sample (for ``telemetry top --dir`` / ``merge --from-ops``).
- ``HEAT_TPU_OPS_RING=N``        — ring capacity in samples (default 256 —
  comfortably past the 5 m burn window at the default cadence).
- ``HEAT_TPU_OPS_SLO=spec``      — declare objectives without code changes:
  ``tenantA:p99_ms=50,success_ratio=0.999;tenantB:p99_ms=10`` (applied at
  :func:`arm`; malformed entries are skipped, never fatal).

Stdlib-only at module load (like diagnostics/profiler/telemetry): the
executor is imported lazily inside the sampler, so the exporter/parser half
runs in tooling that never loads torch.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

try:
    from . import (diagnostics, forensics, profiler, resilience, supervision,
                   telemetry)
except ImportError:  # standalone file-path load (no parent package): the
    # exporter/parser surface still works; live sampling degrades to None
    diagnostics = forensics = profiler = resilience = supervision = None
    telemetry = None

__all__ = [
    "SCHEMA",
    "BEAT_SCHEMA",
    "BEAT_PREFIX",
    "arm",
    "disarm",
    "armed",
    "reload",
    "sample_once",
    "latest_sample",
    "samples",
    "set_slo",
    "clear_slo",
    "slo_status",
    "render_openmetrics",
    "parse_openmetrics",
    "healthz",
    "http_address",
    "cluster_snapshot",
    "write_beat_file",
    "write_scrape_file",
    "ops_stats",
    "reset",
]

SCHEMA = "heat-tpu-ops/1"
BEAT_SCHEMA = "heat-tpu-ops-beat/1"

#: filename prefix of per-rank beat files inside a beat directory (the
#: file-mode input of ``telemetry top --dir`` and ``merge --from-ops``)
BEAT_PREFIX = "ops-beat-r"

# Observer gate, read bare (``ops._armed``) by the supervision beat tee and
# the sampler loop: one attribute load + branch when off.
_armed: bool = False

# LEAF lock: everything below mutates under it; nothing called while holding
# it may take another module's lock (cross-module snapshots are gathered
# before acquiring, events emitted after releasing).
_lock = threading.RLock()

_DEFAULT_INTERVAL_S = 5.0
_DEFAULT_RING = 256
_BURN_WINDOWS: Tuple[Tuple[str, float], ...] = (("1m", 60.0), ("5m", 300.0))
#: floor on an error budget so a 100% success objective cannot divide by zero
_MIN_BUDGET = 1e-4


def _parse_slo_spec(spec: str) -> Dict[str, Dict[str, float]]:
    """Parse ``HEAT_TPU_OPS_SLO`` — objectives declared from the environment
    so CI can arm SLO tracking on an unmodified workload. Grammar:
    ``tenant:p99_ms=50,success_ratio=0.999;tenant2:p99_ms=10`` (semicolons
    between tenants, commas between objectives). Malformed entries are
    skipped, never fatal: a typo'd knob degrades to fewer objectives, it
    must not take down the process it observes."""
    out: Dict[str, Dict[str, float]] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        tenant, sep, body = entry.partition(":")
        if not sep or not tenant.strip():
            continue
        objectives: Dict[str, float] = {}
        for pair in body.split(","):
            key, eq, value = pair.strip().partition("=")
            if eq and key in ("p99_ms", "success_ratio"):
                try:
                    objectives[key] = float(value)
                except ValueError:
                    pass
        if objectives:
            out[tenant.strip()] = objectives
    return out


class _Knobs:
    """Memoised ``HEAT_TPU_OPS*`` env knobs (the executor's ``_EnvKnobs``
    pattern): read once at import and on every :func:`reload`."""

    __slots__ = ("enabled", "interval_s", "port", "scrape_path", "beat_dir",
                 "ring", "slos")

    def reload(self) -> None:
        env = os.environ
        self.enabled = env.get("HEAT_TPU_OPS") == "1"
        self.slos = _parse_slo_spec(env.get("HEAT_TPU_OPS_SLO", ""))
        try:
            self.interval_s = max(
                0.05, float(env.get("HEAT_TPU_OPS_INTERVAL_S", "")
                            or _DEFAULT_INTERVAL_S))
        except ValueError:
            self.interval_s = _DEFAULT_INTERVAL_S
        try:
            self.port = (int(env["HEAT_TPU_OPS_PORT"])
                         if "HEAT_TPU_OPS_PORT" in env else None)
        except ValueError:
            self.port = None
        self.scrape_path = env.get("HEAT_TPU_OPS_SCRAPE") or None
        self.beat_dir = env.get("HEAT_TPU_OPS_BEAT_DIR") or None
        try:
            self.ring = max(8, int(env.get("HEAT_TPU_OPS_RING", "")
                                   or _DEFAULT_RING))
        except ValueError:
            self.ring = _DEFAULT_RING


_knobs = _Knobs()
_knobs.reload()

# the sample ring (windowed deltas), the previous cumulative snapshot the
# next delta subtracts against, and the lifetime tallies
_ring: "deque[dict]" = deque(maxlen=_knobs.ring)
_prev_cum: Optional[dict] = None
_samples_total: int = 0
_delta_resets: int = 0

# per-tenant SLOs and the current alert state machine
_slos: Dict[str, Dict[str, float]] = {}
_alerts: Dict[str, Dict[str, Any]] = {}

# daemon handles
_thread: Optional[threading.Thread] = None
_thread_stop: Optional[threading.Event] = None
_server: Optional[Any] = None
_server_thread: Optional[threading.Thread] = None


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _record_degrade(site: str, exc: BaseException) -> None:
    """Account one degraded sampler leg (never raises; the plane observes,
    it must not fail the workload it observes)."""
    if diagnostics is not None:
        diagnostics.record_fallback(site, f"{type(exc).__name__}: {exc}")


# ------------------------------------------------------------------ gathering
def _collect_cumulative() -> dict:
    """One cumulative cross-plane snapshot, gathered OUTSIDE ``_lock`` (every
    callee takes its own module's lock; ops holds none of them).

    ``admitted`` / ``shed`` / ``failed`` are the exact executor ledger:
    admitted = inline + queued dispatches, shed = typed ``Shed`` rejections,
    failed = deadline expiries + cancellations — the same cells the serving
    gate asserts on, so the exported totals reconcile against it exactly."""
    cum: Dict[str, Any] = {
        "mono": time.monotonic(),
        "t": _utcnow(),
        "admitted": 0,
        "shed": 0,
        "failed": 0,
        "cache_hits": 0,
        "cache_misses": 0,
        "compile_hits": 0,
        "compile_misses": 0,
        "queue_depth": 0,
        "draining": False,
        "pressure": {"per_shard": [], "service_ewma_s": {}},
        "tenant_lifecycle": {},
        "tenant_cost": {},
        "request_hists": {},
        "breakers": {},
        "supervision": {"armed": False, "aborted": None},
    }
    try:
        from . import _executor
        ex = _executor.executor_stats()
    except Exception as exc:  # ht: ignore[silent-except] -- accounted via diagnostics.record_fallback (_record_degrade); a sampler tick must degrade, not kill the plane, when the executor half is absent (standalone load) or mid-teardown
        _record_degrade("ops.sample.executor", exc)
        ex = None
    if ex is not None:
        cum["admitted"] = (ex.get("inline_dispatches", 0)
                           + ex.get("queued_dispatches", 0))
        cum["shed"] = ex.get("shed_requests", 0)
        cum["failed"] = (ex.get("expired_requests", 0)
                         + ex.get("cancelled_requests", 0))
        cum["cache_hits"] = ex.get("cache_hits", 0)
        cum["cache_misses"] = ex.get("cache_misses", 0)
        cum["compile_hits"] = ex.get("hits", 0)
        cum["compile_misses"] = ex.get("misses", 0)
        cum["draining"] = bool(ex.get("draining", False))
        cum["pressure"] = ex.get("pressure",
                                 {"per_shard": [], "service_ewma_s": {}})
        cum["queue_depth"] = sum(
            s.get("queue_depth", 0) for s in cum["pressure"]["per_shard"])
        cum["tenant_lifecycle"] = ex.get("lifecycle_by_tenant", {})
        # forensics cost meters are CUMULATIVE cells (device seconds, flops,
        # logical collective bytes, cache bytes saved) — exported as counters,
        # never folded into the windowed deltas (the merge disjointness rule)
        cum["tenant_cost"] = ex.get("tenant_cost", {})
    if profiler is not None:
        hists = profiler.histogram_snapshots()
        cum["request_hists"] = {
            name[len("request."):]: snap
            for name, snap in hists.items() if name.startswith("request.")
        }
    if resilience is not None:
        cum["breakers"] = {
            site: snap.get("state", "closed")
            for site, snap in resilience.breakers().items()
        }
    if supervision is not None:
        cum["supervision"] = {
            "armed": supervision._armed,
            "aborted": supervision.aborted(),
        }
    return cum


def _tenant_window(cum: dict, prev: dict) -> Dict[str, dict]:
    """Per-tenant windowed delta cells: completed-request count, requests over
    each tenant's p99 threshold (bucket-exact via ``Histogram.count_over``),
    lifecycle failures, and the window's p50/p99. Pure computation on
    snapshots — no foreign locks. Raises ``ValueError`` when ``prev`` is not
    a prefix (a mid-run reset); the caller re-baselines."""
    out: Dict[str, dict] = {}
    tenants = set(cum["request_hists"]) | set(cum["tenant_lifecycle"])
    tenants |= set(prev.get("tenant_lifecycle", {}))
    for tenant in sorted(tenants):
        cell = {"count": 0, "over": 0, "bad": 0, "p50_ms": None, "p99_ms": None}
        snap = cum["request_hists"].get(tenant)
        if snap is not None and profiler is not None:
            h = profiler.Histogram.from_snapshot(snap)
            prev_snap = prev.get("request_hists", {}).get(tenant)
            d = h.delta(prev_snap) if prev_snap is not None else h
            cell["count"] = d.count
            if d.count:
                cell["p50_ms"] = round(d.percentile(0.50) * 1e3, 6)
                cell["p99_ms"] = round(d.percentile(0.99) * 1e3, 6)
            slo = _slos.get(tenant)
            if slo and slo.get("p99_ms") is not None:
                cell["over"] = d.count_over(slo["p99_ms"] / 1e3)
        cur_lc = cum["tenant_lifecycle"].get(tenant, {})
        prev_lc = prev.get("tenant_lifecycle", {}).get(tenant, {})
        bad = 0
        for kind in ("shed", "deadline_expired", "cancelled"):
            diff = cur_lc.get(kind, 0) - prev_lc.get(kind, 0)
            if diff < 0:
                raise ValueError(
                    f"lifecycle ledger went backwards for {tenant!r}/{kind}")
            bad += diff
        cell["bad"] = bad
        out[tenant] = cell
    return out


def _rate(delta: float, window_s: float) -> float:
    return round(delta / window_s, 6) if window_s > 0 else 0.0


def _burn_for(tenant: str, slo: Dict[str, float],
              window_samples: List[dict]) -> float:
    """One window's burn rate for ``tenant``: observed bad fraction divided
    by the SLO's error budget (>1.0 means the budget is being spent faster
    than it accrues). When both objectives are declared the worse burn wins —
    an alert must not hide behind the healthier objective."""
    count = over = bad = 0
    for s in window_samples:
        cell = s["tenants"].get(tenant)
        if cell is None:
            continue
        count += cell["count"]
        over += cell["over"]
        bad += cell["bad"]
    burns = []
    if slo.get("p99_ms") is not None:
        frac = (over / count) if count else 0.0
        burns.append(frac / 0.01)  # p99 objective: 1% of requests may exceed
    if slo.get("success_ratio") is not None:
        total = count + bad
        frac = (bad / total) if total else 0.0
        budget = max(_MIN_BUDGET, 1.0 - slo["success_ratio"])
        burns.append(frac / budget)
    return round(max(burns), 6) if burns else 0.0


def sample_once() -> Optional[dict]:
    """Take one sample NOW (the daemon's tick; public so tests and
    ``bench.py`` drive windows deterministically): gather the cumulative
    cross-plane snapshot, delta it against the previous one, evaluate SLO
    burn rates over the ring, append to the ring, then emit any alert
    transitions / beat / scrape **after** releasing the lock. Returns the
    sample, or None when no previous snapshot existed yet (the first call
    only establishes the baseline)."""
    global _prev_cum, _samples_total, _delta_resets
    cum = _collect_cumulative()
    # (tenant, kind, detail-dict): details stay dicts until after `_lock` is
    # released so the slo-burn case can attach forensics exemplar refs without
    # calling into another locking module from under the leaf lock
    transitions: List[Tuple[str, str, Dict[str, Any]]] = []
    with _lock:
        prev = _prev_cum
        _prev_cum = cum
        if prev is None:
            return None
        window_s = max(1e-9, cum["mono"] - prev["mono"])
        sample: Dict[str, Any] = {
            "schema": SCHEMA,
            "t": cum["t"],
            "mono": cum["mono"],
            "window_s": round(window_s, 6),
            "delta_reset": False,
            "totals": {k: cum[k] for k in
                       ("admitted", "shed", "failed",
                        "cache_hits", "cache_misses")},
            "queue_depth": cum["queue_depth"],
            "pressure": cum["pressure"],
            "breakers": cum["breakers"],
            "draining": cum["draining"],
            "supervision": cum["supervision"],
            "tenant_cost": cum.get("tenant_cost", {}),
        }
        try:
            deltas = {}
            for k in ("admitted", "shed", "failed",
                      "cache_hits", "cache_misses"):
                d = cum[k] - prev[k]
                if d < 0:
                    raise ValueError(f"counter {k!r} went backwards")
                deltas[k] = d
            sample["tenants"] = _tenant_window(cum, prev)
        except ValueError:
            # a mid-run stats reset: the old snapshot is not a prefix of the
            # new stream — re-baseline instead of exporting negative rates
            _delta_resets += 1
            sample["delta_reset"] = True
            deltas = {k: 0 for k in ("admitted", "shed", "failed",
                                     "cache_hits", "cache_misses")}
            sample["tenants"] = {}
        sample["deltas"] = deltas
        lookups = deltas["cache_hits"] + deltas["cache_misses"]
        sample["rates"] = {
            "rps": _rate(deltas["admitted"], window_s),
            "shed_rate": _rate(deltas["shed"], window_s),
            "failure_rate": _rate(deltas["failed"], window_s),
            "cache_hit_rate": (round(deltas["cache_hits"] / lookups, 6)
                               if lookups else None),
        }
        # ---- SLO burn rates over the ring (this sample included)
        history = list(_ring) + [sample]
        slo_out: Dict[str, dict] = {}
        for tenant, slo in sorted(_slos.items()):
            burns = {}
            for name, span in _BURN_WINDOWS:
                in_window = [s for s in history
                             if cum["mono"] - s["mono"] <= span]
                burns[name] = _burn_for(tenant, slo, in_window)
            alerting = all(b > 1.0 for b in burns.values())
            state = _alerts.setdefault(
                tenant, {"active": False, "since": None, "transitions": 0})
            if alerting and not state["active"]:
                state.update(active=True, since=cum["t"])
                state["transitions"] += 1
                transitions.append((tenant, "slo-burn", {
                    "tenant": tenant, "burn": burns,
                    "window_s": sample["window_s"],
                    "tenant_window": sample["tenants"].get(tenant),
                    "per_shard": cum["pressure"]["per_shard"],
                }))
            elif not alerting and state["active"]:
                state.update(active=False, since=cum["t"])
                transitions.append((tenant, "slo-burn-cleared",
                                    {"tenant": tenant, "burn": burns}))
            slo_out[tenant] = {
                "objectives": dict(slo),
                "burn": burns,
                "alert": state["active"],
            }
        sample["slo"] = slo_out
        _ring.append(sample)
        _samples_total += 1
    # ---- event emission OUTSIDE the leaf lock (telemetry/diagnostics lock)
    for tenant, kind, body in transitions:
        site = f"ops.slo.{tenant}"
        if kind == "slo-burn":
            # reference the tenant's slowest-K forensic exemplars so the
            # post-mortem names the concrete requests that burned the budget
            # (forensics takes its own leaf lock — hence after `_lock`)
            body["exemplars"] = (
                forensics.exemplar_refs(tenant, 3)
                if forensics is not None and forensics._enabled else [])
        detail = json.dumps(body, sort_keys=True)
        if kind == "slo-burn" and diagnostics is not None:
            # the typed event on the always-on resilience stream; its
            # telemetry tee BOTH lands it on the flight ring and auto-dumps
            # the `slo-burn` post-mortem (telemetry's _AUTO_DUMP_KINDS),
            # per-shard breakdown riding in the detail — so exactly one ring
            # event and one dump per OFF->ON transition
            diagnostics.record_resilience_event(site, kind, detail)
        elif telemetry is not None:
            # `slo-burn-cleared` (and the standalone-load fallback): ring
            # only, no dump — recovery is worth a breadcrumb, not a pager
            telemetry.flight_record("ops", site, detail, kind=kind)
    return sample


# ------------------------------------------------------------------ ring views
def latest_sample() -> Optional[dict]:
    """The newest windowed sample, or None before two ticks have happened."""
    with _lock:
        return _ring[-1] if _ring else None


def samples() -> List[dict]:
    """The current ring contents, oldest first."""
    with _lock:
        return list(_ring)


# ------------------------------------------------------------------ SLOs
def set_slo(tenant: str, *, p99_ms: Optional[float] = None,
            success_ratio: Optional[float] = None) -> None:
    """Declare (or replace) ``tenant``'s objectives: ``p99_ms`` — at most 1%
    of a window's requests may exceed this latency; ``success_ratio`` — at
    least this fraction must not be shed/expired/cancelled. At least one
    objective is required."""
    if p99_ms is None and success_ratio is None:
        raise ValueError("an SLO needs p99_ms and/or success_ratio")
    if p99_ms is not None and p99_ms <= 0:
        raise ValueError(f"p99_ms must be positive, got {p99_ms}")
    if success_ratio is not None and not (0.0 < success_ratio <= 1.0):
        raise ValueError(
            f"success_ratio must be in (0, 1], got {success_ratio}")
    slo: Dict[str, float] = {}
    if p99_ms is not None:
        slo["p99_ms"] = float(p99_ms)
    if success_ratio is not None:
        slo["success_ratio"] = float(success_ratio)
    with _lock:
        _slos[str(tenant)] = slo


def clear_slo(tenant: str) -> None:
    """Drop ``tenant``'s objectives (and its alert state)."""
    with _lock:
        _slos.pop(str(tenant), None)
        _alerts.pop(str(tenant), None)


def slo_status() -> Dict[str, dict]:
    """``{tenant: {objectives, burn, alert, since}}`` — the declared SLOs
    with their latest burn rates and alert states."""
    with _lock:
        latest = _ring[-1] if _ring else None
        out: Dict[str, dict] = {}
        for tenant, slo in sorted(_slos.items()):
            entry = (latest or {}).get("slo", {}).get(tenant, {})
            state = _alerts.get(tenant, {})
            out[tenant] = {
                "objectives": dict(slo),
                "burn": dict(entry.get("burn", {})),
                "alert": bool(state.get("active", False)),
                "since": state.get("since"),
            }
        return out


# ------------------------------------------------------------------ exporter
def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(value: Any) -> str:
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return "NaN"
    if isinstance(value, bool):
        return "1" if value else "0"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Family:
    __slots__ = ("name", "type", "help", "rows")

    def __init__(self, name: str, mtype: str, help_text: str):
        self.name, self.type, self.help = name, mtype, help_text
        self.rows: List[Tuple[Dict[str, str], Any]] = []

    def add(self, value: Any, **labels: str) -> "_Family":
        self.rows.append((labels, value))
        return self

    def render(self) -> List[str]:
        lines = [f"# TYPE {self.name} {self.type}",
                 f"# HELP {self.name} {self.help}"]
        suffix = "_total" if self.type == "counter" else ""
        for labels, value in self.rows:
            lbl = ""
            if labels:
                inner = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
                lbl = "{" + inner + "}"
            lines.append(f"{self.name}{suffix}{lbl} {_fmt(value)}")
        return lines


def render_openmetrics() -> str:
    """The OpenMetrics text page for the latest sample: strict metadata
    (``# TYPE`` then ``# HELP`` per family), counter samples suffixed
    ``_total``, escaped label values, and the mandatory terminating
    ``# EOF``. Counters come from the CUMULATIVE totals (monotone across
    pages — the scrape contract); rates/gauges from the latest window.
    Always well-formed, even before the first sample."""
    with _lock:
        sample = _ring[-1] if _ring else None
        samples_total = _samples_total
        resets = _delta_resets
    fams: List[_Family] = []
    fams.append(_Family(
        "ht_samples", "counter",
        "ops samples taken since arm").add(samples_total))
    fams.append(_Family(
        "ht_delta_resets", "counter",
        "samples re-baselined after a mid-run stats reset").add(resets))
    if sample is not None:
        fams.append(_Family(
            "ht_sample_window_seconds", "gauge",
            "width of the latest sample window").add(sample["window_s"]))
        totals = sample["totals"]
        fams.append(_Family(
            "ht_requests_admitted", "counter",
            "dispatches admitted (inline + queued)").add(totals["admitted"]))
        fams.append(_Family(
            "ht_requests_shed", "counter",
            "requests rejected typed by admission control").add(totals["shed"]))
        fams.append(_Family(
            "ht_requests_failed", "counter",
            "requests deadline-expired or cancelled").add(totals["failed"]))
        rates = sample["rates"]
        fams.append(_Family(
            "ht_rps", "gauge",
            "admitted requests per second over the window").add(rates["rps"]))
        fams.append(_Family(
            "ht_shed_rate", "gauge",
            "shed requests per second over the window").add(rates["shed_rate"]))
        hit = _Family("ht_cache_hit_rate", "gauge",
                      "result-cache hit fraction over the window")
        hit.add(rates["cache_hit_rate"]
                if rates["cache_hit_rate"] is not None else float("nan"))
        fams.append(hit)
        depth = _Family("ht_queue_depth", "gauge",
                        "instantaneous queue depth per shard")
        d_ewma = _Family("ht_queue_depth_ewma", "gauge",
                         "queue-depth EWMA per shard (alpha 0.25)")
        s_ewma = _Family("ht_shed_rate_ewma", "gauge",
                         "shed-rate EWMA per shard (1.0 = all sheds)")
        for shard in sample["pressure"]["per_shard"]:
            idx = str(shard.get("shard", shard.get("index", "?")))
            depth.add(shard.get("queue_depth", 0), shard=idx)
            d_ewma.add(shard.get("depth_ewma", 0.0), shard=idx)
            s_ewma.add(shard.get("shed_rate_ewma", 0.0), shard=idx)
        fams.extend((depth, d_ewma, s_ewma))
        svc = _Family("ht_service_ewma_seconds", "gauge",
                      "service-time EWMA per hot signature")
        for label, ewma in sorted(
                sample["pressure"].get("service_ewma_s", {}).items()):
            svc.add(ewma, signature=label)
        if svc.rows:
            fams.append(svc)
        brk = _Family("ht_breaker_open", "gauge",
                      "1 while the site's circuit breaker is open")
        for site, state in sorted(sample["breakers"].items()):
            brk.add(1 if state == "open" else 0, site=site)
        if brk.rows:
            fams.append(brk)
        fams.append(_Family(
            "ht_draining", "gauge",
            "1 while dispatch admission is closed").add(sample["draining"]))
        p99 = _Family("ht_tenant_p99_seconds", "gauge",
                      "per-tenant p99 latency over the window")
        for tenant, cell in sorted(sample.get("tenants", {}).items()):
            if cell.get("p99_ms") is not None:
                p99.add(cell["p99_ms"] / 1e3, tenant=tenant)
        if p99.rows:
            fams.append(p99)
        burn = _Family("ht_slo_burn_rate", "gauge",
                       "error-budget burn rate per tenant and window")
        alert = _Family("ht_slo_alert", "gauge",
                        "1 while the tenant's burn alert is up")
        for tenant, entry in sorted(sample.get("slo", {}).items()):
            for window, b in sorted(entry["burn"].items()):
                burn.add(b, tenant=tenant, window=window)
            alert.add(entry["alert"], tenant=tenant)
        if burn.rows:
            fams.extend((burn, alert))
        # ---- forensics cost meters: cumulative counters per tenant, plus
        # the tenant's lifetime stage time-share as a gauge family
        cost = sample.get("tenant_cost", {})
        if cost:
            dev = _Family("ht_tenant_device_seconds", "counter",
                          "attributed device execute time per tenant")
            flops = _Family("ht_tenant_flops", "counter",
                            "attributed device FLOPs per tenant")
            cbytes = _Family("ht_tenant_collective_bytes", "counter",
                             "logical collective bytes attributed per tenant")
            saved = _Family("ht_tenant_cache_bytes_saved", "counter",
                            "result-cache bytes served per tenant")
            share = _Family("ht_tenant_stage_share", "gauge",
                            "fraction of the tenant's request time per stage")
            for tenant, cell in sorted(cost.items()):
                dev.add(cell.get("device_seconds", 0.0), tenant=tenant)
                flops.add(cell.get("flops", 0.0), tenant=tenant)
                cbytes.add(cell.get("collective_bytes", 0.0), tenant=tenant)
                saved.add(cell.get("cache_bytes_saved", 0.0), tenant=tenant)
                stages = cell.get("stage_seconds", {})
                total = sum(stages.values())
                if total > 0:
                    for stage, secs in sorted(stages.items()):
                        share.add(round(secs / total, 6),
                                  tenant=tenant, stage=stage)
            fams.extend((dev, flops, cbytes, saved))
            if share.rows:
                fams.append(share)
    lines: List[str] = []
    for fam in fams:
        lines.extend(fam.render())
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> Dict[str, dict]:
    """Strict in-repo OpenMetrics parser (the test/CI gate twin of
    :func:`render_openmetrics`): returns ``{family: {"type", "help",
    "samples": [(name, labels, value)]}}`` and raises ``ValueError`` on a
    malformed page — missing ``# EOF``, data after ``# EOF``, a sample
    before its ``# TYPE``, a counter sample not suffixed ``_total``, bad
    label syntax, an unescaped quote, or a non-numeric value."""
    families: Dict[str, dict] = {}
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("page must terminate with '# EOF'")
    current: Optional[str] = None
    for lineno, line in enumerate(lines[:-1], 1):
        if line == "# EOF":
            raise ValueError(f"line {lineno}: data after '# EOF'")
        if not line:
            raise ValueError(f"line {lineno}: blank line inside page")
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[0] != "#" or parts[1] not in (
                    "TYPE", "HELP"):
                raise ValueError(f"line {lineno}: bad metadata: {line!r}")
            _, keyword, name, rest = parts
            if keyword == "TYPE":
                if rest not in ("counter", "gauge", "histogram", "summary",
                                "info", "stateset", "unknown"):
                    raise ValueError(f"line {lineno}: bad type {rest!r}")
                if name in families:
                    raise ValueError(f"line {lineno}: duplicate TYPE {name}")
                families[name] = {"type": rest, "help": None, "samples": []}
                current = name
            else:
                if name not in families:
                    raise ValueError(f"line {lineno}: HELP before TYPE {name}")
                families[name]["help"] = rest
            continue
        sample_name, _, rest = line.partition("{")
        labels: Dict[str, str] = {}
        if rest:
            body, close, tail = rest.partition("}")
            if not close or not tail.startswith(" "):
                raise ValueError(f"line {lineno}: bad label block: {line!r}")
            labels = _parse_labels(body, lineno)
            value_str = tail[1:]
        else:
            try:
                sample_name, value_str = line.split(" ", 1)
            except ValueError:
                raise ValueError(f"line {lineno}: no value: {line!r}")
        fam = current
        if fam is None or not sample_name.startswith(fam):
            fam = next((f for f in families if sample_name.startswith(f)
                        and sample_name[len(f):] in ("", "_total")), None)
        if fam is None:
            raise ValueError(
                f"line {lineno}: sample {sample_name!r} before its TYPE")
        expected = fam + ("_total" if families[fam]["type"] == "counter"
                          else "")
        if sample_name != expected:
            raise ValueError(
                f"line {lineno}: sample {sample_name!r} for "
                f"{families[fam]['type']} family {fam!r} (want {expected!r})")
        try:
            value = float(value_str)
        except ValueError:
            raise ValueError(f"line {lineno}: bad value {value_str!r}")
        families[fam]["samples"].append((sample_name, labels, value))
    return families


def _parse_labels(body: str, lineno: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.find('="', i)
        if eq < 0:
            raise ValueError(f"line {lineno}: bad label syntax: {body!r}")
        key = body[i:eq]
        if not key.replace("_", "").isalnum():
            raise ValueError(f"line {lineno}: bad label name {key!r}")
        j = eq + 2
        out: List[str] = []
        while j < len(body):
            c = body[j]
            if c == "\\":
                if j + 1 >= len(body) or body[j + 1] not in ('\\', '"', 'n'):
                    raise ValueError(f"line {lineno}: bad escape in {body!r}")
                out.append({"\\": "\\", '"': '"', "n": "\n"}[body[j + 1]])
                j += 2
            elif c == '"':
                break
            else:
                out.append(c)
                j += 1
        else:
            raise ValueError(f"line {lineno}: unterminated label in {body!r}")
        labels[key] = "".join(out)
        i = j + 1
        if i < len(body):
            if body[i] != ",":
                raise ValueError(f"line {lineno}: bad label separator")
            i += 1
    return labels


# ------------------------------------------------------------------ health
def healthz() -> Tuple[bool, dict]:
    """``(healthy, payload)``: healthy is False while dispatch admission is
    draining, while any circuit breaker is OPEN, or while a supervision abort
    sentinel (peer-dead / collective-timeout / ...) is installed — the states
    a load balancer must route around. Reads only the latest cumulative
    facts; never blocks on the coordination channel."""
    draining = False
    try:
        from . import _executor
        sched = _executor._dispatch_scheduler
        draining = bool(sched is not None and sched.draining())
    except Exception as exc:  # ht: ignore[silent-except] -- accounted via diagnostics.record_fallback (_record_degrade); a health probe must answer from what it CAN read, not 500 because the executor half is absent
        _record_degrade("ops.healthz", exc)
    open_breakers = []
    if resilience is not None:
        open_breakers = sorted(
            site for site, snap in resilience.breakers().items()
            if snap.get("state") == "open")
    abort = supervision.aborted() if supervision is not None else None
    ok = not draining and not open_breakers and abort is None
    return ok, {
        "ok": ok,
        "draining": draining,
        "open_breakers": open_breakers,
        "abort": abort,
        "armed": _armed,
        "generated_at": _utcnow(),
    }


# ------------------------------------------------------------------ HTTP
def _make_server(port: int):
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - stdlib handler contract
            if self.path == "/metrics":
                body = render_openmetrics().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8")
            elif self.path == "/healthz":
                ok, payload = healthz()
                body = (json.dumps(payload, sort_keys=True) + "\n").encode()
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "application/json")
            else:
                body = b"not found\n"
                self.send_response(404)
                self.send_header("Content-Type", "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr noise
            pass

    # localhost ONLY: an operations endpoint must never bind a routable
    # interface by default
    return http.server.ThreadingHTTPServer(("127.0.0.1", port), _Handler)


def http_address() -> Optional[Tuple[str, int]]:
    """The live ``(host, port)`` of the metrics endpoint, or None. With
    ``HEAT_TPU_OPS_PORT=0`` the OS picks the port; tests read it here."""
    with _lock:
        return _server.server_address[:2] if _server is not None else None


# ------------------------------------------------------------------ beats
def _compact_beat(rank: int) -> dict:
    """This rank's compact beat: the latest window's headline rates plus
    per-tenant SLO state — small enough for a KV value, rich enough for
    ``telemetry top``."""
    with _lock:
        sample = _ring[-1] if _ring else None
        seq = _samples_total
    beat: Dict[str, Any] = {
        "schema": BEAT_SCHEMA,
        "rank": int(rank),
        "seq": seq,
        "t": _utcnow(),
    }
    if sample is not None:
        # per-tenant rows: the window's latency/lifecycle cells joined with
        # the CUMULATIVE forensics cost meters (device_s / flops /
        # collective_bytes) — a tenant seen only by the cost meters (e.g. the
        # unattributed "-" bucket) still gets a row
        cost = sample.get("tenant_cost", {})
        tenants: Dict[str, dict] = {}
        for tenant in sorted(set(sample.get("tenants", {})) | set(cost)):
            cell = sample.get("tenants", {}).get(tenant, {})
            cc = cost.get(tenant, {})
            tenants[tenant] = {
                "p99_ms": cell.get("p99_ms"),
                "count": cell.get("count", 0),
                "bad": cell.get("bad", 0),
                "burn_1m": sample.get("slo", {}).get(tenant, {})
                .get("burn", {}).get("1m"),
                "alert": sample.get("slo", {}).get(tenant, {})
                .get("alert", False),
                "device_s": round(cc.get("device_seconds", 0.0), 6),
                "flops": cc.get("flops", 0.0),
                "collective_bytes": cc.get("collective_bytes", 0.0),
            }
        beat.update({
            "window_s": sample["window_s"],
            "rps": sample["rates"]["rps"],
            "shed_rate": sample["rates"]["shed_rate"],
            "cache_hit_rate": sample["rates"]["cache_hit_rate"],
            "queue_depth": sample["queue_depth"],
            "draining": sample["draining"],
            "tenants": tenants,
        })
    else:
        beat.update({"window_s": None, "rps": 0.0, "shed_rate": 0.0,
                     "cache_hit_rate": None, "queue_depth": 0,
                     "draining": False, "tenants": {}})
    return beat


def _beat_tee(monitor) -> None:
    """The supervision piggyback (installed as ``supervision._ops_tee``; one
    relaxed ``ops._armed`` read per monitor tick when idle): publish this
    rank's beat under ``<ns>/ops/<rank>`` on the coordination KV channel —
    strictly under the prefix, per the ``get_dir`` directory contract."""
    if not _armed:
        return
    beat = _compact_beat(monitor.rank)
    monitor.coordinator.set(
        f"{monitor.ns}/ops/{monitor.rank}",
        json.dumps(beat, sort_keys=True), True)


def publish_beat(coordinator, ns: str, rank: int) -> dict:
    """Publish this rank's beat explicitly (the tee does this automatically
    on every monitor tick while armed). Returns the beat."""
    beat = _compact_beat(rank)
    coordinator.set(f"{ns}/ops/{rank}", json.dumps(beat, sort_keys=True), True)
    return beat


def cluster_snapshot(coordinator=None, ns: Optional[str] = None) -> dict:
    """Fold every rank's latest beat with ONE non-blocking KV directory sweep
    (``get_dir(<ns>/ops/)``): no collective, no waiting — a rank that is
    mid-drain or dead simply contributes a stale or absent row, so this can
    never hang on a sick cluster. Defaults to the armed supervision monitor's
    coordinator/namespace; single-process (no monitor, no coordinator) falls
    back to this process's own beat as rank 0."""
    if coordinator is None and supervision is not None:
        mon = supervision.current_monitor()
        if mon is not None:
            coordinator, ns = mon.coordinator, mon.ns
    ranks: Dict[str, dict] = {}
    if coordinator is not None and ns is not None:
        for key, value in coordinator.get_dir(f"{ns}/ops/"):
            rank = key.rsplit("/", 1)[-1]
            try:
                ranks[rank] = json.loads(value)
            except (ValueError, TypeError):
                ranks[rank] = {"schema": BEAT_SCHEMA, "rank": rank,
                               "error": "unparseable beat"}
    if not ranks:
        local_rank = 0
        if telemetry is not None:
            local_rank = telemetry.process_info()[0]
        ranks[str(local_rank)] = _compact_beat(local_rank)
    return {
        "schema": SCHEMA,
        "generated_at": _utcnow(),
        "ranks": {k: ranks[k] for k in sorted(ranks, key=lambda r: (len(r), r))},
    }


# ------------------------------------------------------------------ files
def _atomic_text(path: str, text: str, site: str) -> None:
    def _write(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(text)

    if resilience is not None:
        resilience.atomic_write(path, _write, site=site)
    else:  # standalone load: plain write (no breaker registry to ride)
        _write(path)


def write_scrape_file(path: str) -> str:
    """Write the OpenMetrics page to ``path`` atomically (the file-based
    scraper contract; also done every tick under ``HEAT_TPU_OPS_SCRAPE``)."""
    _atomic_text(path, render_openmetrics(), "ops.scrape")
    return path


def write_beat_file(directory: str, rank: Optional[int] = None) -> str:
    """Write this rank's beat as ``<directory>/ops-beat-r<rank>.json`` — the
    file the ``telemetry top --dir`` / ``merge --from-ops`` tooling reads on
    login nodes with no coordination channel. Returns the path."""
    if rank is None:
        rank = telemetry.process_info()[0] if telemetry is not None else 0
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{BEAT_PREFIX}{int(rank)}.json")
    beat = _compact_beat(int(rank))
    _atomic_text(path, json.dumps(beat, indent=2, sort_keys=True) + "\n",
                 "ops.beat")
    return path


# ------------------------------------------------------------------ daemon
def _export_tick() -> None:
    if _knobs.scrape_path:
        try:
            write_scrape_file(_knobs.scrape_path)
        except OSError as exc:
            _record_degrade("ops.scrape", exc)
    if _knobs.beat_dir:
        try:
            write_beat_file(_knobs.beat_dir)
        except OSError as exc:
            _record_degrade("ops.beat", exc)


def _sampler_loop(stop: threading.Event, interval: float) -> None:
    while not stop.wait(interval):
        try:
            sample_once()
            _export_tick()
        except Exception as exc:  # ht: ignore[silent-except] -- accounted via diagnostics.record_fallback (_record_degrade); the plane observes the workload and must never kill it — a degraded tick is counted and the next tick retries
            _record_degrade("ops.sampler", exc)


def arm(interval_s: Optional[float] = None, *,
        start_thread: bool = True) -> None:
    """Arm the plane: baseline snapshot now, sampler daemon at ``interval_s``
    (default the env knob), HTTP endpoint if ``HEAT_TPU_OPS_PORT`` is set,
    and the supervision beat piggyback. Idempotent; ``start_thread=False``
    leaves ticking to the caller (tests and ``bench.py`` drive
    :func:`sample_once` with deterministic windows)."""
    global _armed, _thread, _thread_stop, _server, _server_thread, _prev_cum
    with _lock:
        if _armed:
            return
        _armed = True
    # env-declared objectives (HEAT_TPU_OPS_SLO) land before the first
    # sample; a programmatic set_slo for the same tenant later replaces them
    for tenant, objectives in _knobs.slos.items():
        try:
            set_slo(tenant, **objectives)
        except ValueError as exc:
            _record_degrade("ops.slo-env", exc)
    # the baseline (outside _lock: it reads foreign report surfaces)
    baseline = _collect_cumulative()
    with _lock:
        if _prev_cum is None:
            _prev_cum = baseline
    interval = float(interval_s if interval_s is not None
                     else _knobs.interval_s)
    if _knobs.port is not None:
        try:
            server = _make_server(_knobs.port)
        except OSError as exc:
            _record_degrade("ops.http", exc)
            server = None
        if server is not None:
            t = threading.Thread(target=server.serve_forever,
                                 name="heat-tpu-ops-http", daemon=True)
            with _lock:
                _server, _server_thread = server, t
            t.start()
    if start_thread:
        stop = threading.Event()
        t = threading.Thread(target=_sampler_loop, args=(stop, interval),
                             name="heat-tpu-ops-sampler", daemon=True)
        with _lock:
            _thread, _thread_stop = t, stop
        t.start()
    if diagnostics is not None:
        diagnostics.record_resilience_event(
            "ops.plane", "ops-armed",
            f"interval {interval:.3f}s, port {_knobs.port}, "
            f"ring {_knobs.ring}")


def disarm() -> None:
    """Stop the sampler daemon and the HTTP endpoint; the ring, SLOs and
    alert states are kept (post-mortem reads must still work)."""
    global _armed, _thread, _thread_stop, _server, _server_thread
    with _lock:
        if not _armed:
            return
        _armed = False
        stop, thread = _thread_stop, _thread
        server, server_thread = _server, _server_thread
        _thread = _thread_stop = _server = _server_thread = None
    if stop is not None:
        stop.set()
    if thread is not None:
        thread.join(timeout=5.0)
    if server is not None:
        server.shutdown()
        server.server_close()
    if server_thread is not None:
        server_thread.join(timeout=5.0)


def armed() -> bool:
    return _armed


def reload() -> None:
    """Re-read the ``HEAT_TPU_OPS*`` knobs (chained from
    ``_executor.reload_env_knobs``). Ring capacity applies to new samples;
    the enable knob only governs import-time auto-arm."""
    global _ring
    _knobs.reload()
    with _lock:
        if _ring.maxlen != _knobs.ring:
            _ring = deque(_ring, maxlen=_knobs.ring)


def reset() -> None:
    """Drop the ring, baselines, SLOs and alert states (tests)."""
    global _prev_cum, _samples_total, _delta_resets
    with _lock:
        _ring.clear()
        _prev_cum = None
        _samples_total = 0
        _delta_resets = 0
        _slos.clear()
        _alerts.clear()


# ------------------------------------------------------------------ reporting
def ops_stats() -> dict:
    """The ``ops`` section of ``ht.diagnostics.report()``: armed state,
    sample tallies, knobs, SLO/alert summary."""
    with _lock:
        latest = _ring[-1] if _ring else None
        return {
            "schema": SCHEMA,
            "armed": _armed,
            "samples": _samples_total,
            "ring": len(_ring),
            "ring_cap": _ring.maxlen,
            "delta_resets": _delta_resets,
            "interval_s": _knobs.interval_s,
            "http": (_server.server_address[:2] if _server is not None
                     else None),
            "slos": {t: dict(s) for t, s in sorted(_slos.items())},
            "alerts": {
                t: {"active": a["active"], "since": a["since"],
                    "transitions": a["transitions"]}
                for t, a in sorted(_alerts.items())
            },
            "last_window_s": latest["window_s"] if latest else None,
        }


# ------------------------------------------------------------------ wiring
if diagnostics is not None:
    diagnostics.register_provider("ops", ops_stats)

if supervision is not None:
    # the beat piggyback: Monitor.step reads this bare; idle cost is one
    # `ops._armed` attribute load per monitor tick
    supervision._ops_tee = _beat_tee

# Env bootstrap: armed from the start (serving/chaos CI jobs).
if _knobs.enabled:
    arm()
