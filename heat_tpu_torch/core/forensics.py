"""``ht.forensics`` (the port's own copy of heat_tpu/core/forensics.py, stdlib-only at
load) — per-request forensics: lifecycle records, critical-path
attribution, tail exemplars, and per-tenant cost metering.

The rest of the observability stack answers *whether* serving is healthy
(diagnostics counters, profiler traces, telemetry shards, the ops plane's SLO
burn alerts). This module answers the question every one of those planes ends
at: **why was this specific request slow, and who pays for it?**

Lifecycle records
-----------------
While armed (``HEAT_TPU_FORENSICS=1`` or :func:`arm`), every
``profiler.request(tag)`` scope accumulates one compact record as it crosses
the chokepoints the system already instruments:

- **admission** — verdict (``admitted`` / ``shed`` / ``deadline-expired``)
  plus the deadline headroom observed at each lifecycle checkpoint;
- **scheduling** — shard assignment, queue-wait and batch-window-hold
  durations, batch width, and steal provenance (which shard the work was
  stolen from, if any);
- **caches** — result-cache hit/miss/bypass with the *reason* a consult was
  bypassed (``no-replay-spec`` / ``rng-label`` / ``undigestable-operand``),
  compile-cache outcome counts (``miss`` / ``aot-load`` / ``off``);
- **programs** — compile-vs-execute wall split, batch calls folded by
  width-share;
- **collectives** — wall time and logical payload bytes (auxiliary: at trace
  time collectives nest *inside* the compile stage, so their time is reported
  alongside the stages, never added to the stage sum — adding it would double
  count);
- **failure path** — typed-failure, eager-replay, retry and injected-fault
  events, teed from the always-on resilience stream.

Finished records land in a bounded ring (``HEAT_TPU_FORENSICS_RING``), and a
**critical-path reducer** labels each with its dominant stage: the disjoint
timed stages (``queue_wait`` / ``window_hold`` / ``compile`` / ``execute``
plus the residual ``host`` stage — un-instrumented application time between
dispatches) sorted by share, followed by event legs (``typed-failure``,
``eager-replay``, ...). By construction the timed stages sum to the measured
request latency, so one artifact answers "where did the time go".

Tail exemplars
--------------
A per-tenant reservoir retains the **slowest-K** full records
(``HEAT_TPU_FORENSICS_EXEMPLARS``), deterministically ordered by
``(-total_s, rid)``. When the profiler is also collecting, an exemplar grabs
its request's span tree at capture time. ``ht.explain(tag)`` and
``python -m heat_tpu_torch.telemetry slow`` read them; the ops plane's ``slo-burn``
post-mortems name the matching exemplars in their detail payload.

Per-tenant cost meters
----------------------
Device execute-time (program wall seconds; batch calls billed per item at
``dt / width``), logical collective bytes, result-cache bytes saved, and
per-signature FLOPs (memoised once from ``compiled.cost_analysis()`` by the
executor) fold into per-tenant meters. Work outside any request scope bills
to the ``"-"`` tenant, so the meters **reconcile exactly**: :func:`totals` is
defined as the fold over :func:`tenant_cost` — nothing is metered twice and
nothing escapes attribution. Surfaced through ``executor_stats()``, the ops
exporter (``ht_tenant_device_seconds_total``, ``ht_tenant_flops_total``,
``ht_tenant_collective_bytes_total``, ``ht_tenant_stage_share``) and the cost
column of ``telemetry top``.

Contracts
---------
- **Zero-cost when off**: every producer hook gates on one relaxed module
  attribute read (``forensics._enabled``), the same idle contract the
  profiler/telemetry/ops planes honour (forensics never touches what the
  card runs).
- **Stdlib-only at load**: importable with no accelerator stack present
  (``tests/test_torch_imports.py`` loads it by file path).
- **Leaf lock**: ``_lock`` guards every mutable store below and is acquired
  strictly last — producers call in from *outside* their own locks (the
  scheduler after releasing its condvar, the result cache after its shard
  mutex, diagnostics' tee after its ring append), and forensics never calls
  back into another locked module while holding ``_lock`` (exemplar span
  capture re-enters the profiler only *between* two separate acquisitions).
  The committed lock graph gains no edges.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

try:  # guarded for standalone file-path loads (mirrors ops.py)
    from . import diagnostics, profiler
except ImportError:  # pragma: no cover - standalone load only
    diagnostics = profiler = None  # type: ignore[assignment]

__all__ = [
    "arm",
    "disarm",
    "armed",
    "reload",
    "reset",
    "explain",
    "records",
    "exemplars",
    "exemplar_refs",
    "tenant_cost",
    "totals",
    "forensics_stats",
    "SCHEMA",
]

SCHEMA = "heat-tpu-forensics/1"

#: Hot-path hooks read this module attribute directly (``forensics._enabled``):
#: one attribute load + branch when off — the zero-cost-when-disabled contract.
_enabled: bool = False

_lock = threading.Lock()

#: The timed stages of a record, disjoint by construction: ``host`` is the
#: residual (total − sum of measured stages), so the decomposition always
#: sums to the measured request latency.
STAGES = ("queue_wait", "window_hold", "compile", "execute", "host")

#: Event kinds promoted to critical-path legs, in report order.
_EVENT_LEGS = ("typed-failure", "eager-replay", "retry", "fault")

_MAX_LIVE = 8_192  # leak guard: abandoned records evict oldest-first
_MAX_ADMISSION = 16  # admission checkpoints kept per record
_MAX_EVENTS = 32  # failure-path events kept per record

_UNATTRIBUTED = "-"  # meter key for work outside any request scope


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


class _Knobs:
    """Env knobs, read once at import/arm and on :func:`reload` — never per
    record (same memoisation contract as the executor's ``_EnvKnobs``)."""

    __slots__ = ("ring", "exemplars")

    def __init__(self):
        self.reload()

    def reload(self):
        self.ring = max(16, _env_int("HEAT_TPU_FORENSICS_RING", 1024))
        self.exemplars = max(1, _env_int("HEAT_TPU_FORENSICS_EXEMPLARS", 8))


_knobs = _Knobs()

# ------------------------------------------------------------------ stores
# All four mutate only under `_lock`. The ring holds *finished* record dicts
# (evict-oldest); reservoirs hold the slowest-K per tenant; meters are the
# per-tenant cost ledger; `_live` maps rid -> in-flight _Record.
_live: "OrderedDict[int, _Record]" = OrderedDict()
_ring: "deque[dict]" = deque(maxlen=_knobs.ring)
_reservoirs: Dict[str, List[dict]] = {}
_meters: Dict[str, dict] = {}
_finished: int = 0  # records completed since reset (ring may have evicted)
_dropped: int = 0  # ring evictions + abandoned live records


class _Record:
    """One in-flight request's accumulating lifecycle record."""

    __slots__ = (
        "rid", "tenant", "deadline", "stages", "collective_s",
        "collective_bytes", "admission", "shard", "width", "stolen_from",
        "result_cache", "compile_cache", "device_s", "flops", "events",
    )

    def __init__(self, rid: int, tenant: str, deadline: Optional[float]):
        self.rid = rid
        self.tenant = tenant
        self.deadline = deadline
        self.stages: Dict[str, float] = {}
        self.collective_s = 0.0
        self.collective_bytes = 0.0
        self.admission: List[dict] = []
        self.shard: Optional[int] = None
        self.width = 0
        self.stolen_from: Optional[int] = None
        self.result_cache = {"hits": 0, "misses": 0, "bypass": {},
                             "bytes_saved": 0.0}
        self.compile_cache: Dict[str, int] = {}
        self.device_s = 0.0
        self.flops = 0.0
        self.events: List[dict] = []

    def add_stage(self, stage: str, seconds: float) -> None:
        if seconds > 0.0:
            self.stages[stage] = self.stages.get(stage, 0.0) + seconds

    def finish(self, total_s: float) -> dict:
        """Close the record: add the residual ``host`` stage, reduce the
        critical path, and return the finished record dict."""
        total_s = max(0.0, float(total_s))
        stages = dict(self.stages)
        host = total_s - sum(stages.values())
        if host > 0.0:
            stages["host"] = host
        path = [
            {"stage": s, "seconds": round(v, 9),
             "share": round(v / total_s, 6) if total_s > 0.0 else 0.0}
            for s, v in sorted(stages.items(), key=lambda kv: (-kv[1], kv[0]))
            if v > 0.0
        ]
        for kind in _EVENT_LEGS:
            n = sum(1 for e in self.events if e["kind"] == kind)
            if n:
                path.append({"stage": kind, "events": n})
        if not path:  # zero-duration, zero-event record: still non-empty
            path = [{"stage": "host", "seconds": 0.0, "share": 1.0}]
        headroom = None
        if self.deadline is not None:
            headroom = round(self.deadline - time.monotonic(), 9)
        return {
            "schema": SCHEMA,
            "rid": self.rid,
            "tenant": self.tenant,
            "total_s": round(total_s, 9),
            "deadline_headroom_s": headroom,
            "shard": self.shard,
            "width": self.width,
            "stolen_from": self.stolen_from,
            "stages": {s: round(v, 9) for s, v in stages.items()},
            "collective_s": round(self.collective_s, 9),
            "collective_bytes": self.collective_bytes,
            "admission": list(self.admission),
            "result_cache": {
                "hits": self.result_cache["hits"],
                "misses": self.result_cache["misses"],
                "bypass": dict(self.result_cache["bypass"]),
                "bytes_saved": self.result_cache["bytes_saved"],
            },
            "compile_cache": dict(self.compile_cache),
            "device_s": round(self.device_s, 9),
            "flops": self.flops,
            "events": list(self.events),
            "critical_path": path,
            "dominant": path[0]["stage"],
        }


# ------------------------------------------------------------------ switches
def arm() -> None:
    """Start recording request forensics (re-reads the env knobs). Idempotent."""
    global _enabled
    _knobs.reload()
    _resize_ring_locked_out()
    _enabled = True


def disarm() -> None:
    """Stop recording. Collected records, exemplars and meters are kept —
    :func:`explain` / :func:`tenant_cost` still work; :func:`reset` clears."""
    global _enabled
    _enabled = False


def armed() -> bool:
    """Whether forensics is currently recording."""
    return _enabled


def reload() -> None:
    """Re-read the ``HEAT_TPU_FORENSICS*`` env knobs (chained from
    ``ht.reload_env_knobs()``); re-arms/disarms from ``HEAT_TPU_FORENSICS``."""
    global _enabled
    _knobs.reload()
    _resize_ring_locked_out()
    env = os.environ.get("HEAT_TPU_FORENSICS")
    if env is not None:
        _enabled = env == "1"


def _resize_ring_locked_out() -> None:
    global _ring
    with _lock:
        if _ring.maxlen != _knobs.ring:
            _ring = deque(_ring, maxlen=_knobs.ring)


def reset() -> None:
    """Drop every record, exemplar and meter (the switch state is kept)."""
    global _finished, _dropped
    with _lock:
        _live.clear()
        _ring.clear()
        _reservoirs.clear()
        _meters.clear()
        _finished = 0
        _dropped = 0


# ------------------------------------------------------------------ producers
def _ambient_rid() -> Optional[int]:
    if profiler is None:
        return None
    return profiler._current_request.get()


def _meter_locked(tenant: str) -> dict:
    m = _meters.get(tenant)
    if m is None:
        m = _meters[tenant] = {
            "requests": 0,
            "device_seconds": 0.0,
            "flops": 0.0,
            "collective_bytes": 0.0,
            "cache_bytes_saved": 0.0,
            "stage_seconds": {},
        }
    return m


def begin_request(rid: int, tenant: str, deadline: Optional[float] = None) -> None:
    """Open the lifecycle record for ``rid`` (called by ``profiler.request``
    at scope entry; ``deadline`` is the absolute monotonic deadline, if any)."""
    if not _enabled:
        return
    global _dropped
    rec = _Record(int(rid), str(tenant), deadline)
    with _lock:
        _live[rec.rid] = rec
        while len(_live) > _MAX_LIVE:
            _live.popitem(last=False)
            _dropped += 1


def finish_request(rid: int, total_s: float) -> None:
    """Close ``rid``'s record (called by ``profiler.request`` at scope exit
    with the measured wall latency): reduce the critical path, append to the
    ring, fold the per-tenant meters, and offer the record to the slowest-K
    reservoir. When the record becomes an exemplar while the profiler is
    collecting, its span tree is captured in a second, separate lock
    acquisition (the profiler's lock is never taken under ``_lock``)."""
    if not _enabled:
        return
    global _finished, _dropped
    with _lock:
        rec = _live.pop(rid, None)
        if rec is None:
            return
        done = rec.finish(total_s)
        if _ring.maxlen is not None and len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(done)
        _finished += 1
        m = _meter_locked(rec.tenant)
        m["requests"] += 1
        shares = m["stage_seconds"]
        for stage, seconds in done["stages"].items():
            shares[stage] = shares.get(stage, 0.0) + seconds
        inserted = _reservoir_offer_locked(done)
    if inserted and profiler is not None and profiler._active:
        slices = profiler.request_slices(rid)
        if slices:
            tree = _span_tree(slices)
            with _lock:  # `done` is the exemplar object itself
                done["spans"] = tree


def _reservoir_offer_locked(done: dict) -> bool:
    res = _reservoirs.setdefault(done["tenant"], [])
    res.append(done)
    res.sort(key=lambda r: (-r["total_s"], r["rid"]))
    del res[_knobs.exemplars:]
    return any(r is done for r in res)


def _span_tree(slices: List[dict]) -> List[dict]:
    """Nest flat ``{cat, name, t0_us, t1_us}`` slices into a forest by
    interval containment (stack sweep over slices sorted by start, widest
    first on ties)."""
    root: List[dict] = []
    stack: List[dict] = []
    for s in sorted(slices, key=lambda x: (x["t0_us"], -x["t1_us"])):
        node = dict(s)
        node["children"] = []
        while stack and s["t0_us"] >= stack[-1]["t1_us"]:
            stack.pop()
        (stack[-1]["children"] if stack else root).append(node)
        stack.append(node)
    return root


def note_admission(checkpoint: str, verdict: str,
                   headroom_s: Optional[float] = None,
                   rid: Optional[int] = None) -> None:
    """One lifecycle-checkpoint admission decision: ``verdict`` is
    ``admitted`` / ``shed`` / ``deadline-expired``, ``headroom_s`` the
    deadline headroom observed there (negative = already past)."""
    if not _enabled:
        return
    if rid is None:
        rid = _ambient_rid()
    if rid is None:
        return
    entry = {"checkpoint": str(checkpoint), "verdict": str(verdict)}
    if headroom_s is not None:
        entry["headroom_s"] = round(float(headroom_s), 9)
    with _lock:
        rec = _live.get(rid)
        if rec is not None and len(rec.admission) < _MAX_ADMISSION:
            rec.admission.append(entry)


def note_scheduled(rid: Optional[int], shard: int, queue_wait_s: float,
                   hold_s: float = 0.0, width: int = 1,
                   stolen_from: Optional[int] = None) -> None:
    """One work item leaving the dispatch queue: which shard ran it, how long
    it waited queued, how long the batch window held it, the batch width it
    rode, and — when it was stolen — the shard it came from. Called by the
    scheduler loop after releasing its condvar."""
    if not _enabled or rid is None:
        return
    with _lock:
        rec = _live.get(rid)
        if rec is None:
            return
        rec.add_stage("queue_wait", queue_wait_s)
        rec.add_stage("window_hold", hold_s)
        rec.shard = int(shard)
        rec.width = max(rec.width, int(width))
        if stolen_from is not None:
            rec.stolen_from = int(stolen_from)


def note_program(label: str, seconds: float, phase: str,
                 flops: float = 0.0, rid: Optional[int] = None) -> None:
    """One program invocation attributed to the ambient (or given) request:
    ``phase`` is ``"compile"`` (first call: trace+lower+compile wall) or
    ``"execute"``. Execute time and FLOPs also bill the tenant's cost meter;
    work outside any request scope bills tenant ``"-"``."""
    if not _enabled:
        return
    if rid is None:
        rid = _ambient_rid()
    seconds = max(0.0, float(seconds))
    with _lock:
        rec = _live.get(rid) if rid is not None else None
        tenant = rec.tenant if rec is not None else _UNATTRIBUTED
        if rec is not None:
            rec.add_stage(phase, seconds)
            if phase == "execute":
                rec.device_s += seconds
            rec.flops += flops
        if phase == "execute":
            m = _meter_locked(tenant)
            m["device_seconds"] += seconds
            m["flops"] += flops


def note_batch_execute(rids: List[Optional[int]], label: str, seconds: float,
                       flops_each: float = 0.0) -> None:
    """One batched program call folded by width-share: each of the ``width``
    items is billed ``seconds / width`` of device time (and its own single
    program's FLOPs), so the meters reconcile with the unbatched accounting."""
    if not _enabled or not rids:
        return
    share = max(0.0, float(seconds)) / len(rids)
    with _lock:
        for rid in rids:
            rec = _live.get(rid) if rid is not None else None
            tenant = rec.tenant if rec is not None else _UNATTRIBUTED
            if rec is not None:
                rec.add_stage("execute", share)
                rec.device_s += share
                rec.flops += flops_each
            m = _meter_locked(tenant)
            m["device_seconds"] += share
            m["flops"] += flops_each


def note_result_cache(outcome: str, reason: Optional[str] = None,
                      nbytes: float = 0.0, rid: Optional[int] = None) -> None:
    """One result-cache consult: ``outcome`` is ``hit`` / ``miss`` /
    ``bypass`` (with ``reason`` naming *why* the consult was skipped —
    ``no-replay-spec``, ``rng-label``, ``undigestable-operand``). A hit's
    ``nbytes`` credits the tenant's ``cache_bytes_saved`` meter."""
    if not _enabled:
        return
    if rid is None:
        rid = _ambient_rid()
    with _lock:
        rec = _live.get(rid) if rid is not None else None
        tenant = rec.tenant if rec is not None else _UNATTRIBUTED
        if rec is not None:
            rc = rec.result_cache
            if outcome == "hit":
                rc["hits"] += 1
                rc["bytes_saved"] += nbytes
            elif outcome == "miss":
                rc["misses"] += 1
            else:
                key = reason or "bypass"
                rc["bypass"][key] = rc["bypass"].get(key, 0) + 1
        if outcome == "hit" and nbytes:
            _meter_locked(tenant)["cache_bytes_saved"] += nbytes


def note_compile_cache(outcome: str, rid: Optional[int] = None) -> None:
    """One first-call compile's persistent-cache outcome (``aot-load`` /
    ``miss`` / ``off``), counted on the record."""
    if not _enabled:
        return
    if rid is None:
        rid = _ambient_rid()
    if rid is None:
        return
    with _lock:
        rec = _live.get(rid)
        if rec is not None:
            rec.compile_cache[outcome] = rec.compile_cache.get(outcome, 0) + 1


def note_collective(site: str, seconds: float, nbytes: float = 0.0) -> None:
    """One collective invocation: wall time is *auxiliary* (collectives run
    at trace time, nested inside the ``compile`` stage — adding them to the
    stage sum would double count); logical payload bytes bill the tenant's
    ``collective_bytes`` meter."""
    if not _enabled:
        return
    rid = _ambient_rid()
    with _lock:
        rec = _live.get(rid) if rid is not None else None
        tenant = rec.tenant if rec is not None else _UNATTRIBUTED
        if rec is not None:
            rec.collective_s += max(0.0, float(seconds))
            rec.collective_bytes += nbytes
        if nbytes:
            _meter_locked(tenant)["collective_bytes"] += nbytes


@contextlib.contextmanager
def collective_timer(site: str):
    """Time one collective invocation (retries included) onto the ambient
    record as auxiliary collective time — the wrapper communication's
    guarded chain puts around the actual dispatch. The clock reads live
    HERE, not in the (trace-reachable) caller, mirroring
    ``telemetry.collective_window``: the purity rule bans wall-clock reads
    inside traced bodies, and this plane keeps its own clocks."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        note_collective(site, time.perf_counter() - t0)


def note_event(kind: str, detail: str = "", rid: Optional[int] = None) -> None:
    """One failure-path event (``typed-failure`` / ``eager-replay`` /
    ``retry`` / ``fault`` / ...) on the ambient or given request; promoted to
    a critical-path leg at finish."""
    if not _enabled:
        return
    if rid is None:
        rid = _ambient_rid()
    if rid is None:
        return
    with _lock:
        rec = _live.get(rid)
        if rec is not None and len(rec.events) < _MAX_EVENTS:
            rec.events.append({"kind": str(kind), "detail": str(detail)})


def _note_resilience(site: str, kind: str, detail: str) -> None:
    """``diagnostics._forensics_tee`` adapter: attribute retry / fault /
    exhausted / breaker events from the always-on resilience stream to the
    ambient request (invoked outside the diagnostics lock)."""
    if not _enabled:
        return
    note_event(kind, f"{site}: {detail}")


# ------------------------------------------------------------------ consumers
def records(tag: Optional[str] = None, limit: int = 64) -> List[dict]:
    """The most recent finished records (newest last), optionally filtered to
    one tenant tag. Copies — safe to mutate."""
    with _lock:
        out = [dict(r) for r in _ring
               if tag is None or r["tenant"] == tag]
    return out[-limit:]


def exemplars(tenant: Optional[str] = None) -> Dict[str, List[dict]]:
    """The slowest-K full records per tenant (deterministic ``(-total_s,
    rid)`` order), or just ``tenant``'s."""
    with _lock:
        if tenant is not None:
            return {tenant: [dict(r) for r in _reservoirs.get(tenant, [])]}
        return {t: [dict(r) for r in res] for t, res in _reservoirs.items()}


def exemplar_refs(tenant: Optional[str] = None, k: int = 3) -> List[dict]:
    """Compact exemplar references (``rid`` / ``tenant`` / ``total_ms`` /
    ``dominant``) for embedding in alert payloads — the ``slo-burn``
    post-mortem detail names these."""
    with _lock:
        if tenant is not None:
            pool = list(_reservoirs.get(tenant, []))
        else:
            pool = [r for res in _reservoirs.values() for r in res]
        pool.sort(key=lambda r: (-r["total_s"], r["rid"]))
        return [
            {"rid": r["rid"], "tenant": r["tenant"],
             "total_ms": round(r["total_s"] * 1e3, 3),
             "dominant": r["dominant"]}
            for r in pool[:max(0, int(k))]
        ]


def tenant_cost() -> Dict[str, dict]:
    """The per-tenant cost meters: ``requests`` / ``device_seconds`` /
    ``flops`` / ``collective_bytes`` / ``cache_bytes_saved`` /
    ``stage_seconds`` (per-stage wall totals). Unattributed work meters under
    ``"-"``. Copies."""
    with _lock:
        return {
            t: {**{k: v for k, v in m.items() if k != "stage_seconds"},
                "stage_seconds": dict(m["stage_seconds"])}
            for t, m in _meters.items()
        }


def totals() -> dict:
    """The module-wide cost totals, defined as the *fold* over
    :func:`tenant_cost` — the meter reconciliation rule: per-tenant meters
    sum exactly to these totals because these totals ARE that sum."""
    agg = {"requests": 0, "device_seconds": 0.0, "flops": 0.0,
           "collective_bytes": 0.0, "cache_bytes_saved": 0.0,
           "stage_seconds": {}}
    for m in tenant_cost().values():
        agg["requests"] += m["requests"]
        agg["device_seconds"] += m["device_seconds"]
        agg["flops"] += m["flops"]
        agg["collective_bytes"] += m["collective_bytes"]
        agg["cache_bytes_saved"] += m["cache_bytes_saved"]
        for stage, seconds in m["stage_seconds"].items():
            agg["stage_seconds"][stage] = (
                agg["stage_seconds"].get(stage, 0.0) + seconds)
    return agg


def explain(tag: Optional[str] = None, limit: int = 5) -> dict:
    """Answer "why was this slow" for ``tag``'s requests (or all traffic)
    from the forensic artifact: dominant-stage distribution over the ring,
    the tenant's cost meter, and the slowest exemplars with their critical
    paths. Exported as ``ht.explain``."""
    with _lock:
        ring = [r for r in _ring if tag is None or r["tenant"] == tag]
        dominants: Dict[str, int] = {}
        for r in ring:
            dominants[r["dominant"]] = dominants.get(r["dominant"], 0) + 1
        if tag is not None:
            pool = list(_reservoirs.get(tag, []))
        else:
            pool = [r for res in _reservoirs.values() for r in res]
        pool.sort(key=lambda r: (-r["total_s"], r["rid"]))
        slowest = [dict(r) for r in pool[:max(0, int(limit))]]
    cost = tenant_cost()
    return {
        "schema": SCHEMA,
        "tag": tag,
        "records": len(ring),
        "dominant_stages": dominants,
        "cost": cost.get(tag) if tag is not None else totals(),
        "slowest": slowest,
    }


def forensics_stats() -> dict:
    """The diagnostics report section (provider ``"forensics"``): switch
    state, ring/reservoir occupancy, the cost meters and their fold, and the
    exemplars — this is what rides telemetry shard dumps, so
    ``telemetry slow`` can read exemplars from merged artifacts offline."""
    with _lock:
        live = len(_live)
        ring = len(_ring)
        finished = _finished
        dropped = _dropped
    return {
        "schema": SCHEMA,
        "armed": _enabled,
        "live": live,
        "ring": ring,
        "finished": finished,
        "dropped": dropped,
        "knobs": {"ring": _knobs.ring, "exemplars": _knobs.exemplars},
        "tenant_cost": tenant_cost(),
        "totals": totals(),
        "exemplars": exemplars(),
    }


# ------------------------------------------------------------------ wiring
# Late-bound collaborator hooks, installed once at import (the same pattern
# telemetry uses for the diagnostics tees): the profiler drives record
# open/close from `request()` even while itself disabled ("lite-active"),
# and the always-on resilience stream tees failure events onto the ambient
# record. Both collaborators invoke us OUTSIDE their own locks.
if profiler is not None:
    profiler._forensics = sys.modules[__name__]
if diagnostics is not None:
    diagnostics._forensics_tee = _note_resilience
    diagnostics.register_provider("forensics", forensics_stats)

if os.environ.get("HEAT_TPU_FORENSICS") == "1":
    arm()
