"""``ht.diagnostics``: counters, spans, resilience and fallback events, and the report
(the port's own copy of heat_tpu/core/diagnostics.py, which loads with the stdlib alone).

The registry the port's failure paths report into:

- **Counters & spans**: :func:`counter` named tallies; :func:`span` wall-clock
  aggregation (count / total / max seconds per name).
- **Resilience events** (:func:`record_resilience_event`): policy retries and
  exhaustions, circuit-breaker transitions, fault firings, checkpoint degradations,
  prunes and corrupt verdicts. Always on, like the backend-health events.
- **Fallbacks** (:func:`record_fallback`): a path that took its recorded second choice
  (the checkpoint's v2 -> v1 ladder), counted per site and kept with its reason.
- **Provider sections**: :func:`register_provider` attaches named sections computed at
  :func:`report` time; ``resilience`` reports through it.

``record_collective`` is fed by every ``TorchCommunication`` collective, and
``record_compile`` and ``record_dispatch_event`` by the executor;
``record_pad_waste`` keeps heat_tpu's name and report section (the port pads nothing).

Zero-cost contract: while disabled (the default) the metric hooks are one module
attribute read and a branch not taken. Every mutation of the registries runs under the
one module ``_lock``, so counts are exact under threads (the checkpoint's writer pool
records from several).

Env knobs (read once at import): ``HEAT_TPU_METRICS=1`` starts with metrics on,
``HEAT_TPU_TRACE=1`` with tracing on, ``HEAT_TPU_DIAG_DUMP=path`` dumps the report at
interpreter exit, ``HEAT_TPU_DIAG_LOG=path`` appends backend-health transitions.
"""

from __future__ import annotations

import atexit
import calendar
import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "enable",
    "disable",
    "enabled",
    "tracing",
    "reset",
    "report",
    "dump",
    "span",
    "counter",
    "record_collective",
    "record_compile",
    "record_dispatch_event",
    "record_fallback",
    "record_resilience_event",
    "record_pad_waste",
    "record_backend_event",
    "relay_outage_windows",
    "register_provider",
]

SCHEMA = "heat-tpu-diagnostics/1"

# Hot-path hooks read these module attributes directly (`diagnostics._enabled`):
# one attribute load + branch when off — the zero-cost-when-disabled contract.
_enabled: bool = False
_tracing: bool = False

_lock = threading.RLock()

# Bounded event streams: telemetry must never become the memory leak it exists
# to find. Aggregates (counters/spans/collectives/pad gauges) are dicts keyed by
# identity and stay small; raw event streams evict OLDEST on overflow (deque
# maxlen) so the report always holds the most recent tail of the run.
_MAX_EVENTS = 10_000

_counters: Dict[str, float] = {}
_spans: Dict[str, Dict[str, float]] = {}
_collectives: Dict[Any, Dict[str, int]] = {}
_pad_gauges: Dict[Any, Dict[str, Any]] = {}
_compile_events: "deque[dict]" = deque(maxlen=_MAX_EVENTS)
_dispatch_events: "deque[dict]" = deque(maxlen=_MAX_EVENTS)
_fallback_events: "deque[dict]" = deque(maxlen=_MAX_EVENTS)
_resilience_events: "deque[dict]" = deque(maxlen=_MAX_EVENTS)
_backend_events: "deque[dict]" = deque(maxlen=_MAX_EVENTS)
_backend_state: Optional[bool] = None

# Subsystems register report sections lazily (resilience registers its stats
# here) so this module never imports the package: it loads with the stdlib alone.
_providers: Dict[str, Callable[[], Any]] = {}

# Late-bound collaborators, installed by modules this one must not import
# (each would be a cycle — resilience and telemetry both import diagnostics).
# All three are written once at their owner's import and read bare afterwards
# (relaxed, like the switches): ``_atomic_writer`` is
# ``resilience.atomic_write`` so :func:`dump` commits whole artifacts;
# ``_resilience_tee`` / ``_fallback_tee`` are ``telemetry.flight_record``
# adapters so every failure-path event also lands in the flight-recorder ring
# (and can trigger its automatic post-mortem dump); ``_forensics_tee`` is the
# forensics event adapter so typed failures also land on the active request's
# critical path. Tees are invoked OUTSIDE ``_lock`` — the flight ring and the
# forensics store have their own locks and must stay leaves.
_atomic_writer: Optional[Callable[..., Any]] = None
_resilience_tee: Optional[Callable[[str, str, str], None]] = None
_fallback_tee: Optional[Callable[[str, str], None]] = None
_forensics_tee: Optional[Callable[[str, str, str], None]] = None


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _parse_utc(stamp: str) -> Optional[float]:
    try:
        return calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))
    except (ValueError, TypeError):
        return None


# ------------------------------------------------------------------ switches
def enable(trace: Optional[bool] = None) -> None:
    """Turn on metrics collection; ``trace=True`` additionally turns on trace
    annotations (``trace=False`` turns them off, ``None`` leaves them as-is)."""
    global _enabled, _tracing
    _enabled = True
    if trace is not None:
        _tracing = bool(trace)


def disable(trace: Optional[bool] = None) -> None:
    """Stop collecting metrics (collected data is kept — :func:`report` still
    works; :func:`reset` clears it). ``trace`` as in :func:`enable`, default
    turns tracing off too."""
    global _enabled, _tracing
    _enabled = False
    _tracing = bool(trace) if trace is not None else False


def enabled() -> bool:
    """Whether metrics collection is currently on."""
    return _enabled


def tracing() -> bool:
    """Whether trace annotations (named_scope / TraceAnnotation) are on."""
    return _tracing


def reset() -> None:
    """Drop every collected datum (counters, spans, collectives, pad gauges,
    compile/dispatch/backend events). The enabled/tracing switches and the
    last-known backend state are kept."""
    with _lock:
        _counters.clear()
        _spans.clear()
        _collectives.clear()
        _pad_gauges.clear()
        _compile_events.clear()
        _dispatch_events.clear()
        _fallback_events.clear()
        _resilience_events.clear()
        _backend_events.clear()


def register_provider(name: str, fn: Callable[[], Any]) -> None:
    """Attach a named report section computed at :func:`report` time (the
    executor registers its stats here; avoids an import cycle and keeps this
    module standalone-loadable)."""
    with _lock:
        _providers[name] = fn


# ------------------------------------------------------------------ primitives
def counter(name: str, value: float = 1) -> None:
    """Add ``value`` to the named counter (no-op while disabled)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + value


@contextlib.contextmanager
def span(name: str):
    """Time a ``with`` block into the span registry: per-name count / total
    seconds / max seconds. No-op (and near-free) while disabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            agg = _spans.get(name)
            if agg is None:
                agg = _spans[name] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
            agg["count"] += 1
            agg["total_s"] += dt
            agg["max_s"] = max(agg["max_s"], dt)


def record_collective(op: str, axis: Any, participants: int, nbytes: int) -> None:
    """Count one (traced) collective: ``nbytes`` is the *logical* payload —
    per-participant payload bytes × participants for the symmetric collectives,
    the logical array size for layout ops (``shard`` / ``_pad_reshard``)."""
    if not _enabled:
        return
    key = (op, str(axis), int(participants))
    with _lock:
        agg = _collectives.get(key)
        if agg is None:
            agg = _collectives[key] = {"count": 0, "bytes": 0}
        agg["count"] += 1
        agg["bytes"] += int(nbytes)


def record_compile(label: str, seconds: float) -> None:
    """One executor program compile: signature label + wall seconds (first-call
    wall time — trace + XLA compile + the first execution)."""
    if not _enabled:
        return
    rec = {"t": _utcnow(), "label": label, "seconds": round(float(seconds), 6)}
    with _lock:
        _compile_events.append(rec)


def record_dispatch_event(kind: str, label: str, reason: str) -> None:
    """An executor cache event worth explaining — currently ``miss`` with the
    signature component(s) that changed vs. the nearest cached key."""
    if not _enabled:
        return
    rec = {"t": _utcnow(), "kind": kind, "label": label, "reason": reason}
    with _lock:
        _dispatch_events.append(rec)


def record_fallback(site: str, reason: str) -> None:
    """One eager-path fallback that used to be a silent ``except Exception``:
    counted per site (``fallback.<site>``) and recorded with its reason
    (exception type + op label), so a workload that quietly lost its staged
    programs is visible in the report instead of just slow."""
    if not _enabled:
        return
    rec = {"t": _utcnow(), "site": site, "reason": str(reason)}
    with _lock:
        _counters[f"fallback.{site}"] = _counters.get(f"fallback.{site}", 0) + 1
        _fallback_events.append(rec)
    tee = _fallback_tee
    if tee is not None:
        tee(site, rec["reason"])


def record_resilience_event(site: str, kind: str, detail: str = "") -> None:
    """A resilience-subsystem event: policy ``retry``/``exhausted``, circuit
    ``breaker`` transitions, injected ``fault`` firings, executor ``fallback``
    and quarantine decisions. Always on (not gated by :func:`enabled`), like
    backend-health events: these come from explicit failure-path machinery,
    never from a hot compute path, and a null round must stay attributable
    even when metrics were off."""
    rec = {"t": _utcnow(), "site": site, "kind": kind, "detail": str(detail)}
    with _lock:
        _resilience_events.append(rec)
    tee = _resilience_tee
    if tee is not None:
        tee(site, kind, rec["detail"])
    ftee = _forensics_tee
    if ftee is not None:
        ftee(site, kind, rec["detail"])


def record_pad_waste(gshape, split: int, padded_dim: int) -> None:
    """Gauge the padded-layout waste of one dispatched op's ``(gshape, split)``
    family: pad fraction ``(padded - n) / padded`` of the split dimension."""
    if not _enabled:
        return
    gshape = tuple(int(s) for s in gshape)
    n = gshape[split]
    padded_dim = int(padded_dim)
    frac = (padded_dim - n) / padded_dim if padded_dim else 0.0
    key = (gshape, int(split), padded_dim)
    with _lock:
        agg = _pad_gauges.get(key)
        if agg is None:
            agg = _pad_gauges[key] = {"pad_fraction": round(frac, 6), "observations": 0}
        agg["observations"] += 1


# ------------------------------------------------------------------ backend health
def record_backend_event(up: bool, detail: str = "") -> dict:
    """Record an accelerator-backend probe result. Only *transitions* (and the
    first probe) enter the event stream and the ``HEAT_TPU_DIAG_LOG`` file —
    steady-state probes just confirm the known state. Always on (not gated by
    :func:`enabled`): health events come from explicit driver probes, never
    from a compute path."""
    global _backend_state
    up = bool(up)
    rec = {"t": _utcnow(), "up": up, "detail": str(detail)}
    with _lock:
        transition = _backend_state is None or _backend_state != up
        _backend_state = up
        if transition:
            _backend_events.append(rec)
    if transition:
        path = os.environ.get("HEAT_TPU_DIAG_LOG")
        if path:
            try:
                with open(path, "a") as f:
                    f.write(json.dumps({"backend": rec}) + "\n")
            except OSError:
                pass
    rec = dict(rec)
    rec["transition"] = transition
    return rec


def relay_outage_windows(events: Optional[List[dict]] = None) -> List[dict]:
    """Fold a time-ordered up/down event stream (default: the recorded backend
    transitions) into outage windows ``{"start", "end", "duration_s"}`` —
    ``end``/``duration_s`` are ``None`` for an outage still open at the last
    event."""
    if events is None:
        with _lock:
            events = list(_backend_events)
    windows: List[dict] = []
    current: Optional[dict] = None
    for ev in events:
        if not ev.get("up"):
            if current is None:
                current = {"start": ev.get("t"), "end": None, "duration_s": None}
        elif current is not None:
            current["end"] = ev.get("t")
            t0, t1 = _parse_utc(current["start"]), _parse_utc(current["end"])
            if t0 is not None and t1 is not None:
                current["duration_s"] = max(0, int(t1 - t0))
            windows.append(current)
            current = None
    if current is not None:
        windows.append(current)
    return windows


# ------------------------------------------------------------------ reporting
def report() -> dict:
    """The full structured snapshot — the JSON schema documented in
    ``doc/source/observability.rst``."""
    with _lock:
        rep = {
            "schema": SCHEMA,
            "generated_at": _utcnow(),
            "enabled": _enabled,
            "tracing": _tracing,
            "counters": dict(_counters),
            "spans": {k: dict(v) for k, v in _spans.items()},
            "collectives": [
                {
                    "op": op,
                    "axis": axis,
                    "participants": participants,
                    "count": agg["count"],
                    "bytes": agg["bytes"],
                }
                for (op, axis, participants), agg in sorted(_collectives.items())
            ],
            "pad_waste": [
                {
                    "gshape": list(gshape),
                    "split": split,
                    "physical_dim": padded,
                    "logical_dim": gshape[split],
                    "pad_fraction": agg["pad_fraction"],
                    "observations": agg["observations"],
                }
                for (gshape, split, padded), agg in sorted(_pad_gauges.items())
            ],
            "compile_events": list(_compile_events),
            "dispatch_events": list(_dispatch_events),
            "fallback_events": list(_fallback_events),
            "resilience_events": list(_resilience_events),
            "backend_events": list(_backend_events),
        }
    rep["relay_outage_windows"] = relay_outage_windows(rep["backend_events"])
    with _lock:
        providers = list(_providers.items())
    for name, provider in providers:
        try:
            rep[name] = provider()
        except Exception as exc:  # not silent: the error lands in the report itself; a broken provider must not kill the report
            rep[name] = {"error": repr(exc)}
    return rep


def dump(path: str) -> None:
    """Write :func:`report` as JSON to ``path``.

    Routed through ``resilience.atomic_write`` (site ``diagnostics.dump``)
    when the resilience module has installed itself: a crash mid-dump leaves
    the previous artifact (or nothing), never a torn half-JSON — merged
    telemetry reads these artifacts back, so partial writes must be
    impossible, not just unlikely."""
    payload = report()

    def _write(target: str) -> None:
        with open(target, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")

    writer = _atomic_writer
    if writer is not None:
        writer(path, _write, site="diagnostics.dump")
    else:  # standalone load before resilience exists: plain write
        _write(path)


# ------------------------------------------------------------------ env bootstrap
if os.environ.get("HEAT_TPU_METRICS") == "1":
    _enabled = True
if os.environ.get("HEAT_TPU_TRACE") == "1":
    _tracing = True

# Only the package instance registers the exit dump: a copy of this file loaded
# standalone (no parent package, __package__ falsy) must not overwrite its report.
_dump_path = os.environ.get("HEAT_TPU_DIAG_DUMP")
if _dump_path and __package__:

    @atexit.register
    def _dump_at_exit(path: str = _dump_path) -> None:  # pragma: no cover - exit hook
        try:
            dump(path)
        except Exception:  # an atexit hook: raising here would mask the process's real exit status
            pass
