"""``ht.profiler``: request-level latency histograms, per-request span trees and
Chrome-trace/Perfetto timeline export (the port's own copy of
heat_tpu/core/profiler.py, which loads with the stdlib alone).

- **Latency histograms** (:class:`Histogram`): streaming, log-bucketed,
  bounded-memory and *mergeable* (bucket counts add), with p50/p95/p99/max
  snapshots in :func:`report`. Every :func:`request` scope observes its wall
  latency into the ``request.<tag>`` histogram; :func:`observe` feeds others.
- **Per-request span trees**: ``with profiler.request("kmeans"):`` opens a
  contextvar-scoped request id that the dispatch wrappers (:mod:`_operations`),
  the deferred-graph force and program calls (:mod:`_executor`) and every
  ``TorchCommunication`` collective pick up, so the slices of concurrent requests
  attribute to the right request even when they interleave on a thread pool. A
  :class:`~._executor.Deferred` node also *captures* the ambient request id at
  defer time, so a chain built inside a request scope but forced later, from
  another thread, still attributes its force to the request that built it.
- **Chrome-trace export** (:func:`dump_trace`): the recorded slices as
  trace-event JSON for Perfetto / ``chrome://tracing``: one track (pid) per
  request with its tag as the process name, nested B/E slices for ``dispatch`` →
  ``compile``/``execute`` → ``collective``, and counter tracks (queue depth,
  lifecycle events, donated bytes, force-boundary memory samples).
- **Force-boundary memory gauge**: at every deferred-graph force the executor
  samples the bytes the force touched (leaf inputs + emitted outputs);
  ``report()["memory"]`` keeps the last and the peak sample. It is the
  framework's view of its working set, not an allocator readout.
- **Program phases** (:func:`phase`, :func:`part`, :func:`count`): the
  estimator's and the trainer's own spans (``fit.entry``, ``lloyd.pass``,
  ``step.forward``, ...) and counters (``lloyd.host_reads``). They record while
  the profiler is enabled AND while a ``torch.profiler`` session runs, so a
  device trace carries the program's phases without a switch of its own; they
  are no ``torch.profiler`` annotations, which would show on the device
  timeline as operations. A phase given a CUDA device also times the device's
  share: one CUDA event at each edge, from a reused pool, resolved only when
  :func:`phases` is read. :func:`phases` returns each phase's count, host
  seconds and device seconds, and the counters.

Zero-cost contract: disabled (the default), every hook is one module-attribute
read (``profiler._active``) and a branch not taken; a phase hook reads one
more (``torch.autograd.profiler._is_profiler_enabled``). All timing is on the
host, around dispatch, but for the phases' CUDA events; nothing is added to the
operations a program runs.

One clock: timestamps are microseconds of CLOCK_REALTIME (``time.time_ns``)
from :data:`_T0_NS`, fixed at import. ``torch.profiler`` stamps its events on
that clock too (its chrome trace's ``baseTimeNanoseconds`` plus ``ts``), and
:func:`dump_trace` writes ``baseTimeNanoseconds`` the same way, so the
program's slices lie on the device trace's timeline.

Request deadlines: ``request(tag, deadline_s=...)`` also arms a wall-clock
deadline in a second contextvar scoped like the request id. ``current_deadline()``
reads it, ``Deferred`` nodes capture it at defer time, and the executor's
lifecycle checkpoints (admission, pre-dispatch, batch formation, eager replay)
act on it. Deadlines are a lifecycle contract, not telemetry, so they are armed
even while the profiler is disabled; ``_deadline_seen`` (set once, never
cleared) lets a process that never uses deadlines skip the contextvar read.

Thread-safety: all registries mutate under one module lock; the current request
id is a ``contextvars.ContextVar``. Slices are stored as complete (start, end)
records and serialised to B/E pairs only at dump time, so an evicted record
takes its B and its E with it and the exported trace always has matched pairs.

Env knobs (read once at import): ``HEAT_TPU_PROFILE=1`` starts with the profiler
enabled; ``HEAT_TPU_PROFILE_TRACE=path`` dumps the Chrome trace to ``path`` at
interpreter exit.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import json
import math
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from . import diagnostics, resilience

__all__ = [
    "Histogram",
    "enable",
    "disable",
    "active",
    "reset",
    "request",
    "current_request",
    "current_request_tag",
    "current_deadline",
    "attributed",
    "attribution_active",
    "request_slices",
    "scope",
    "recording",
    "phase",
    "part",
    "count",
    "phases",
    "observe",
    "histogram_snapshots",
    "record_counter",
    "record_force_memory",
    "report",
    "dump_trace",
    "trace_snapshot",
    "trace_events",
    "SCHEMA",
    "TRACE_SCHEMA",
]

SCHEMA = "heat-tpu-profiler/1"
TRACE_SCHEMA = "heat-tpu-profiler-trace/1"

# Hot-path hooks read this module attribute directly (`profiler._active`):
# one attribute load + branch when off — the zero-cost-when-disabled contract.
_active: bool = False


class _TorchProfilerFlag:
    """Stands in for ``torch.autograd.profiler`` until torch is loaded (this
    module loads with the stdlib alone): its ``_is_profiler_enabled`` reads
    False, and from the first read with torch loaded the module's attribute is
    the real one, a plain module boolean the phase hooks read."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _torch_profiler
        real = sys.modules.get("torch.autograd.profiler")
        if real is None:
            return False
        _torch_profiler = real
        return real._is_profiler_enabled


_torch_profiler = sys.modules.get("torch.autograd.profiler") or _TorchProfilerFlag()

_lock = threading.RLock()

# Bounded stores, same policy as diagnostics: evict OLDEST on overflow so the
# dump holds the most recent tail of the run. Slices are (rid, tid, cat, name,
# t0_us, t1_us) tuples — complete records, so eviction never orphans a B or E.
_MAX_SLICES = 65_536
_MAX_COUNTER_EVENTS = 16_384
_MAX_REQUESTS = 8_192

_slices: "deque[tuple]" = deque(maxlen=_MAX_SLICES)
_counter_events: "deque[tuple]" = deque(maxlen=_MAX_COUNTER_EVENTS)
# rid -> {"tag", "t0_us", "t1_us"} — insertion-ordered; evict-oldest beyond cap
_requests: "OrderedDict[int, dict]" = OrderedDict()
_hists: Dict[str, "Histogram"] = {}
_mem = {"forces": 0, "last_force_live_bytes": 0, "peak_force_live_bytes": 0}
_counters: Dict[str, float] = {}  # cumulative values behind the counter tracks

_rid_counter = itertools.count(1)
_current_request: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "heat_tpu_profiler_request", default=None
)

# Request deadlines ride the same contextvar scoping as the request id but are
# a LIFECYCLE feature, not telemetry: `request(tag, deadline_s=...)` arms the
# ambient deadline even while the profiler is disabled, and the executor's
# deadline checkpoints act on it either way. `_deadline_seen` is the relaxed
# one-attribute-read gate (set once, never cleared) the executor's hot paths
# check before paying the contextvar lookup — a process that never sets a
# deadline never reads the contextvar at all (the deadline-off parity
# contract).
_current_deadline: "contextvars.ContextVar[Optional[float]]" = contextvars.ContextVar(
    "heat_tpu_profiler_deadline", default=None
)
_deadline_seen: bool = False

# Late-bound forensics module (set once at ``forensics`` import, read bare
# afterwards — the diagnostics tee pattern). While the forensics plane is
# armed, `request()` runs "lite-active": it allocates a request id and threads
# the contextvar (so tenant attribution and forensic records work) even when
# the profiler itself is disabled, but records no slices and observes no
# histograms. Forensics calls happen OUTSIDE `_lock`.
_forensics = None

# Trace timestamps: microseconds (Chrome's native unit) of CLOCK_REALTIME, the
# clock torch.profiler stamps its events on, from this origin. Fixed at import:
# every slice of the process shares one timeline, whatever enable() and
# disable() do in between.
_T0_NS = time.time_ns()


def _now_us() -> float:
    return (time.time_ns() - _T0_NS) / 1e3


# ------------------------------------------------------------------ histograms
class Histogram:
    """A streaming log-bucketed latency histogram: bounded memory, mergeable,
    quantile estimates with a known relative error bound.

    Values (seconds) land in geometric buckets ``[base·growth^i,
    base·growth^(i+1))``; the default ``growth=1.05`` bounds any quantile
    estimate's relative error by ~2.5% (half a bucket width, geometric
    midpoint) while covering 1 µs … >1 h in under 600 buckets. Buckets are a
    sparse dict — a workload whose latencies span three decades holds ~140
    entries, not an array of the full index range.

    ``merge`` adds bucket counts (exact, associative, commutative), takes
    min/max of extremes and sums counts/totals — two processes, or two
    rounds, fold into one histogram whose quantiles are identical to having
    observed the union stream (bucket counts are integers; only ``sum_s``
    is subject to float addition order)."""

    __slots__ = ("base", "growth", "_log_growth", "buckets", "count", "sum_s",
                 "min_s", "max_s")

    #: index clamp: base·growth^512 at the defaults is ≳ 19 h — anything slower
    #: is an outage, not a latency, and lands saturated in the top bucket.
    MAX_INDEX = 512

    def __init__(self, base: float = 1e-6, growth: float = 1.05):
        if not (base > 0 and growth > 1):
            raise ValueError(f"need base > 0 and growth > 1, got {base}, {growth}")
        self.base = float(base)
        self.growth = float(growth)
        self._log_growth = math.log(growth)
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    def _index(self, seconds: float) -> int:
        if seconds <= self.base:
            return 0
        i = int(math.log(seconds / self.base) / self._log_growth) + 1
        return min(i, self.MAX_INDEX)

    def _bound(self, index: int) -> float:
        """Upper bound of bucket ``index`` (its quantile estimate uses the
        geometric midpoint of [bound/growth, bound])."""
        return self.base * self.growth ** index

    def observe(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        i = self._index(seconds)
        self.buckets[i] = self.buckets.get(i, 0) + 1
        self.count += 1
        self.sum_s += seconds
        if seconds < self.min_s:
            self.min_s = seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into self (in place; returns self). Bucket configs
        must match — merging histograms of different resolutions would silently
        corrupt the quantiles."""
        if (other.base, other.growth) != (self.base, self.growth):
            raise ValueError(
                f"cannot merge histograms with different bucket configs: "
                f"({self.base}, {self.growth}) vs ({other.base}, {other.growth})"
            )
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.count += other.count
        self.sum_s += other.sum_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)
        return self

    def percentile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (``q`` in [0, 1]): geometric midpoint of
        the bucket where the cumulative count crosses ``q·count``, clamped to
        the observed min/max so tiny histograms never report an estimate
        outside the data. None when empty."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= target:
                hi = self._bound(i)
                est = hi / math.sqrt(self.growth) if i > 0 else hi / 2.0
                return min(max(est, self.min_s), self.max_s)
        return self.max_s

    def count_over(self, threshold_s: float) -> int:
        """How many observed samples exceeded ``threshold_s`` — the SLO
        burn-rate numerator (a window's requests over the
        tenant's p99 objective with this). Bucket-resolution: a whole bucket
        counts as over when its LOWER bound is at or above the threshold, so
        the answer is exact whenever the threshold lands on a bucket boundary
        and otherwise errs by at most the one straddling bucket (under — the
        conservative direction for alerting on latency)."""
        threshold_s = max(0.0, float(threshold_s))
        total = 0
        for i, c in self.buckets.items():
            lower = self._bound(i - 1) if i > 0 else 0.0
            if lower >= threshold_s:
                total += c
        return total

    def snapshot(self) -> dict:
        """A JSON-able summary: counts, extremes, p50/p95/p99, and the sparse
        bucket table (``[[index, count], …]`` with the bucket config) so a
        downstream consumer can re-merge snapshots offline."""
        return {
            "count": self.count,
            "sum_s": round(self.sum_s, 9),
            "min_s": round(self.min_s, 9) if self.count else None,
            "max_s": round(self.max_s, 9) if self.count else None,
            "p50_s": _round_opt(self.percentile(0.50)),
            "p95_s": _round_opt(self.percentile(0.95)),
            "p99_s": _round_opt(self.percentile(0.99)),
            "bucket_base": self.base,
            "bucket_growth": self.growth,
            "buckets": [[i, self.buckets[i]] for i in sorted(self.buckets)],
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        """Rebuild a mergeable histogram from :meth:`snapshot` output (the
        offline half of mergeability — fold recorded rounds without the process
        that recorded them)."""
        h = cls(base=snap["bucket_base"], growth=snap["bucket_growth"])
        for i, c in snap["buckets"]:
            h.buckets[int(i)] = int(c)
        h.count = int(snap["count"])
        h.sum_s = float(snap["sum_s"])
        h.min_s = float(snap["min_s"]) if snap.get("min_s") is not None else math.inf
        h.max_s = float(snap["max_s"]) if snap.get("max_s") is not None else 0.0
        return h

    def delta(self, prev) -> "Histogram":
        """The *windowed* histogram between an earlier :meth:`snapshot` of this
        same stream (``prev`` — a snapshot dict or a Histogram) and now: bucket
        counts subtract exactly, so interval p50/p99 between two dumps come out
        of cumulative snapshots without any per-window state. Raises
        ``ValueError`` when ``prev`` is not a prefix of this stream (some
        bucket would go negative — the histograms are from different streams
        or the stream was reset between the snapshots).

        The window's true ``min_s``/``max_s`` are not recoverable from
        cumulative counts; the delta clamps them to the occupied buckets'
        bounds, so quantile estimates keep their usual half-bucket error
        but the extremes are bucket-resolution, not sample-resolution.
        ``merge(prev, delta)`` reproduces the cumulative bucket table exactly
        (an exact round-trip)."""
        if isinstance(prev, dict):
            prev = Histogram.from_snapshot(prev)
        if (prev.base, prev.growth) != (self.base, self.growth):
            raise ValueError(
                f"cannot delta histograms with different bucket configs: "
                f"({self.base}, {self.growth}) vs ({prev.base}, {prev.growth})"
            )
        h = Histogram(base=self.base, growth=self.growth)
        for i in set(self.buckets) | set(prev.buckets):
            c = self.buckets.get(i, 0) - prev.buckets.get(i, 0)
            if c < 0:
                raise ValueError(
                    f"snapshot is not a prefix of this histogram: bucket {i} "
                    f"has {self.buckets.get(i, 0)} < prior {prev.buckets.get(i, 0)}"
                )
            if c:
                h.buckets[i] = c
        h.count = self.count - prev.count
        if h.count < 0 or h.count != sum(h.buckets.values()):
            raise ValueError(
                "snapshot is not a prefix of this histogram (count mismatch)"
            )
        h.sum_s = max(0.0, self.sum_s - prev.sum_s)
        if h.buckets:
            lo, hi = min(h.buckets), max(h.buckets)
            h.min_s = self._bound(lo - 1) if lo > 0 else 0.0
            h.max_s = min(self._bound(hi), self.max_s)
            h.min_s = min(h.min_s, h.max_s)
        return h


def _round_opt(v: Optional[float]) -> Optional[float]:
    return round(v, 9) if v is not None else None


# ------------------------------------------------------------------ switches
def enable() -> None:
    """Turn the profiler on. The timestamp origin stays :data:`_T0_NS`, so
    slices from before and after a disable/enable cycle share one timeline."""
    global _active
    _active = True


def disable() -> None:
    """Stop collecting. Collected data is kept — :func:`report` and
    :func:`dump_trace` still work; :func:`reset` clears."""
    global _active
    _active = False


def active() -> bool:
    """Whether the profiler is currently collecting."""
    return _active


def recording() -> bool:
    """Whether the phase and collective hooks record: while the profiler is
    enabled, or while a ``torch.profiler`` session runs."""
    return _active or _torch_profiler._is_profiler_enabled


def reset() -> None:
    """Drop every collected slice, request, histogram, counter and memory
    sample. The enabled switch is kept."""
    with _lock:
        _slices.clear()
        _counter_events.clear()
        _requests.clear()
        _hists.clear()
        _counters.clear()
        _phase_tallies.clear()
        _event_pool.clear()
        _mem["forces"] = 0
        _mem["last_force_live_bytes"] = 0
        _mem["peak_force_live_bytes"] = 0


# ------------------------------------------------------------------ requests & scopes
def current_request() -> Optional[int]:
    """The ambient request id (inside a :func:`request` scope on this
    thread/context), or None."""
    return _current_request.get()


def attribution_active() -> bool:
    """True while request attribution is flowing: the profiler is enabled, or
    the forensics plane is armed (its lifecycle records ride the same request
    contextvar). Hot paths that only need a tenant/request id gate on this;
    relaxed attribute reads."""
    f = _forensics
    return _active or (f is not None and f._enabled)


def request_slices(rid: int) -> List[dict]:
    """Every recorded slice attributed to request ``rid``, as ``{cat, name,
    t0_us, t1_us}`` dicts in recording order."""
    with _lock:
        return [
            {"cat": c, "name": n, "t0_us": t0, "t1_us": t1}
            for (r, _tid, c, n, t0, t1) in _slices
            if r == rid
        ]


def current_request_tag() -> Optional[str]:
    """The ambient request's *tag* (the string passed to :func:`request`), or
    None outside a request scope / while disabled. The async executor uses
    this as the tenant key for its fair dispatch queue: requests sharing a tag
    share one round-robin slot."""
    rid = _current_request.get()
    if rid is None:
        return None
    with _lock:
        entry = _requests.get(rid)
        return entry["tag"] if entry is not None else None


@contextlib.contextmanager
def attributed(req: Optional[int]):
    """Make ``req`` the ambient request for this thread for the duration of
    the block (no-op for ``None`` or while disabled). The dispatch scheduler
    wraps queued executions in this so program-call and collective slices
    running on the scheduler thread still attribute to the request that
    planned the force."""
    if req is None or not attribution_active():
        yield
        return
    token = _current_request.set(req)
    try:
        yield
    finally:
        _current_request.reset(token)


def current_deadline() -> Optional[float]:
    """The ambient request's absolute wall-clock deadline (a
    ``time.monotonic()`` instant), or None when no deadline is armed. Set by
    ``request(tag, deadline_s=...)``; captured by ``Deferred`` nodes at defer
    time and acted on at the executor's lifecycle checkpoints."""
    return _current_deadline.get()


@contextlib.contextmanager
def request(tag: str, deadline_s: Optional[float] = None):
    """Scope one serving request: allocates a request id, makes it the ambient
    request for every profiler hook on this thread (dispatch, force, program
    call, collective), records the request as a top-level slice on its own
    trace track, and observes its wall latency into the ``request.<tag>``
    histogram. Yields the request id. No-op (yields None) while disabled.

    ``deadline_s`` arms a wall-clock deadline ``deadline_s`` seconds from now
    for everything scoped under this request — deferred nodes capture it at
    defer time (like the request id), the async executor refuses/cancels work
    that cannot meet it, and readers get a typed
    ``ht.resilience.DeadlineExceeded`` instead of late results. The deadline
    is a lifecycle contract, not telemetry: it is armed even while the
    profiler is disabled.

    While the forensics plane is armed the scope runs "lite-active" even with
    the profiler disabled: a request id is allocated and threaded (so tenant
    attribution and the lifecycle record work) and the forensic record is
    opened/closed around the body, but no slices or histograms are recorded."""
    global _deadline_seen
    dtoken = None
    if deadline_s is not None:
        _deadline_seen = True
        dtoken = _current_deadline.set(time.monotonic() + float(deadline_s))
    f = _forensics
    fon = f is not None and f._enabled
    if not _active and not fon:
        try:
            yield None
        finally:
            if dtoken is not None:
                _current_deadline.reset(dtoken)
        return
    rid = next(_rid_counter)
    t0 = _now_us()
    with _lock:
        _requests[rid] = {"tag": str(tag), "t0_us": t0, "t1_us": None}
        while len(_requests) > _MAX_REQUESTS:
            _requests.popitem(last=False)
    token = _current_request.set(rid)
    if fon:
        f.begin_request(rid, str(tag), _current_deadline.get())
    try:
        yield rid
    finally:
        _current_request.reset(token)
        if dtoken is not None:
            _current_deadline.reset(dtoken)
        t1 = _now_us()
        with _lock:
            entry = _requests.get(rid)
            if entry is not None:
                entry["t1_us"] = t1
            if _active:
                _slices.append((rid, threading.get_ident(), "request", str(tag), t0, t1))
                _hist_locked(f"request.{tag}").observe((t1 - t0) / 1e6)
        if fon:
            f.finish_request(rid, (t1 - t0) / 1e6)


@contextlib.contextmanager
def scope(cat: str, name: str, req: Optional[int] = None):
    """Record one timed slice of category ``cat`` (``dispatch`` / ``compile``
    / ``execute`` / ``collective`` / ``force`` / user categories), attributed
    to the ambient request. ``req`` is a *fallback* attribution: when no
    request scope is ambient (a deferred chain forced outside the scope that
    built it) the slice — and everything nested under it — attributes to
    ``req`` instead. Callers on hot paths gate on ``profiler._active``
    themselves; this guard is for direct users.

    Yields a control handle: setting ``handle["keep"] = False`` before the
    block exits discards the slice. The executor uses this for a force that
    lost the plan race and had nothing to execute — recording it would put a
    phantom empty ``force`` on the timeline.

    Records while :func:`recording`: enabled, or inside a ``torch.profiler``
    session."""
    if not (_active or _torch_profiler._is_profiler_enabled):
        yield {"keep": True}
        return
    token = None
    if req is not None and _current_request.get() is None:
        token = _current_request.set(req)
    rid = _current_request.get()
    ctl = {"keep": True}
    t0 = _now_us()
    try:
        yield ctl
    finally:
        t1 = _now_us()
        if ctl["keep"]:
            with _lock:
                _slices.append((rid, threading.get_ident(), str(cat), str(name), t0, t1))
        if token is not None:
            _current_request.reset(token)


# ------------------------------------------------------------------ program phases
# name -> [count, host seconds, device seconds (None: timed on the host alone),
# pending (start, end) CUDA event pairs, oldest first]
_phase_tallies: Dict[str, list] = {}
_MAX_PENDING = 1024  # pairs a phase holds before it folds the completed ones
_event_pool: list = []  # CUDA events whose times were read, for reuse
_open: Dict[int, "_Phase"] = {}  # thread id -> its innermost open phase
_OFF = contextlib.nullcontext()
_time_ns = time.time_ns


def _cuda_event(stream):
    try:
        event = _event_pool.pop()
    except IndexError:
        import torch

        event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def _fold_locked(tally: list) -> None:
    # callers hold _lock: add the device seconds of the completed prefix of the
    # pending pairs (one stream completes its events in order), pool the events
    pending = tally[3]
    done = 0
    while done < len(pending) and pending[done][1].query():
        done += 1
    if done:
        ms = sum(start.elapsed_time(end) for start, end in pending[:done])
        tally[2] = (tally[2] or 0.0) + ms / 1e3
        _event_pool.extend(e for pair in pending[:done] for e in pair)
        del pending[:done]


class _Phase:
    """One open phase: its request and thread, its host start, its start event
    on ``stream`` (None: timed on the host alone), and its current part's name,
    start and event (:func:`part`). The hot path stamps the clock inline."""

    __slots__ = ("name", "stream", "parts", "rid", "tid", "outer", "t0", "ev0", "part", "part_t0", "part_ev0")

    def __init__(self, name: str, stream, parts: bool):
        self.name, self.stream, self.parts, self.part = name, stream, parts, None

    def record(self, name: str, t0: float, t1: float, events) -> None:
        with _lock:
            _slices.append((self.rid, self.tid, "phase", name, t0, t1))
            tally = _phase_tallies.get(name)
            if tally is None:
                tally = _phase_tallies[name] = [0, 0.0, None, []]
            tally[0] += 1
            tally[1] += (t1 - t0) / 1e6
            if events is not None:
                tally[3].append(events)
                if len(tally[3]) >= _MAX_PENDING:
                    _fold_locked(tally)

    def __enter__(self) -> "_Phase":
        self.rid = _current_request.get()
        self.tid = tid = threading.get_ident()
        self.outer = _open.get(tid)
        _open[tid] = self
        self.ev0 = None if self.stream is None else _cuda_event(self.stream)
        self.t0 = (_time_ns() - _T0_NS) / 1e3
        return self

    def __exit__(self, *exc) -> bool:
        ev1 = None if self.stream is None else _cuda_event(self.stream)
        t1 = (_time_ns() - _T0_NS) / 1e3
        if self.outer is None:
            del _open[self.tid]
        else:
            _open[self.tid] = self.outer
        if self.part is not None:  # the last part ends with the phase
            self.record(self.part, self.part_t0, t1, None if ev1 is None else (self.part_ev0, ev1))
        self.record(self.name, self.t0, t1, None if ev1 is None else (self.ev0, ev1))
        return False


def phase(name: str, device: Optional["torch.device"] = None, parts: bool = False):
    """A context that records the program phase ``name`` while
    :func:`recording`, as a ``phase`` slice on the timeline and in the tallies
    :func:`phases` reads; otherwise one shared no-op context.

    ``device``: on a CUDA device the phase also times the device's share, one
    CUDA event on the current stream at each edge (never a synchronisation).
    ``parts``: :func:`part` calls made inside the phase, in callees too, split
    it into consecutive parts."""
    if not (_active or _torch_profiler._is_profiler_enabled):
        return _OFF
    stream = None
    if device is not None and device.type == "cuda":
        import torch

        stream = torch.cuda.current_stream(device)
    return _Phase(name, stream, parts)


def part(name: str) -> None:
    """End the current part of this thread's innermost open phase, where that
    phase was opened with ``parts=True``, and start its part ``name``, which
    lasts until the next call or the phase's end. A no-op elsewhere and while
    not :func:`recording`."""
    if not (_active or _torch_profiler._is_profiler_enabled):
        return
    outer = _open.get(threading.get_ident())
    if outer is None or not outer.parts:
        return
    event = None if outer.stream is None else _cuda_event(outer.stream)
    t = (_time_ns() - _T0_NS) / 1e3
    if outer.part is not None:  # parts follow one another without a gap
        outer.record(outer.part, outer.part_t0, t, None if event is None else (outer.part_ev0, event))
    outer.part, outer.part_t0, outer.part_ev0 = name, t, event


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the cumulative counter ``name`` (``report()["counters"]``
    and a counter track) while :func:`recording`."""
    if not (_active or _torch_profiler._is_profiler_enabled):
        return
    with _lock:
        value = _counters[name] = _counters.get(name, 0.0) + n
        _counter_events.append((name, _now_us(), value))


def phases() -> dict:
    """``{"spans": {name: {"count", "host_s", "device_s"}}, "counters":
    {name: value}}`` of every phase recorded since :func:`reset`, with
    ``device_s`` None for a phase timed on the host alone. Reading resolves the
    phases' device times: read after the device has run their work (a
    synchronisation), or the read waits for it."""
    with _lock:
        last = [t[3][-1][1] for t in _phase_tallies.values() if t[3]]
    for event in last:
        event.synchronize()
    with _lock:
        for tally in _phase_tallies.values():
            _fold_locked(tally)
        return {
            "spans": {name: {"count": t[0], "host_s": t[1], "device_s": t[2]}
                      for name, t in _phase_tallies.items()},
            "counters": dict(_counters),
        }


# ------------------------------------------------------------------ metrics feeds
def _hist_locked(name: str) -> Histogram:
    h = _hists.get(name)
    if h is None:
        h = _hists[name] = Histogram()
    return h


def observe(name: str, seconds: float) -> None:
    """Observe one latency sample into the named histogram (no-op while
    disabled)."""
    if not _active:
        return
    with _lock:
        _hist_locked(name).observe(seconds)


def histogram_snapshots() -> Dict[str, dict]:
    """``{name: snapshot}`` for every histogram (works while disabled — the
    data survives :func:`disable` until :func:`reset`)."""
    with _lock:
        return {name: h.snapshot() for name, h in sorted(_hists.items())}


def record_counter(name: str, value: float) -> None:
    """One sample of a cumulative/gauge series, exported as a Chrome counter
    track (``ph: "C"``). The executor feeds ``donated_bytes`` (cumulative) and
    ``pad_waste_fraction`` (gauge) through here; callers gate on
    ``profiler._active``."""
    if not _active:
        return
    with _lock:
        _counters[name] = float(value)
        _counter_events.append((str(name), _now_us(), float(value)))


def record_force_memory(live_bytes: int) -> None:
    """Sample the logical bytes a deferred-graph force touched (leaf inputs +
    emitted outputs) — the force-boundary memory gauge. Callers gate on
    ``profiler._active``."""
    if not _active:
        return
    live_bytes = int(live_bytes)
    with _lock:
        _mem["forces"] += 1
        _mem["last_force_live_bytes"] = live_bytes
        if live_bytes > _mem["peak_force_live_bytes"]:
            _mem["peak_force_live_bytes"] = live_bytes
        _counter_events.append(("force_live_bytes", _now_us(), float(live_bytes)))


# ------------------------------------------------------------------ reporting
def report() -> dict:
    """The structured profiler snapshot (also registered as the ``profiler``
    section of ``ht.diagnostics.report()``)."""
    with _lock:
        reqs = [
            {"id": rid, "tag": e["tag"],
             "latency_s": round((e["t1_us"] - e["t0_us"]) / 1e6, 9)
             if e["t1_us"] is not None else None}
            for rid, e in list(_requests.items())[-64:]
        ]
        return {
            "schema": SCHEMA,
            "active": _active,
            "histograms": {name: h.snapshot() for name, h in sorted(_hists.items())},
            "requests_total": _requests_total(),
            "recent_requests": reqs,
            "memory": dict(_mem),
            "counters": dict(_counters),
            "slices_recorded": len(_slices),
        }


def _requests_total() -> int:
    # request.<tag> histogram counts are the durable tally (the _requests
    # table is evict-oldest); summing them counts every completed request
    return sum(h.count for name, h in _hists.items() if name.startswith("request."))


def _snapshot_locked() -> Dict[str, list]:
    # callers hold _lock (the _locked-suffix convention)
    return {
        "requests": [
            {"id": rid, "tag": e["tag"], "t0_us": e["t0_us"],
             "t1_us": e["t1_us"]}
            for rid, e in _requests.items()
        ],
        "slices": [list(s) for s in _slices],
        "counter_events": [list(c) for c in _counter_events],
    }


def trace_snapshot() -> Dict[str, list]:
    """The raw timeline data — requests, complete slices, counter samples —
    as JSON-able lists: the per-process export from which ONE
    cross-process trace can be rebuilt with per-process track groups (``trace_events``
    re-serialises a snapshot into Chrome trace events)."""
    with _lock:
        return _snapshot_locked()


def trace_events(snapshot: Dict[str, list], *, pid_offset: int = 0,
                 ts_shift_us: float = 0.0,
                 process_label: Optional[str] = None) -> List[dict]:
    """Serialise a :func:`trace_snapshot` into Chrome trace events.

    ``pid_offset`` namespaces every track pid (request tracks become
    ``pid_offset + rid``, the unattributed and counter tracks sit at
    ``pid_offset`` itself) — a merger gives each process its own
    disjoint pid range so two processes' request id 3 cannot collide on one
    track, and cumulative counters from different ranks land on separate
    tracks instead of summing into nonsense. ``ts_shift_us`` is added to every
    timestamp (the merger's clock alignment); ``process_label`` prefixes the
    track metadata names (``p1/request 3: kmeans``)."""
    prefix = f"{process_label}/" if process_label else ""
    events: List[dict] = []
    # one track (pid) per request, its tag as the process name; the offset
    # base pid is the unattributed track (framework work outside any request)
    events.append({"name": "process_name", "ph": "M", "pid": pid_offset,
                   "tid": 0, "args": {"name": f"{prefix}unattributed"}})
    events.append({"name": "process_sort_index", "ph": "M", "pid": pid_offset,
                   "tid": 0, "args": {"sort_index": pid_offset}})
    for entry in snapshot.get("requests", ()):
        rid = entry["id"]
        events.append({
            "name": "process_name", "ph": "M", "pid": pid_offset + rid,
            "tid": 0, "args": {"name": f"{prefix}request {rid}: {entry['tag']}"},
        })
        events.append({
            "name": "process_sort_index", "ph": "M", "pid": pid_offset + rid,
            "tid": 0, "args": {"sort_index": pid_offset + rid},
        })
    be: List[tuple] = []
    for seq, (rid, tid, cat, name, t0, t1) in enumerate(snapshot.get("slices", ())):
        pid = pid_offset + (rid if rid is not None else 0)
        t0 += ts_shift_us
        t1 += ts_shift_us
        t1 = max(t1, t0 + 1e-3)  # floor at 1 ns: a zero-length slice must
        dur = t1 - t0            # still emit its B strictly before its E
        be.append((t0, 1, -dur, -seq, {"name": name, "cat": cat, "ph": "B",
                                       "pid": pid, "tid": tid, "ts": round(t0, 3)}))
        be.append((t1, 0, dur, seq, {"name": name, "cat": cat, "ph": "E",
                                     "pid": pid, "tid": tid, "ts": round(t1, 3)}))
    # nesting-stable order: at equal ts an E closes before a B opens (sibling
    # slices), an enclosing B opens before its co-timed child (-dur sorts the
    # longer slice first, and a parent's larger append seq breaks exact ties —
    # children exit scopes, and so append, before their parents), and a child
    # E closes before its co-timed parent E (dur, then seq ascending)
    be.sort(key=lambda e: (e[0], e[1], e[2], e[3]))
    events.extend(e[-1] for e in be)
    for name, ts, value in snapshot.get("counter_events", ()):
        events.append({"name": name, "cat": "counter", "ph": "C",
                       "pid": pid_offset, "tid": 0,
                       "ts": round(ts + ts_shift_us, 3), "args": {name: value}})
    return events


def _trace_events_locked() -> List[dict]:
    # callers hold _lock (the _locked-suffix convention)
    return trace_events(_snapshot_locked())


def dump_trace(path: str, base_ns: Optional[int] = None) -> dict:
    """Write the recorded timeline as Chrome trace-event JSON (the object
    format: ``{"traceEvents": [...]}``) loadable in Perfetto /
    ``chrome://tracing``. Returns the written object (tests schema-check it
    without re-reading the file).

    ``baseTimeNanoseconds`` is the CLOCK_REALTIME instant of ``ts`` 0, as in
    ``torch.profiler``'s chrome trace. ``base_ns`` (default: the profiler's
    origin) sets it: given a device trace's ``baseTimeNanoseconds``, the two
    files' events share one time base, and their ``traceEvents`` lists merge
    into one timeline.

    The write goes through ``resilience.atomic_write`` (site
    ``profiler.trace``): a crash mid-dump leaves the previous artifact (or
    nothing), never a torn half-JSON."""
    base = _T0_NS if base_ns is None else int(base_ns)
    with _lock:
        obj = {
            "schema": TRACE_SCHEMA,
            "displayTimeUnit": "ms",
            "baseTimeNanoseconds": base,
            "traceEvents": trace_events(_snapshot_locked(), ts_shift_us=(_T0_NS - base) / 1e3),
        }

    def _write(target: str) -> None:
        with open(target, "w") as f:
            json.dump(obj, f)
            f.write("\n")

    resilience.atomic_write(path, _write, site="profiler.trace")
    return obj


# The profiler's section of ht.diagnostics.report(): histograms + memory +
# recent requests ride along with the aggregate counters in one artifact.
diagnostics.register_provider("profiler", report)


# ------------------------------------------------------------------ env bootstrap
if os.environ.get("HEAT_TPU_PROFILE") == "1":
    enable()

_trace_path = os.environ.get("HEAT_TPU_PROFILE_TRACE")
if _trace_path:

    @atexit.register
    def _dump_trace_at_exit(path: str = _trace_path) -> None:  # pragma: no cover - exit hook
        try:
            dump_trace(path)
        except Exception:  # ht: ignore[silent-except] -- atexit hook: raising here would mask the process's real exit status
            pass
