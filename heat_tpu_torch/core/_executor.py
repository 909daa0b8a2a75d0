"""Signature-cached executor for the dispatch layer, with its deferred expression
graph and the async multi-tenant dispatch path (the port's counterpart of
heat_tpu/core/_executor.py).

The four dispatch wrappers in :mod:`_operations` resolve each framework-level op
to an **abstract signature** (operation identity, operand shapes and dtypes with
the Python type of each scalar, the result's split, ``fn_kwargs``, ``out=`` /
``where=`` presence, the device) and run a cached :class:`_Program` for it: one
linearised closure of the port's own torch operations, built once per signature.

How each of heat_tpu's XLA features maps onto the port:

==============================  =====================================================
heat_tpu (XLA)                  port (PyTorch/CUDA)
==============================  =====================================================
``jax.jit`` of a signature's    one linearised closure of the port's own torch ops,
chain                           built once per signature. On the card a fused chain
                                of two or more ops is captured in a
                                ``torch.cuda.CUDAGraph`` when heat_tpu would compile
                                (at the jit threshold, after one eager warm-up run)
                                and replayed after it; on the CPU the closure runs.
                                A replay launches the same kernels as eager
                                execution, so every executor result is bit-equal to
                                the port's eager path (``HEAT_TPU_EAGER_DISPATCH=1``).
                                One-op staged programs are not captured: a replay of
                                one op saves no launch and adds the copies in and out.
XLA fusion                      none (recorded deviation): a graph removes launches
                                and host overhead, not memory passes.
pad re-mask (``_zero_pads``)    does not port: the port has no padded layout.
``jax.eval_shape`` avals        the wrappers' own result-type rules, evaluated on
                                ``meta`` tensors by the same kernels that run.
``donate_argnums``              the output written into the donated leaf's (or the
                                ``out=`` buffer's) storage; grants and refusals follow
                                heat_tpu's contract and are counted the same way, and
                                a tensor that shares its storage (a view, a view's
                                base) or requires grad is never donated.
``jax.vmap`` in                 one call of the fused closure on operands stacked
``call_batched``                along a new leading axis (the plan is elementwise);
                                staged one-op programs go through ``torch.func.vmap``.
collectives inside a program    a program that issues a collective (a reduction or
                                scan over the split axis of a distributed array) is
                                never queued, batched or captured: every rank must
                                issue it in the same order, so it runs inline on the
                                calling thread (recorded deviation: heat_tpu's single
                                controller has no such hazard).
persistent compile cache, AOT   the same replay specs and index (:mod:`._compile_cache`);
warmup                          no compiled artifact (recorded deviation): warmup
                                replays the specs through the public dispatch path,
                                so a program's build and CUDA-graph capture leave the
                                first request; ``aot_loaded`` stays 0.
result cache over immutable     the same keys and invalidation (:mod:`._result_cache`),
``jax.Array`` buffers           plus each tensor's version and storage, checked at
                                every hit: an in-place write fails the entry closed.
==============================  =====================================================

**The deferred expression graph.** Supported elementwise ops (binary/local, no
``out=``/``where=``, operands of one ``(gshape, split, comm)`` family, so their
local tensors line up) do not execute at call time: they return a
:class:`Deferred` node holding (kernel, operands) and the result's local shape and
dtype. The first read of the result's local tensor (``DNDarray.larray``) **forces**
it: the reachable graph is linearised, keyed by its structural signature, and run
as ONE program. Interior nodes whose value has a future (referenced twice, still
wrapped by a live DNDarray, or held by a graph outside the plan) are emitted as
extra outputs and memoised, separately built identical subexpressions collapse by
structural CSE, and a leaf tensor whose only reader is the plan is donated.

A torch tensor, unlike a ``jax.Array``, can be written in place, so a deferred
read of a tensor must happen before any later write to it. Every node that reads
a concrete tensor is registered under the tensor's storage; ``DNDarray.larray`` —
the accessor every write goes through — first settles every pending reader of the
storage it hands out (:func:`settle_readers`), and a leaf whose version counter
moved anyway raises instead of computing from changed data.

**Async multi-tenant dispatch.** With ``HEAT_TPU_ASYNC_DISPATCH`` (default on) a
force only *plans* under the executor lock: the donation and emission decisions
are made, every emitted node's value becomes a :class:`~._scheduler.PendingValue`,
and the buffers the call touches are claimed in the per-buffer ownership
registry. The execution runs outside the lock: inline when nobody else is
dispatching on the tenant's shard, else in the :class:`~._scheduler.
DispatchScheduler`'s bounded per-tenant queue, where concurrent same-signature
forces batch into one stacked call. A full queue is backpressure under the
``executor.queue`` ``ht.resilience`` policy, then inline execution; work is never
dropped. A scheduler thread enters the device of the work it runs, and every
launch goes to the device's default stream, so a consumer that reads a fulfilled
future launches after the producer's kernels.

**Request lifecycle.** ``profiler.request(tag, deadline_s=...)`` arms a wall-clock
deadline that nodes capture at defer time; it is checked at admission, before
dispatch, at batch formation and between the ops of the eager replay, and a
request past it gets a typed ``ht.resilience.DeadlineExceeded``. ``HEAT_TPU_SHED=1``
sheds deadline-bearing work that the program's service-time EWMA says cannot fit,
and queue-full backpressure for such work, with a typed ``Shed``. Every shed,
cancel and expiry lands in the scheduler's lifecycle ledger.

**The planes.** Each program records the replay spec of its signature
(``lookup(spec=...)``, :func:`_plan_spec`), the compile cache's fingerprint and the
result cache's key; with ``HEAT_TPU_RESULT_CACHE=1`` a plain call (and a force, before it
queues) is served from the cache when its key validates. While the forensics plane is
armed, admissions, cache outcomes, program times and failure legs land on the ambient
request's record; once a supervision abort is up, a force is refused typed.

Failure hardening: a program whose call fails falls back to the eager path (the
same math, :func:`fallback_after_failure`), and a signature that keeps failing is
quarantined to it. Escape hatch: ``HEAT_TPU_EAGER_DISPATCH=1`` turns the executor
off. Introspection: :func:`executor_stats`.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import (
    _compile_cache, _result_cache, _scheduler, diagnostics, forensics, ops, profiler, resilience,
    supervision,
)
from ._compile_cache import executor_save_warmup, executor_warmup
from ._scheduler import PendingValue

__all__ = [
    "executor_stats",
    "reset_executor_stats",
    "clear_executor_cache",
    "reload_env_knobs",
    "executor_enabled",
    "async_dispatch_enabled",
    "rebuild_scheduler",
    "executor_warmup",
    "executor_save_warmup",
]

# Retrace-storm guard: genuinely polymorphic workloads must not grow the program
# table without bound.
_MAX_PROGRAMS = 1024

# Per-program cap on distinct leaf-donation variants.
_MAX_DONATE_VARIANTS = 4

# Captured CUDA graphs each hold a memory pool and static copies of their inputs;
# past this many graphs, or this many bytes held by them, the remaining programs run
# their closure without a graph.
_MAX_GRAPHS = 64
_MAX_GRAPH_BYTES = 4 << 30

UNSUPPORTED = object()
"""Sentinel a ``build`` callback returns (and the cache stores) for signatures the
executor cannot stage; the wrapper takes the eager path."""


# Telemetry tallies: PER-THREAD accumulator cells merged at report time, so an
# increment on a scheduler thread is exact without a lock.
_STAT_FIELDS = (
    "hits", "misses", "retraces",
    "interior_outputs", "reexec_avoided", "reexecuted",
    "cse_hits", "donated_bytes",
    "eager_fallbacks",
    "lock_wait_ns", "donation_refusals",
    # the port's CUDA graphs: captures, replays, and captures that failed (the
    # program then runs its closure without a graph)
    "graph_captures", "graph_replays", "graph_capture_failures",
)
_STAT_FIELD_SET = frozenset(_STAT_FIELDS)


class _StatsCell:
    __slots__ = _STAT_FIELDS + ("_thread",)

    def __init__(self):
        for field in _STAT_FIELDS:
            setattr(self, field, 0)
        self._thread = weakref.ref(threading.current_thread())


class _Stats:
    """Per-thread stat cells behind the ``_stats.field += n`` shape. Reads and
    writes of a stat field resolve to the calling thread's cell; :meth:`totals`
    merges every cell (minus the reset baseline), folding dead threads' cells into
    ``_retired``."""

    def __init__(self):
        object.__setattr__(self, "_local", threading.local())
        object.__setattr__(self, "_cells", [])
        object.__setattr__(self, "_cells_lock", threading.Lock())
        object.__setattr__(self, "_retired", {f: 0 for f in _STAT_FIELDS})
        object.__setattr__(self, "_base", {f: 0 for f in _STAT_FIELDS})

    def _cell(self) -> _StatsCell:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = _StatsCell()
            with self._cells_lock:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def __getattr__(self, name):
        if name in _STAT_FIELD_SET:
            return getattr(self._cell(), name)
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in _STAT_FIELD_SET:
            setattr(self._cell(), name, value)
        else:
            object.__setattr__(self, name, value)

    def _raw_totals_locked(self) -> dict:
        live = []
        for cell in self._cells:
            th = cell._thread()
            if th is None or not th.is_alive():
                for f in _STAT_FIELDS:
                    self._retired[f] += getattr(cell, f)
            else:
                live.append(cell)
        self._cells[:] = live
        totals = dict(self._retired)
        for cell in live:
            for f in _STAT_FIELDS:
                totals[f] += getattr(cell, f)
        return totals

    def totals(self) -> dict:
        with self._cells_lock:
            raw = self._raw_totals_locked()
        return {f: raw[f] - self._base[f] for f in _STAT_FIELDS}

    def total(self, name: str) -> int:
        return self.totals()[name]

    def reset(self) -> None:
        # a baseline snapshot, not a zeroing write: concurrent increments on
        # other threads count toward the next window
        with self._cells_lock:
            raw = self._raw_totals_locked()
            self._base.update(raw)


_stats = _Stats()
_programs: "OrderedDict[Any, Any]" = OrderedDict()
_lock = threading.RLock()


def _lock_acquire() -> None:
    """Acquire the executor lock, charging a blocked wait to ``lock_wait_ns``."""
    if _lock.acquire(blocking=False):
        return
    t0 = time.perf_counter_ns()
    _lock.acquire()
    _stats.lock_wait_ns += time.perf_counter_ns() - t0


class _TimedLock:
    """``with _tlock:`` — the executor lock with contention accounting."""

    __slots__ = ()

    def __enter__(self):
        _lock_acquire()

    def __exit__(self, *exc):
        _lock.release()


_tlock = _TimedLock()

# Warm-up counts for signatures seen but not yet built (jit threshold > 1).
_seen: Dict[Any, int] = {}
_MAX_SEEN = 8192


# ----------------------------------------------------------------- env knobs
# Parsed once at import and re-read only by reload_env_knobs() and
# clear_executor_cache(); a fresh process always re-reads.


class _EnvKnobs:
    __slots__ = (
        "eager_dispatch", "async_dispatch", "jit_threshold",
        "queue_bound", "batch_max", "quarantine_after", "shed",
        "sched_shards", "batch_window_s",
    )

    def reload(self) -> None:
        def _int(name: str, default: int) -> int:
            try:
                return max(1, int(os.environ.get(name, str(default))))
            except ValueError:
                return default

        self.eager_dispatch = os.environ.get("HEAT_TPU_EAGER_DISPATCH") == "1"
        self.async_dispatch = os.environ.get("HEAT_TPU_ASYNC_DISPATCH", "1") != "0"
        self.jit_threshold = _int("HEAT_TPU_JIT_THRESHOLD", 1)
        self.queue_bound = _int("HEAT_TPU_DISPATCH_QUEUE", 256)
        self.batch_max = _int("HEAT_TPU_BATCH_MAX", 8)
        self.quarantine_after = _int("HEAT_TPU_QUARANTINE_AFTER", 3)
        self.shed = os.environ.get("HEAT_TPU_SHED") == "1"
        # applied when the scheduler is CONSTRUCTED (rebuild_scheduler)
        self.sched_shards = _int("HEAT_TPU_SCHED_SHARDS", min(4, os.cpu_count() or 1))
        try:
            self.batch_window_s = max(0.0, int(os.environ.get("HEAT_TPU_BATCH_WINDOW_US", "0")) * 1e-6)
        except ValueError:
            self.batch_window_s = 0.0


_knobs = _EnvKnobs()
_knobs.reload()


def reload_env_knobs() -> None:
    """Re-read every memoised ``HEAT_TPU_*`` dispatch knob from ``os.environ``
    (``HEAT_TPU_EAGER_DISPATCH`` / ``ASYNC_DISPATCH`` / ``JIT_THRESHOLD`` /
    ``DISPATCH_QUEUE`` / ``BATCH_MAX`` / ``QUARANTINE_AFTER`` / ``SHED`` /
    ``BATCH_WINDOW_US``). ``HEAT_TPU_SCHED_SHARDS`` is re-read but applied only
    when the scheduler is (re)constructed — see :func:`rebuild_scheduler`."""
    _knobs.reload()
    supervision.reload_env_knobs()
    _compile_cache.reload()
    _result_cache.reload()
    ops.reload()
    forensics.reload()


def jit_threshold() -> int:
    """How many sightings of a signature before the executor builds its program
    (``HEAT_TPU_JIT_THRESHOLD``, default 1). Below it the op-by-op eager replay
    runs."""
    return _knobs.jit_threshold


def executor_enabled() -> bool:
    """Whether dispatch routes through the executor (``HEAT_TPU_EAGER_DISPATCH=1``
    is the debugging escape hatch). Unlike heat_tpu's single controller, every
    rank of the port runs its own executor: programs that issue a collective run
    inline, in program order."""
    return not _knobs.eager_dispatch


def async_dispatch_enabled() -> bool:
    """Whether forces take the async scheduler path (``HEAT_TPU_ASYNC_DISPATCH=0``
    restores the lock-serialized force)."""
    return _knobs.async_dispatch


def queue_bound() -> int:
    """Dispatch-queue capacity per shard (``HEAT_TPU_DISPATCH_QUEUE``, 256)."""
    return _knobs.queue_bound


def batch_max() -> int:
    """Cross-request batching width cap (``HEAT_TPU_BATCH_MAX``, 8; 1 disables
    batching)."""
    return _knobs.batch_max


def batch_window_s() -> float:
    """Adaptive batch-window cap in seconds (``HEAT_TPU_BATCH_WINDOW_US``, 0 = no
    holds)."""
    return _knobs.batch_window_s


# ------------------------------------------------------- per-buffer ownership
# A planned call REGISTERS its leaf tensors (reads) and CLAIMS its donation
# candidates under _own_lock before the executor lock is released; a claim is
# refused (the call runs undonated) when another in-flight call still reads the
# tensor or holds a standing claim on it.

_own_lock = threading.Lock()
_inflight_reads: Dict[int, int] = {}   # id(tensor) -> in-flight reading calls
_donation_claims: Dict[int, int] = {}  # id(tensor) -> claim epoch
_donation_epoch = 0


def _acquire_buffers(read_leaves, donate_leaves):
    """Register one planned call's buffer ownership. Returns the subset of
    ``donate_leaves`` whose claims were GRANTED (the rest count as
    ``donation_refusals`` and run undonated)."""
    global _donation_epoch
    granted = []
    with _own_lock:
        _donation_epoch += 1
        for leaf in donate_leaves:
            i = id(leaf)
            if _inflight_reads.get(i) or i in _donation_claims:
                _stats.donation_refusals += 1
                read_leaves.append(leaf)  # demoted to a plain read
            else:
                _donation_claims[i] = _donation_epoch
                granted.append(leaf)
        for leaf in read_leaves:
            i = id(leaf)
            _inflight_reads[i] = _inflight_reads.get(i, 0) + 1
    if diagnostics._enabled and len(granted) != len(donate_leaves):
        diagnostics.counter("executor.donation_refused", len(donate_leaves) - len(granted))
    if granted and _result_cache._enabled:
        # the donation doubles as result-cache invalidation: every entry whose
        # inputs or outputs alias a granted tensor is dropped BEFORE the donating
        # call writes into it
        _result_cache.note_donation([id(v) for v in granted])
    return granted


def _release_buffers(read_leaves, granted) -> None:
    with _own_lock:
        for leaf in read_leaves:
            i = id(leaf)
            n = _inflight_reads.get(i, 0) - 1
            if n > 0:
                _inflight_reads[i] = n
            else:
                _inflight_reads.pop(i, None)
        for leaf in granted:
            _donation_claims.pop(id(leaf), None)


# ------------------------------------------------------------ dispatch queue
_dispatch_scheduler: Optional[_scheduler.DispatchScheduler] = None


def _get_scheduler() -> _scheduler.DispatchScheduler:
    global _dispatch_scheduler
    sched = _dispatch_scheduler
    if sched is None:
        with _lock:
            sched = _dispatch_scheduler
            if sched is None:
                sched = _scheduler.DispatchScheduler(_execute_batch, shards=_knobs.sched_shards)
                _dispatch_scheduler = sched
    return sched


def rebuild_scheduler() -> _scheduler.DispatchScheduler:
    """Drain the scheduler singleton and rebuild it with the CURRENT memoised knobs
    (``HEAT_TPU_SCHED_SHARDS`` is applied at construction); telemetry starts at
    zero. Every outstanding future of the old scheduler settles first."""
    global _dispatch_scheduler
    old = _dispatch_scheduler
    if old is not None:
        try:
            old.drain(timeout=30.0)
        except resilience.DrainTimeout:
            pass  # leftovers were shed with typed errors
    with _lock:
        _dispatch_scheduler = _scheduler.DispatchScheduler(_execute_batch, shards=_knobs.sched_shards)
        sched = _dispatch_scheduler
    return sched


_PRESSURE_TOP_SIGNATURES = 8


def _pressure_block(per_shard: Sequence[dict]) -> dict:
    """Per-shard queue-depth / shed-rate / submit-gap EWMAs (exact at copy time)
    plus the service-time EWMA of the hottest programs (relaxed reads)."""
    pressure_shards = [
        {
            "shard": i,
            "queue_depth": snap["queue_depth"],
            "depth_ewma": round(snap["depth_ewma"], 6),
            "shed_rate_ewma": round(snap["shed_rate_ewma"], 6),
            "gap_ewma_s": round(snap["gap_ewma_s"], 9),
        }
        for i, snap in enumerate(per_shard)
    ]
    with _lock:
        entries = [
            (entry.label or _key_label(key), entry.hits, entry.ewma_s)
            for key, entry in _programs.items()
            if entry is not UNSUPPORTED
        ]
    entries.sort(key=lambda e: (-e[1], e[0]))
    service = {label: round(ewma, 9) for label, hits, ewma in entries[:_PRESSURE_TOP_SIGNATURES] if ewma > 0.0}
    return {"per_shard": pressure_shards, "service_ewma_s": service}


def executor_stats(top: int = 0) -> dict:
    """Cache introspection, with heat_tpu's field names.

    - ``hits`` / ``misses`` (signature-table lookups), ``retraces`` (first runs of
      a program variant — where heat_tpu traces), ``programs`` (table size).
    - Fused-graph tallies: ``interior_outputs`` (interior values emitted and
      memoised), ``reexec_avoided`` (subchains not re-run thanks to a memo),
      ``reexecuted`` (should stay 0), ``cse_hits`` (structural-CSE collapses),
      ``donated_bytes`` (leaf bytes donated to fused programs).
    - Failure hardening: ``eager_fallbacks``, ``quarantined`` (label -> reason).
    - Async scheduler: ``queue_depth_peak``, ``batched_requests``,
      ``batch_width_hist``, ``queue_full_events``, ``inline_dispatches``,
      ``queued_dispatches``, ``lock_wait_ns``, ``donation_refusals``,
      ``sched_shards``, ``per_shard``, ``stolen_batch_items``, ``window_holds``,
      ``window_widened``, ``window_hold_ns`` and ``pressure``.
    - Lifecycle ledger: ``expired_requests``, ``shed_requests``,
      ``cancelled_requests``, ``drain_rejects``, ``draining``,
      ``lifecycle_by_tenant``.
    - The port's CUDA graphs: ``graphs`` (captured and live), ``graph_pool_bytes``
      (the bytes their pools and static buffers hold), ``graph_captures``,
      ``graph_replays``, ``graph_capture_failures``.
    - The result cache (``result_cache`` with ``cache_hits``, ``cache_misses``,
      ``cache_bytes_saved``, ``cache_invalidations``) and the forensics plane's
      per-tenant cost meters (``tenant_cost``).

    ``top > 0`` adds ``top_signatures``: the N hottest programs by lifetime replay
    count, each ``{"label", "hits", "compile_s"}`` (ties by label)."""
    totals = _stats.totals()
    stats = {
        "hits": totals["hits"],
        "misses": totals["misses"],
        "retraces": totals["retraces"],
        "programs": len(_programs),
        "interior_outputs": totals["interior_outputs"],
        "reexec_avoided": totals["reexec_avoided"],
        "reexecuted": totals["reexecuted"],
        "cse_hits": totals["cse_hits"],
        "donated_bytes": totals["donated_bytes"],
        "eager_fallbacks": totals["eager_fallbacks"],
        "lock_wait_ns": totals["lock_wait_ns"],
        "donation_refusals": totals["donation_refusals"],
        "graph_captures": totals["graph_captures"],
        "graph_replays": totals["graph_replays"],
        "graph_capture_failures": totals["graph_capture_failures"],
    }
    sched = _dispatch_scheduler
    if sched is not None:
        sstats = sched.stats()
        stats["queue_depth_peak"] = sstats["queue_depth_peak"]
        stats["batched_requests"] = sstats["batched_requests"]
        stats["batch_width_hist"] = sstats["batch_width_hist"]
        stats["queue_full_events"] = sstats["queue_full_events"]
        stats["inline_dispatches"] = sstats["inline_runs"]
        stats["queued_dispatches"] = sstats["submitted"]
        stats["shed_requests"] = sstats["lifecycle"]["shed"]
        stats["expired_requests"] = sstats["lifecycle"]["deadline_expired"]
        stats["cancelled_requests"] = sstats["lifecycle"]["cancelled"]
        stats["drain_rejects"] = sstats["drain_rejects"]
        stats["draining"] = sstats["draining"]
        stats["lifecycle_by_tenant"] = sstats["tenant_lifecycle"]
        stats["sched_shards"] = sstats["shards"]
        stats["per_shard"] = sstats["per_shard"]
        stats["stolen_batch_items"] = sstats["stolen_batch_items"]
        stats["window_holds"] = sstats["window_holds"]
        stats["window_widened"] = sstats["window_widened"]
        stats["window_hold_ns"] = sstats["window_hold_ns"]
        stats["pressure"] = _pressure_block(sstats["per_shard"])
    else:
        stats.update({
            "queue_depth_peak": 0, "batched_requests": 0, "batch_width_hist": {},
            "queue_full_events": 0, "inline_dispatches": 0, "queued_dispatches": 0,
            "shed_requests": 0, "expired_requests": 0, "cancelled_requests": 0,
            "drain_rejects": 0, "draining": False, "lifecycle_by_tenant": {},
            "sched_shards": _knobs.sched_shards, "per_shard": [],
            "stolen_batch_items": 0, "window_holds": 0, "window_widened": 0,
            "window_hold_ns": 0, "pressure": _pressure_block([]),
        })
    rc = _result_cache.stats()
    stats["result_cache"] = rc
    stats["cache_hits"] = rc["hits"]
    stats["cache_misses"] = rc["misses"]
    stats["cache_bytes_saved"] = rc["bytes_saved"]
    stats["cache_invalidations"] = rc["invalidations"]
    # per-tenant cost meters (forensics plane): empty until armed; the fold over
    # tenants reconciles exactly with forensics.totals()
    stats["tenant_cost"] = forensics.tenant_cost()
    with _lock:
        stats["quarantined"] = dict(_quarantined)
        graphs = [e._graph for e in _programs.values() if e is not UNSUPPORTED and e._graph is not None]
    stats["graphs"] = len(graphs)
    stats["graph_pool_bytes"] = sum(g.pool_bytes for g in graphs)
    if top > 0:
        with _lock:
            progs = [(key, entry) for key, entry in _programs.items() if entry is not UNSUPPORTED]
        progs.sort(key=lambda item: (-item[1].hits, item[1].label or _key_label(item[0])))
        stats["top_signatures"] = [
            {"label": entry.label or _key_label(key), "hits": entry.hits, "compile_s": round(entry.compile_s, 6)}
            for key, entry in progs[:top]
        ]
    return stats


def reset_executor_stats() -> None:
    """Zero the global counters and the scheduler telemetry. The program table and
    the per-signature lifetime tallies behind ``executor_stats(top=N)`` are kept."""
    _stats.reset()
    sched = _dispatch_scheduler
    if sched is not None:
        sched.reset_stats()
    _result_cache.reset_stats()


def clear_executor_cache() -> None:
    """Drop every cached program (and its CUDA graph), the warm-up counts, the
    result-type cache and every result-cache entry, reset all statistics, and
    re-read the knobs."""
    with _lock:
        _programs.clear()
        _seen.clear()
        _quarantined.clear()
    with _aval_lock:
        _aval_cache.clear()
    _result_cache.clear()
    reset_executor_stats()
    reload_env_knobs()


# ------------------------------------------------------------------ diagnostics glue
# Signature keys are positional tuples; these name the positions per dispatch
# family so a cache miss can be explained.
_KEY_COMPONENTS: Dict[str, Tuple[str, ...]] = {
    "b.log": ("family", "operation", "kwargs", "out_shape", "out_split", "device",
              "operand_avals", "where", "out"),
    "l": ("family", "operation", "kwargs", "operand_aval", "gshape", "split", "device", "out"),
    "r": ("family", "operation", "operand_aval", "gshape", "split", "axis", "keepdims",
          "device", "collective", "out"),
    "c": ("family", "operation", "operand_aval", "gshape", "split", "axis", "accum_dtype",
          "device", "collective", "out"),
    "defer": ("family", "device", "gshape", "split", "graph", "outputs"),
}


def _op_label(operation) -> str:
    name = getattr(operation, "__name__", None)
    return name if name else repr(operation)


def _key_label(key) -> str:
    """A compact label for a signature key: dispatch family + op name."""
    if not isinstance(key, tuple) or not key:
        return repr(key)
    tag = key[0]
    if tag == "defer" and len(key) >= 5 and isinstance(key[4], tuple):
        return f"defer:[{len(key[4])}]"
    if tag in _KEY_COMPONENTS and len(key) >= 2:
        return f"{tag}:{_op_label(key[1])}"
    return repr(tag)


def _miss_reason(key) -> str:
    """Explain a cache miss: the signature components that differ from the nearest
    cached key of the same family (diagnostics only)."""
    if not isinstance(key, tuple) or not key:
        return "uncategorised signature"
    n = _seen.get(key)
    if n is not None:
        return f"warm-up (seen {n + 1} of threshold {jit_threshold()})"
    tag = key[0]
    names = _KEY_COMPONENTS.get(tag)
    best_diff: Optional[Tuple[int, ...]] = None
    scanned = 0
    for cached in reversed(_programs):
        scanned += 1
        if scanned > 256:
            break
        if not isinstance(cached, tuple) or len(cached) != len(key) or cached[0] != tag:
            continue
        diff = tuple(i for i in range(1, len(key)) if cached[i] != key[i])
        if best_diff is None or len(diff) < len(best_diff):
            best_diff = diff
            if len(diff) <= 1:
                break
    if best_diff is None:
        return f"first {tag!r} signature seen"
    if not best_diff:
        return "evicted signature recompiled"
    if names:
        changed = ", ".join(names[i] if i < len(names) else f"component[{i}]" for i in best_diff)
    else:
        changed = ", ".join(f"component[{i}]" for i in best_diff)
    return f"changed vs nearest cached signature: {changed}"


_PY_SCALAR_TYPES = frozenset((bool, int, float, complex))


def kwargs_sig(kwargs: dict):
    """A hashable signature of an op's ``fn_kwargs``, or :data:`UNSUPPORTED`."""
    if not kwargs:
        return ()
    try:
        items = tuple(sorted(kwargs.items()))
        hash(items)
    except TypeError:
        return UNSUPPORTED
    return items


def operand_sig(x):
    """The abstract signature of one program operand: a tensor (or a future of one)
    keys on (shape, dtype); a scalar on its *type* (two Python floats share a
    program, a ``np.float32`` gets its own, a bool is never an int)."""
    t = type(x)
    if t in _PY_SCALAR_TYPES:
        return ("s", t.__name__)
    if isinstance(x, (torch.Tensor, PendingValue)):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, np.ndarray):
        return (x.shape, x.dtype, "np")
    if isinstance(x, (np.number, np.bool_)):
        return ("s", x.dtype)
    return ("s", type(x).__name__)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


@contextlib.contextmanager
def _on_device(device):
    """Enter ``device`` on this thread (a scheduler thread runs work of any card)."""
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def _first_device(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


class _Graph:
    """A captured CUDA graph of one program's plain variant: static input buffers
    (tensor leaves, and one 0-d buffer for each scalar at each dtype it is used
    in), the static outputs in the graph's pool, and a lock that serialises
    replays (copy in, replay, copy out)."""

    __slots__ = ("graph", "static_in", "static_scalars", "static_out", "single", "pool_bytes", "lock")


class _Program:
    """One cached dispatch program: a closure plus its per-variant bookkeeping.

    ``donate_index`` names the trailing ``out=`` buffer argument. Variants (plain,
    ``out=``-donating, each leaf-donation mask, each batch width) are "built" at
    their first call, which counts a retrace as heat_tpu's trace does.
    ``collective`` marks a body that issues a collective: it runs inline only.
    ``capturable`` marks a fused chain the card may capture in a CUDA graph;
    ``scalar_uses`` lists the (leaf position, dtype) pairs its scalars are used
    at. Telemetry: ``label``, ``hits`` (lifetime replays), ``compile_s`` (first-call
    wall time), ``ewma_s`` (replay service-time EWMA, behind ``HEAT_TPU_SHED``).

    Persistent compile cache: ``spec`` is the JSON-able replay description the
    miss site captured (heat_tpu's dict for the same signature; None when the
    signature cannot be described portably), ``fingerprint`` its content hash
    (computed lazily), ``aot_loaded`` whether the program came from a loaded
    artifact (never in the port: see :mod:`._compile_cache`)."""

    __slots__ = (
        "body", "donate_index", "meta", "label", "hits", "compile_s",
        "_variants", "_seen", "_batched", "failures", "proven", "ewma_s",
        "collective", "capturable", "scalar_uses", "_graph", "_graph_tried",
        "spec", "fingerprint", "aot_loaded",
    )

    def __init__(self, body, donate_index, meta, opts=None):
        opts = opts or {}
        self.body = body
        self.donate_index = donate_index
        self.meta = meta
        self.label = None
        self.hits = 0
        self.compile_s = 0.0
        self._variants = None  # leaf-donation masks seen
        self._seen = set()     # plain / out-donating variants seen
        self._batched = None   # batch widths seen
        self.failures = 0
        self.proven = False
        self.ewma_s = 0.0
        self.collective = bool(opts.get("collective", False))
        self.capturable = bool(opts.get("capturable", False))
        self.scalar_uses = tuple(opts.get("scalar_uses", ()))
        self._graph: Optional[_Graph] = None
        self._graph_tried = False
        self.spec = None
        self.fingerprint = None
        self.aot_loaded = False

    def _lifecycle_check(self) -> None:
        """Admission checkpoint for staged dispatches: an ambient deadline already
        passed raises ``DeadlineExceeded``; with ``HEAT_TPU_SHED=1`` a budget the
        service-time EWMA cannot fit raises ``Shed``."""
        dl = profiler.current_deadline()
        if dl is None:
            return
        now = time.monotonic()
        if now >= dl:
            if forensics._enabled:
                forensics.note_admission("staged", "deadline-expired", dl - now)
            raise resilience.DeadlineExceeded(f"deadline passed before dispatch ({self.label or 'program'})")
        if _knobs.shed and self.ewma_s > 0.0 and now + self.ewma_s >= dl:
            if forensics._enabled:
                forensics.note_admission("staged", "shed", dl - now)
            raise resilience.Shed(
                f"admission control: estimated service time {self.ewma_s * 1e3:.2f} ms exceeds the "
                f"remaining deadline budget ({self.label or 'program'})"
            )
        if forensics._enabled:
            forensics.note_admission("staged", "admitted", dl - now)

    def _first_of(self, variant, table: str) -> bool:
        """Whether this call is the first of ``variant`` (and so "builds" it: a
        counted retrace); decided under the executor lock so racing first calls
        build once."""
        seen = getattr(self, table)
        if seen is not None and variant in seen:
            return False
        with _tlock:
            seen = getattr(self, table)
            if seen is None:
                seen = set()
                setattr(self, table, seen)
            if variant in seen:
                return False
            if resilience._armed:
                # the deterministic hook for injected build failures
                resilience.maybe_fault("executor.compile")
            seen.add(variant)
            _stats.retraces += 1
            return True

    def __call__(self, *args, donate: bool = False, donate_leaves: Tuple[int, ...] = ()):
        if profiler._deadline_seen:
            self._lifecycle_check()
        if resilience._armed:
            # every program call is one countable "executor.execute" event; the
            # fault fires before any launch, so every argument is still intact
            resilience.maybe_fault("executor.execute")
        donating = donate and self.donate_index is not None
        rkey = None
        if _result_cache._enabled and not donating and not donate_leaves and self.donate_index is None:
            # cross-request result memoization (HEAT_TPU_RESULT_CACHE=1): the
            # plain variant is a pure function of (fingerprint, input digest), so
            # a validated hit IS the execution
            rkey, rwhy = _result_key_explained(self, args)
            if rkey is not None:
                cached = _result_cache.lookup(rkey, _tenant_or_none())
                if cached is not _result_cache.MISS:
                    if forensics._enabled:
                        forensics.note_result_cache("hit", nbytes=_result_cache.result_nbytes(cached))
                    return cached
                if forensics._enabled:
                    forensics.note_result_cache("miss")
            elif forensics._enabled:
                forensics.note_result_cache("bypass", rwhy)
        elif forensics._enabled:
            forensics.note_result_cache("bypass", "cache-off" if not _result_cache._enabled else "donation")
        if donate_leaves:
            variants = self._variants
            if variants is not None and donate_leaves not in variants and len(variants) >= _MAX_DONATE_VARIANTS:
                donate_leaves = ()  # variant table full: run undonated
        if donate_leaves:
            first = self._first_of(donate_leaves, "_variants")
        else:
            first = self._first_of("out" if donating else "plain", "_seen")
            if first and not donating and self.donate_index is None and _compile_cache.armed():
                # the persistent cache's first-call hook: the port loads no artifact
                # (None), but an indexed blob is verified and the outcome recorded
                _compile_cache.load_program(self)
        t0 = time.perf_counter()
        if profiler._active:
            with profiler.scope("compile" if first else "execute", self.label or "program"):
                out = self._run(args, first, donating, donate_leaves)
        else:
            out = self._run(args, first, donating, donate_leaves)
        dt = time.perf_counter() - t0
        if first:
            self.compile_s += dt
            if diagnostics._enabled:
                diagnostics.record_compile(self.label or "program", dt)
            if forensics._enabled:
                forensics.note_program(self.label or "program", dt, "compile")
                forensics.note_compile_cache("miss" if _compile_cache.armed() else "off")
        else:
            self._note_service(dt)
            if forensics._enabled:
                forensics.note_program(self.label or "program", dt, "execute")
        self.proven = True
        if rkey is not None:
            # memoised only after a successful plain-path execution
            _result_cache.store(rkey, out, _tenant_or_none())
        return out

    def _run(self, args, first: bool, donating: bool, donate_leaves: Tuple[int, ...]):
        if donating:
            # the out= buffer (trailing argument) receives the result in its storage
            value = self.body(*args)
            buf = args[self.donate_index]
            buf.copy_(value)
            return buf
        if donate_leaves:
            return self._donate_into(self.body(*args), args, donate_leaves)
        graph = self._graph
        if graph is not None:
            return self._replay(graph, args)
        out = self.body(*args)
        if first and self.capturable and not self._graph_tried:
            self._graph_tried = True
            self._capture(args)
        return out

    def _donate_into(self, outs, args, donate_leaves):
        """Write each output into a donated leaf of the same shape and dtype (one
        leaf per output, as XLA aliases one donated buffer per output slot)."""
        single = not isinstance(outs, tuple)
        outs = [outs] if single else list(outs)
        free = list(donate_leaves)
        for k, o in enumerate(outs):
            for j in free:
                leaf = args[j]
                if leaf.shape == o.shape and leaf.dtype == o.dtype:
                    leaf.copy_(o)
                    outs[k] = leaf
                    free.remove(j)
                    break
        return outs[0] if single else tuple(outs)

    # ---------------------------------------------------------------- CUDA graphs
    def _capture(self, args) -> None:
        """Capture the plain variant in a CUDA graph (after the eager warm-up run
        of this call): on a side stream, ``capture_error_mode="thread_local"``
        since other threads go on launching. A body that cannot be captured (a
        host sync, a data-dependent shape) leaves the program graph-less,
        counted in ``graph_capture_failures``."""
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if not tensors or any(not t.is_cuda or t.requires_grad for t in tensors):
            return
        device = tensors[0].device
        with _lock:
            live = [e._graph for e in _programs.values() if e is not UNSUPPORTED and e._graph is not None]
        if len(live) >= _MAX_GRAPHS or sum(g.pool_bytes for g in live) >= _MAX_GRAPH_BYTES:
            return
        g = _Graph()
        try:
            with _capture_lock, torch.cuda.device(device):
                g.static_in = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                g.static_scalars = {
                    (j, dt): torch.full((), args[j].item() if isinstance(args[j], np.generic) else args[j],
                                        dtype=dt, device=device)
                    for j, dt in self.scalar_uses
                }
                in_bytes = sum(_nbytes(t) for t in g.static_in) + sum(_nbytes(t) for t in g.static_scalars.values())
                current = torch.cuda.current_stream(device)
                side = _side_stream(device)
                side.wait_stream(current)
                before = torch.cuda.memory_reserved(device)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outs = self.body(*g.static_in, scalar_slots=g.static_scalars)
                    except BaseException:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                current.wait_stream(side)
                g.graph = graph
                g.single = not isinstance(outs, tuple)
                g.static_out = (outs,) if g.single else tuple(outs)
                g.pool_bytes = in_bytes + max(0, torch.cuda.memory_reserved(device) - before)
                g.lock = threading.Lock()
        except Exception as exc:
            _stats.graph_capture_failures += 1
            if diagnostics._enabled:
                diagnostics.record_fallback(
                    "executor.graph_capture", f"{self.label}: {type(exc).__name__}: {exc}"
                )
            return
        self._graph = g
        _stats.graph_captures += 1

    def _replay(self, g: _Graph, args):
        """Copy the inputs into the graph's static buffers, replay it, and copy the
        outputs out of its pool before the next replay can overwrite them; all on
        the current stream, under the graph's lock."""
        with g.lock:
            for buf, a in zip(g.static_in, args):
                if isinstance(buf, torch.Tensor):
                    buf.copy_(a)
            for (j, _dt), buf in g.static_scalars.items():
                a = args[j]
                buf.fill_(a.item() if isinstance(a, np.generic) else a)
            g.graph.replay()
            outs = tuple(o.clone() for o in g.static_out)
        _stats.graph_replays += 1
        return outs[0] if g.single else outs

    def _note_service(self, dt: float, items: int = 1) -> None:
        """Fold one replay's wall time into the service-time EWMA and, while the
        profiler collects, into the ``service.<label>`` histogram."""
        per = dt / items
        prev = self.ewma_s
        self.ewma_s = per if prev <= 0.0 else prev + 0.25 * (per - prev)
        if profiler._active:
            profiler.observe(f"service.{self.label or 'program'}", per)

    def call_batched(self, width: int, array_pos: Tuple[int, ...], scalar_pos: Tuple[int, ...],
                     flat_arrays: Sequence, scalars: Sequence, reqs: Optional[Sequence] = None) -> Tuple:
        """Run ``width`` same-signature calls as ONE batched call: each leaf
        position's ``width`` tensors are stacked along a new leading axis; a fused
        (elementwise) plan runs once on the stacks, a staged one-op program through
        ``torch.func.vmap``. Returns a flat tuple, item-major, ``n_outs`` entries
        per item; each item's result is bit-equal to its single call."""
        first = self._first_of(width, "_batched")
        if resilience._armed:
            resilience.maybe_fault("executor.execute")
        n_arr = len(array_pos)
        label = f"{self.label or 'program'}[x{width}]"
        t0 = time.perf_counter()
        ctx = profiler.scope("compile" if first else "execute", label) if profiler._active else contextlib.nullcontext()
        t_f = time.perf_counter() if forensics._enabled else 0.0
        with ctx:
            stacked = [torch.stack([flat_arrays[i * n_arr + k] for i in range(width)]) for k in range(n_arr)]
            argv: List[Any] = [None] * (len(array_pos) + len(scalar_pos))
            for k, j in enumerate(scalar_pos):
                argv[j] = scalars[k]
            if self.meta == "defer":
                for k, j in enumerate(array_pos):
                    argv[j] = stacked[k]
                outs = self.body(*argv)
            else:
                def one(*xs):
                    a = list(argv)
                    for k, j in enumerate(array_pos):
                        a[j] = xs[k]
                    return self.body(*a)

                outs = torch.func.vmap(one)(*stacked)
            if not isinstance(outs, tuple):
                outs = (outs,)
            out = tuple(o[i] for i in range(width) for o in outs)
        if forensics._enabled:
            forensics.note_batch_execute(list(reqs or ()), self.label or "program", time.perf_counter() - t_f)
        dt = time.perf_counter() - t0
        if first:
            self.compile_s += dt
            if diagnostics._enabled:
                diagnostics.record_compile(label, dt)
        else:
            self._note_service(dt, items=width)
        self.proven = True
        return out


def _result_key_explained(prog: "_Program", args) -> Tuple[Optional[Tuple[str, Tuple]], Optional[str]]:
    """The result-cache key ``(fingerprint, input digest)`` for a plain call of
    ``prog`` over ``args``, or ``(None, reason)`` when the call is uncacheable:
    ``no-replay-spec``, ``rng-label`` or ``undigestable-operand`` (the forensic
    record's bypass label). The fingerprint is the compile cache's, memoised on the
    program."""
    spec = prog.spec
    if spec is None:
        return None, "no-replay-spec"
    if _result_cache.uncacheable_label(prog.label):
        return None, "rng-label"
    digest = _result_cache.digest_args(args)
    if digest is None:
        return None, "undigestable-operand"
    fp = prog.fingerprint
    if fp is None:
        fp = prog.fingerprint = _compile_cache.fingerprint(spec)
    return (fp, digest), None


def _result_key(prog: "_Program", args) -> Optional[Tuple[str, Tuple]]:
    """The key half of :func:`_result_key_explained`."""
    return _result_key_explained(prog, args)[0]


_capture_lock = threading.Lock()
_side_streams: Dict[Any, Any] = {}


def _side_stream(device):
    s = _side_streams.get(device)
    if s is None:
        s = _side_streams[device] = torch.cuda.Stream(device=device)
    return s


def lookup(key, build: Callable[[], Any], label: Optional[str] = None,
           spec: Optional[Callable[[], Optional[dict]]] = None) -> Optional[_Program]:
    """The cached :class:`_Program` for ``key``, building it on miss.

    ``build()`` returns ``(body, donate_index, meta[, opts])`` or
    :data:`UNSUPPORTED`; both are cached, so an eager-only signature is rejected in
    O(1) later. Returns None for unsupported (and below the jit threshold).
    ``spec`` (a zero-arg callable, evaluated only on a successful build) returns
    the JSON-able replay description behind the compile cache, the warmup and the
    result cache, or None; a spec that raises is a counted ``executor.warmup_spec``
    gap, never a dispatch failure."""
    with _tlock:
        entry = _programs.get(key)
        if entry is not None:
            _stats.hits += 1
            if entry is not UNSUPPORTED:
                entry.hits += 1
            _programs.move_to_end(key)  # LRU eviction
            return None if entry is UNSUPPORTED else entry
        if diagnostics._enabled:
            diagnostics.record_dispatch_event("miss", label or _key_label(key), _miss_reason(key))
        threshold = jit_threshold()
        if threshold > 1:
            n = _seen.get(key, 0) + 1
            if n < threshold:
                # still warming up: the caller takes the eager path
                if len(_seen) >= _MAX_SEEN:
                    for stale in list(_seen)[: _MAX_SEEN // 2]:
                        del _seen[stale]
                _seen.pop(key, None)
                _seen[key] = n
                _stats.misses += 1
                return None
            _seen.pop(key, None)
        built = build()
        if built is UNSUPPORTED:
            entry = UNSUPPORTED
        else:
            entry = _Program(*built)
            entry.label = label or _key_label(key)
            if spec is not None:
                try:
                    entry.spec = spec()
                except Exception as exc:
                    entry.spec = None
                    if diagnostics._enabled:
                        diagnostics.record_fallback(
                            "executor.warmup_spec", f"{entry.label}: {type(exc).__name__}: {exc}"
                        )
        while len(_programs) >= _MAX_PROGRAMS:
            _programs.popitem(last=False)
        _programs[key] = entry
        _stats.misses += 1
        return None if entry is UNSUPPORTED else entry


# ------------------------------------------------------------- failure hardening
_quarantined: "OrderedDict[str, str]" = OrderedDict()
_MAX_QUARANTINED = 64


def quarantine_threshold() -> int:
    """Failures of one signature before it is quarantined to the eager path
    (``HEAT_TPU_QUARANTINE_AFTER``, default 3)."""
    return _knobs.quarantine_after


def fallback_after_failure(key, prog: "_Program", exc: BaseException, donated: Sequence = ()) -> bool:
    """Account one program failure and decide whether the eager path may re-run the
    op.

    Returns False (the caller re-raises) for a request-lifecycle rejection
    (``DeadlineExceeded`` / ``Shed``, counted once in the lifecycle ledger: the
    request ran out of budget, so there is no replay and no quarantine).
    Otherwise the failure is counted (``eager_fallbacks``) and recorded, and the
    signature is quarantined after :func:`quarantine_threshold` failures. A donated
    buffer is written only after the program's body succeeded, so a failed call
    leaves every argument intact and the eager replay is always possible
    (``donated`` is accepted for heat_tpu's signature)."""
    if isinstance(exc, (resilience.DeadlineExceeded, resilience.Shed)):
        kind = "deadline_expired" if isinstance(exc, resilience.DeadlineExceeded) else "shed"
        if not getattr(exc, "_ht_ledgered", False):
            _get_scheduler().note_lifecycle(kind, _tenant_or_none())
            if forensics._enabled:
                forensics.note_event("typed-failure", f"{kind}: {prog.label or _key_label(key)}")
        return False
    if isinstance(exc, (resilience.PeerFailed, resilience.CollectiveTimeout)):
        # a supervision abort delivered into a queued execution: typed re-raise,
        # no eager replay (the signature is healthy, the cluster aborted) and no
        # quarantine — the shed was ledgered at the shard
        return False
    label = prog.label or _key_label(key)
    phase = "execute" if prog.proven else "compile"
    with _lock:
        _stats.eager_fallbacks += 1
        prog.failures += 1
        reason = f"{phase} failure {prog.failures}: {type(exc).__name__}: {exc}"
        if prog.failures >= quarantine_threshold() and _programs.get(key) is prog:
            _programs[key] = UNSUPPORTED
            while len(_quarantined) >= _MAX_QUARANTINED:
                _quarantined.popitem(last=False)
            _quarantined[label] = reason
            diagnostics.record_resilience_event(f"executor.{phase}", "quarantine", f"{label}: {reason}")
    if diagnostics._enabled:
        diagnostics.record_fallback(f"executor.{phase}", f"{label}: {type(exc).__name__}: {exc}")
    if forensics._enabled:
        # the caller re-runs the op eagerly: the record's eager-replay leg
        forensics.note_event("eager-replay", f"{label}: {type(exc).__name__}")
    return True


# ------------------------------------------------------------- deferred expression graph

# Past this many unforced nodes a graph spills: the pending operands are forced
# first and a fresh graph starts.
_MAX_FUSED_NODES = 256

# (id(op), kwargs sig, operand sigs) -> (op, (shape, dtype) | UNSUPPORTED): the
# result type of an op resolved once per signature on meta tensors. The stored op
# pins its id for the entry's lifetime. Hits read without a lock (a dict read); misses
# insert and evict the oldest half under its own small lock.
_aval_cache: Dict[Any, Any] = {}
_aval_lock = threading.Lock()
_MAX_AVALS = 4096


class Deferred:
    """A pending node in the executor's fused expression graph.

    ``operands`` entries are ``("d", Deferred)``, ``("a", torch.Tensor)`` or
    ``("s", scalar)``; every tensor operand is a local tensor of one aligned
    ``(gshape, split)`` family, so the node evaluates element by element.
    ``shape``/``dtype``/``device`` describe the local result. ``value`` memoises the
    forced result (set when the node is forced as a root or emitted as an interior
    output), so the node becomes a plain leaf in any later graph. ``wref``
    weak-references the wrapping ``DNDarray`` (:func:`note_wrapped`); ``executed``
    marks a node that ran inside some program. ``versions`` holds the version
    counter of each tensor operand at defer time, and ``consumers`` weak-references
    the nodes built on this one (both guard in-place writes, see
    :func:`settle_readers`)."""

    __slots__ = ("operation", "fn_kwargs", "operands", "shape", "dtype", "device",
                 "gshape", "split", "comm", "size", "value", "wref", "executed",
                 "req", "deadline", "versions", "consumers", "__weakref__")

    def __init__(self, operation, fn_kwargs, operands, shape, dtype, device, gshape, split, comm, size):
        self.operation = operation
        self.fn_kwargs = fn_kwargs
        self.operands = operands
        self.shape = shape
        self.dtype = dtype
        self.device = device
        self.gshape = gshape
        self.split = split
        self.comm = comm
        self.size = size
        self.value = None
        self.wref = None
        self.executed = False
        self.req = None
        self.deadline = None
        self.versions = None
        self.consumers = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def force(self):
        """Materialise this node (and everything it needs) as one cached program
        run. A memoised value is returned as-is; a :class:`PendingValue` (a force
        in flight) is resolved — the wait covers the program's *launch* only.
        Resolution happens outside the executor lock."""
        v = self.value
        if v is None or (isinstance(v, PendingValue) and v.failed()):
            if v is not None:
                self.value = None  # failed dispatch: this force is the retry
            _force_graph((self,))
            v = self.value
            if v is None:
                _force_graph((self,))
                v = self.value
        else:
            _stats.reexec_avoided += 1
        if isinstance(v, PendingValue):
            try:
                if profiler._active and not v.done():
                    with profiler.scope("wait", "force:queue_wait", req=self.req):
                        v = v.resolve()
                else:
                    v = v.resolve()
            except BaseException:
                if self.value is v:
                    self.value = None
                raise
            self.value = v
        return v


def note_wrapped(node: Deferred, holder) -> None:
    """Register ``holder`` (a DNDarray) as the live wrapper of ``node``: while it
    lives (and still holds the node), any program that executes the node emits
    its value. The reference is weak."""
    node.wref = weakref.ref(holder)


# -- in-place write guard: storage -> weakrefs of nodes that will read it
_readers: Dict[int, list] = {}
_readers_lock = threading.Lock()
_readers_adds = 0


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _note_reader(t: torch.Tensor, node: Deferred) -> None:
    global _readers_adds
    key = _storage_key(t)
    with _readers_lock:
        _readers.setdefault(key, []).append(weakref.ref(node))
        _readers_adds += 1
        if _readers_adds >= 4096:
            _readers_adds = 0
            for k in list(_readers):
                live = [w for w in _readers[k] if _unsettled(w())]
                if live:
                    _readers[k] = live
                else:
                    del _readers[k]


def _unsettled(node) -> bool:
    """A reader still to run (or running): not forced, or a future not yet fulfilled.
    A node that ran inside a program without being emitted is settled: nothing can
    read it any more but this registry, which must not revive it."""
    if node is None:
        return False
    v = node.value
    return (v is None and not node.executed) or (isinstance(v, PendingValue) and not v.done())


def settle_readers(t: torch.Tensor) -> None:
    """Before ``t``'s storage is handed out for a possible in-place write, force
    every pending node that reads it and wait for every in-flight one: a deferred
    read must see the value the op was issued on. Called by ``DNDarray.larray``
    while any reader is registered (one dict read otherwise)."""
    key = _storage_key(t)
    with _readers_lock:
        refs = _readers.pop(key, None)
    if not refs:
        return
    for w in refs:
        node = w()
        if _unsettled(node):
            with contextlib.suppress(Exception):
                node.force()


def defer_node(operation, fn_kwargs, operands, gshape, split, comm):
    """Build a :class:`Deferred` for ``operation(*operands, **fn_kwargs)``, or
    :data:`UNSUPPORTED` when the op cannot join a fused graph (unhashable kwargs,
    a result that is not element by element, a complex result, operands on
    different devices, a tensor that requires grad).

    The result's shape and dtype come from running ``operation`` once per
    signature on ``meta`` tensors and must equal the operands' local shape.
    Operation identity is keyed on ``id(operation)``; every cache that stores such
    a key also holds the operation strongly, so the id cannot be recycled while
    the key lives."""
    kwsig = kwargs_sig(fn_kwargs)
    if kwsig is UNSUPPORTED:
        return UNSUPPORTED
    phys_shape = None
    device = None
    sigs = []
    for kind, v in operands:
        if kind == "s":
            sigs.append(operand_sig(v))
            continue
        if kind == "a" and v.requires_grad:
            return UNSUPPORTED  # autograd records at call time: stay eager
        shape, dtype = tuple(v.shape), v.dtype
        dev = v.device
        if phys_shape is None:
            phys_shape, device = shape, dev
        elif shape != phys_shape or dev != device:
            return UNSUPPORTED
        sigs.append(("t", shape, dtype))
    if phys_shape is None:
        return UNSUPPORTED
    akey = (id(operation), kwsig, tuple(sigs))
    entry = _aval_cache.get(akey)
    if entry is not None:
        aval = entry[1]
    else:
        try:
            args = [v if kind == "s" else torch.empty(v.shape, dtype=v.dtype, device="meta") for kind, v in operands]
            out = operation(*args, **fn_kwargs)
            aval = (tuple(out.shape), out.dtype) if isinstance(out, torch.Tensor) else UNSUPPORTED
        except Exception as exc:
            if diagnostics._enabled:
                diagnostics.record_fallback(
                    "dispatch.defer", f"{_op_label(operation)}: {type(exc).__name__}: {exc}"
                )
            aval = UNSUPPORTED
        with _aval_lock:
            if len(_aval_cache) >= _MAX_AVALS:
                for stale in list(_aval_cache)[: _MAX_AVALS // 2]:
                    del _aval_cache[stale]
            _aval_cache[akey] = (operation, aval)
    if aval is UNSUPPORTED:
        return UNSUPPORTED
    shape, dtype = aval
    if shape != phys_shape or dtype.is_complex:
        return UNSUPPORTED
    size = 1
    for kind, v in operands:
        if kind == "d" and v.value is None:
            size += v.size
    if size > _MAX_FUSED_NODES:
        # per-edge sums count a shared node once per path: recount unique nodes
        size = _pending_count(operands, _MAX_FUSED_NODES)
    if size > _MAX_FUSED_NODES:
        # the graph grew past the fusion window: materialise ALL pending operands
        # through ONE multi-output program and start a fresh graph
        pending, seen = [], set()
        for kind, v in operands:
            if kind == "d" and v.value is None and id(v) not in seen:
                seen.add(id(v))
                pending.append(v)
        _force_graph(tuple(pending))
        operands = tuple(
            ("a", v.value)
            if kind == "d" and v.value is not None and not isinstance(v.value, PendingValue)
            else (kind, v)
            for kind, v in operands
        )
        size = 1
    node = Deferred(operation, fn_kwargs, tuple(operands), shape, dtype, device, tuple(gshape), split, comm, size)
    versions = None
    for i, (kind, v) in enumerate(node.operands):
        if kind == "a":
            if versions is None:
                versions = [None] * len(node.operands)
            versions[i] = v._version
            _note_reader(v, node)
        elif kind == "d":
            if v.consumers is None:
                v.consumers = []
            v.consumers.append(weakref.ref(node))
    if versions is not None:
        node.versions = tuple(versions)
    if profiler.attribution_active():
        node.req = profiler.current_request()
    if profiler._deadline_seen:
        dl = profiler.current_deadline()
        if dl is not None:
            if time.monotonic() >= dl:
                # defer-time admission: a request already over its deadline dies at
                # its first op instead of building a graph it may never force
                _get_scheduler().note_lifecycle("deadline_expired", _tenant_or_none())
                if forensics._enabled:
                    forensics.note_admission("defer", "deadline-expired", dl - time.monotonic())
                raise resilience.DeadlineExceeded(f"deadline passed before defer of {_op_label(operation)}")
            node.deadline = dl
    return node


def _pending_count(operands, cap: int) -> int:
    """Exact count of unique unforced nodes under ``operands`` (+1 for the node
    being built), walking at most ``cap`` nodes."""
    seen = set()
    stack = [v for kind, v in operands if kind == "d" and v.value is None]
    count = 1
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        count += 1
        if count > cap:
            return count
        for kind, v in n.operands:
            if kind == "d" and v.value is None:
                stack.append(v)
    return count


def _force_graph(roots: Tuple[Deferred, ...]) -> None:
    """Force the graph under ``roots``: linearise it, look up / build ONE (possibly
    multi-output) program, run it, and memoise every emitted value. The serialized
    path (``HEAT_TPU_ASYNC_DISPATCH=0``) plans and runs under the executor lock; the
    async path plans under it and runs outside it (inline or queued)."""
    if profiler._active:
        req = next((r.req for r in roots if r.req is not None), None)
        with profiler.scope("force", f"force:{_op_label(roots[0].operation)}", req=req) as ctl:
            if not _force_graph_inner(roots):
                ctl["keep"] = False  # lost the plan race: nothing ran here
        return
    _force_graph_inner(roots)


def _roots_deadline(roots) -> Optional[float]:
    """The earliest deadline governing this force (roots' captures and the ambient
    one); None after one attribute read in a process that never armed one."""
    if not profiler._deadline_seen:
        return None
    dl = profiler.current_deadline()
    for r in roots:
        d = r.deadline
        if d is not None and (dl is None or d < dl):
            dl = d
    return dl


def _tenant_or_none() -> Optional[str]:
    """The ambient request tag for lifecycle accounting, or None."""
    return profiler.current_request_tag() if profiler.attribution_active() else None


def _force_graph_inner(roots: Tuple[Deferred, ...]) -> bool:
    """True when this call planned work; False when every root was already forced
    or in flight."""
    if supervision._aborted:
        # the executor's supervision checkpoint: once the abort sentinel is up, a
        # force is refused typed at admission; the nodes stay unforced
        abort = supervision.abort_error("executor.force")
        if abort is not None:
            _get_scheduler().note_lifecycle("shed", _tenant_or_none())
            raise abort
    deadline = _roots_deadline(roots)
    if deadline is not None:
        now = time.monotonic()
        if now >= deadline:
            # admission checkpoint: the rejection consumes the roots' deadlines
            # (the request was told), so a later force outside the expired scope
            # computes the same nodes normally
            for r in roots:
                r.deadline = None
            _get_scheduler().note_lifecycle("deadline_expired", _tenant_or_none())
            if forensics._enabled:
                forensics.note_admission("force", "deadline-expired", deadline - now)
            raise resilience.DeadlineExceeded(
                f"deadline passed before force admission ({_op_label(roots[0].operation)})"
            )
        if forensics._enabled:
            forensics.note_admission("force", "admitted", deadline - now)
    if async_dispatch_enabled():
        return _force_async(roots, deadline)
    _settle_pending_nodes(roots)
    with _tlock:
        return _force_sync_locked(roots, deadline)


def _settle_pending_nodes(roots) -> None:
    """Resolve every in-flight :class:`PendingValue` under ``roots`` (switching from
    async to serialized with forces in flight). Never under the executor lock."""
    stack = list(roots)
    seen = set()
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        v = node.value
        if isinstance(v, PendingValue):
            try:
                node.value = v.resolve()
            except BaseException:
                node.value = None
                raise
        elif v is None:
            stack.extend(v2 for kind, v2 in node.operands if kind == "d")


class _ForcePlan:
    """Everything :func:`_linearise` decided about one force."""

    __slots__ = (
        "root", "leaves", "leaf_donatable", "plan", "entry_sig",
        "entry_nodes", "arefs", "out_idxs", "root_idxs", "single", "key",
        "label", "gshape", "split", "device", "deadline",
    )


def _linearise(roots: Tuple[Deferred, ...]) -> Optional[_ForcePlan]:
    """Linearise the graph under ``roots`` into a :class:`_ForcePlan`: evaluation
    ordered entries, deduplicated leaves, the program key, and the emission and
    donation bookkeeping. Runs under the executor lock. Roots already forced (or
    in flight) are dropped; None means nothing is left to run.

    An interior entry is emitted (and memoised) when it is referenced by more than
    one entry, a live DNDarray still wraps one of its nodes, or a graph outside
    this plan holds one of its nodes (its refcount exceeds the plan's own
    references)."""
    live = tuple(r for r in roots if r.value is None)
    if len(live) != len(roots):
        _stats.reexec_avoided += len(roots) - len(live)
    if not live:
        return None
    roots = live
    leaves: list = []
    leaf_index: Dict[Any, int] = {}
    leaf_donatable: List[bool] = []
    entries: list = []
    entry_sig: list = []
    entry_nodes: List[List[Deferred]] = []
    node_index: Dict[int, int] = {}
    sig_index: Dict[Any, int] = {}
    in_refs: Dict[int, int] = {}
    drefs: Dict[int, int] = {}
    arefs: Dict[int, int] = {}
    memo_hits = 0
    cse_hits = 0

    def leaf_ref(value, donatable: bool):
        if type(value) not in _PY_SCALAR_TYPES and isinstance(value, (torch.Tensor, PendingValue)):
            k = ("a", id(value))
        else:
            try:
                # repr, not the value: equality would collapse distinct scalars
                # (-0.0 == 0.0, 1 == True) into one leaf
                k = ("s", type(value), repr(value))
            except Exception:
                k = ("s", id(value))
        idx = leaf_index.get(k)
        if idx is None:
            idx = len(leaves)
            leaf_index[k] = idx
            leaves.append(value)
            leaf_donatable.append(donatable)
        elif not donatable:
            leaf_donatable[idx] = False
        return ("L", idx, operand_sig(value))

    def visit(node: Deferred):
        nonlocal memo_hits, cse_hits
        idx = node_index.get(id(node))
        if idx is not None:
            return ("N", idx)
        refs = []
        for pos, (kind, v) in enumerate(node.operands):
            if kind == "d":
                drefs[id(v)] = drefs.get(id(v), 0) + 1
                vv = v.value
                if vv is not None and isinstance(vv, PendingValue) and vv.failed():
                    v.value = vv = None
                if vv is None:
                    refs.append(visit(v))
                else:
                    memo_hits += 1
                    refs.append(leaf_ref(vv, False))
            elif kind == "a":
                if v._version != node.versions[pos]:
                    raise RuntimeError(
                        f"a tensor read by a deferred {_op_label(node.operation)} was written in place after "
                        "the op was issued; write through DNDarray.larray, which settles pending reads first"
                    )
                arefs[id(v)] = arefs.get(id(v), 0) + 1
                refs.append(leaf_ref(v, True))
            else:
                refs.append(leaf_ref(v, False))
        sig = (id(node.operation), kwargs_sig(node.fn_kwargs), tuple(refs))
        idx = sig_index.get(sig)
        if idx is not None:
            cse_hits += 1
            entry_nodes[idx].append(node)
            node_index[id(node)] = idx
            return ("N", idx)
        if node.executed:
            _stats.reexecuted += 1
        last_ci = None
        for r in refs:
            if r[0] == "N":
                ci = r[1]
                if ci != last_ci:
                    in_refs[ci] += 1
                    last_ci = ci
        idx = len(entries)
        entries.append((node.operation, node.fn_kwargs, tuple(refs)))
        entry_sig.append(sig)
        entry_nodes.append([node])
        sig_index[sig] = idx
        node_index[id(node)] = idx
        in_refs[idx] = 0
        return ("N", idx)

    root_idxs = [visit(r)[1] for r in roots]
    root = roots[0]

    emit = set(root_idxs)
    for idx in range(len(entries)):
        if idx in emit:
            continue
        if in_refs[idx] > 1:
            emit.add(idx)
            continue
        for node in entry_nodes[idx]:
            w = node.wref
            if w is not None:
                holder = w()
                if holder is not None and holder._payload is node:
                    emit.add(idx)
                    break
            # the plan as the node's only holder: its ("d", node) operand tuples +
            # the entry_nodes list + the loop variable + getrefcount's argument
            if sys.getrefcount(node) > drefs.get(id(node), 0) + 3:
                emit.add(idx)
                break
    out_idxs = tuple(sorted(emit))

    pl = _ForcePlan()
    pl.root = root
    pl.leaves = leaves
    pl.leaf_donatable = leaf_donatable
    pl.plan = tuple(entries)
    pl.entry_sig = tuple(entry_sig)
    pl.entry_nodes = entry_nodes
    pl.arefs = arefs
    pl.out_idxs = out_idxs
    pl.root_idxs = root_idxs
    pl.single = len(out_idxs) == 1
    pl.gshape = root.gshape
    pl.split = root.split
    pl.device = root.device
    pl.key = ("defer", root.device, root.gshape, root.split, pl.entry_sig, out_idxs)
    pl.label = f"defer:{_op_label(pl.plan[0][0])}..{_op_label(pl.plan[-1][0])}[{len(pl.plan)}]"

    n_interior = len(out_idxs) - len(set(root_idxs))
    _stats.interior_outputs += n_interior
    _stats.reexec_avoided += memo_hits
    _stats.cse_hits += cse_hits
    if diagnostics._enabled:
        if n_interior:
            diagnostics.counter("executor.interior_outputs", n_interior)
        if memo_hits:
            diagnostics.counter("executor.reexec_avoided", memo_hits)
        if cse_hits:
            diagnostics.counter("executor.cse_collapses", cse_hits)
    return pl


def _scalar_uses(plan, leaves) -> tuple:
    """The (leaf position, compute dtype) pairs at which the plan's scalar leaves are
    used: a captured graph keeps one static 0-d buffer for each."""
    uses = set()
    for operation, _kw, refs in plan:
        ct = getattr(operation, "compute_dtype", None)
        if ct is None:
            continue
        for r in refs:
            if r[0] == "L" and not isinstance(leaves[r[1]], (torch.Tensor, PendingValue)):
                uses.add((r[1], ct))
    return tuple(sorted(uses, key=lambda u: (u[0], str(u[1]))))


def _plan_frees(plan, out_idxs) -> tuple:
    """For each plan entry, the interior values whose last reader it is: the run drops
    them there, so a chain holds about as much memory as eager execution does (and a
    captured graph's pool stays as small)."""
    last = {}
    for j, (_op, _kw, refs) in enumerate(plan):
        for r in refs:
            if r[0] == "N":
                last[r[1]] = j
    keep = set(out_idxs)
    frees = [[] for _ in plan]
    for i, j in last.items():
        if i not in keep:
            frees[j].append(i)
    return tuple(tuple(f) for f in frees)


def _run_plan(plan, out_idxs, single, leaf_vals, scalar_slots=None, deadline=None, label="", frees=None):
    """Run a linearised plan op by op, dropping each interior value after its last
    reader (``frees``). ``scalar_slots`` (a captured graph's static 0-d buffers)
    replaces each scalar leaf by its buffer of the consumer's compute dtype;
    ``deadline`` is checked between ops (the eager replay's checkpoint)."""
    vals = []
    for j, (operation, fn_kwargs, refs) in enumerate(plan):
        if deadline is not None and time.monotonic() >= deadline:
            raise resilience.DeadlineExceeded(
                f"deadline passed between ops of the eager replay ({label}, {len(vals)}/{len(plan)} ops done)"
            )
        args = []
        for r in refs:
            if r[0] == "L":
                v = leaf_vals[r[1]]
                if scalar_slots is not None and not isinstance(v, torch.Tensor):
                    v = scalar_slots[(r[1], operation.compute_dtype)]
                args.append(v)
            else:
                args.append(vals[r[1]])
        vals.append(operation(*args, **fn_kwargs))
        del args
        if frees is not None:
            for i in frees[j]:
                vals[i] = None
    outs = [vals[i] for i in out_idxs]
    return outs[0] if single else tuple(outs)


def _plan_build(pl: _ForcePlan):
    """The ``build`` callback of a plan's program. Closes over the plan TUPLE (not
    the _ForcePlan): the program pins the operations but not the nodes."""
    plan, out_idxs, single, leaves = pl.plan, pl.out_idxs, pl.single, pl.leaves

    def build():
        frees = _plan_frees(plan, out_idxs)
        opts = {"capturable": len(plan) >= 2, "scalar_uses": _scalar_uses(plan, leaves)}

        def body(*leaf_vals, scalar_slots=None):
            return _run_plan(plan, out_idxs, single, leaf_vals, scalar_slots, frees=frees)

        return body, None, "defer", opts

    return build


def _plan_spec(pl: _ForcePlan) -> Optional[dict]:
    """The JSON-able replay description of a fused-graph plan, heat_tpu's dict for
    the same graph (heat_tpu/core/_executor.py:2326): every operation by its jnp
    name (``_operations.JNP_OPS``), kwargs that survive JSON, tensor leaves by the
    global shape and dtype of their family (the port pads nothing), scalar leaves by
    value and type, the emission and root sets and the mesh. None when an operation
    has no jnp name or a leaf has no portable description (a pending value, a
    bfloat16 tensor): the signature is not warmup-coverable."""
    from . import _operations

    entries = []
    names = []
    for operation, fn_kwargs, refs in pl.plan:
        name = _operations.jnp_name(operation)
        if name is None:
            return None
        if fn_kwargs and json.loads(json.dumps(fn_kwargs)) != fn_kwargs:
            return None
        names.append(name)
        entries.append({"op": name, "kwargs": dict(fn_kwargs) if fn_kwargs else {},
                        "refs": [[r[0], r[1]] for r in refs]})
    leaves = []
    for leaf in pl.leaves:
        if isinstance(leaf, torch.Tensor):
            dt = _operations._np_dtype_str(leaf.dtype)
            if dt is None:
                return None
            leaves.append({"shape": list(pl.gshape), "dtype": dt})
        elif isinstance(leaf, (bool, int, float)):
            leaves.append({"scalar": leaf, "py": type(leaf).__name__})
        elif isinstance(leaf, (np.number, np.bool_)):
            leaves.append({"scalar": leaf.item(), "np": np.dtype(leaf.dtype).str})
        else:
            return None  # an in-flight value has no portable description
    return {
        "family": "defer",
        "label": f"defer:{names[0]}..{names[-1]}[{len(names)}]",
        "entries": entries,
        "leaves": leaves,
        "gshape": list(pl.gshape),
        "split": pl.split,
        "out_idxs": list(pl.out_idxs),
        "root_idxs": sorted(set(pl.root_idxs)),
        "mesh": _operations.mesh_spec(pl.root.comm),
    }


def _plan_replay_eager(pl: _ForcePlan) -> list:
    """Op-by-op replay of the plan: below the jit threshold, and as the no-data-loss
    fallback when a program fails. A deadline-bearing plan checks its budget
    between ops."""
    outs = _run_plan(pl.plan, pl.out_idxs, pl.single, pl.leaves, deadline=pl.deadline, label=pl.label,
                     frees=_plan_frees(pl.plan, pl.out_idxs))
    return [outs] if pl.single else list(outs)


def _pick_donations(pl: _ForcePlan, prog: _Program) -> Tuple[int, ...]:
    """Leaf positions safe and useful to donate: donatable per the plan, matching
    an output of the same shape and dtype (one per output), and proven sole-read
    (``sanitation.sanitize_leaf_donation``)."""
    if not any(pl.leaf_donatable):
        return ()
    from . import sanitation

    leaves = pl.leaves
    arefs = pl.arefs
    entry_nodes = pl.entry_nodes
    out_avals: Dict[Any, int] = {}
    for i in pl.out_idxs:
        aval = (tuple(entry_nodes[i][0].shape), entry_nodes[i][0].dtype)
        out_avals[aval] = out_avals.get(aval, 0) + 1
    picked = []
    for i in range(len(leaves)):
        # persistent refs when the plan is the leaf's last reader: its ("a", leaf)
        # operand tuples + the leaves list; the subscript temp is passed directly
        if not pl.leaf_donatable[i]:
            continue
        aval = (tuple(leaves[i].shape), leaves[i].dtype)
        if out_avals.get(aval, 0) > 0 and sanitation.sanitize_leaf_donation(leaves[i], arefs.get(id(leaves[i]), 0) + 1):
            out_avals[aval] -= 1
            picked.append(i)
    donate_idx = tuple(picked)
    variants = prog._variants
    if donate_idx and variants is not None and donate_idx not in variants and len(variants) >= _MAX_DONATE_VARIANTS:
        donate_idx = ()
    return donate_idx


def _memoise(pl: _ForcePlan, outs) -> None:
    for nodes in pl.entry_nodes:
        for node in nodes:
            node.executed = True
    for value, i in zip(outs, pl.out_idxs):
        for node in pl.entry_nodes[i]:
            node.value = value
            # consumers not yet run now read this tensor: guard it like a leaf
            cons = node.consumers
            if cons:
                for w in cons:
                    c = w()
                    if c is not None and c.value is None and not c.executed:
                        _note_reader(value, c)


def _tally_donated(pl: _ForcePlan, donate_idx: Tuple[int, ...]) -> None:
    """Account a SUCCESSFUL donating call's bytes (stats, diagnostics, profiler)."""
    donated = sum(_nbytes(pl.leaves[i]) for i in donate_idx)
    _stats.donated_bytes += donated
    if diagnostics._enabled:
        diagnostics.counter("executor.donated_leaf_bytes", donated)
    if profiler._active:
        profiler.record_counter("donated_bytes", _stats.total("donated_bytes"))


def _record_force_memory(pl: _ForcePlan, outs) -> None:
    live = sum(_nbytes(v) for v in pl.leaves)
    live += sum(_nbytes(o) for o in outs)
    profiler.record_force_memory(live)


def _force_sync_locked(roots: Tuple[Deferred, ...], deadline: Optional[float] = None) -> bool:
    """The serialized executor: plan, call and memoise under the lock."""
    pl = _linearise(roots)
    if pl is None:
        return False
    pl.deadline = deadline
    prog = lookup(pl.key, _plan_build(pl), label=pl.label, spec=lambda: _plan_spec(pl))
    if prog is None:
        try:
            outs = _plan_replay_eager(pl)
        except resilience.DeadlineExceeded:
            _get_scheduler().note_lifecycle("deadline_expired", _tenant_or_none())
            raise
    else:
        donate_idx = _pick_donations(pl, prog)
        if donate_idx and _result_cache._enabled:
            # the serialized path claims no ownership: invalidate the donated leaves'
            # entries here, before the donating call writes into them
            _result_cache.note_donation([id(pl.leaves[i]) for i in donate_idx])
        try:
            with _on_device(pl.device):
                if donate_idx:
                    outs = prog(*pl.leaves, donate_leaves=donate_idx)
                elif resilience._active:
                    outs = resilience.guard("executor.execute", prog, *pl.leaves, inject=False)
                else:
                    outs = prog(*pl.leaves)
            if pl.single:
                outs = (outs,)
            if donate_idx:
                _tally_donated(pl, donate_idx)
        except Exception as exc:
            if not fallback_after_failure(pl.key, prog, exc):
                raise
            try:
                outs = _plan_replay_eager(pl)
            except resilience.DeadlineExceeded:
                _get_scheduler().note_lifecycle("deadline_expired", _tenant_or_none())
                raise
    if profiler._active:
        _record_force_memory(pl, outs)
    _memoise(pl, outs)
    return True


def _force_async(roots: Tuple[Deferred, ...], deadline: Optional[float] = None) -> bool:
    """The async executor: plan under the lock, run outside it.

    Under the lock: linearise, look up the program, pick donations, claim buffer
    ownership and install a :class:`PendingValue` into every node the program
    emits. Outside it: resolve leaves still pending from earlier forces, then run
    — inline when the tenant's shard is idle, else queued (same-signature items
    batch). Warm-up / unsupported signatures replay op by op under the lock.
    With ``HEAT_TPU_SHED=1`` a deadline-bearing force the service-time EWMA says
    cannot fit, or that stays blocked by a full queue, fails with ``Shed``."""
    sched = _get_scheduler()
    with _tlock:
        pl = _linearise(roots)
        if pl is None:
            return False
        pl.deadline = deadline
        prog = lookup(pl.key, _plan_build(pl), label=pl.label, spec=lambda: _plan_spec(pl))
        if prog is None:
            if not any(isinstance(v, PendingValue) for v in pl.leaves):
                try:
                    outs = _plan_replay_eager(pl)
                except resilience.DeadlineExceeded:
                    sched.note_lifecycle("deadline_expired", _tenant_or_none())
                    raise
                if profiler._active:
                    _record_force_memory(pl, outs)
                _memoise(pl, outs)
                return True
            donate_idx = ()
        else:
            if _result_cache._enabled and (deadline is None or time.monotonic() < deadline):
                # result-cache consult BEFORE donation picking and queueing: a
                # validated hit memoises straight into the plan's nodes
                rkey = _result_key(prog, pl.leaves)
                if rkey is not None:
                    cached = _result_cache.lookup(rkey, _tenant_or_none(), count_miss=False)
                    if cached is not _result_cache.MISS:
                        outs = (cached,) if pl.single else cached
                        if profiler._active:
                            _record_force_memory(pl, outs)
                        _memoise(pl, outs)
                        return True
            donate_idx = _pick_donations(pl, prog)
        donate_set = set(donate_idx)
        read_leaves = [v for i, v in enumerate(pl.leaves) if isinstance(v, torch.Tensor) and i not in donate_set]
        granted_leaves = _acquire_buffers(read_leaves, [pl.leaves[i] for i in donate_idx])
        granted_ids = {id(v) for v in granted_leaves}
        granted_idx = tuple(i for i in donate_idx if id(pl.leaves[i]) in granted_ids)
        pendings = []
        for i in pl.out_idxs:
            node0 = pl.entry_nodes[i][0]
            p = PendingValue(node0.shape, node0.dtype)
            pendings.append(p)
            for node in pl.entry_nodes[i]:
                node.value = p
        req = profiler.current_request() if profiler.attribution_active() else None

    tenant = _tenant_or_none() if pl.deadline is not None else None
    released = []

    def release_once():
        if not released:
            released.append(True)
            _release_buffers(read_leaves, granted_leaves)

    def fail(exc: BaseException) -> None:
        # the futures stay installed but FAILED: every waiter re-raises, and the
        # next force re-plans them (the serialized path's retry semantics)
        release_once()
        for p in pendings:
            p.fail(exc)

    def complete(outs, donation_happened: bool = True) -> None:
        release_once()
        if granted_idx and donation_happened:
            _tally_donated(pl, granted_idx)
        _memoise(pl, outs)
        for p, value in zip(pendings, outs):
            p.fulfill(value)
        if profiler._active:
            _record_force_memory(pl, outs)

    def execute() -> None:
        # the whole single-item execution, fallback included; never raises
        donation_happened = True
        try:
            if pl.deadline is not None and time.monotonic() >= pl.deadline:
                sched.note_lifecycle("deadline_expired", tenant)
                fail(resilience.DeadlineExceeded(f"deadline passed before dispatch ({pl.label})"))
                return
            with _on_device(pl.device):
                if prog is None:
                    try:
                        outs = tuple(_plan_replay_eager(pl))
                    except resilience.DeadlineExceeded as dexc:
                        sched.note_lifecycle("deadline_expired", tenant)
                        fail(dexc)
                        return
                    complete(outs, False)
                    return
                try:
                    with profiler.attributed(req):
                        if granted_idx:
                            outs = prog(*pl.leaves, donate_leaves=granted_idx)
                        elif resilience._active:
                            outs = resilience.guard("executor.execute", prog, *pl.leaves, inject=False)
                        else:
                            outs = prog(*pl.leaves)
                    if pl.single:
                        outs = (outs,)
                except Exception as exc:
                    if not fallback_after_failure(pl.key, prog, exc):
                        fail(exc)
                        return
                    try:
                        outs = _plan_replay_eager(pl)
                    except resilience.DeadlineExceeded as dexc:
                        sched.note_lifecycle("deadline_expired", tenant)
                        fail(dexc)
                        return
                    donation_happened = False
            complete(tuple(outs), donation_happened)
        except BaseException as exc:  # waiters must never strand on a bookkeeping bug
            fail(exc)

    if (
        pl.deadline is not None
        and _knobs.shed
        and prog is not None
        and prog.ewma_s > 0.0
        and time.monotonic() + prog.ewma_s >= pl.deadline
    ):
        sched.note_lifecycle("shed", tenant)
        fail(resilience.Shed(
            f"admission control: estimated service time {prog.ewma_s * 1e3:.2f} ms exceeds the "
            f"remaining deadline budget ({pl.label})"
        ))
        return True

    try:
        for i, v in enumerate(pl.leaves):
            if isinstance(v, PendingValue):
                pl.leaves[i] = v.resolve()
    except BaseException as exc:
        fail(exc)
        raise

    batch_key = None
    if prog is not None and not granted_idx and batch_max() > 1:
        scalar_fp: list = []
        eligible = True
        for j, v in enumerate(pl.leaves):
            if isinstance(v, torch.Tensor):
                continue
            if isinstance(v, (int, float, bool, np.number, np.bool_)):
                # scalar identity (type + repr) is part of the batch key
                scalar_fp.append((j, type(v).__name__, repr(v)))
            else:
                eligible = False
                break
        if eligible:
            batch_key = (id(prog), tuple(scalar_fp))

    token = sched.try_inline(tenant if tenant is not None else _tenant_or_none())
    if token is not None:
        try:
            execute()
        finally:
            sched.end_inline(token)
        return True
    if tenant is None:
        tenant = _tenant_or_none()
    if tenant is None:
        tenant = f"t{threading.get_ident()}"
    item = _scheduler.WorkItem(
        tenant, execute, req=req, batch_key=batch_key, prog=prog,
        leaves=pl.leaves, complete=complete, fail=fail, deadline=pl.deadline,
    )
    if not _submit_with_backpressure(sched, item):
        if _knobs.shed and pl.deadline is not None:
            fail(_shed_backpressure(sched, tenant, pl.label))
            return True
        execute()
    return True


def _execute_batch(items) -> None:
    """Run 2+ same-signature queued items as ONE batched call
    (:meth:`_Program.call_batched`); on failure each item re-runs singly. Never
    raises."""
    width = len(items)
    prog = items[0].prog
    base = items[0].leaves
    array_pos = tuple(j for j, v in enumerate(base) if isinstance(v, torch.Tensor))
    scalar_pos = tuple(j for j in range(len(base)) if j not in array_pos)
    try:
        flat = [it.leaves[j] for it in items for j in array_pos]
        scalars = [base[j] for j in scalar_pos]
        with profiler.attributed(items[0].req), _on_device(_first_device(base)):
            out_flat = prog.call_batched(width, array_pos, scalar_pos, flat, scalars,
                                         reqs=[it.req for it in items])
        n_outs = len(out_flat) // width
        if diagnostics._enabled:
            diagnostics.counter("executor.batched_requests", width)
        for i, it in enumerate(items):
            it.complete(tuple(out_flat[i * n_outs: (i + 1) * n_outs]))
    except BaseException as exc:
        if diagnostics._enabled:
            diagnostics.record_fallback(
                "executor.batch",
                f"{prog.label or 'program'}[x{width}]: {type(exc).__name__}: {exc} — re-running {width} singly",
            )
        for it in items:
            it.execute()


def _shed_backpressure(sched, tenant, label) -> "resilience.Shed":
    """Ledger + build the typed ``Shed`` for a queue that stayed full through the
    backpressure ladder (``HEAT_TPU_SHED=1`` + a deadline-bearing request)."""
    sched.note_lifecycle("shed", tenant)
    exc = resilience.Shed(f"dispatch queue full through backpressure; shedding deadline-bearing request ({label})")
    exc._ht_ledgered = True
    return exc


def call_staged(key, prog: _Program, x):
    """Run a staged one-op program (the ``l``/``r``/``c`` families) through the
    scheduler when other work is in flight, so concurrent same-signature staged
    calls batch; a plain call when async dispatch or batching is off or the
    tenant's shard is idle. The caller sees the synchronous contract either way. A
    program that issues a collective never comes here: it runs inline."""
    if not _knobs.async_dispatch or _knobs.batch_max <= 1:
        return prog(x)
    sched = _get_scheduler()
    tenant = _tenant_or_none()
    token = sched.try_inline(tenant)
    if token is not None:
        try:
            return prog(x)
        finally:
            sched.end_inline(token)
    deadline = None
    if profiler._deadline_seen:
        prog._lifecycle_check()
        deadline = profiler.current_deadline()
    req = profiler.current_request() if profiler.attribution_active() else None
    pending = PendingValue(x.shape, x.dtype)
    device = x.device

    def fail(exc: BaseException) -> None:
        pending.fail(exc)

    def complete(outs, donation_happened: bool = True) -> None:
        pending.fulfill(outs[0])

    def execute() -> None:
        try:
            if deadline is not None and time.monotonic() >= deadline:
                sched.note_lifecycle("deadline_expired", tenant)
                exc = resilience.DeadlineExceeded(f"deadline passed before dispatch ({prog.label or 'program'})")
                exc._ht_ledgered = True
                pending.fail(exc)
                return
            with profiler.attributed(req), _on_device(device):
                pending.fulfill(prog(x))
        except BaseException as exc:
            pending.fail(exc)

    item = _scheduler.WorkItem(
        tenant if tenant is not None else f"t{threading.get_ident()}",
        execute, req=req, batch_key=(id(prog), ()), prog=prog, leaves=[x],
        complete=complete, fail=fail, deadline=deadline,
    )
    if not _submit_with_backpressure(sched, item):
        if _knobs.shed and deadline is not None:
            raise _shed_backpressure(sched, item.tenant, prog.label or "program")
        return prog(x)
    return pending.resolve()


class _QueueFull(Exception):
    pass


# Backpressure for a full dispatch queue: retried under this policy (override with
# resilience.set_policy("executor.queue", ...)); on exhaustion the submitter runs
# inline.
_QUEUE_POLICY = resilience.Policy(max_attempts=4, backoff_base=0.002, jitter=0.0, max_delay_s=0.05)


def _submit_with_backpressure(sched, item) -> bool:
    """Submit ``item``; a full queue retries under the ``executor.queue`` policy.
    False means the caller runs inline (or sheds). A draining scheduler refuses at
    once."""
    bound = queue_bound()
    if sched.submit(item, bound):
        return True
    if sched.draining():
        if diagnostics._enabled:
            diagnostics.record_fallback("executor.queue", "scheduler draining; admission closed")
        return False

    def attempt():
        if not sched.submit(item, bound):
            raise _QueueFull(f"dispatch queue at bound {bound}")

    policy = resilience.site_policy("executor.queue") or _QUEUE_POLICY
    try:
        policy.run("executor.queue", attempt)
        return True
    except _QueueFull:
        if diagnostics._enabled:
            diagnostics.record_fallback("executor.queue", f"queue full (bound {bound}) after backpressure; executing inline")
        return False


# The executor's section of ht.diagnostics.report().
diagnostics.register_provider("executor", lambda: executor_stats(top=10))


@atexit.register
def _drain_scheduler_at_exit() -> None:
    """Interpreter shutdown: flush what the scheduler can within the timeout and
    shed the rest with typed errors, so no future stays blocked."""
    sched = _dispatch_scheduler
    if sched is None:
        return
    try:
        sched.drain(timeout=5.0)
    except Exception:  # the drain delivered typed errors; raising would mask the exit status
        pass
