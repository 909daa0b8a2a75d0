"""``ht.telemetry`` (the port's own copy of heat_tpu/core/telemetry.py, stdlib-only
at load, with the same shard schema) — the distributed telemetry plane: cross-process
metric/trace aggregation, collective skew & straggler attribution, and a
failure flight recorder.

Everything :mod:`diagnostics`, :mod:`profiler` and the
executor/scheduler ledgers collect is strictly per-process: a
4-process ``torch.distributed`` job yields four disjoint reports with no global
view, no cross-rank clock alignment, and no way to see which rank straggles
inside a collective — even though :class:`profiler.Histogram` was designed
mergeable for exactly this. This module closes that gap with three pillars:

- **Aggregation.** :func:`dump_shard` writes one self-describing *telemetry
  shard* per process (schema ``heat-tpu-telemetry/1``): the full diagnostics
  report (counters, spans, collectives, pad gauges, and the executor /
  profiler / resilience provider sections), the raw profiler timeline
  (:func:`profiler.trace_snapshot`), this process's collective windows, and
  the flight-recorder ring — all stamped with the process identity and the
  clock-alignment anchor. :func:`merge` (also ``python -m heat_tpu_torch.telemetry
  merge``) folds N shards into ONE global report — counters sum exactly,
  spans fold, histogram merge is the associative bucket fold that already
  exists, per-process breakdowns are preserved — and :func:`merged_trace`
  emits ONE Perfetto trace with per-process track groups: every process gets
  a disjoint pid range (``(index + 1) * PID_STRIDE``), fixing the pid
  collision two concatenated per-process traces used to have, and every
  timestamp is aligned onto the shared clock (below).

- **Clock alignment.** At ``torch.distributed`` bootstrap,
  :mod:`communication` runs a one-shot handshake: a global barrier, then each
  process samples ``time.monotonic_ns()`` and one ``allgather`` shares the
  anchors (:func:`record_clock_anchor`). Trace timestamps are shifted so the
  barrier instant is t=0 on every track — host-side only, nothing on the card,
  accurate to the barrier's exit skew (milliseconds; see
  heat_tpu's ``doc/source/observability.rst`` for the caveats). Without a handshake
  (single process, or ``HEAT_TPU_TELEMETRY_HANDSHAKE=0``) each shard falls
  back to its import-time anchor and the merged report says so
  (``clock.aligned``).

- **Collective skew & straggler attribution.** When collection is on
  (:func:`enable` / ``HEAT_TPU_TELEMETRY=1``) the single
  ``communication._guarded`` chokepoint wraps every collective /
  layout-op invocation in :func:`collective_window`: the enter/exit wall
  times land in a bounded window log and a per-site duration histogram, each
  window identified by ``(site, ambient request tag, seq)`` — SPMD symmetry
  makes the k-th guarded call *of one request* at one site the same
  collective on every rank, even when concurrent tenants interleave in a
  different order per process. :func:`merge` lines the windows up across
  ranks by that identity: the cross-rank skew is ``max(enter) - min(enter)``
  and the rank that entered last is the straggler. The merged report carries
  ``skew.<op>`` histograms, a per-rank straggler scoreboard naming the
  slowest rank, and the merged trace draws flow arrows linking the same
  collective across process tracks (worst skews first). The same identity
  also powers the **sequence-consistency gate** (the runtime twin of the
  static ``spmd-divergent-collective`` rule of heat_tpu's static analysis):
  every rank's per-tag ordered site list must match the lowest rank's, and
  ``merge --check`` fails on the first divergence naming the rank, the
  index, and the expected/actual sites — the signature a rank-dependent
  branch around a collective produces. Needs no clock alignment (local
  ordering only), so it works even when the handshake degraded.

- **Flight recorder.** An always-on bounded ring of the last
  ``HEAT_TPU_FLIGHT_EVENTS`` lifecycle / resilience / fallback events per
  process (:func:`flight_record`; fed by the diagnostics tee hooks and the
  scheduler's lifecycle ledger). On the typed failure paths — fault-plan
  firings, signature quarantine, ``CheckpointCorrupt``, a circuit breaker
  opening, ``DrainTimeout`` — the ring is dumped automatically (rate-limited,
  on a background thread so no caller lock ever waits on a disk) to
  ``HEAT_TPU_FLIGHT_DIR``, so a chaos-CI failure or a multi-process hang
  ships a post-mortem artifact instead of a bare traceback.
  :func:`flight_dump` does the same on demand.

Zero-cost contract (same discipline as diagnostics/profiler/resilience)
-----------------------------------------------------------------------
Idle (the default), the one hook on a hot path — the collective-window check
in ``communication._guarded`` — is a single module-attribute read
(``telemetry._collecting``) and a branch not taken. Window timing is
host-side, around the collective's call: nothing is added to what the card runs. The flight
recorder's feeds are failure-path machinery, never a compute path.

Thread-safety
-------------
Every registry — the window log, per-site sequence numbers and duration
histograms, the flight ring and dump ledger, the process/clock identity —
mutates under the one module ``_lock``, which is a strict LEAF: no code
holding it calls into any other locking module (shard payloads are built
under the lock, written outside it; auto-dumps run on their own thread).
``_collecting`` is the relaxed hot-path switch, read bare like
``diagnostics._enabled``; ``_in_flight_dump`` is a thread-local reentrancy
guard.

Env knobs
---------
- ``HEAT_TPU_TELEMETRY=1``          — start with collective-window collection
  on (read at import, like its diagnostics/profiler siblings).
- ``HEAT_TPU_FLIGHT_DIR=path``      — flight-recorder dump directory
  (default: ``<tempdir>/heat-tpu-flight``; read at dump time — a cold path,
  so tests repoint it without reloads).
- ``HEAT_TPU_FLIGHT=0``             — disable the *automatic* failure dumps
  (the ring still records; on-demand dumps still work; read at dump time).
- ``HEAT_TPU_FLIGHT_EVENTS=N``      — ring capacity (default 512; applied at
  import and re-applied by :func:`reset`).
- ``HEAT_TPU_TELEMETRY_WINDOWS=N``  — collective-window ring capacity
  (default 16384; applied at import and by :func:`reset`). An overflowed
  ring invalidates the cross-rank sequence gate (oldest windows dropped),
  and ``merge --check`` then FAILS rather than silently passing — long
  collection runs that need the gate raise this.
- ``HEAT_TPU_TELEMETRY_HANDSHAKE=0``— skip the clock handshake at bootstrap.

Stdlib-only at module load (like diagnostics/profiler/resilience): the merge
half must run in tooling that never loads torch.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import socket
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

try:
    from . import diagnostics, profiler, resilience
except ImportError:  # standalone file-path load (no parent package): degrade —
    diagnostics = resilience = None  # merge still needs Histogram, so load the
    import importlib.util as _ilu    # stdlib-only sibling by file path
    import sys as _sys

    def _load_sibling(name: str):
        mod = _sys.modules.get(f"_heat_tpu_torch_{name}")
        if mod is not None:
            return mod
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.py")
        try:
            spec = _ilu.spec_from_file_location(f"_heat_tpu_torch_{name}", path)
            mod = _ilu.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception:  # ht: ignore[silent-except] -- best-effort standalone load: callers treat None as merge-degraded (histograms kept raw)
            return None
        _sys.modules.setdefault(f"_heat_tpu_torch_{name}", mod)
        return mod

    profiler = _load_sibling("profiler")
    del _ilu, _sys

__all__ = [
    "SCHEMA",
    "MERGED_SCHEMA",
    "TRACE_SCHEMA",
    "FLIGHT_SCHEMA",
    "PID_STRIDE",
    "enable",
    "disable",
    "collecting",
    "reset",
    "set_process_info",
    "process_info",
    "record_clock_anchor",
    "clock_info",
    "collective_window",
    "windows",
    "duration_snapshots",
    "flight_record",
    "flight_events",
    "flight_dump",
    "flight_dir",
    "dump_shard",
    "shard_payload",
    "load_shards",
    "load_ops_beats",
    "OPS_BEAT_PREFIX",
    "merge",
    "merged_trace",
    "write_report",
    "write_trace",
    "main",
]

SCHEMA = "heat-tpu-telemetry/1"
MERGED_SCHEMA = "heat-tpu-telemetry-merged/1"
TRACE_SCHEMA = "heat-tpu-telemetry-trace/1"
FLIGHT_SCHEMA = "heat-tpu-flight/1"

#: filename prefix of per-process shards inside a telemetry directory
SHARD_PREFIX = "telemetry-shard-"

#: pid range per process in the merged trace: process ``i`` owns
#: ``[(i+1)*PID_STRIDE, (i+2)*PID_STRIDE)`` — request rid ``r`` maps to
#: ``(i+1)*PID_STRIDE + r``, the per-process collective track sits at the top
#: of the range. No single-process trace has ever come near 10^6 request ids
#: (the profiler's request table is capped at 8192 entries).
PID_STRIDE = 1_000_000

# Hot-path gate, read as ``telemetry._collecting`` by TorchCommunication's
# chokepoint: one attribute load + branch when off — the zero-cost contract.
_collecting: bool = False

_lock = threading.RLock()

_MAX_WINDOWS = 16_384
_DEFAULT_FLIGHT_EVENTS = 512
_MAX_AUTO_DUMPS = 16
_AUTO_MIN_INTERVAL_NS = 5_000_000_000  # >= 5 s between auto-dumps per trigger

# process identity + the clock anchor (rewritten by the bootstrap handshake)
_process: Dict[str, Any] = {
    "index": 0,
    "count": 1,
    "pid": os.getpid(),
    "host": socket.gethostname(),
}
_clock: Dict[str, Any] = {
    # import-time fallback anchor: aligns nothing across processes, but keeps
    # per-process timestamps small and the shard schema uniform
    "anchor_ns": time.monotonic_ns(),
    "anchors_ns": None,
    "aligned": False,
}

# collective windows: (site, seq, enter_ns, exit_ns, tag); seq counts per
# (site, ambient request tag) — SPMD symmetry makes the k-th guarded call of
# request X at one site the SAME collective on every rank, even when two
# tenants' requests interleave in a different order per process (the async
# executor's default shape; a bare per-site counter would pair unrelated
# collectives across ranks and attribute phantom skew)
def _windows_capacity() -> int:
    """Window-ring capacity: ``HEAT_TPU_TELEMETRY_WINDOWS`` (default 16384;
    applied at import and re-applied by :func:`reset`). An overflowed ring
    drops its oldest windows, which invalidates the cross-rank sequence
    gate — long jobs that need the gate raise the cap."""
    try:
        return max(256, int(os.environ.get("HEAT_TPU_TELEMETRY_WINDOWS", "")
                            or _MAX_WINDOWS))
    except ValueError:
        return _MAX_WINDOWS


_windows: "deque[tuple]" = deque(maxlen=_windows_capacity())
_site_seq: Dict[Tuple[str, Optional[str]], int] = {}
_durations: Dict[str, Any] = {}  # site -> profiler.Histogram

# flight recorder: bounded ring + the ledger of dumps already written
def _flight_capacity() -> int:
    try:
        return max(16, int(os.environ.get("HEAT_TPU_FLIGHT_EVENTS", "") or
                           _DEFAULT_FLIGHT_EVENTS))
    except ValueError:
        return _DEFAULT_FLIGHT_EVENTS


_flight: "deque[dict]" = deque(maxlen=_flight_capacity())
_flight_dumps: List[str] = []
_flight_seq = itertools.count(1)
_auto_dumps: int = 0
_last_auto_ns: Dict[str, int] = {}
_in_flight_dump = threading.local()

#: resilience-event kinds whose occurrence auto-dumps the flight ring — the
#: typed failure paths (breaker opens match on the transition
#: detail instead, see :func:`_on_resilience_event`)
_AUTO_DUMP_KINDS = frozenset({
    "fault",          # a fault-plan entry fired
    "quarantine",     # the executor evicted a signature to the eager path
    "corrupt",        # CheckpointCorrupt on a hard restore/verify path (the
                      # CheckpointManager step SCAN records a softer
                      # "corrupt-step" that rides the ring without dumping —
                      # re-scanning a known-bad step must not burn budget)
    "data-loss",      # donated buffer invalidated by a failed call
    "drain-timeout",  # DispatchScheduler.drain could not flush
    "swap-failed",    # a model hot-swap rolled back (ht.serving.swap_state)
    # supervision-plane aborts: every typed abort ships its
    # post-mortem (the watchdog additionally dumps its own
    # `supervision.watchdog` trigger before posting the sentinel)
    "peer-failed",           # a peer stopped heartbeating past the budget
    "collective-timeout",    # the collective watchdog flagged a stuck window
    "coordination-timeout",  # a supervised coordination wait exhausted
    "peer-dead",             # the injected peer-death fault fired (this rank)
    "peer-failover",         # a serving pool shed typed after a peer failure
    "slo-burn",              # an ops-plane tenant burn-rate alert went UP
                             # the transition event's detail
                             # carries the offending window's per-shard
                             # pressure breakdown, so the post-mortem shows
                             # WHERE the budget burned — only the OFF->ON
                             # edge is typed (clears ride the ring without
                             # dumping), so one regression dumps exactly once
    # deliberately NOT here: "cache-corrupt" — a corrupt compile-cache or
    # result-cache entry is self-healing (typed rejection, then recompile /
    # recompute), so it rides the ring as post-mortem context without
    # spending dump budget on a failure the very next dispatch repairs
})


def _utcnow() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# ------------------------------------------------------------------ switches
def enable() -> None:
    """Turn collective-window collection on (the flight recorder and shard
    dumps are always available; this gates only the per-collective timing
    in ``communication._guarded``)."""
    global _collecting
    _collecting = True


def disable() -> None:
    """Stop collecting collective windows (collected data is kept until
    :func:`reset`)."""
    global _collecting
    _collecting = False


def collecting() -> bool:
    """Whether collective-window collection is currently on."""
    return _collecting


def reset() -> None:
    """Drop collected windows, per-site sequence counters, duration
    histograms, and the flight ring (the dump ledger and rate-limit state are
    kept — they describe files already on disk). Process identity and the
    clock anchor survive; the collecting switch is untouched. The flight
    ring is rebuilt at the current ``HEAT_TPU_FLIGHT_EVENTS`` capacity and
    the window ring at ``HEAT_TPU_TELEMETRY_WINDOWS``, so an in-process env
    change takes effect at the next reset."""
    global _flight, _windows
    with _lock:
        _windows = deque(maxlen=_windows_capacity())
        _site_seq.clear()
        _durations.clear()
        _flight = deque(maxlen=_flight_capacity())


# ------------------------------------------------------------------ identity & clock
def set_process_info(index: int, count: int) -> None:
    """Record this process's rank in the job (called by the communication
    bootstrap; defaults to 0-of-1 for single-process runs)."""
    with _lock:
        _process["index"] = int(index)
        _process["count"] = int(count)
        _process["pid"] = os.getpid()


def process_info() -> Tuple[int, int]:
    """``(process_index, process_count)`` as recorded by the bootstrap."""
    with _lock:
        return _process["index"], _process["count"]


def record_clock_anchor(anchor_ns: int, anchors_ns: Sequence[int]) -> None:
    """Install the boot-time clock-offset handshake result: ``anchor_ns`` is
    THIS process's ``time.monotonic_ns()`` sampled right after the global
    barrier, ``anchors_ns`` the allgathered anchors of every process
    (index-ordered). From here on, aligned time is
    ``(t_monotonic_ns - anchor_ns) / 1e3`` microseconds — t=0 is the barrier
    instant on every rank, to within the barrier's exit skew."""
    with _lock:
        _clock["anchor_ns"] = int(anchor_ns)
        _clock["anchors_ns"] = [int(a) for a in anchors_ns]
        _clock["aligned"] = True


def clock_info() -> Dict[str, Any]:
    """The current clock-anchor state (``anchor_ns`` / ``anchors_ns`` /
    ``aligned``)."""
    with _lock:
        return dict(_clock)


def _clock_payload() -> Dict[str, Any]:
    now_ns = time.monotonic_ns()
    with _lock:
        payload = {
            "anchor_monotonic_ns": _clock["anchor_ns"],
            "anchors_monotonic_ns": (
                list(_clock["anchors_ns"]) if _clock["anchors_ns"] else None
            ),
            "aligned": bool(_clock["aligned"]),
            "dumped_at_monotonic_ns": now_ns,
        }
    if profiler is not None:
        # The profiler timeline's origin expressed on the monotonic clock: the
        # profiler stamps CLOCK_REALTIME, which runs at the monotonic clock's
        # rate unless stepped, so the difference sampled once converts any
        # profiler timestamp to a monotonic instant (and from there, via the
        # anchor, to aligned time).
        payload["profiler_origin_monotonic_us"] = now_ns / 1e3 - profiler._now_us()
    return payload


# ------------------------------------------------------------------ collective windows
@contextlib.contextmanager
def collective_window(site: str):
    """Time one collective (or layout-op) invocation at ``site`` into the
    window log and the per-site duration histogram. The sequence number is
    taken at ENTER and counts per (site, ambient profiler request tag), so
    two ranks' k-th ``comm.psum`` *of the same request* carry the same
    ``(site, tag, seq)`` identity and the merger can compute their cross-rank
    enter skew — correct even when concurrent tenants interleave in a
    different order on each process. Callers gate on
    ``telemetry._collecting`` (the communication chokepoint does); timing is
    host-side only — nothing is added to what the card runs."""
    site = str(site)
    tag = None
    if profiler is not None and hasattr(profiler, "current_request_tag"):
        tag = profiler.current_request_tag()
    with _lock:
        key = (site, tag)
        seq = _site_seq.get(key, 0) + 1
        _site_seq[key] = seq
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        t1 = time.monotonic_ns()
        with _lock:
            _windows.append((site, seq, t0, t1, tag))
            h = _durations.get(site)
            if h is None and profiler is not None:
                h = _durations[site] = profiler.Histogram()
            if h is not None:
                h.observe((t1 - t0) / 1e9)


def windows() -> List[tuple]:
    """The recorded collective windows
    ``(site, seq, enter_ns, exit_ns, request_tag)``."""
    with _lock:
        return list(_windows)


def duration_snapshots() -> Dict[str, dict]:
    """Per-site collective duration histogram snapshots."""
    with _lock:
        return {site: h.snapshot() for site, h in sorted(_durations.items())}


# ------------------------------------------------------------------ flight recorder
def flight_record(source: str, site: str, detail: str = "",
                  kind: str = "") -> None:
    """Append one event to the flight ring (always-on; the ring is bounded so
    this can never become the leak it exists to diagnose). ``source`` names
    the feeding subsystem (``resilience`` / ``fallback`` / ``lifecycle`` /
    ``manual``), ``kind`` the event type within it."""
    rec = {
        "t": _utcnow(),
        "t_mono_us": time.monotonic_ns() / 1e3,
        "source": str(source),
        "kind": str(kind),
        "site": str(site),
        "detail": str(detail),
    }
    with _lock:
        _flight.append(rec)


def flight_events() -> List[dict]:
    """The current flight-ring contents, oldest first."""
    with _lock:
        return list(_flight)


def flight_dir() -> str:
    """Where flight dumps land: ``HEAT_TPU_FLIGHT_DIR`` or a per-host temp
    default. Read at dump time (dumps are cold paths; tests repoint the env
    var without reloads)."""
    return os.environ.get("HEAT_TPU_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "heat-tpu-flight"
    )


def flight_dump(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Write the flight ring (plus process/clock identity and the resilience
    snapshot) as one post-mortem JSON artifact; returns the path, or None when
    the directory is unwritable (counted via ``diagnostics.record_fallback``
    — a failed post-mortem must not raise out of a failure path that is
    already unwinding)."""
    with _lock:
        payload = {
            "schema": FLIGHT_SCHEMA,
            "generated_at": _utcnow(),
            "reason": str(reason),
            "process": dict(_process),
            "events": list(_flight),
            "prior_dumps": list(_flight_dumps),
        }
        seq = next(_flight_seq)
        index = _process["index"]
    payload["clock"] = _clock_payload()
    if resilience is not None:
        payload["resilience"] = resilience.resilience_stats()
    if path is None:
        safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in str(reason))
        path = os.path.join(
            flight_dir(), f"flight-p{index}-{seq:03d}-{safe[:48]}.json"
        )
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        _atomic_json(path, payload, "telemetry.flight")
    except OSError as exc:
        if diagnostics is not None:
            diagnostics.record_fallback("telemetry.flight", repr(exc))
        return None
    with _lock:
        _flight_dumps.append(path)
    return path


def flight_dumps() -> List[str]:
    """Paths of every flight dump this process has written."""
    with _lock:
        return list(_flight_dumps)


def _maybe_auto_dump(trigger: str) -> None:
    """Schedule an automatic flight dump for a typed failure ``trigger`` —
    rate-limited (one per trigger per 5 s, :data:`_MAX_AUTO_DUMPS` per
    process), skipped while a dump is already running on this thread, and
    executed on a daemon thread so no caller lock ever waits on the disk."""
    if getattr(_in_flight_dump, "active", False):
        return
    if os.environ.get("HEAT_TPU_FLIGHT") == "0":
        return
    global _auto_dumps
    now = time.monotonic_ns()
    with _lock:
        if _auto_dumps >= _MAX_AUTO_DUMPS:
            return
        last = _last_auto_ns.get(trigger)
        if last is not None and now - last < _AUTO_MIN_INTERVAL_NS:
            return
        _last_auto_ns[trigger] = now
        _auto_dumps += 1
    try:
        threading.Thread(
            target=_auto_dump_thread, args=(trigger,),
            name="heat-tpu-flight-dump", daemon=True,
        ).start()
    except RuntimeError:
        # thread creation can fail once interpreter finalization has begun
        # (the atexit-drain path): a lost post-mortem must never propagate
        # into the failure path that triggered it — refund and move on
        _refund_auto_dump()


def _refund_auto_dump() -> None:
    # the reservation bought nothing: give it back so a later real failure
    # can still produce a post-mortem — the per-trigger rate limit still
    # spaces the retries
    global _auto_dumps
    with _lock:
        _auto_dumps -= 1


def _auto_dump_thread(trigger: str) -> None:
    _in_flight_dump.active = True
    written = None
    try:
        written = flight_dump(trigger)
    except Exception:  # ht: ignore[silent-except] -- accounted by the refund below + the flight ring already holds the triggering event; a dump-thread crash must not kill the process or stay charged against the budget
        pass
    finally:
        _in_flight_dump.active = False
    if written is None:
        _refund_auto_dump()


def _on_resilience_event(site: str, kind: str, detail: str) -> None:
    """The diagnostics ``_resilience_tee``: every resilience event enters the
    flight ring; the typed failure kinds (and breaker transitions INTO open)
    additionally trigger an automatic post-mortem dump."""
    if getattr(_in_flight_dump, "active", False):
        return  # a dump's own retry/exhaustion events must not recurse
    flight_record("resilience", site, detail, kind=kind)
    if kind in _AUTO_DUMP_KINDS:
        _maybe_auto_dump(kind)
    elif kind == "breaker" and "->open" in detail.split(":", 1)[0]:
        _maybe_auto_dump("breaker-open")


def _on_fallback_event(site: str, reason: str) -> None:
    """The diagnostics ``_fallback_tee``: eager-path fallbacks enter the ring
    (context for the post-mortem) but do not trigger dumps themselves."""
    if getattr(_in_flight_dump, "active", False):
        return
    flight_record("fallback", site, reason, kind="fallback")


# ------------------------------------------------------------------ shard dump
def shard_payload() -> dict:
    """This process's full telemetry shard as a JSON-able dict (see the
    module header for the section inventory)."""
    payload: Dict[str, Any] = {
        "schema": SCHEMA,
        "generated_at": _utcnow(),
    }
    with _lock:
        payload["process"] = dict(_process)
        payload["collectives"] = {
            "windows": [list(w) for w in _windows],
            "windows_cap": _windows.maxlen,
            "durations": {
                site: h.snapshot() for site, h in sorted(_durations.items())
            },
        }
        payload["flight"] = {
            "events": list(_flight),
            "dumps": list(_flight_dumps),
        }
    payload["clock"] = _clock_payload()
    payload["diagnostics"] = diagnostics.report() if diagnostics is not None else {}
    payload["trace"] = (
        profiler.trace_snapshot()
        if profiler is not None and hasattr(profiler, "trace_snapshot")
        else {}
    )
    return payload


def dump_shard(directory: str) -> str:
    """Write this process's telemetry shard to
    ``<directory>/telemetry-shard-pNNNN.json`` (atomically, so a crash
    mid-dump can never leave a torn shard for :func:`merge` to choke on).
    Returns the path."""
    payload = shard_payload()
    index = payload["process"]["index"]
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{SHARD_PREFIX}p{index:04d}.json")
    return _atomic_json(path, payload, "telemetry.shard", indent=None)


# ------------------------------------------------------------------ merge
def load_shards(directory: str) -> List[dict]:
    """Read every ``telemetry-shard-*.json`` under ``directory``, schema- and
    identity-checked, ordered by process index. Raises ``ValueError`` on a
    wrong schema or a duplicated process index (two jobs dumped into one
    directory)."""
    shards: List[dict] = []
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return []
    for name in names:
        if not (name.startswith(SHARD_PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        with open(path) as f:
            shard = json.load(f)
        if shard.get("schema") != SCHEMA:
            raise ValueError(
                f"{path}: schema {shard.get('schema')!r} is not {SCHEMA!r}"
            )
        shards.append(shard)
    shards.sort(key=lambda s: s["process"]["index"])
    seen: Dict[int, str] = {}
    for shard in shards:
        idx = shard["process"]["index"]
        if idx in seen:
            raise ValueError(
                f"duplicate telemetry shard for process {idx} "
                f"(two jobs dumped into one directory?)"
            )
        seen[idx] = shard.get("generated_at", "")
    return shards


def _resolve_shards(shards: Union[str, Sequence[dict]]) -> List[dict]:
    if isinstance(shards, str):
        return load_shards(shards)
    shards = sorted(shards, key=lambda s: s["process"]["index"])
    seen: set = set()
    for shard in shards:
        idx = shard["process"]["index"]
        if idx in seen:
            # same contract as load_shards: double-counting a rank would
            # silently corrupt every merged sum
            raise ValueError(f"duplicate telemetry shard for process {idx}")
        seen.add(idx)
    return shards


def _clocks_aligned(shards: List[dict]) -> bool:
    """Whether cross-rank timestamp comparisons are meaningful: every shard
    carries a handshake anchor. (A single shard is trivially 'aligned' with
    itself — there is nothing cross-rank to compare.)"""
    return len(shards) == 1 or all(s["clock"].get("aligned") for s in shards)


def _hist_from(snap: dict):
    return profiler.Histogram.from_snapshot(snap) if profiler is not None else None


#: executor-stat keys that are PEAKS or point-in-time gauges: summing them
#: across ranks would fabricate a global value no process ever saw (four
#: ranks peaking at depth 10 did NOT make a depth-40 queue) — they max-fold.
#: ``sched_shards`` is a per-process CONFIGURATION value, not a tally: ranks
#: agree on it in any sane deployment, and max-folding keeps a mixed fleet
#: readable instead of summing shard counts into nonsense. The ``per_shard``
#: list is per-process structure — the merge keeps the first shard's copy
#: (cross-rank per-shard detail lives in the per_process section).
_MAX_FOLD_KEYS = frozenset({"queue_depth_peak", "queue_depth", "sched_shards"})


def _merge_numeric_tree(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Fold ``src`` into ``dst``: counters sum, peak/gauge keys (and any
    ``*_peak``) take the max, nested dicts recurse, anything else (labels,
    bools, lists) is kept from the first shard that had it."""
    for key, val in src.items():
        if isinstance(val, bool):
            dst.setdefault(key, val)
        elif isinstance(val, (int, float)):
            cur = dst.get(key, 0)
            if not (isinstance(cur, (int, float)) and not isinstance(cur, bool)):
                cur = 0
            if key in _MAX_FOLD_KEYS or key.endswith("_peak"):
                dst[key] = max(cur, val)
            else:
                dst[key] = cur + val
        elif isinstance(val, dict):
            sub = dst.setdefault(key, {})
            if isinstance(sub, dict):
                _merge_numeric_tree(sub, val)
        else:
            dst.setdefault(key, val)


def _window_key(win) -> Tuple[str, Optional[str], int]:
    """The cross-rank matching identity of one window record:
    ``(site, request_tag, seq)`` — tolerant of pre-tag 4-tuple fixtures."""
    tag = win[4] if len(win) > 4 else None
    return (str(win[0]), tag, int(win[1]))


def _aligned_windows(shard: dict) -> Dict[tuple, Tuple[float, float]]:
    """``{(site, tag, seq): (enter_us, exit_us)}`` on the aligned clock."""
    anchor_us = shard["clock"]["anchor_monotonic_ns"] / 1e3
    out: Dict[tuple, Tuple[float, float]] = {}
    for win in shard.get("collectives", {}).get("windows", ()):
        out[_window_key(win)] = (
            win[2] / 1e3 - anchor_us, win[3] / 1e3 - anchor_us
        )
    return out


def _compute_skew(shards: List[dict]) -> dict:
    """Cross-rank skew per collective sequence number, plus the straggler
    scoreboard. A collective participates only when >= 2 shards recorded its
    (site, seq) — single-rank windows have no skew to measure. When the
    clocks are NOT aligned (a skipped or degraded handshake), cross-rank
    enter deltas would include arbitrary per-process boot offsets — the
    result is marked invalid and carries NO attribution rather than a
    confidently-named phantom straggler."""
    if not _clocks_aligned(shards):
        return {
            "valid": False,
            "reason": "clock handshake missing or degraded on >=1 shard: "
                      "cross-rank enter times are not comparable",
            "collectives_measured": 0,
            "sites": {},
            "scoreboard": {},
            "slowest_rank": None,
        }
    per_shard = {s["process"]["index"]: _aligned_windows(s) for s in shards}
    groups: Dict[tuple, Dict[int, Tuple[float, float]]] = {}
    for idx, wins in per_shard.items():
        for key, span in wins.items():
            groups.setdefault(key, {})[idx] = span
    sites: Dict[str, dict] = {}
    scoreboard: Dict[int, dict] = {
        s["process"]["index"]: {
            "straggler_count": 0, "total_skew_us": 0.0,
            "worst_skew_us": 0.0, "worst_site": None, "worst_seq": None,
        }
        for s in shards
    }
    measured = 0
    for (site, _tag, seq), spans in groups.items():
        if len(spans) < 2:
            continue
        measured += 1
        enters = {idx: span[0] for idx, span in spans.items()}
        lo, hi = min(enters.values()), max(enters.values())
        skew_us = hi - lo
        straggler = max(enters, key=lambda i: (enters[i], i))
        entry = sites.get(site)
        if entry is None:
            entry = sites[site] = {
                "collectives": 0, "max_skew_us": 0.0, "max_skew_seq": None,
                "max_skew_rank": None, "straggler_counts": {}, "_hist": (
                    profiler.Histogram() if profiler is not None else None
                ),
            }
        entry["collectives"] += 1
        if skew_us >= entry["max_skew_us"]:
            entry["max_skew_us"] = skew_us
            entry["max_skew_seq"] = seq
            entry["max_skew_rank"] = straggler
        entry["straggler_counts"][straggler] = (
            entry["straggler_counts"].get(straggler, 0) + 1
        )
        if entry["_hist"] is not None:
            entry["_hist"].observe(skew_us / 1e6)
        board = scoreboard[straggler]
        board["straggler_count"] += 1
        board["total_skew_us"] += skew_us
        if skew_us > board["worst_skew_us"]:
            board["worst_skew_us"] = skew_us
            board["worst_site"] = site
            board["worst_seq"] = seq
    for site, entry in sites.items():
        hist = entry.pop("_hist")
        entry["histogram"] = hist.snapshot() if hist is not None else None
        entry["max_skew_us"] = round(entry["max_skew_us"], 3)
        # "slowest" at a site = the rank that straggled where it MATTERED:
        # the rank behind the worst skew (a count-based mode would let many
        # µs-noise wins outvote one catastrophic stall)
        entry["slowest_rank"] = entry.pop("max_skew_rank")
        entry["straggler_counts"] = {
            str(k): v for k, v in sorted(entry["straggler_counts"].items())
        }
    for board in scoreboard.values():
        board["total_skew_us"] = round(board["total_skew_us"], 3)
        board["worst_skew_us"] = round(board["worst_skew_us"], 3)
    slowest = None
    if measured:
        # overall slowest rank: the one that accumulated the most skew, with
        # straggle count as the tiebreak
        slowest = max(
            scoreboard,
            key=lambda i: (scoreboard[i]["total_skew_us"],
                           scoreboard[i]["straggler_count"], i),
        )
    return {
        "valid": True,
        "collectives_measured": measured,
        "sites": {k: sites[k] for k in sorted(sites)},
        "scoreboard": {str(k): scoreboard[k] for k in sorted(scoreboard)},
        "slowest_rank": slowest,
    }


def _site_op(site: str) -> str:
    """``comm.psum`` -> ``psum`` (the ``skew.<op>`` histogram names)."""
    return site.rsplit(".", 1)[-1]


_MAX_SEQUENCE_DIVERGENCES = 16


def _sequence_check(shards: List[dict]) -> dict:
    """Cross-rank collective-sequence consistency — the runtime twin of the
    static ``spmd-divergent-collective`` rule. Every rank's windows, ordered
    by enter time and grouped by the ambient request tag (SPMD symmetry is
    per REQUEST: concurrent tenants may interleave differently per process,
    but one request's guarded calls must be the same ordered site list on
    every rank), are compared element-wise against the lowest rank. The
    first mismatch per (tag, rank) is reported with the diverging rank, the
    index into the sequence, and the expected/actual sites — the exact hang
    signature a rank-dependent branch around a collective produces. Clock
    alignment is NOT required: only per-rank local ordering is compared.

    A shard whose bounded window ring overflowed (>= its recorded capacity)
    dropped its oldest windows, so sequence comparison would report phantom
    divergence — the check marks itself invalid instead."""
    if len(shards) < 2:
        return {
            "valid": True, "consistent": True, "tags_checked": 0,
            "windows_checked": 0, "divergences": [],
        }
    cap = min(
        int(s.get("collectives", {}).get("windows_cap") or _MAX_WINDOWS)
        for s in shards
    )
    overflowed = [
        s["process"]["index"] for s in shards
        if len(s.get("collectives", {}).get("windows", ())) >= cap
    ]
    if overflowed:
        return {
            "valid": False,
            "reason": f"window ring overflowed on rank(s) {overflowed}: "
                      "oldest windows were dropped, sequences are not "
                      "comparable (raise HEAT_TPU_TELEMETRY_WINDOWS)",
            "consistent": True, "tags_checked": 0, "windows_checked": 0,
            "divergences": [],
        }
    per_rank: Dict[int, Dict[Optional[str], List[str]]] = {}
    windows_checked = 0
    for shard in shards:
        idx = shard["process"]["index"]
        wins = sorted(
            shard.get("collectives", {}).get("windows", ()),
            key=lambda w: (w[2], w[1]),
        )
        tagmap: Dict[Optional[str], List[str]] = {}
        for win in wins:
            tag = win[4] if len(win) > 4 else None
            tagmap.setdefault(tag, []).append(str(win[0]))
            windows_checked += 1
        per_rank[idx] = tagmap
    ranks = sorted(per_rank)
    reference = ranks[0]
    tags = sorted(
        {t for m in per_rank.values() for t in m},
        key=lambda t: (t is not None, t or ""),
    )
    divergences: List[dict] = []
    for tag in tags:
        ref_seq = per_rank[reference].get(tag, [])
        for rank in ranks[1:]:
            seq = per_rank[rank].get(tag, [])
            if seq == ref_seq:
                continue
            n = min(len(seq), len(ref_seq))
            at = next(
                (i for i in range(n) if seq[i] != ref_seq[i]), n
            )
            divergences.append({
                "tag": tag,
                "rank": rank,
                "reference_rank": reference,
                "index": at,
                "expected": ref_seq[at] if at < len(ref_seq) else None,
                "actual": seq[at] if at < len(seq) else None,
                "expected_len": len(ref_seq),
                "actual_len": len(seq),
            })
            if len(divergences) >= _MAX_SEQUENCE_DIVERGENCES:
                break
        if len(divergences) >= _MAX_SEQUENCE_DIVERGENCES:
            break
    return {
        "valid": True,
        "consistent": not divergences,
        "tags_checked": len(tags),
        "windows_checked": windows_checked,
        "divergences": divergences,
    }


def merge(shards: Union[str, Sequence[dict]]) -> dict:
    """Fold N telemetry shards (a directory or loaded dicts) into ONE global
    report: exact counter sums, folded spans and collective tallies, merged
    latency histograms (the associative bucket fold), summed executor /
    lifecycle stats, cross-rank ``skew.<op>`` histograms with the straggler
    scoreboard, the collective-sequence consistency section (``sequence``:
    per-tag ordered site lists compared across ranks, first divergence per
    rank named), and per-process breakdowns. Raises ``ValueError`` on zero
    shards or inconsistent process counts."""
    shards = _resolve_shards(shards)
    if not shards:
        raise ValueError("no telemetry shards to merge")
    counts = {s["process"].get("count") for s in shards}
    if len(counts) > 1:
        raise ValueError(
            f"shards disagree on process count ({sorted(counts)}): "
            "they are not from one job"
        )
    counters: Dict[str, float] = {}
    spans: Dict[str, Dict[str, float]] = {}
    collectives: Dict[Tuple[str, str, int], Dict[str, int]] = {}
    hists: Dict[str, Any] = {}
    raw_hists: Dict[str, List[dict]] = {}
    executor: Dict[str, Any] = {}
    processes: Dict[str, dict] = {}
    aligned = all(s["clock"].get("aligned") for s in shards) and len(shards) > 1
    for shard in shards:
        idx = shard["process"]["index"]
        diag = shard.get("diagnostics") or {}
        for name, val in (diag.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + val
        for name, agg in (diag.get("spans") or {}).items():
            cur = spans.setdefault(
                name, {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            cur["count"] += agg.get("count", 0)
            cur["total_s"] += agg.get("total_s", 0.0)
            cur["max_s"] = max(cur["max_s"], agg.get("max_s", 0.0))
        for rec in diag.get("collectives") or ():
            key = (rec["op"], str(rec["axis"]), int(rec["participants"]))
            cur = collectives.setdefault(key, {"count": 0, "bytes": 0})
            cur["count"] += rec["count"]
            cur["bytes"] += rec["bytes"]
        prof = diag.get("profiler") or {}
        for name, snap in (prof.get("histograms") or {}).items():
            if profiler is not None:
                h = hists.get(name)
                if h is None:
                    hists[name] = _hist_from(snap)
                else:
                    h.merge(_hist_from(snap))
            else:  # degraded standalone merge: keep the raw snapshots
                raw_hists.setdefault(name, []).append(snap)
        if isinstance(diag.get("executor"), dict):
            _merge_numeric_tree(executor, diag["executor"])
        processes[str(idx)] = {
            "host": shard["process"].get("host"),
            "pid": shard["process"].get("pid"),
            "generated_at": shard.get("generated_at"),
            "counters": dict((diag.get("counters") or {})),
            "requests_total": prof.get("requests_total", 0),
            "flight_events": len(shard.get("flight", {}).get("events", ())),
            "flight_dumps": list(shard.get("flight", {}).get("dumps", ())),
            "collective_windows": len(
                shard.get("collectives", {}).get("windows", ())
            ),
        }
    skew = _compute_skew(shards)
    sequence = _sequence_check(shards)
    for site, entry in skew["sites"].items():
        if entry.get("histogram") is not None and profiler is not None:
            hists[f"skew.{_site_op(site)}"] = _hist_from(entry["histogram"])
    report = {
        "schema": MERGED_SCHEMA,
        "generated_at": _utcnow(),
        "processes": len(shards),
        "process_count": shards[0]["process"].get("count"),
        "clock": {
            "aligned": aligned,
            "anchors_monotonic_ns": shards[0]["clock"].get("anchors_monotonic_ns"),
        },
        "counters": {k: counters[k] for k in sorted(counters)},
        "spans": {k: spans[k] for k in sorted(spans)},
        "collectives": [
            {"op": op, "axis": axis, "participants": parts,
             "count": agg["count"], "bytes": agg["bytes"]}
            for (op, axis, parts), agg in sorted(collectives.items())
        ],
        "histograms": (
            {name: hists[name].snapshot() for name in sorted(hists)}
            if profiler is not None
            else {name: {"unmerged": snaps} for name, snaps in sorted(raw_hists.items())}
        ),
        "executor": executor,
        "skew": skew,
        "sequence": sequence,
        "per_process": processes,
    }
    return report


# ------------------------------------------------------------------ merged trace
def _remap_rids(trace: dict) -> dict:
    """Keep every request pid inside its process's :data:`PID_STRIDE` range.

    Profiler request ids come from an unbounded counter (only the request
    TABLE is capped), so a long-lived serving process can exceed the stride
    and bleed into the next process's pid range. When any rid is that large,
    renumber them densely (1..k, insertion order — k is bounded by the
    capped table/slice stores) and keep the original id visible in the tag."""
    rids = [e["id"] for e in trace.get("requests", ())]
    rids += [s[0] for s in trace.get("slices", ()) if s[0] is not None]
    if not rids or max(rids) < PID_STRIDE - 1:
        return trace
    mapping: Dict[int, int] = {}
    for rid in rids:
        if rid not in mapping:
            mapping[rid] = len(mapping) + 1
    return {
        "requests": [
            {**e, "id": mapping[e["id"]], "tag": f"{e['tag']} (rid {e['id']})"}
            for e in trace.get("requests", ())
        ],
        "slices": [
            [mapping.get(s[0]), *s[1:]] if s[0] is not None else list(s)
            for s in trace.get("slices", ())
        ],
        "counter_events": list(trace.get("counter_events", ())),
    }


def merged_trace(shards: Union[str, Sequence[dict]], *,
                 max_flows: int = 64) -> dict:
    """ONE Chrome/Perfetto trace for the whole job: each process's profiler
    timeline re-emitted into its own pid range (``p<i>/…`` track groups, so
    request tracks AND counter tracks from different ranks never collide or
    sum), timestamps aligned onto the handshake clock and rebased so the
    earliest event sits at t=0, a per-process ``collectives`` track built from
    the telemetry windows, and flow arrows linking the ``max_flows``
    worst-skew collectives across the process tracks."""
    shards = _resolve_shards(shards)
    if not shards:
        raise ValueError("no telemetry shards to merge")
    # pass 1: per-shard profiler->aligned shift and the global rebase
    shifts: Dict[int, float] = {}
    traces: Dict[int, dict] = {}
    min_ts = math.inf
    for shard in shards:
        idx = shard["process"]["index"]
        clock = shard["clock"]
        anchor_us = clock["anchor_monotonic_ns"] / 1e3
        origin_us = clock.get("profiler_origin_monotonic_us")
        shift = (origin_us - anchor_us) if origin_us is not None else -anchor_us
        shifts[idx] = shift
        trace = traces[idx] = _remap_rids(shard.get("trace") or {})
        for s in trace.get("slices", ()):
            min_ts = min(min_ts, s[4] + shift)
        for c in trace.get("counter_events", ()):
            min_ts = min(min_ts, c[1] + shift)
        for win in shard.get("collectives", {}).get("windows", ()):
            min_ts = min(min_ts, win[2] / 1e3 - anchor_us)
    rebase = -min_ts if min_ts is not math.inf and min_ts < 0 else 0.0
    events: List[dict] = []
    flow_groups: Dict[tuple, Dict[int, float]] = {}
    for shard in shards:
        idx = shard["process"]["index"]
        base = (idx + 1) * PID_STRIDE
        label = f"p{idx}"
        anchor_us = shard["clock"]["anchor_monotonic_ns"] / 1e3
        if profiler is not None and traces.get(idx):
            events.extend(profiler.trace_events(
                traces[idx], pid_offset=base,
                ts_shift_us=shifts[idx] + rebase, process_label=label,
            ))
        wins = shard.get("collectives", {}).get("windows", ())
        if wins:
            cpid = base + PID_STRIDE - 1
            events.append({"name": "process_name", "ph": "M", "pid": cpid,
                           "tid": 0, "args": {"name": f"{label}/collectives"}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": cpid, "tid": 0, "args": {"sort_index": cpid}})
            for win in wins:
                site, seq, t0, t1 = win[0], win[1], win[2], win[3]
                ts = t0 / 1e3 - anchor_us + rebase
                dur = max((t1 - t0) / 1e3, 1e-3)
                events.append({
                    "name": str(site), "cat": "collective", "ph": "X",
                    "ts": round(ts, 3), "dur": round(dur, 3),
                    "pid": cpid, "tid": 0, "args": {"seq": int(seq)},
                })
                flow_groups.setdefault(_window_key(win), {})[idx] = ts
    # flow arrows for the worst skews: same collective, every process track.
    # Without aligned clocks a "worst skew" ranking would order arbitrary
    # boot offsets — emit no arrows at all (the per-process tracks stay,
    # each self-consistent on its own clock).
    if not _clocks_aligned(shards):
        flow_groups.clear()
    ranked = sorted(
        ((max(g.values()) - min(g.values()), key, g)
         for key, g in flow_groups.items() if len(g) >= 2),
        key=lambda item: -item[0],
    )[:max(0, max_flows)]
    for flow_id, (_, (site, _tag, seq), group) in enumerate(ranked, start=1):
        members = sorted(group.items())
        for j, (idx, ts) in enumerate(members):
            ph = "s" if j == 0 else ("f" if j == len(members) - 1 else "t")
            ev = {
                "name": site, "cat": "collective-skew", "ph": ph,
                "id": flow_id, "pid": (idx + 1) * PID_STRIDE + PID_STRIDE - 1,
                "tid": 0, "ts": round(ts + 0.0005, 3), "args": {"seq": seq},
            }
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice, not its end
            events.append(ev)
    return {
        "schema": TRACE_SCHEMA,
        "displayTimeUnit": "ms",
        "traceEvents": events,
    }


# ------------------------------------------------------------------ artifact writers
def _atomic_json(path: str, payload: dict, site: str, *, indent=2,
                 sort_keys: bool = True) -> str:
    """The one JSON-artifact writer: through ``resilience.atomic_write`` when
    the resilience module is present (a crash mid-dump leaves the previous
    artifact, never a torn one), plain otherwise (standalone file-path
    loads). Every telemetry artifact — shards, flight post-mortems, merged
    reports/traces — routes here."""
    def _write(target: str) -> None:
        with open(target, "w") as f:
            json.dump(payload, f, indent=indent, sort_keys=sort_keys)
            f.write("\n")

    if resilience is not None:
        resilience.atomic_write(path, _write, site=site)
    else:
        _write(path)
    return path


def write_report(report: dict, path: str) -> str:
    """Write a merged report atomically; returns ``path``."""
    return _atomic_json(path, report, "telemetry.report")


def write_trace(trace: dict, path: str) -> str:
    """Write a merged trace atomically; returns ``path``."""
    return _atomic_json(path, trace, "telemetry.trace",
                        indent=None, sort_keys=False)


# ------------------------------------------------------------------ ops beats
#: filename prefix of per-rank ops-beat files (must match ``ops.BEAT_PREFIX``;
#: duplicated here because a standalone file-path load of this module has no
#: package to import ops from — tests/test_torch_ops.py asserts the two agree)
OPS_BEAT_PREFIX = "ops-beat-r"


def load_ops_beats(directory: str) -> Dict[str, dict]:
    """Read every ``ops-beat-r<rank>.json`` under ``directory`` into
    ``{rank: beat}`` — one LATEST beat per rank (each write replaces the
    rank's file atomically, so there is never more than one). Unparseable
    files raise: a torn beat must not pass silently as a healthy rank."""
    out: Dict[str, dict] = {}
    for name in sorted(os.listdir(directory)):
        if not (name.startswith(OPS_BEAT_PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        with open(path) as f:
            beat = json.load(f)
        rank = str(beat.get("rank", name[len(OPS_BEAT_PREFIX):-len(".json")]))
        out[rank] = beat
    return out


def _fold_ops_section(beats: Dict[str, dict]) -> dict:
    """The ``ops`` section of a merged report (``merge --from-ops``): the
    per-rank beats plus sums of the WINDOWED rates.

    Disjointness rule (why folding live scrapes alongside shards cannot
    double-count): the shard counters merged above are CUMULATIVE since
    process start, while every ops number is a windowed delta/rate over the
    last sample interval — the two live in different units over different
    spans, so they land in disjoint report sections (``counters`` /
    ``executor`` vs ``ops``) and are never added together. One beat per rank
    (latest-wins files), so the cross-rank sums here are exact for the
    beats' own windows.

    The per-tenant COST cells (``device_s`` / ``flops`` /
    ``collective_bytes`` from the forensics meters) are the one cumulative
    family riding the beats; they still obey the disjointness rule — they
    fold into their own ``tenant_cost`` sub-section here (exact cross-rank
    sums of per-rank cumulative meters), never into the windowed totals and
    never into the shard ``counters`` section."""
    ranks = {r: beats[r] for r in sorted(beats, key=lambda x: (len(x), x))}
    totals = {"rps": 0.0, "shed_rate": 0.0, "queue_depth": 0}
    alerts = []
    tenant_cost: Dict[str, Dict[str, float]] = {}
    for rank, beat in ranks.items():
        totals["rps"] += beat.get("rps") or 0.0
        totals["shed_rate"] += beat.get("shed_rate") or 0.0
        totals["queue_depth"] += beat.get("queue_depth") or 0
        for tenant, cell in (beat.get("tenants") or {}).items():
            if cell.get("alert"):
                alerts.append({"rank": rank, "tenant": tenant,
                               "burn_1m": cell.get("burn_1m")})
            if any(cell.get(k) for k in
                   ("device_s", "flops", "collective_bytes")):
                cost = tenant_cost.setdefault(
                    tenant, {"device_s": 0.0, "flops": 0.0,
                             "collective_bytes": 0.0})
                cost["device_s"] += cell.get("device_s") or 0.0
                cost["flops"] += cell.get("flops") or 0.0
                cost["collective_bytes"] += cell.get("collective_bytes") or 0.0
    return {
        "schema": "heat-tpu-ops-merged/1",
        "ranks": ranks,
        "totals": {k: round(v, 6) if isinstance(v, float) else v
                   for k, v in totals.items()},
        "alerts": alerts,
        "tenant_cost": {t: {k: round(v, 6) for k, v in c.items()}
                        for t, c in sorted(tenant_cost.items())},
    }


def _render_top(ranks: Dict[str, dict]) -> str:
    """The ``telemetry top`` table: one row per rank, nested rows per tenant
    with SLO state — the terminal view of :func:`heat_tpu_torch.core.ops
    .cluster_snapshot`."""
    lines = [f"{'RANK':>4}  {'RPS':>8}  {'SHED/S':>8}  {'HIT%':>6}  "
             f"{'DEPTH':>5}  {'DRAIN':>5}  {'SEQ':>6}"]
    for rank in sorted(ranks, key=lambda r: (len(r), r)):
        beat = ranks[rank]
        hit = beat.get("cache_hit_rate")
        lines.append(
            f"{rank:>4}  {beat.get('rps') or 0.0:>8.2f}  "
            f"{beat.get('shed_rate') or 0.0:>8.2f}  "
            f"{(hit * 100 if hit is not None else float('nan')):>6.1f}  "
            f"{beat.get('queue_depth') or 0:>5d}  "
            f"{'yes' if beat.get('draining') else '-':>5}  "
            f"{beat.get('seq') or 0:>6d}")
        for tenant, cell in sorted((beat.get("tenants") or {}).items()):
            p99 = cell.get("p99_ms")
            burn = cell.get("burn_1m")
            dev = cell.get("device_s")
            lines.append(
                f"      {tenant:<16} p99 "
                f"{(f'{p99:.2f}ms' if p99 is not None else '-'):>10}  "
                f"burn1m {(f'{burn:.2f}' if burn is not None else '-'):>6}  "
                f"cost {(f'{dev:.3f}s' if dev else '-'):>9}  "
                f"{'ALERT' if cell.get('alert') else 'ok'}")
    return "\n".join(lines)


def _render_slow(shards: List[dict], tenant: Optional[str],
                 limit: int) -> Tuple[int, str]:
    """The ``telemetry slow`` view: the slowest forensic exemplars across a
    directory of shards — each with its critical path, so "why was this
    slow" is answerable from merged artifacts offline. Exemplars ride shard
    dumps inside the ``diagnostics.forensics`` provider section (written
    when the run was armed with ``HEAT_TPU_FORENSICS=1``)."""
    rows: List[Tuple[Any, dict]] = []
    for shard in shards:
        rank = (shard.get("process") or {}).get("index", "?")
        fx = (shard.get("diagnostics") or {}).get("forensics") or {}
        for t, recs in (fx.get("exemplars") or {}).items():
            if tenant is not None and t != tenant:
                continue
            rows.extend((rank, r) for r in recs)
    if not rows:
        return 1, ("no forensic exemplars in these shards — was the run "
                   "armed with HEAT_TPU_FORENSICS=1?")
    rows.sort(key=lambda pr: (-pr[1].get("total_s", 0.0),
                              pr[1].get("rid", 0)))
    lines = []
    for rank, r in rows[:max(1, limit)]:
        lines.append(
            f"#{r.get('rid')} tenant={r.get('tenant')} rank={rank} "
            f"total={r.get('total_s', 0.0) * 1e3:.2f}ms "
            f"dominant={r.get('dominant')}")
        path = " -> ".join(
            f"{leg.get('stage')} {leg.get('share', 0.0) * 100:.0f}% "
            f"({leg.get('seconds', 0.0) * 1e3:.2f}ms)"
            for leg in r.get("critical_path") or [])
        lines.append(f"    path: {path or '(empty)'}")
    return 0, "\n".join(lines)


def _top_once(directory: Optional[str]) -> Tuple[int, str]:
    """One ``top`` refresh: beats from ``--dir`` files, else the live
    cluster fold over the coordination channel."""
    if directory:
        ranks = load_ops_beats(directory)
        if not ranks:
            return 1, f"no {OPS_BEAT_PREFIX}*.json beats under {directory}"
        return 0, _render_top(ranks)
    try:
        from . import ops
    except ImportError:
        return 1, ("telemetry top needs --dir in a standalone load "
                   "(no package to reach the live ops plane through)")
    snap = ops.cluster_snapshot()
    return 0, _render_top(snap["ranks"])


# ------------------------------------------------------------------ CLI
def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m heat_tpu_torch.telemetry merge --dir D [--out R] [--trace-out T]
    [--expect N] [--check] [--from-ops DIR]`` — fold a directory of
    per-process shards into one report (and optionally one merged trace).
    Unreadable/torn/inconsistent shards always exit non-zero. ``--expect``
    fails unless exactly N shards merged; ``--check`` (the CI gate)
    additionally requires a COMPLETE job — one shard per process recorded in
    the shards themselves — so a partial collection cannot pass as a global
    report. ``--from-ops`` folds a directory of live ops-beat files into the
    report's separate ``ops`` section (windowed rates; disjoint from the
    cumulative shard counters by construction — see ``_fold_ops_section``).

    ``python -m heat_tpu_torch.telemetry top [--dir D] [--watch N]`` — render the
    per-rank / per-tenant live operations table: from ``ops-beat-r*.json``
    files under ``--dir``, or (no ``--dir``) from the live cluster fold over
    the torch.distributed coordination channel (``ops.cluster_snapshot``).

    ``python -m heat_tpu_torch.telemetry slow --dir D [--limit N] [--tenant T]``
    — print the slowest forensic exemplars recorded in the shards under
    ``D`` (dumped by a run armed with ``HEAT_TPU_FORENSICS=1``), each with
    its per-stage critical path — the offline "why was this slow" view."""
    import argparse

    parser = argparse.ArgumentParser(prog="python -m heat_tpu_torch.telemetry")
    sub = parser.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="fold per-process shards into one report")
    mp.add_argument("--dir", required=True, help="directory holding telemetry-shard-*.json")
    mp.add_argument("--out", help="write the merged report JSON here")
    mp.add_argument("--trace-out", help="write the merged Perfetto trace here")
    mp.add_argument("--expect", type=int, default=None,
                    help="fail unless exactly N shards merged")
    mp.add_argument("--check", action="store_true",
                    help="CI gate: also require one shard per process of the "
                    "job (a partial collection must not pass as global) AND "
                    "cross-rank collective-sequence consistency — the same "
                    "ordered site list per request tag on every rank, the "
                    "runtime twin of the static spmd-divergent-collective "
                    "rule; a divergence names the first diverging rank/site")
    mp.add_argument("--from-ops", metavar="DIR", default=None,
                    help="also fold ops-beat-r*.json live-scrape files from "
                    "DIR into the report's `ops` section (windowed "
                    "rates/deltas — disjoint from the cumulative shard "
                    "counters, so nothing is double-counted)")
    tp = sub.add_parser("top", help="render the per-rank/per-tenant live "
                        "operations table")
    tp.add_argument("--dir", default=None,
                    help="read ops-beat-r*.json files instead of the live "
                    "coordination channel")
    tp.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="refresh every N seconds until interrupted")
    sp = sub.add_parser("slow", help="print the slowest forensic exemplars "
                        "from a directory of telemetry shards")
    sp.add_argument("--dir", required=True,
                    help="directory holding telemetry-shard-*.json")
    sp.add_argument("--limit", type=int, default=10,
                    help="show at most N exemplars (default 10)")
    sp.add_argument("--tenant", default=None,
                    help="only this tenant's exemplars")
    args = parser.parse_args(argv)

    if args.cmd == "slow":
        try:
            shards = load_shards(args.dir)
            if not shards:
                raise ValueError(
                    f"no {SHARD_PREFIX}*.json shards under {args.dir}")
        except (ValueError, OSError, KeyError) as exc:
            print(f"telemetry slow FAILED: {type(exc).__name__}: {exc}")
            return 1
        rc, text = _render_slow(shards, args.tenant, args.limit)
        print(text)
        return rc

    if args.cmd == "top":
        try:
            while True:
                rc, text = _top_once(args.dir)
                if args.watch is not None and rc == 0:
                    print("\x1b[2J\x1b[H", end="")
                print(text)
                if args.watch is None or rc != 0:
                    return rc
                time.sleep(max(0.1, args.watch))
        except KeyboardInterrupt:
            return 0
        except OSError as exc:
            print(f"telemetry top FAILED: {type(exc).__name__}: {exc}")
            return 1

    try:
        shards = load_shards(args.dir)
        if not shards:
            raise ValueError(f"no {SHARD_PREFIX}*.json shards under {args.dir}")
        if args.expect is not None and len(shards) != args.expect:
            raise ValueError(
                f"expected {args.expect} shards, found {len(shards)}"
            )
        if args.check:
            recorded = shards[0]["process"].get("count")
            if recorded is not None and len(shards) != recorded:
                raise ValueError(
                    f"incomplete job: {len(shards)} shard(s) for a "
                    f"{recorded}-process job"
                )
        report = merge(shards)
        if args.from_ops:
            report["ops"] = _fold_ops_section(load_ops_beats(args.from_ops))
        # the trace is the expensive half (every slice re-serialised): only
        # build it when someone asked for it
        trace = merged_trace(shards) if args.trace_out else None
    except (ValueError, OSError, KeyError) as exc:
        print(f"telemetry merge FAILED: {type(exc).__name__}: {exc}")
        return 1
    if args.out:
        write_report(report, args.out)
        print(f"merged report -> {args.out}")
    if args.trace_out:
        write_trace(trace, args.trace_out)
        print(f"merged trace  -> {args.trace_out}")
    skew = report["skew"]
    sequence = report["sequence"]
    print(json.dumps({
        "shards": len(shards),
        "aligned": report["clock"]["aligned"],
        "counters": len(report["counters"]),
        "histograms": len(report["histograms"]),
        "collectives_measured": skew["collectives_measured"],
        # an invalid gate must never read as an affirmative "consistent"
        "sequence_consistent": sequence["consistent"] if sequence["valid"] else None,
        "sequence_valid": sequence["valid"],
        "slowest_rank": skew["slowest_rank"],
    }, sort_keys=True))
    if args.check and not sequence["valid"]:
        # a gate that cannot check must not pass as a gate that checked
        print(
            "telemetry merge FAILED: collective-sequence gate could not "
            f"run: {sequence.get('reason', 'unknown')}"
        )
        return 1
    if args.check and sequence["valid"] and not sequence["consistent"]:
        d = sequence["divergences"][0]
        site = d["actual"] or d["expected"]
        have = d["actual"] or "(sequence ended)"
        want = d["expected"] or "(sequence ended)"
        print(
            "telemetry merge FAILED: cross-rank collective-sequence "
            f"divergence: rank {d['rank']} diverges from rank "
            f"{d['reference_rank']} at {site} "
            f"(tag={d['tag']!r}, index {d['index']}: expected {want}, "
            f"got {have}; lengths {d['expected_len']} vs {d['actual_len']}) "
            "— a rank-dependent branch issued a different collective "
            "sequence; this job would hang on a real mesh"
        )
        return 1
    return 0


# ------------------------------------------------------------------ wiring
# Install the flight-recorder tees into diagnostics (it cannot import this
# module — that would be a cycle). Under a standalone file-path load there is
# no shared diagnostics instance, so the ring only sees explicit records.
if diagnostics is not None:
    diagnostics._resilience_tee = _on_resilience_event
    diagnostics._fallback_tee = _on_fallback_event

# Env bootstrap: collection on from the start (the multi-process CI jobs).
if os.environ.get("HEAT_TPU_TELEMETRY") == "1":
    _collecting = True

# Backend-free CLI: `python heat_tpu_torch/core/telemetry.py merge --dir shards/`
# runs the merge as a standalone file-path load — no package import, no torch
# (the `python -m heat_tpu_torch.telemetry` spelling imports the package, which
# loads torch; use this form on login/tooling nodes).
if __name__ == "__main__":
    import sys as _main_sys

    _main_sys.exit(main())
