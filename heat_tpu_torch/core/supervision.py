"""``ht.supervision`` (the port's copy of heat_tpu/core/supervision.py) — the
distributed supervision plane: heartbeats, a collective watchdog, coordinated typed
abort, and elastic restart.

Static analysis prevents *divergent* collective sequences, but a peer that dies or
wedges mid-step still strands every other rank inside a collective (or a
coordination wait) forever: a hang, not a crash. This module turns any
single-process failure into a typed error on every survivor within a bounded
budget, and — together with the checkpoint's reshard-on-restore — into automatic
recovery:

- **Heartbeats + abort sentinel.** Each process publishes a monotonic heartbeat
  over the coordination store of the job (:class:`ClientCoordinator`: a
  ``torch.distributed`` ``TCPStore``, or a ``FileStore`` for file rendezvous —
  no collective, no device). A daemon monitor detects a peer whose beat has not
  advanced for ``HEAT_TPU_PEER_TIMEOUT_S`` and posts a cluster-wide *abort
  sentinel*; every rank polls it at the communication chokepoint
  (``communication._guarded``), at the scheduler's pre-dispatch checkpoint, and
  inside every supervised coordination wait — raising typed
  :class:`~.resilience.PeerFailed` on all survivors, never a silent hang. A rank
  that exits cleanly publishes a departure marker first, so normal shutdown is not
  a failure.

- **Collective watchdog.** :func:`watch` arms a per-collective deadline around
  every guarded collective when ``HEAT_TPU_COLLECTIVE_TIMEOUT_S`` is set (off by
  default). A window that overruns triggers a flight-recorder auto-dump (trigger
  kind ``supervision.watchdog``), posts the abort sentinel, and delivers typed
  :class:`~.resilience.CollectiveTimeout` — on the survivors at their next
  sentinel poll, and on the stuck rank itself the moment its call unblocks. A
  collective that *fails* while the plane is armed (gloo raises when a peer's
  connection closes) waits up to two peer budgets for the monitor's verdict and
  then raises the typed abort error from the backend's, so a dead peer surfaces as
  ``PeerFailed`` and not as a backend ``RuntimeError``.

- **Supervised coordination waits.** :func:`kv_wait` / :func:`kv_barrier`: the
  wait is chunked so the sentinel is polled while blocked, bounded by the unified
  ``HEAT_TPU_COORD_TIMEOUT_MS`` budget, and exhaustion raises typed
  :class:`~.resilience.CoordinationTimeout` naming the key and the ranks still
  missing. The checkpoint's barriers and agreements run through them whenever the
  plane is armed on a store.

- **Elastic restart.** :func:`run_supervised` (also exported as
  ``ht.resilience.run_supervised``) wraps a training loop: on ``PeerFailed`` /
  ``CollectiveTimeout`` / ``CoordinationTimeout`` it drains the dispatch scheduler
  (typed), tears down the process group, re-initializes at the surviving world size
  (the caller's ``reinit`` policy names the new rendezvous), restores the latest
  ``CheckpointManager`` step through the reshard-on-restore path, and resumes —
  under a bounded restart budget (an ``ht.resilience.Policy`` plus the
  ``supervision.restart`` circuit breaker).

How heat_tpu's ``jax.distributed`` runtime maps onto the port
-------------------------------------------------------------
- **Coordinator.** :class:`LocalCoordinator` is heat_tpu's. :class:`ClientCoordinator`
  wraps a ``torch.distributed.Store``. A store cannot list keys by prefix, so the
  directory semantics of :meth:`ClientCoordinator.get_dir` are built from keys it
  can enumerate: every ``set`` also records the key in an index of each ancestor
  directory (a counter and numbered name keys, ``add`` and ``set`` only, the
  methods every store has), and ``get_dir`` reads the index and keeps the keys
  that still exist (``check``).
- **Bootstrap.** :func:`bootstrap_distributed` makes the store (a ``TCPStore``
  with rank 0 as its server, or a ``FileStore`` for a ``file://`` address) and
  joins ``init_process_group`` over it, with the process group's timeout from
  ``HEAT_TPU_COLLECTIVE_TIMEOUT_S`` (else ``HEAT_TPU_COORD_TIMEOUT_MS``).
- **Teardown.** Clean: ``destroy_process_group``. Dirty (a peer is dead): the
  group's communicators are aborted first (``_abort_process_group`` where torch has
  it, else the NCCL backend's ``abort``) — NCCL would otherwise block on the dead
  peer — then the group is destroyed; the dead generation's store joins the
  graveyard (a ``TCPStore`` server must outlive clients that may still poll it).

Zero-cost contract: idle, the one hook on a hot path — the chokepoint check in
``communication._guarded`` — is a single module-attribute read
(``supervision._armed``) and a branch not taken. Armed, the per-collective cost is
a relaxed bool read (:func:`poll`) plus, with the watchdog on, one dict
insert/remove. Nothing is added to what the card runs.

Thread-safety: registries — the watchdog window table, the monitor's per-peer
bookkeeping, the abort payload, the graveyard — mutate under the one module
``_lock`` (a leaf; nothing holding it calls into another locking module).
``_armed`` and ``_aborted`` are the relaxed hot-path switches; the abort payload
they point at is installed before the flag flips and never mutated after.

Env knobs (memoised; re-read by :func:`reload_env_knobs`, which
``_executor.reload_env_knobs()`` calls too):

- ``HEAT_TPU_SUPERVISION=0``          — disable the plane entirely.
- ``HEAT_TPU_PEER_TIMEOUT_S``         — missed-beat budget before a peer is
  declared failed (default 60).
- ``HEAT_TPU_COLLECTIVE_TIMEOUT_S``   — per-collective watchdog deadline
  (default 0 = watchdog off).
- ``HEAT_TPU_COORD_TIMEOUT_MS``       — the unified coordination wait budget
  (default 600000).

Stdlib-only at module load: ``torch.distributed`` is imported inside the functions
that make or tear down the runtime.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

try:  # standalone file-path load (tooling without the package): degrade like siblings
    from . import diagnostics, resilience, telemetry
except ImportError:  # pragma: no cover - exercised via tests/test_analysis.py
    diagnostics = resilience = telemetry = None

__all__ = [
    "LocalCoordinator",
    "ClientCoordinator",
    "Monitor",
    "arm",
    "disarm",
    "armed",
    "auto_arm",
    "poll",
    "abort_error",
    "aborted",
    "post_abort",
    "current_monitor",
    "forget_peer",
    "watch",
    "kv_wait",
    "kv_barrier",
    "coord_timeout_ms",
    "peer_timeout_s",
    "collective_timeout_s",
    "enabled",
    "reload_env_knobs",
    "bootstrap_distributed",
    "teardown_distributed",
    "run_supervised",
    "supervision_stats",
]

# Hot-path gates, read bare by the communication chokepoint and the
# scheduler loop: one attribute load + branch when idle — the zero-cost
# contract. ``_armed``: a monitor is running (or a test armed the plane).
# ``_aborted``: an abort sentinel was observed; the payload in ``_abort`` is
# installed BEFORE this flips and never mutated after, so relaxed readers can
# hand it to abort_error() without the lock.
_armed: bool = False
_aborted: bool = False

_lock = threading.RLock()

_abort: Optional[dict] = None
_monitor: Optional["Monitor"] = None
_thread: Optional[threading.Thread] = None
_thread_stop: Optional[threading.Event] = None
_generation: int = 0

# Late-bound collaborator hook (the diagnostics tee pattern): ``ht.ops``
# installs its beat publisher here at ITS import so every monitor tick also
# carries the rank's compact ops beat on the same KV channel — this module
# cannot import ops (that would be a cycle). Written once, read bare; the
# tee itself gates on ``ops._armed``, so the idle cost per tick is one
# foreign attribute load + branch.
_ops_tee: Optional[Callable[["Monitor"], None]] = None

# watchdog: token -> (site, start_monotonic, deadline_monotonic); tokens the
# scan flagged overdue move to _watch_fired so the stuck rank raises typed
# the moment its call unblocks
_watch_seq = itertools.count(1)
_watch_windows: Dict[int, Tuple[str, float, float]] = {}
_watch_fired: Dict[int, float] = {}

# the dead-generation graveyard: the coordination stores of abandoned runtimes,
# kept referenced so a TCPStore server outlives the clients that may still poll it
_graveyard: List[Any] = []

# process identity as armed (mirrors telemetry's, but supervision must work
# when telemetry degraded): set by arm()
_rank: int = 0
_nprocs: int = 1

_restarts: int = 0  # elastic restarts performed by this process

# the supervised bootstrap's store, and whether this module built the process
# group (then the atexit hook tears it down)
_store: Any = None
_owns_client: bool = False
_atexit_registered: bool = False

_CHUNK_MS = 2000  # sentinel-poll cadence inside a supervised wait


# ----------------------------------------------------------------- env knobs
class _Knobs:
    __slots__ = ("enabled", "peer_timeout_s", "collective_timeout_s",
                 "coord_timeout_ms")

    def reload(self) -> None:
        def _num(name: str, default: float, lo: float) -> float:
            try:
                return max(lo, float(os.environ.get(name, "") or default))
            except ValueError:
                return default

        self.enabled = os.environ.get("HEAT_TPU_SUPERVISION", "1") != "0"
        self.peer_timeout_s = _num("HEAT_TPU_PEER_TIMEOUT_S", 60.0, 0.1)
        self.collective_timeout_s = _num("HEAT_TPU_COLLECTIVE_TIMEOUT_S", 0.0, 0.0)
        self.coord_timeout_ms = int(_num("HEAT_TPU_COORD_TIMEOUT_MS", 600_000, 1))


_knobs = _Knobs()
_knobs.reload()


def reload_env_knobs() -> None:
    """Re-read the memoised ``HEAT_TPU_SUPERVISION`` / ``PEER_TIMEOUT_S`` /
    ``COLLECTIVE_TIMEOUT_S`` / ``COORD_TIMEOUT_MS`` knobs from ``os.environ``
    (``_executor.reload_env_knobs()`` calls this too, so one re-read point
    covers the whole framework), and re-apply the process group's timeout
    (:func:`_apply_pg_timeout`)."""
    _knobs.reload()
    _apply_pg_timeout()


def _pg_timeout_s() -> float:
    """The live process group's collective timeout: the watchdog budget when set,
    else the coordination budget."""
    return _knobs.collective_timeout_s or max(1.0, _knobs.coord_timeout_ms / 1e3)


def _apply_pg_timeout() -> None:
    """Bound every collective of the initialized default group by
    :func:`_pg_timeout_s`. An abort does not interrupt a gloo collective blocked on a
    peer that left it (the peer's socket stays open while it recovers); its timeout
    does, and the failure then surfaces typed through :func:`watch`. Only while the
    plane is enabled and ``torch.distributed`` is loaded and initialized."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if not _knobs.enabled or dist is None or not (dist.is_available() and dist.is_initialized()):
        return
    setter = getattr(dist.distributed_c10d, "_set_pg_timeout", None)
    if setter is None:
        return
    import datetime

    try:
        setter(datetime.timedelta(seconds=_pg_timeout_s()))
    except Exception as exc:  # a backend that refuses: the timeout given at init stays
        record_resilience_event("supervision.runtime", "pg-timeout-unchanged",
                f"{type(exc).__name__}: {exc}")


def enabled() -> bool:
    """Whether the supervision plane is enabled (``HEAT_TPU_SUPERVISION``,
    default on; memoised)."""
    return _knobs.enabled


def peer_timeout_s() -> float:
    """Missed-beat budget before a peer is declared failed
    (``HEAT_TPU_PEER_TIMEOUT_S``, default 60; memoised)."""
    return _knobs.peer_timeout_s


def collective_timeout_s() -> float:
    """Per-collective watchdog deadline (``HEAT_TPU_COLLECTIVE_TIMEOUT_S``,
    default 0 = watchdog off; memoised)."""
    return _knobs.collective_timeout_s


def coord_timeout_ms() -> int:
    """The unified coordination-channel wait budget
    (``HEAT_TPU_COORD_TIMEOUT_MS``, default 600000; memoised). Replaces the
    old hardcoded handshake/checkpoint timeouts."""
    return _knobs.coord_timeout_ms


def record_resilience_event(site: str, kind: str, detail: str = "") -> None:
    """Forward one supervision event into the always-on resilience stream
    (``supervision.*`` sites; the flight-recorder tee sees every one)."""
    if diagnostics is not None:
        diagnostics.record_resilience_event(site, kind, detail)


def _count(name: str) -> None:
    if diagnostics is not None:
        diagnostics.counter(name)


# -------------------------------------------------------------- coordinators
class LocalCoordinator:
    """An in-memory KV coordinator: the single-process stand-in for the
    job's coordination store, so the heartbeat state machine,
    the watchdog, and the supervised waits are testable (and chaos-drivable)
    without real process murder. Same surface as :class:`ClientCoordinator`.

    Thread-safe: one condition variable guards the store; :meth:`wait` blocks
    on it, so a publisher wakes waiters promptly like the real service.

    The semantics deliberately MATCH heat_tpu's coordination service and
    :class:`ClientCoordinator`, so tests exercise what production does: :meth:`get_dir` has DIRECTORY semantics — it returns
    keys strictly *under* the prefix, never a key exactly equal to it — and
    :meth:`delete` removes the key AND its whole subtree."""

    def __init__(self):
        self._cv = threading.Condition()
        self._kv: Dict[str, str] = {}

    @staticmethod
    def _as_dir(prefix: str) -> str:
        return prefix if prefix.endswith("/") else prefix + "/"

    def set(self, key: str, value: str, overwrite: bool = True) -> None:
        with self._cv:
            if not overwrite and key in self._kv:
                raise ValueError(f"key {key!r} already set")
            self._kv[key] = value
            self._cv.notify_all()

    def get_dir(self, prefix: str) -> List[Tuple[str, str]]:
        p = self._as_dir(prefix)
        with self._cv:
            return [(k, v) for k, v in sorted(self._kv.items())
                    if k.startswith(p)]

    def wait(self, key: str, timeout_ms: int) -> str:
        with self._cv:
            ok = self._cv.wait_for(lambda: key in self._kv,
                                   timeout=max(0.0, timeout_ms / 1e3))
            if not ok:
                raise TimeoutError(f"key {key!r} not set within {timeout_ms}ms")
            return self._kv[key]

    def delete(self, key: str) -> None:
        p = self._as_dir(key)
        with self._cv:
            self._kv.pop(key, None)
            for k in [k for k in self._kv if k.startswith(p)]:
                del self._kv[k]


class ClientCoordinator:
    """The coordinator surface over a ``torch.distributed.Store`` (``TCPStore``,
    ``FileStore``, or the default group's store): heat_tpu's ``jax.distributed``
    client, mapped onto the calls every store offers (``set``, ``get``, ``add``,
    ``check``, ``wait``, ``delete_key``, ``compare_set``).

    A store lists no keys by prefix, so :meth:`get_dir` reads an index: each
    :meth:`set` also registers the key under every ancestor directory
    (``<_IDX>/<dir>/#n``, a counter bumped by ``add``, and ``<_IDX>/<dir>/#<i>``,
    the i-th key name), once per key and process. Reads keep the indexed keys that
    still exist, so :meth:`delete` (the key and its subtree, as heat_tpu's) needs
    no index update; a re-set key after a delete is found again through its old
    index entry."""

    _IDX = "heat_tpu/__idx__"

    def __init__(self, store):
        self._store = store
        self._indexed: set = set()
        self._ilock = threading.Lock()

    @property
    def store(self):
        return self._store

    @staticmethod
    def _dirs(key: str) -> List[str]:
        parts = key.split("/")
        return ["/".join(parts[:i]) + "/" for i in range(1, len(parts))]

    def _index(self, key: str) -> None:
        with self._ilock:
            if key in self._indexed:
                return
            self._indexed.add(key)
        for d in self._dirs(key):
            n = self._store.add(f"{self._IDX}/{d}#n", 1)
            self._store.set(f"{self._IDX}/{d}#{n}", key)

    def set(self, key: str, value: str, overwrite: bool = True) -> None:
        if overwrite:
            self._store.set(key, value)
        else:
            got = self._store.compare_set(key, "", value)  # ht: ignore[coord-unbounded-wait] -- a compare-and-set answers at once: it never waits for the key
            if isinstance(got, bytes):
                got = got.decode()
            if got != value or self._store.get(key).decode() != value:  # ht: ignore[coord-unbounded-wait] -- the compare-and-set above has just set the key, so the read answers at once
                raise ValueError(f"key {key!r} already set")
        self._index(key)

    def _get(self, key: str) -> Optional[str]:
        if not self._store.check([key]):
            return None
        try:
            return self._store.get(key).decode()  # ht: ignore[coord-unbounded-wait] -- guarded by check([key]) just above: the key exists, so the read answers at once (a delete in between raises, handled below)
        except Exception:  # ht: ignore[silent-except] -- deleted between check and get: absent, as a listing taken a moment later would show
            return None

    def get_dir(self, prefix: str) -> List[Tuple[str, str]]:
        d = prefix if prefix.endswith("/") else prefix + "/"
        n = int(self._store.add(f"{self._IDX}/{d}#n", 0))
        names = set()
        for i in range(1, n + 1):
            name = self._get(f"{self._IDX}/{d}#{i}")
            if name is not None and name.startswith(d):
                names.add(name)
        out = []
        for name in sorted(names):
            value = self._get(name)
            if value is not None:
                out.append((name, value))
        return out

    def wait(self, key: str, timeout_ms: int) -> str:
        import datetime

        self._store.wait([key], datetime.timedelta(milliseconds=max(1, int(timeout_ms))))
        return self._store.get(key).decode()  # ht: ignore[coord-unbounded-wait] -- after the bounded wait on the same key above: the key exists, so the read answers at once

    def delete(self, key: str) -> None:
        for name, _ in self.get_dir(key):
            self._store.delete_key(name)
        self._store.delete_key(key)


def _default_store():
    """The store of the initialized default process group: the supervised
    bootstrap's own, else the one ``init_process_group`` made; None without a
    group."""
    if _store is not None:
        return _store
    try:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return None
        return dist.distributed_c10d._get_default_store()
    except Exception as exc:  # a torch without the accessor: stay store-less
        record_resilience_event("supervision.plane", "store-unavailable",
                f"{type(exc).__name__}: {exc}")
        return None


def default_coordinator() -> Optional[ClientCoordinator]:
    """A coordinator over the live process group's store, or None when no group
    is initialized (single-process runs)."""
    store = _default_store()
    return ClientCoordinator(store) if store is not None else None


def _require_coordinator(coordinator=None):
    if coordinator is not None:
        return coordinator
    with _lock:
        if _monitor is not None:
            return _monitor.coordinator
    co = default_coordinator()
    if co is None:
        raise RuntimeError(
            "supervised coordination wait needs an initialized process "
            "group's store (or an explicit coordinator)"
        )
    return co


# ------------------------------------------------------------- typed errors
def _errors():
    """The typed supervision error classes (from ht.resilience — the error
    vocabulary module). Standalone loads degrade to RuntimeError lookups."""
    if resilience is not None:
        return (resilience.PeerFailed, resilience.CollectiveTimeout,
                resilience.CoordinationTimeout)
    raise RuntimeError("supervision typed errors need ht.resilience")


def abort_error(site: str = "") -> Optional[BaseException]:
    """The typed exception for the installed abort sentinel, or None. Each
    call constructs a FRESH exception (tracebacks must not be shared across
    raising threads)."""
    if not _aborted:
        return None
    with _lock:
        payload = dict(_abort) if _abort is not None else None
    if payload is None:  # pragma: no cover - _aborted implies _abort installed
        return None
    PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
    kind = payload.get("kind", "peer-failed")
    if kind == "collective-timeout":
        return CollectiveTimeout(
            payload.get("site", site or "<unknown>"),
            float(payload.get("elapsed_s", 0.0)),
            detected_by=int(payload.get("by", -1)),
        )
    if kind == "coordination-timeout":
        return CoordinationTimeout(
            payload.get("site", site or "<unknown>"),
            key=payload.get("key", ""),
            timeout_ms=int(payload.get("timeout_ms", 0)),
            waiting_on=payload.get("waiting_on", ()),
        )
    return PeerFailed(
        int(payload.get("rank", -1)),
        float(payload.get("last_seen_s", 0.0)),
        detected_by=int(payload.get("by", -1)),
    )


def poll(site: str = "") -> None:
    """The sentinel chokepoint: raise the typed abort error if one is
    installed, else return immediately (one relaxed bool read). Called by
    ``communication._guarded``, the scheduler's pre-dispatch checkpoint,
    and every supervised coordination wait."""
    if _aborted:
        exc = abort_error(site)
        if exc is not None:
            raise exc


def aborted() -> Optional[dict]:
    """The installed abort-sentinel payload, or None."""
    with _lock:
        return dict(_abort) if _abort is not None else None


def _install_abort_locked(payload: dict) -> None:
    # called with _lock held (the _locked-suffix convention)
    global _abort, _aborted
    if _abort is None:
        _abort = dict(payload)
        _aborted = True


def _replace_abort_locked(payload: dict) -> None:
    # adopt a racing peer's earlier sentinel payload; with _lock held
    global _abort, _aborted
    _abort = dict(payload)
    _aborted = True


def post_abort(kind: str, *, site: str = "", coordinator=None, **fields) -> dict:
    """Post the cluster-wide abort sentinel (first poster wins — a racing
    second abort keeps the original payload) and install it locally. Returns
    the effective payload. Records a ``supervision.abort`` resilience event
    of ``kind`` — the kinds (``peer-failed`` / ``collective-timeout`` /
    ``coordination-timeout``) are flight-recorder auto-dump triggers, so
    every abort ships a post-mortem."""
    payload = {"kind": kind, "by": _rank, "site": site, **fields}
    with _lock:
        mon = _monitor
        _install_abort_locked(payload)
        effective = dict(_abort)
    co = coordinator or (mon.coordinator if mon is not None else None)
    if co is not None and mon is not None:
        try:
            co.set(mon.sentinel_key, json.dumps(effective), False)
        except Exception as exc:
            # a racing rank posted first, or the channel is already gone:
            # adopt the original payload when readable; either way the LOCAL
            # abort above already guarantees typed delivery on this rank
            record_resilience_event("supervision.abort", "post-raced",
                    f"{type(exc).__name__}: {exc}")
            try:
                found = co.get_dir(mon.abort_key)
                if found:
                    prior = json.loads(found[0][1])
                    with _lock:
                        _replace_abort_locked(prior)
                    effective = prior
            except Exception as exc2:
                record_resilience_event("supervision.abort", "sentinel-unreadable",
                        f"{type(exc2).__name__}: {exc2}")
    record_resilience_event("supervision.abort", kind, json.dumps(effective))
    _count(f"supervision.abort.{kind}")
    return effective


# ----------------------------------------------------------------- monitor
class Monitor:
    """The heartbeat + watchdog state machine, one :meth:`step` per tick.

    Deliberately thread-free: the daemon thread :func:`arm` starts just calls
    ``step(clock())`` in a loop, and tests drive the same machine with an
    injected clock and a :class:`LocalCoordinator` — the
    heartbeat/departure/detection logic is exercised without wall time or
    real processes.

    Peer liveness is judged on the OBSERVER's clock: a peer's beat value is
    tracked with the local time it last *changed*; a beat that has not
    advanced for ``peer_timeout_s`` marks the peer failed. Cross-process
    clock skew therefore never enters the decision, and a peer that died
    before its first beat is aged from this monitor's start."""

    def __init__(self, coordinator, rank: int, nprocs: int, *,
                 generation: int, peer_timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.coordinator = coordinator
        self.rank = int(rank)
        self.nprocs = int(nprocs)
        self.generation = int(generation)
        self.peer_timeout_s = float(peer_timeout_s)
        self.clock = clock
        self.ns = f"heat_tpu/sup/{generation}"
        # the sentinel is STORED under the prefix (abort_key is the
        # directory, sentinel_key the one entry in it): the real service's
        # key_value_dir_get has directory semantics — a key exactly equal to
        # the prefix is never returned — so readers get_dir(abort_key) and
        # the payload must live strictly below it
        self.abort_key = f"{self.ns}/abort"
        self.sentinel_key = f"{self.ns}/abort/0"
        self._seq = 0
        started = clock()
        # rank -> (last beat value seen, local time it last changed)
        self._seen: Dict[int, Tuple[Optional[str], float]] = {
            r: (None, started) for r in range(self.nprocs) if r != self.rank
        }
        self._departed: set = set()

    # ------------------------------------------------------------ publishing
    def beat(self) -> None:
        """Publish this rank's next heartbeat (monotonic counter)."""
        self._seq += 1
        self.coordinator.set(f"{self.ns}/hb/{self.rank}", str(self._seq), True)

    def depart(self) -> None:
        """Publish the clean-departure marker: peers stop expecting beats."""
        try:
            self.coordinator.set(f"{self.ns}/bye/{self.rank}", "1", True)
        except Exception as exc:
            record_resilience_event("supervision.heartbeat", "depart-unpublished",
                    f"{type(exc).__name__}: {exc}")

    def forget(self, rank: int) -> None:
        """Stop expecting beats from ``rank``: its failure has been HANDLED
        (e.g. the serving failover shed its work typed and the pool serves
        on) — without this the next scan would re-detect the same silent
        peer and re-post the abort the handler just cleared."""
        self._departed.add(int(rank))

    # ------------------------------------------------------------- detection
    def scan(self, now: float) -> Optional[dict]:
        """One detection pass: read peers' beats and departures, age the
        silent ones, and post the abort sentinel for the first peer past the
        budget. Returns the posted payload, or None."""
        beats: Dict[int, str] = {}
        for key, value in self.coordinator.get_dir(f"{self.ns}/hb/"):
            try:
                beats[int(key.rsplit("/", 1)[-1])] = value
            except ValueError:
                continue  # foreign key under the prefix: not a beat
        for key, _ in self.coordinator.get_dir(f"{self.ns}/bye/"):
            try:
                self._departed.add(int(key.rsplit("/", 1)[-1]))
            except ValueError:
                continue
        for r, (last, changed) in list(self._seen.items()):
            if r in self._departed:
                continue
            cur = beats.get(r)
            if cur is not None and cur != last:
                self._seen[r] = (cur, now)
                continue
            age = now - changed
            if age > self.peer_timeout_s:
                record_resilience_event(
                    "supervision.heartbeat", "peer-missed",
                    f"rank {r} silent for {age:.3f}s "
                    f"(budget {self.peer_timeout_s:.3f}s)",
                )
                return post_abort(
                    "peer-failed", site="supervision.heartbeat",
                    rank=r, last_seen_s=round(age, 3),
                )
        return None

    def check_sentinel(self) -> Optional[dict]:
        """Adopt a peer-posted abort sentinel into the local abort state."""
        if _aborted:
            return aborted()
        found = self.coordinator.get_dir(self.abort_key)
        if not found:
            return None
        try:
            payload = json.loads(found[0][1])
        except ValueError:
            payload = {"kind": "peer-failed", "rank": -1, "last_seen_s": 0.0}
        with _lock:
            _install_abort_locked(payload)
        record_resilience_event("supervision.abort", "adopted", json.dumps(payload))
        return payload

    # -------------------------------------------------------------- watchdog
    def watchdog_scan(self, now: float) -> Optional[dict]:
        """Flag in-flight collective windows past their deadline: mark the
        window fired (the stuck rank raises when it unblocks), dump a
        ``supervision.watchdog`` post-mortem, and post the sentinel so every
        survivor aborts typed."""
        overdue: Optional[Tuple[int, str, float]] = None
        with _lock:
            for token, (site, start, deadline) in _watch_windows.items():
                if now >= deadline and token not in _watch_fired:
                    _watch_fired[token] = now - start
                    overdue = (token, site, now - start)
                    break
        if overdue is None:
            return None
        _token, site, elapsed = overdue
        record_resilience_event(
            "supervision.watchdog", "watchdog-fired",
            f"collective window at {site!r} stuck for {elapsed:.3f}s "
            f"(budget {collective_timeout_s():.3f}s)",
        )
        _count("supervision.watchdog.fired")
        if telemetry is not None:
            telemetry.flight_record(
                "supervision", site,
                f"stuck collective window: {elapsed:.3f}s", kind="watchdog",
            )
            telemetry.flight_dump("supervision.watchdog")
        return post_abort(
            "collective-timeout", site=site, elapsed_s=round(elapsed, 3),
        )

    def step(self, now: Optional[float] = None) -> None:
        """One monitor tick: beat, adopt/post sentinels, age peers, scan the
        watchdog. Each leg is independent; a channel error in one must not
        starve the others (it is recorded and retried next tick)."""
        now = self.clock() if now is None else now
        try:
            self.beat()
        except Exception as exc:
            record_resilience_event("supervision.heartbeat", "beat-unpublished",
                    f"{type(exc).__name__}: {exc}")
        tee = _ops_tee
        if tee is not None:
            try:
                tee(self)
            except Exception as exc:
                record_resilience_event(
                    "supervision.heartbeat", "ops-beat-unpublished",
                    f"{type(exc).__name__}: {exc}")
        try:
            self.check_sentinel()
            if not _aborted:
                self.scan(now)
        except Exception as exc:
            record_resilience_event("supervision.heartbeat", "scan-failed",
                    f"{type(exc).__name__}: {exc}")
        self.watchdog_scan(now)


# ------------------------------------------------------------ arm / disarm
def _tick_interval(timeout_s: float) -> float:
    """Monitor cadence: a few beats per peer-timeout window, bounded to stay
    responsive for test-scale budgets and cheap for production ones."""
    return min(1.0, max(0.05, timeout_s / 5.0))


def arm(coordinator=None, *, rank: Optional[int] = None,
        nprocs: Optional[int] = None, peer_timeout_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        start_thread: bool = True) -> Monitor:
    """Arm the supervision plane: start heartbeats + the monitor daemon on
    ``coordinator`` (default: the live process group's store) for this
    ``rank`` of ``nprocs``. Re-arming replaces the previous monitor (a new
    generation namespace). ``start_thread=False`` leaves stepping to the
    caller — the injected-clock tests."""
    global _armed, _monitor, _thread, _thread_stop, _generation, _rank, _nprocs
    if rank is None or nprocs is None:
        if telemetry is not None:
            t_rank, t_count = telemetry.process_info()
        else:  # pragma: no cover - standalone load
            t_rank, t_count = 0, 1
        rank = t_rank if rank is None else rank
        nprocs = t_count if nprocs is None else nprocs
    co = coordinator if coordinator is not None else default_coordinator()
    if co is None:
        co = LocalCoordinator()
    disarm()
    with _lock:
        _generation += 1
        _rank, _nprocs = int(rank), int(nprocs)
        monitor = Monitor(
            co, rank, nprocs, generation=_generation,
            peer_timeout_s=(peer_timeout_s if peer_timeout_s is not None
                            else _knobs.peer_timeout_s),
            clock=clock,
        )
        _monitor = monitor
        stop = _thread_stop = threading.Event()
    _armed = True
    _register_atexit()
    if start_thread and nprocs > 1:
        interval = _tick_interval(monitor.peer_timeout_s)

        def loop() -> None:
            try:
                # first beat before any sleep: peers start aging us now; a
                # transient channel error here must not kill the daemon (the
                # next step()'s beat retries) — an armed-looking plane whose
                # thread died at birth would get this healthy rank declared
                # dead by every peer
                monitor.beat()
            except Exception as exc:
                record_resilience_event(
                    "supervision.heartbeat", "beat-unpublished",
                    f"{type(exc).__name__}: {exc}")
            while not stop.wait(interval):
                monitor.step()

        t = threading.Thread(target=loop, name="heat-tpu-supervision",
                             daemon=True)
        with _lock:
            _thread = t
        t.start()
    record_resilience_event("supervision.plane", "armed",
            f"rank {rank}/{nprocs}, peer_timeout {monitor.peer_timeout_s:.3f}s,"
            f" generation {_generation}")
    return monitor


def current_monitor() -> Optional["Monitor"]:
    """The armed :class:`Monitor`, or None — the handle ``ht.ops`` folds
    cluster beats through (``cluster_snapshot`` sweeps ``<ns>/ops/`` on its
    coordinator)."""
    with _lock:
        return _monitor


def disarm() -> None:
    """Stop the monitor daemon and return the plane to zero-cost idle. The
    abort state is kept (a typed failure must stay deliverable until
    :func:`reset_abort`); watchdog windows are cleared."""
    global _armed, _monitor, _thread, _thread_stop
    with _lock:
        thread, stop = _thread, _thread_stop
        _thread = _thread_stop = None
        _monitor = None
    _armed = False
    if stop is not None:
        stop.set()
    if thread is not None and thread.is_alive():
        thread.join(timeout=5.0)
    with _lock:
        _watch_windows.clear()
        _watch_fired.clear()


def armed() -> bool:
    """Whether the supervision plane is armed."""
    return _armed


def reset_abort() -> None:
    """Clear the installed abort sentinel (failover handled / elastic
    restart / test isolation). While a monitor is still armed — the
    single-host serving failover, where the SAME generation keeps running —
    the store copy is deleted FIRST (its ``check_sentinel`` would re-adopt a
    lingering key every tick); after a disarm the store copy belongs to the
    dead generation's namespace and is simply left behind."""
    global _abort, _aborted
    with _lock:
        mon = _monitor
    if mon is not None:
        try:
            mon.coordinator.delete(mon.abort_key)
        except Exception as exc:
            record_resilience_event("supervision.abort", "sentinel-clear-failed",
                    f"{type(exc).__name__}: {exc}")
    with _lock:
        _abort = None
        _aborted = False


def forget_peer(rank: int) -> None:
    """Tell the armed monitor that ``rank``'s failure has been handled: it
    stops expecting the dead peer's beats, so clearing the abort sentinel
    (``reset_abort``) does not just get it re-posted at the next scan. The
    single-host failover verb — ``ModelPool.on_peer_failure`` uses it; the
    multi-host elastic restart re-arms a fresh monitor at the surviving
    world size instead."""
    with _lock:
        mon = _monitor
    if mon is not None:
        mon.forget(rank)


def auto_arm() -> None:
    """Arm the plane for a multi-process job when enabled — called by the
    communication bootstrap after the runtime is up. Single-process runs (or
    ``HEAT_TPU_SUPERVISION=0``) stay zero-cost idle."""
    if not _knobs.enabled:
        return
    try:
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return
        nprocs = dist.get_world_size()
        rank = dist.get_rank()
    except Exception as exc:  # runtime not initialized yet: stay idle
        record_resilience_event("supervision.plane", "arm-deferred",
                f"{type(exc).__name__}: {exc}")
        return
    if nprocs <= 1:
        return
    store = _default_store()
    if store is None:
        return
    arm(ClientCoordinator(store), rank=rank, nprocs=nprocs)


# ------------------------------------------------------------ the watchdog
@contextlib.contextmanager
def watch(site: str):
    """Supervise one collective invocation window: poll the sentinel on
    entry and exit, and — when ``HEAT_TPU_COLLECTIVE_TIMEOUT_S`` is set —
    arm a watchdog deadline for the window. A window the watchdog flagged
    raises typed :class:`~.resilience.CollectiveTimeout` on this rank as soon
    as the call unblocks (survivors raise at their own sentinel polls)."""
    poll(site)
    budget = collective_timeout_s()
    mon = _monitor  # snapshot: a concurrent disarm() may null the global
    if budget <= 0.0 or mon is None:
        try:
            yield
        except Exception as exc:
            _typed_from(site, exc, mon)
            raise
        poll(site)
        return
    token = next(_watch_seq)
    start = mon.clock()
    with _lock:
        _watch_windows[token] = (site, start, start + budget)
    fired: Optional[float] = None
    try:
        yield
    except Exception as exc:
        with _lock:
            _watch_windows.pop(token, None)
            fired = _watch_fired.pop(token, None)
        if fired is None:
            _typed_from(site, exc, mon)
        raise
    finally:
        with _lock:
            _watch_windows.pop(token, None)
            fired = _watch_fired.pop(token, None)
    if fired is not None:
        PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
        raise CollectiveTimeout(site, fired, detected_by=_rank)
    poll(site)


def _typed_from(site: str, exc: BaseException, mon) -> None:
    """A collective failed while the plane is armed: a backend error from a dead
    peer (gloo's closed connection) must surface typed. Wait up to two peer
    budgets for the monitor's verdict, then raise the installed abort error from
    the backend's; without a verdict (or for an error already typed) return, and
    the caller re-raises the original."""
    if mon is None or resilience is None or isinstance(exc, _errors()):
        return
    deadline = time.monotonic() + 2.0 * mon.peer_timeout_s
    while not _aborted and time.monotonic() < deadline:
        time.sleep(0.02)
    typed = abort_error(site)
    if typed is not None:
        raise typed from exc


# ------------------------------------------------- supervised coordination
def _looks_like_timeout(exc: BaseException) -> bool:
    if isinstance(exc, TimeoutError):
        return True
    text = f"{type(exc).__name__}: {exc}".lower()
    return "deadline" in text or "timeout" in text or "timed out" in text


def kv_wait(key: str, timeout_ms: Optional[int] = None, *,
            site: str = "supervision.kv", coordinator=None) -> str:
    """A supervised ``blocking_key_value_get``: the wait is chunked so the
    abort sentinel is polled while blocked (a detected peer failure raises
    typed :class:`~.resilience.PeerFailed` MID-WAIT, not after the full
    budget), bounded by ``timeout_ms`` (default: the unified
    ``HEAT_TPU_COORD_TIMEOUT_MS``), and exhaustion raises typed
    :class:`~.resilience.CoordinationTimeout` naming the key — never the raw
    backend error. This wrapper (and :func:`kv_barrier`) is the only
    sanctioned coordination-wait form: the ``coord-unbounded-wait`` analysis
    rule flags raw waits anywhere else."""
    co = _require_coordinator(coordinator)
    budget = coord_timeout_ms() if timeout_ms is None else int(timeout_ms)
    mon = _monitor  # snapshot: a concurrent disarm() may null the global
    clock = mon.clock if mon is not None else time.monotonic
    deadline = clock() + budget / 1e3
    last: Optional[BaseException] = None
    while True:
        poll(site)
        remaining_ms = (deadline - clock()) * 1e3
        if remaining_ms <= 0.0:
            PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
            detail = f"{type(last).__name__}: {last}" if last else ""
            raise CoordinationTimeout(
                site, key=key, timeout_ms=budget, detail=detail
            ) from last
        try:
            return co.wait(key, int(max(1.0, min(_CHUNK_MS, remaining_ms))))
        except Exception as exc:
            last = exc
            if not _looks_like_timeout(exc):
                # a genuine channel failure (service gone, connection reset):
                # typed immediately — waiting out the budget cannot fix it
                PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
                raise CoordinationTimeout(
                    site, key=key, timeout_ms=budget,
                    detail=f"{type(exc).__name__}: {exc}",
                ) from exc
            # chunk expired: loop to poll the sentinel, then keep waiting


def kv_barrier(ns: str, *, nprocs: Optional[int] = None,
               rank: Optional[int] = None, timeout_ms: Optional[int] = None,
               site: str = "supervision.barrier", coordinator=None) -> None:
    """A supervised barrier over the KV store: every rank publishes
    ``<ns>/<rank>`` and waits for all ``nprocs`` keys. Unlike the native
    ``wait_at_barrier`` this is sentinel-abortable mid-wait, and a timeout
    raises typed :class:`~.resilience.CoordinationTimeout` NAMING the ranks
    that never arrived. The namespace must be fresh per use (callers thread
    their own sequence numbers, e.g. ``checkpoint._coord_ns``)."""
    co = _require_coordinator(coordinator)
    if nprocs is None or rank is None:
        with _lock:
            mon = _monitor
        if mon is None:
            raise ValueError("kv_barrier needs nprocs/rank when disarmed")
        nprocs = mon.nprocs if nprocs is None else nprocs
        rank = mon.rank if rank is None else rank
    budget = coord_timeout_ms() if timeout_ms is None else int(timeout_ms)
    mon = _monitor  # snapshot: a concurrent disarm() may null the global
    clock = mon.clock if mon is not None else time.monotonic
    deadline = clock() + budget / 1e3
    co.set(f"{ns}/{rank}", "1", True)
    PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
    for r in range(int(nprocs)):
        remaining = max(1, int((deadline - clock()) * 1e3))
        try:
            kv_wait(f"{ns}/{r}", remaining, site=site, coordinator=co)
        except CoordinationTimeout as exc:
            # one directory listing of the arrived ranks (keys {ns}/{rank}
            # sit strictly under the namespace, so directory semantics
            # return them; an exact-key probe per rank would not — the real
            # service never returns a key equal to the prefix)
            arrived = set()
            try:
                for k, _v in co.get_dir(ns):
                    try:
                        arrived.add(int(k.rsplit("/", 1)[-1]))
                    except ValueError:
                        continue
            except Exception as exc2:
                # channel gone: report the timeout unadorned
                record_resilience_event(
                    "supervision.barrier", "arrived-unreadable",
                    f"{type(exc2).__name__}: {exc2}")
                arrived = None
            waiting = ([w for w in range(int(nprocs)) if w not in arrived]
                       if arrived is not None else [])
            raise CoordinationTimeout(
                site, key=f"{ns}/{r}", timeout_ms=budget, waiting_on=waiting,
                detail=exc.detail,
            ) from exc


# ------------------------------------------------- supervised runtime
def _make_store(address: str, num_processes: int, process_id: int, timeout_s: float):
    """The coordination store for ``address``: a ``FileStore`` for
    ``file://path``, else a ``TCPStore`` at ``[tcp://]host:port`` whose server
    runs in process 0."""
    import datetime

    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=timeout_s)
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], num_processes)
        store.set_timeout(timeout)
        return store
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes, process_id == 0, timeout,
                         wait_for_workers=False)


def bootstrap_distributed(coordinator_address: str, num_processes: int,
                          process_id: int, *,
                          init_timeout_s: Optional[int] = None,
                          backend: Optional[str] = None) -> None:
    """Initialize the distributed runtime in SUPERVISED mode: the coordination
    store (:func:`_make_store`) is made here and kept, and ``init_process_group``
    joins over it, so the supervision plane beats, aborts and agrees on the same
    store, and a dead generation can be abandoned (:func:`teardown_distributed`)
    and replaced at the surviving world size. ``backend`` defaults to NCCL when
    the default device is the card and gloo under ``use_device("cpu")``. The
    process group's timeout is ``HEAT_TPU_COLLECTIVE_TIMEOUT_S`` when set, else the
    coordination budget; the store's is the coordination budget."""
    import datetime

    import torch
    import torch.distributed as dist

    global _owns_client, _store
    if dist.is_initialized():
        return  # already initialized (explicit user bootstrap): respect it
    coord_s = (float(init_timeout_s) if init_timeout_s is not None
               else max(1.0, coord_timeout_ms() / 1e3))
    store = _make_store(coordinator_address, int(num_processes), int(process_id), coord_s)
    if backend is None:
        from .devices import get_device

        backend = "gloo" if get_device().device_type == "cpu" else "nccl"
    if backend == "nccl":
        import os as _os

        torch.cuda.set_device(int(_os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, store=store, rank=int(process_id),
                            world_size=int(num_processes),
                            timeout=datetime.timedelta(seconds=_pg_timeout_s()))
    with _lock:
        _owns_client = True
        _store = store
    if resilience is not None:
        resilience.set_fault_rank(int(process_id))
    _register_atexit()
    record_resilience_event("supervision.runtime", "bootstrapped",
            f"rank {process_id}/{num_processes} ({backend}) at {coordinator_address}")


def _abort_group() -> str:
    """Abort the default group's communicators without waiting on any peer:
    ``_abort_process_group`` where torch has it, else the NCCL backend's
    ``abort``. Returns what was done (for the teardown event)."""
    import torch
    import torch.distributed as dist

    c10d = dist.distributed_c10d
    abort = getattr(c10d, "_abort_process_group", None)
    if abort is not None:
        abort()
        return "aborted"
    pg = c10d._get_default_group()
    try:
        be = pg._get_backend(torch.device("cuda"))
    except Exception:  # ht: ignore[silent-except] -- no NCCL backend in this group (gloo): nothing blocks on a dead peer, destroy suffices
        return "no communicator to abort"
    if hasattr(be, "abort"):
        be.abort()
        return "nccl backend aborted"
    return "no abort available"


def teardown_distributed(*, clean: Optional[bool] = None) -> None:
    """Tear the process group down. ``clean`` (default: no abort installed) is
    the ordinary ``destroy_process_group``. Dirty teardown (a peer is dead)
    aborts the communicators first — a communicator with a dead peer would block
    the destroy — then destroys the group; the store joins the graveyard and the
    next :func:`bootstrap_distributed` makes a new one at its new size."""
    import torch.distributed as dist

    global _owns_client, _store
    if clean is None:
        clean = not _aborted
    with _lock:
        _owns_client = False
        store, _store = _store, None
    how = "clean"
    if dist.is_initialized():
        if not clean:
            try:
                how = _abort_group()
            except Exception as exc:  # ht: ignore[silent-except] -- not silent: the failure is carried in `how` into the teardown's resilience event below, and the destroy still runs
                # recorded; the destroy below still runs
                how = f"abort failed: {type(exc).__name__}: {exc}"
        try:
            dist.destroy_process_group()
        except Exception as exc:
            record_resilience_event("supervision.runtime", "shutdown-degraded",
                    f"{type(exc).__name__}: {exc}")
    if store is not None:
        with _lock:
            _graveyard.append(store)
    record_resilience_event("supervision.runtime", "teardown", how)


def _register_atexit() -> None:
    global _atexit_registered
    with _lock:
        if _atexit_registered:
            return
        _atexit_registered = True
    atexit.register(_atexit_shutdown)


def _atexit_shutdown() -> None:
    """Process-exit hook for supervised runs: publish the clean-departure
    marker (peers must not read a normal exit as a failure), then — when this
    module built the runtime and no abort happened — perform the ordinary
    synchronized shutdown the default client would have done from its
    destructor. After an abort the runtime is abandoned instead: the
    destructors must not run (see :func:`teardown_distributed`)."""
    with _lock:
        mon = _monitor
        owns = _owns_client
    if mon is not None:
        mon.depart()
    disarm()
    if not owns:
        return
    try:
        teardown_distributed()
    except Exception as exc:
        # the process is exiting: a failed courtesy shutdown must not turn
        # a clean exit into a crash
        record_resilience_event("supervision.runtime", "atexit-degraded",
                f"{type(exc).__name__}: {exc}")


# --------------------------------------------------------- elastic restart
def _drain_scheduler(timeout_s: float) -> None:
    """Flush the dispatch scheduler before teardown: queued work is delivered
    or shed TYPED (DrainTimeout's contract), so no request future can survive
    into the new generation blocked."""
    from . import _executor

    try:
        _executor._get_scheduler().drain(timeout_s)
    except Exception as exc:
        if resilience is not None and isinstance(exc, resilience.DrainTimeout):
            return  # typed + delivered to every waiter: exactly the contract
        raise


def _reanchor_framework() -> None:
    """Rebuild every world-size-derived singleton after a re-init: the default
    communicator (``COMM_WORLD`` reads the new group's size when asked), the
    executor's program/signature caches, the checkpoint coordination counters,
    and the telemetry identity/clock handshake for the new generation."""
    from . import _executor, checkpoint, communication

    communication.use_comm(None)
    _executor.clear_executor_cache()
    checkpoint._reset_coordination()
    communication._telemetry_bootstrap()
    _executor._get_scheduler().reopen()


def elastic_restart(exc: BaseException, *, reinit=None,
                    drain_timeout_s: float = 10.0) -> dict:
    """One supervised restart: drain → disarm → teardown → (re)initialize →
    re-anchor → re-arm. ``reinit(exc)`` is the caller's elasticity policy: it
    returns ``{"coordinator_address", "num_processes", "process_id"}`` for
    the surviving world (a fresh coordinator address — the dead generation's
    port is abandoned, not reused), or None to continue single-process.
    Returns a summary dict. Used by :func:`run_supervised`; callable directly
    by serving-side failover logic."""
    import torch.distributed as dist

    global _restarts
    record_resilience_event("supervision.restart", "elastic-restart",
            f"{type(exc).__name__}: {exc}")
    _count("supervision.restart")
    _drain_scheduler(drain_timeout_s)
    disarm()
    # the abort is being HANDLED from here on: clear it before the reinit
    # policy runs, whose own supervised waits (negotiating the new
    # coordinator over the old KV store) must not re-raise it
    reset_abort()
    had_client = dist.is_available() and dist.is_initialized()
    spec = reinit(exc) if reinit is not None else None
    if had_client:
        teardown_distributed(clean=False)
    if spec is not None:
        bootstrap_distributed(
            spec["coordinator_address"], int(spec["num_processes"]),
            int(spec["process_id"]),
        )
    if had_client or spec is not None:
        _reanchor_framework()  # ends in the telemetry bootstrap → auto_arm()
    else:
        from . import _executor

        _executor._get_scheduler().reopen()
        auto_arm()
    with _lock:
        _restarts += 1
        restarts = _restarts
    summary = {
        "cause": f"{type(exc).__name__}: {exc}",
        "world": (spec or {}).get("num_processes", 1),
        "rank": (spec or {}).get("process_id", 0),
        "restarts": restarts,
    }
    record_resilience_event("supervision.restart", "restarted", json.dumps(summary))
    return summary


def run_supervised(step_fn, manager, policy=None, *, template=None,
                   state=None, start_step: int = 0,
                   max_steps: Optional[int] = None, save_every: int = 1,
                   reinit=None, drain_timeout_s: float = 10.0,
                   restore_kwargs: Optional[dict] = None) -> dict:
    """Run a training loop under the supervision plane with elastic restart.

    ``step_fn(step, state) -> state`` is one training step;
    ``manager`` is a :class:`~.checkpoint.CheckpointManager`; ``template``
    the restore template pytree, or a CALLABLE returning one — pass a
    callable for elastic multi-process jobs, because a template's DNDarray
    leaves pin the communicator and the restore after a world-size change
    must build against the surviving world's mesh (defaults to ``state``).
    Steps where
    ``step % save_every == 0`` are checkpointed. On a typed supervision
    failure (:class:`~.resilience.PeerFailed` /
    :class:`~.resilience.CollectiveTimeout` /
    :class:`~.resilience.CoordinationTimeout`) the harness performs
    :func:`elastic_restart` — drain, teardown, re-init at the surviving world
    size per the ``reinit`` policy, restore the latest step through the
    reshard-on-restore path — and resumes, under a bounded restart budget:
    ``policy.max_attempts`` restarts (default 3) gated by the
    ``supervision.restart`` circuit breaker. An exhausted budget (or an open
    breaker) re-raises the typed failure unchanged.

    Returns ``{"state", "steps", "restarts"}``."""
    if resilience is None:  # pragma: no cover - standalone load
        raise RuntimeError("run_supervised needs the heat_tpu_torch package")
    PeerFailed, CollectiveTimeout, CoordinationTimeout = _errors()
    pol = policy or resilience.Policy(max_attempts=3, backoff_base=0.5)
    br = resilience.breaker("supervision.restart")
    template = template if template is not None else state

    def _template():
        return template() if callable(template) else template

    restore_kwargs = dict(restore_kwargs or {})
    if state is None:
        latest = manager.latest_step
        if latest is None:
            raise ValueError("run_supervised needs an initial state or a "
                             "restorable checkpoint step")
        state = manager.restore(_template(), **restore_kwargs)
        start_step = latest + 1
    step = int(start_step)
    restarts = 0
    while max_steps is None or step < max_steps:
        try:
            poll("supervision.step")
            state = step_fn(step, state)
            if save_every and step % save_every == 0:
                manager.save(step, state)
            br.record_success()
            step += 1
        except (PeerFailed, CollectiveTimeout, CoordinationTimeout) as exc:
            restarts += 1
            br.record_failure(f"{type(exc).__name__}: {exc}")
            budget_left = (pol.max_attempts is None
                           or restarts < pol.max_attempts)
            if not budget_left or not br.allows():
                record_resilience_event(
                    "supervision.restart", "exhausted",
                    f"restart {restarts} refused "
                    f"(budget_left={budget_left}, breaker={br.state}): "
                    f"{type(exc).__name__}: {exc}",
                )
                raise
            time.sleep(pol.delay_s(restarts))
            elastic_restart(exc, reinit=reinit,  # ht: ignore[spmd-collective-in-except] -- every survivor enters this handler: the abort sentinel delivers the same typed PeerFailed/CollectiveTimeout/CoordinationTimeout to all of them, and the re-join's store barrier is among the survivors of the new world
                            drain_timeout_s=drain_timeout_s)
            latest = manager.latest_step
            if latest is None:
                raise
            state = manager.restore(_template(), **restore_kwargs)
            step = latest + 1
    return {"state": state, "steps": step, "restarts": restarts}


# ------------------------------------------------------------------ stats
def supervision_stats() -> dict:
    """The supervision section of ``ht.diagnostics.report()``: armed state,
    identity, abort payload, watchdog windows, restart count."""
    with _lock:
        mon = _monitor
        return {
            "armed": _armed,
            "enabled": _knobs.enabled,
            "rank": _rank,
            "nprocs": _nprocs,
            "generation": _generation,
            "peer_timeout_s": (mon.peer_timeout_s if mon is not None
                               else _knobs.peer_timeout_s),
            "collective_timeout_s": _knobs.collective_timeout_s,
            "coord_timeout_ms": _knobs.coord_timeout_ms,
            "aborted": dict(_abort) if _abort is not None else None,
            "watch_windows": len(_watch_windows),
            "restarts": _restarts,
            "graveyard": len(_graveyard),
        }


if diagnostics is not None:
    diagnostics.register_provider("supervision", supervision_stats)

if resilience is not None:
    def _go_silent_for_peer_death() -> None:
        """The ``peer-dead`` fault hook: stop heartbeating WITHOUT the
        clean-departure marker — peers must observe a crash (silence, then
        absence), not a shutdown. The exit that follows skips atexit, so the
        marker can never leak out after this."""
        disarm()

    resilience._peer_dead_hook = _go_silent_for_peer_death
