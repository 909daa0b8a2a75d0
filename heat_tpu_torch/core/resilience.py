"""``ht.resilience``: retry policies, circuit breakers, deterministic fault injection
and atomic writes (the port's own copy of heat_tpu/core/resilience.py, which loads with
the stdlib alone).

- :class:`Policy`: ``max_attempts`` x exponential backoff (``backoff_base *
  2**(attempt-1)``) with optional ``jitter``, ``max_delay_s`` cap and a wall-clock
  ``deadline_s``. ``Policy.run(site, fn)`` re-raises the failing call's exception
  unchanged on exhaustion; every retry and exhaustion is recorded through
  :func:`diagnostics.record_resilience_event`.
- :class:`CircuitBreaker`: per-site closed -> open -> half-open; the checkpoint's
  ``checkpoint.chunk_write`` breaker sends later saves to the serialized v1 path while
  it is open.
- **Deterministic fault injection**: ``HEAT_TPU_FAULT_PLAN=<json>`` (or
  :func:`arm_fault_plan`) loads entries naming a ``site``, a fire-on-Nth-call trigger
  (``on_call``, ``count``), a ``kind`` (``raise``, ``timeout``, ``backend-down``,
  ``torn-write``, ``deadline-exceeded``, ``peer-dead``) and optionally the ``rank`` it
  fires on (:func:`set_fault_rank`). Sites count calls under a lock, so a plan replays
  the same failure sequence every time.
- :func:`atomic_write`: write to a temp file, fsync, ``os.replace``, under the site's
  retry policy; the primitive behind the checkpoint manifest and the whole-file
  ``ht.save`` paths.

The request-lifecycle errors (:class:`DeadlineExceeded`, :class:`Shed`,
:class:`RequestCancelled`, :class:`DrainTimeout`, :class:`SwapFailed`) and the
supervision errors (:class:`PeerFailed`, :class:`CollectiveTimeout`,
:class:`CoordinationTimeout`) keep heat_tpu's names and messages;
:func:`run_supervised` delegates to the supervision plane's elastic restart.

Zero-cost contract: instrumented sites gate on ``resilience._armed`` (a plan is
loaded) and ``resilience._active`` (a plan or a site policy), one attribute read and a
branch not taken when idle.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

try:
    from . import diagnostics
except ImportError:  # loaded standalone, without its package
    diagnostics = None

__all__ = [
    "Policy",
    "CircuitBreaker",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
    "breaker",
    "breakers",
    "relay_breaker",
    "RELAY_SITE",
    "get_policy",
    "site_policy",
    "set_policy",
    "guard",
    "arm_fault_plan",
    "disarm_fault_plan",
    "fault_plan",
    "fault_signal",
    "maybe_fault",
    "atomic_write",
    "fsync_dir",
    "resilience_stats",
    "reset",
    "FaultInjected",
    "InjectedTimeout",
    "InjectedBackendDown",
    "InjectedDeadlineExceeded",
    "CircuitOpen",
    "DeadlineExceeded",
    "Shed",
    "RequestCancelled",
    "DrainTimeout",
    "SwapFailed",
    "PeerFailed",
    "CollectiveTimeout",
    "CoordinationTimeout",
    "set_fault_rank",
    "run_supervised",
]

# Hot-path gates, read as ``resilience._armed`` / ``resilience._active`` by the
# instrumented sites (one attribute load + branch when idle — the zero-cost
# contract). ``_armed``: a fault plan is loaded. ``_active``: a plan is loaded
# or at least one site policy was registered (guard() then applies retries).
_armed: bool = False
_active: bool = False

_lock = threading.RLock()

FAULT_KINDS = (
    "raise", "timeout", "backend-down", "torn-write", "deadline-exceeded",
    "peer-dead",
)


class FaultInjected(RuntimeError):
    """An injected fault fired (``HEAT_TPU_FAULT_PLAN``); never raised by real
    failures, so tests can tell injection from genuine breakage."""


class InjectedTimeout(FaultInjected, TimeoutError):
    """Injected ``timeout`` fault — also a ``TimeoutError`` so probe code that
    special-cases timeouts treats it identically to a real one."""


class InjectedBackendDown(FaultInjected):
    """Injected ``backend-down`` fault — probe sites treat it as an unreachable
    relay without paying their subprocess timeout."""


class CircuitOpen(RuntimeError):
    """A call was short-circuited because the site's circuit breaker is open."""

    def __init__(self, site: str):
        super().__init__(f"circuit breaker for site {site!r} is open")
        self.site = site


# ------------------------------------------------------------- request lifecycle
class DeadlineExceeded(RuntimeError):
    """A request's wall-clock deadline passed before (or while) its work could
    run: the executor delivers this instead of late results — at queue
    admission, when an expired queued item is cancelled pre-dispatch, and
    between ops of an eager replay. Never retried by a :class:`Policy`
    (retrying cannot un-expire a deadline)."""


class Shed(RuntimeError):
    """The load-shedding admission control (``HEAT_TPU_SHED=1``) rejected this
    request instead of executing it: its deadline was infeasible per the
    per-signature service-time estimate, or the dispatch queue stayed full
    through backpressure. The work was NOT attempted — retrying later (or
    without a deadline) is safe and side-effect-free."""


class RequestCancelled(RuntimeError):
    """Queued work was cancelled by an explicit lifecycle verb
    (``DispatchScheduler.cancel(tag)``) before it dispatched."""


class DrainTimeout(RuntimeError):
    """``DispatchScheduler.drain(timeout)`` could not flush the queue in time.
    Every still-queued item's future was failed with this same exception (so
    nothing is left blocked); ``undelivered`` names them, and ``in_flight``
    counts executions that were still running when the timeout struck (their
    futures are fulfilled by the executing thread when it finishes)."""

    def __init__(self, timeout_s: float, undelivered, in_flight: int = 0):
        self.timeout_s = timeout_s
        self.undelivered = list(undelivered)
        self.in_flight = int(in_flight)
        names = ", ".join(self.undelivered) or "<none>"
        super().__init__(
            f"scheduler drain did not settle within {timeout_s:.3f}s: "
            f"{len(self.undelivered)} queued item(s) shed with this error "
            f"({names}); {self.in_flight} execution(s) still in flight"
        )


class SwapFailed(RuntimeError):
    """A zero-downtime model swap (``ht.serving.swap_state``) failed and was
    rolled back to the previous generation: staging the new state raised
    (verification/IO — serving was never touched), the drain timed out, or the
    rebind itself failed. ``stage`` names the step; serving continues on the
    old generation either way — a failed swap is an incident, never an
    outage."""

    def __init__(self, stage: str, pool: str, detail: str):
        self.stage = stage
        self.pool = pool
        super().__init__(
            f"model swap for pool {pool!r} failed at the {stage!r} step and "
            f"was rolled back: {detail}"
        )


class InjectedDeadlineExceeded(FaultInjected, DeadlineExceeded):
    """Injected ``deadline-exceeded`` fault — also a :class:`DeadlineExceeded`
    so the executor's lifecycle paths (typed delivery, no eager replay of
    over-deadline work, no quarantine) treat it exactly like a real expiry."""


# ------------------------------------------------------------- supervision
class PeerFailed(RuntimeError):
    """A peer process stopped heartbeating past ``HEAT_TPU_PEER_TIMEOUT_S``
    (or the coordination runtime reported it dead): the supervision plane
    (``ht.supervision``) posts a cluster-wide abort sentinel and EVERY
    survivor raises this at its next chokepoint — collective invocation,
    scheduler dispatch, or supervised coordination wait — instead of hanging.
    ``rank`` is the failed peer (-1 when unknown), ``last_seen_s`` how long
    it had been silent when declared dead, ``detected_by`` the rank whose
    monitor posted the sentinel. Never retried by a :class:`Policy` — the
    recovery path is ``run_supervised``'s elastic restart."""

    def __init__(self, rank: int, last_seen_s: float, *, detected_by: int = -1):
        self.rank = int(rank)
        self.last_seen_s = float(last_seen_s)
        self.detected_by = int(detected_by)
        super().__init__(
            f"peer rank {self.rank} failed (no heartbeat for "
            f"{self.last_seen_s:.3f}s; detected by rank {self.detected_by}); "
            "all survivors abort typed at their next supervision chokepoint"
        )


class CollectiveTimeout(RuntimeError):
    """The collective watchdog (``HEAT_TPU_COLLECTIVE_TIMEOUT_S``) found a
    ``MeshCommunication._guarded`` invocation window stuck past its deadline:
    a flight-recorder post-mortem was dumped (trigger kind
    ``supervision.watchdog``), the abort sentinel posted, and this raised on
    every survivor — the stuck rank itself raises the moment its call
    unblocks. ``site`` is the guarded call site, ``elapsed_s`` how long the
    window had been open when flagged."""

    def __init__(self, site: str, elapsed_s: float, *, detected_by: int = -1):
        self.site = str(site)
        self.elapsed_s = float(elapsed_s)
        self.detected_by = int(detected_by)
        super().__init__(
            f"collective at {self.site!r} exceeded its watchdog deadline "
            f"({self.elapsed_s:.3f}s elapsed; detected by rank "
            f"{self.detected_by})"
        )


class CoordinationTimeout(RuntimeError):
    """A supervised coordination-channel wait (``supervision.kv_wait`` /
    ``kv_barrier``) exhausted its ``HEAT_TPU_COORD_TIMEOUT_MS`` budget: the
    typed replacement for the raw KV/barrier backend errors the old
    hardcoded handshake/checkpoint timeouts surfaced. ``key`` names the
    coordination key waited on; ``waiting_on`` lists the ranks that never
    arrived (barriers); ``detail`` carries the last backend error text."""

    def __init__(self, site: str, *, key: str = "", timeout_ms: int = 0,
                 waiting_on=(), detail: str = ""):
        self.site = str(site)
        self.key = str(key)
        self.timeout_ms = int(timeout_ms)
        self.waiting_on = [int(r) for r in waiting_on]
        self.detail = str(detail)
        ranks = (f"; ranks not arrived: {self.waiting_on}"
                 if self.waiting_on else "")
        extra = f"; last error: {self.detail}" if self.detail else ""
        super().__init__(
            f"coordination wait at {self.site!r} for key {self.key!r} "
            f"exceeded {self.timeout_ms}ms{ranks}{extra}"
        )


def _record_event(site: str, kind: str, detail: str = "") -> None:
    """Resilience events (retries, breaker transitions, fault firings) are rare
    and explicit — recorded always-on like backend-health events. Metric
    counters stay gated on ``diagnostics.enabled()`` as usual."""
    if diagnostics is not None:
        diagnostics.record_resilience_event(site, kind, detail)


def _count(name: str) -> None:
    if diagnostics is not None:
        diagnostics.counter(name)


# ------------------------------------------------------------------ policy engine
class Policy:
    """A retry/backoff policy: ``max_attempts`` tries with exponential backoff.

    ``max_attempts=None`` retries until ``deadline_s`` (which is then required).
    ``backoff_base`` seconds doubles per attempt, capped at ``max_delay_s``;
    ``jitter`` is a ± fraction applied from a module-seeded RNG (leave 0 for
    fully deterministic schedules — the chaos tests do). ``retry_on`` bounds
    which exception types are retried; anything else propagates immediately.

    :meth:`run` re-raises the failing call's exception UNCHANGED when attempts
    or the deadline are exhausted (the final attempt's exception — earlier
    attempts' errors are in the recorded retry events) — callers keep their
    existing ``except`` semantics and the policy stays an invisible wrapper.
    """

    __slots__ = (
        "max_attempts", "backoff_base", "jitter", "deadline_s", "max_delay_s",
        "retry_on",
    )

    def __init__(
        self,
        max_attempts: Optional[int] = 3,
        backoff_base: float = 0.5,
        jitter: float = 0.0,
        deadline_s: Optional[float] = None,
        max_delay_s: Optional[float] = None,
        retry_on: Tuple[type, ...] = (Exception,),
    ):
        if max_attempts is None and deadline_s is None:
            raise ValueError("max_attempts=None (unbounded) requires deadline_s")
        if max_attempts is not None and max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = max_attempts
        self.backoff_base = float(backoff_base)
        self.jitter = float(jitter)
        self.deadline_s = deadline_s
        self.max_delay_s = max_delay_s
        self.retry_on = retry_on

    def delay_s(self, attempt: int) -> float:
        """Backoff after the ``attempt``-th failure (1-based)."""
        d = self.backoff_base * (2.0 ** (attempt - 1))
        if self.max_delay_s is not None:
            d = min(d, self.max_delay_s)
        if self.jitter:
            d *= 1.0 + _jitter_rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def run(
        self,
        site: str,
        fn: Callable,
        *args,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        breaker: Optional["CircuitBreaker"] = None,
        **kwargs,
    ):
        """Call ``fn(*args, **kwargs)`` under this policy.

        When ``breaker`` is given, an open circuit raises :class:`CircuitOpen`
        before any attempt, and every attempt's outcome feeds the breaker.
        ``sleep``/``clock`` are injectable so tests run without wall time.
        """
        start = clock()
        attempt = 0
        while True:
            attempt += 1
            if breaker is not None and not breaker.allows():
                raise CircuitOpen(site)
            try:
                result = fn(*args, **kwargs)
            except self.retry_on as exc:
                if isinstance(exc, CircuitOpen):
                    raise
                if isinstance(exc, DeadlineExceeded):
                    # a deadline that has passed cannot un-pass: retrying would
                    # only burn backoff time the request no longer has. The
                    # breaker learned NOTHING about the backend from a request
                    # running out of time — release a half-open probe token so
                    # the next caller can run the real trial instead of
                    # everyone waiting out another cooldown.
                    if breaker is not None:
                        breaker.abandon_probe()
                    raise
                if breaker is not None:
                    breaker.record_failure(f"{type(exc).__name__}: {exc}")
                exhausted = (
                    self.max_attempts is not None and attempt >= self.max_attempts
                )
                delay = self.delay_s(attempt)
                if (
                    self.deadline_s is not None
                    and clock() - start + delay >= self.deadline_s
                ):
                    exhausted = True
                if exhausted:
                    _record_event(
                        site, "exhausted",
                        f"attempt {attempt}: {type(exc).__name__}: {exc}",
                    )
                    raise
                _record_event(
                    site, "retry",
                    f"attempt {attempt} failed ({type(exc).__name__}: {exc}); "
                    f"backing off {delay:.3f}s",
                )
                _count(f"resilience.retry.{site}")
                sleep(delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                return result


_jitter_rng = random.Random(0x48454154)  # deterministic per process

# The fallback policy for sites without a registered override: a short, cheap
# retry ladder (three attempts, 50 ms base) — enough to absorb a transient
# fault without turning a deterministic failure into seconds of stalling.
_DEFAULT_POLICY = Policy(max_attempts=3, backoff_base=0.05, jitter=0.0)

_site_policies: Dict[str, Policy] = {}


def get_policy(site: str) -> Policy:
    """The policy for ``site``: a registered override or the module default."""
    return _site_policies.get(site, _DEFAULT_POLICY)


def site_policy(site: str) -> Optional[Policy]:
    """The registered override for ``site``, or None — lets non-idempotent
    call sites pick their own fallback instead of the retrying default."""
    return _site_policies.get(site)


def set_policy(site: str, policy: Optional[Policy]) -> None:
    """Register (or, with ``None``, remove) a per-site policy override.
    Registering any override also activates :func:`guard`-wrapped sites."""
    with _lock:
        if policy is None:
            _site_policies.pop(site, None)
        else:
            if not isinstance(policy, Policy):
                raise TypeError(f"expected a Policy, got {type(policy)}")
            _site_policies[site] = policy
        _refresh_active_locked()


def _refresh_active_locked() -> None:
    # called with _lock held (the _locked-suffix convention ht.analysis checks)
    global _active
    _active = _armed or bool(_site_policies)


def guard(site: str, fn: Callable, *args, inject: bool = True,
          policy: Optional[Policy] = None, **kwargs):
    """Run ``fn`` under ``site``'s policy, injecting planned faults per attempt.

    The retry wrapper for instrumented call sites (collective invocation, the
    executor's program calls). Callers gate on ``resilience._active`` so the
    idle cost is one attribute read; ``inject=False`` skips the per-attempt
    :func:`maybe_fault` for callees that carry their own injection hook (the
    executor's ``_Program.__call__``) — a site must count each attempt exactly
    once for fire-on-Nth-call plans to stay deterministic. ``policy``
    overrides the site lookup (non-idempotent writers pass a single-attempt
    policy so a half-applied in-place write is never blindly replayed)."""
    policy = policy or get_policy(site)
    if inject and _armed:

        def attempt():
            maybe_fault(site)
            return fn(*args, **kwargs)

        return policy.run(site, attempt)
    return policy.run(site, fn, *args, **kwargs)


# ------------------------------------------------------------------ circuit breaker
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Per-site closed → open → half-open breaker.

    ``failure_threshold`` consecutive :meth:`record_failure` calls open the
    circuit; :meth:`allows` then returns False (callers short-circuit to their
    cached negative result) until ``cooldown_s`` elapses, when the breaker
    half-opens: exactly ONE caller per half-open window is admitted as the
    trial probe — success closes the circuit, failure re-opens it (restarting
    the cooldown). Concurrent callers during the trial see the circuit as
    still open, so N threads hitting a half-open breaker cannot re-probe a
    down backend simultaneously (the thundering-herd shape the relay probe's
    90 s subprocess timeout makes expensive). A probe holder that never
    reports back (crashed caller) forfeits its token after another
    ``cooldown_s``, when a fresh window grants a new one.

    Every state transition is recorded via
    ``diagnostics.record_resilience_event(site, "breaker", "old->new")``.
    ``clock`` is injectable for deterministic tests.
    """

    __slots__ = (
        "site", "failure_threshold", "cooldown_s", "clock",
        "_state", "_failures", "_opened_at", "opens", "short_circuits",
        "_probe_taken", "_probe_at",
    )

    def __init__(
        self,
        site: str,
        failure_threshold: int = 3,
        cooldown_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        self.site = site
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._state = CLOSED
        self._failures = 0
        self._opened_at: Optional[float] = None
        self.opens = 0
        self.short_circuits = 0
        self._probe_taken = False
        self._probe_at: Optional[float] = None

    def _transition(self, new: str, detail: str = "") -> None:
        old, self._state = self._state, new
        if old != new:
            self._probe_taken = False  # every state change opens a fresh window
            self._probe_at = None
            _record_event(
                self.site, "breaker", f"{old}->{new}" + (f": {detail}" if detail else "")
            )
            _count(f"resilience.breaker.{self.site}.{new}")

    def _poll(self) -> None:
        if self._state == OPEN and self._opened_at is not None:
            if self.clock() - self._opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN, f"cooldown {self.cooldown_s:.0f}s elapsed")

    @property
    def state(self) -> str:
        with _lock:
            self._poll()
            return self._state

    def allows(self) -> bool:
        """Whether a call may proceed: True in closed; in half-open True for
        exactly ONE caller per window (the trial probe — everyone else sees the
        circuit as open until the probe reports); False while open (the caller
        should use its cached negative result)."""
        with _lock:
            self._poll()
            if self._state == HALF_OPEN:
                if self._probe_taken and self._probe_at is not None and (
                    self.clock() - self._probe_at < self.cooldown_s
                ):
                    # a trial probe is already out: admitting more would
                    # thundering-herd the backend the breaker is protecting
                    self.short_circuits += 1
                    _count(f"resilience.breaker.{self.site}.short_circuit")
                    return False
                # first caller of this window (or the previous probe holder
                # vanished for a whole cooldown): this call IS the trial
                self._probe_taken = True
                self._probe_at = self.clock()
                return True
            if self._state == OPEN:
                self.short_circuits += 1
                _count(f"resilience.breaker.{self.site}.short_circuit")
                return False
            return True

    def abandon_probe(self) -> None:
        """Release a held half-open probe token WITHOUT a verdict: the trial
        call ended for a reason that says nothing about the backend (its
        request's deadline expired). The next caller becomes the trial."""
        with _lock:
            if self._state == HALF_OPEN:
                self._probe_taken = False
                self._probe_at = None

    def record_success(self) -> None:
        with _lock:
            self._poll()
            self._failures = 0
            if self._state != CLOSED:
                self._transition(CLOSED, "probe succeeded")

    def record_failure(self, detail: str = "") -> None:
        with _lock:
            self._poll()
            self._failures += 1
            if self._state == HALF_OPEN or self._failures >= self.failure_threshold:
                if self._state != OPEN:
                    self.opens += 1
                self._opened_at = self.clock()
                self._transition(OPEN, detail or f"{self._failures} consecutive failures")

    def snapshot(self) -> dict:
        with _lock:
            self._poll()
            return {
                "site": self.site,
                "state": self._state,
                "failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s,
                "opens": self.opens,
                "short_circuits": self.short_circuits,
                "half_open_probe_out": self._probe_taken and self._state == HALF_OPEN,
            }


_breakers: Dict[str, CircuitBreaker] = {}

def breaker(site: str, **kwargs) -> CircuitBreaker:
    """The process-wide breaker for ``site``, created on first use. ``kwargs``
    (``failure_threshold`` / ``cooldown_s`` / ``clock``) apply only at creation;
    later callers share whatever the first caller configured."""
    with _lock:
        br = _breakers.get(site)
        if br is None:
            br = _breakers[site] = CircuitBreaker(site, **kwargs)
        return br


def breakers() -> Dict[str, dict]:
    """Snapshot of every registered breaker, keyed by site."""
    with _lock:
        return {site: br.snapshot() for site, br in _breakers.items()}


# The one breaker every backend/relay probe shares (bench.py, __graft_entry__,
# devices.py caps probe). Its config lives HERE — the registry applies kwargs
# only at first creation, so scattering the numbers across call sites would
# silently resolve to whichever probe ran first.
RELAY_SITE = "backend.relay"
_RELAY_FAILURE_THRESHOLD = 2
_RELAY_COOLDOWN_S = 300.0


def relay_breaker() -> CircuitBreaker:
    """The process-wide ``backend.relay`` breaker: two consecutive probe
    failures open it, a 5 min cooldown half-opens it for a real re-probe."""
    return breaker(
        RELAY_SITE,
        failure_threshold=_RELAY_FAILURE_THRESHOLD,
        cooldown_s=_RELAY_COOLDOWN_S,
    )


# ------------------------------------------------------------------ fault injection
class _FaultEntry:
    __slots__ = ("site", "kind", "on_call", "count", "fraction", "message",
                 "rank")

    def __init__(self, site, kind, on_call, count, fraction, message,
                 rank=None):
        self.site = site
        self.kind = kind
        self.on_call = on_call
        self.count = count
        self.fraction = fraction
        self.message = message
        self.rank = rank

    def as_dict(self) -> dict:
        return {
            "site": self.site, "kind": self.kind, "on_call": self.on_call,
            "count": self.count, "fraction": self.fraction,
            **({"message": self.message} if self.message else {}),
            **({"rank": self.rank} if self.rank is not None else {}),
        }


_plan: Dict[str, List[_FaultEntry]] = {}
_site_calls: Dict[str, int] = {}
_fired: int = 0


def _parse_plan(spec: Union[str, Sequence[dict]]) -> Dict[str, List[_FaultEntry]]:
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except ValueError as exc:
            raise ValueError(f"HEAT_TPU_FAULT_PLAN is not valid JSON: {exc}") from exc
    if not isinstance(spec, (list, tuple)):
        raise ValueError(f"fault plan must be a JSON list of entries, got {type(spec)}")
    plan: Dict[str, List[_FaultEntry]] = {}
    for i, raw in enumerate(spec):
        if not isinstance(raw, dict):
            raise ValueError(f"fault-plan entry {i} must be an object, got {type(raw)}")
        unknown = set(raw) - {
            "site", "kind", "on_call", "count", "fraction", "message", "rank",
        }
        if unknown:
            raise ValueError(f"fault-plan entry {i} has unknown keys {sorted(unknown)}")
        site = raw.get("site")
        if not isinstance(site, str) or not site:
            raise ValueError(f"fault-plan entry {i} needs a non-empty 'site'")
        kind = raw.get("kind", "raise")
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"fault-plan entry {i}: kind {kind!r} not in {FAULT_KINDS}"
            )
        on_call = int(raw.get("on_call", 1))
        count = int(raw.get("count", 1))
        if on_call < 1 or count < 1:
            raise ValueError(f"fault-plan entry {i}: on_call/count must be >= 1")
        fraction = float(raw.get("fraction", 0.5))
        if not 0.0 <= fraction < 1.0:
            raise ValueError(f"fault-plan entry {i}: fraction must be in [0, 1)")
        rank = raw.get("rank")
        if rank is not None and (not isinstance(rank, int) or rank < 0):
            raise ValueError(
                f"fault-plan entry {i}: rank must be a process index >= 0"
            )
        plan.setdefault(site, []).append(
            _FaultEntry(site, kind, on_call, count, fraction,
                        raw.get("message", ""), rank)
        )
    return plan


def arm_fault_plan(plan: Union[None, str, Sequence[dict]] = None) -> None:
    """Load a deterministic fault plan (a JSON string, a list of entry dicts, or
    ``None`` to read ``HEAT_TPU_FAULT_PLAN``) and reset every site's call
    counter, so the same plan replays the same failure sequence."""
    global _armed
    if plan is None:
        plan = os.environ.get("HEAT_TPU_FAULT_PLAN", "")
        if not plan:
            raise ValueError("no plan given and HEAT_TPU_FAULT_PLAN is unset")
    parsed = _parse_plan(plan)
    with _lock:
        _plan.clear()
        _plan.update(parsed)
        _site_calls.clear()
        _armed = bool(_plan)
        _refresh_active_locked()
    _record_event(
        "plan", "armed",
        f"{sum(len(v) for v in parsed.values())} entries at {sorted(parsed)}",
    )


def disarm_fault_plan() -> None:
    """Drop the fault plan and its call counters; sites go back to zero-cost."""
    global _armed
    with _lock:
        _plan.clear()
        _site_calls.clear()
        _armed = False
        _refresh_active_locked()


def fault_plan() -> List[dict]:
    """The armed plan as plain dicts (empty when disarmed) — introspection."""
    with _lock:
        return [e.as_dict() for entries in _plan.values() for e in entries]


def fault_signal(site: str) -> Optional[_FaultEntry]:
    """Count one call at ``site`` and return the plan entry firing on it, if
    any. The non-raising form for sites that handle kinds specially (probe
    sites map ``backend-down`` to a recorded DOWN result; :func:`atomic_write`
    maps ``torn-write`` to a truncated payload). Most sites use
    :func:`maybe_fault` instead. Entries carrying a ``rank`` fire only on the
    process whose :func:`set_fault_rank` identity matches — one env-armed
    plan can target one rank of a multi-process chaos job."""
    if not _armed:
        return None
    global _fired
    with _lock:
        n = _site_calls.get(site, 0) + 1
        _site_calls[site] = n
        for entry in _plan.get(site, ()):
            if entry.rank is not None and entry.rank != _fault_rank:
                continue
            if entry.on_call <= n < entry.on_call + entry.count:
                _fired += 1
                _record_event(site, "fault", f"{entry.kind} fired on call {n}")
                _count(f"resilience.fault.{site}")
                return entry
    return None


def maybe_fault(site: str) -> None:
    """Raise the planned fault for this call at ``site``, if one fires."""
    entry = fault_signal(site)
    if entry is not None:
        raise_entry(entry, site)


def raise_entry(entry: _FaultEntry, site: str) -> None:
    """Raise the exception form of a fired plan entry (``peer-dead`` does not
    return at all: the process exits)."""
    msg = entry.message or f"injected {entry.kind} at {site!r}"
    if entry.kind == "timeout":
        raise InjectedTimeout(msg)
    if entry.kind == "backend-down":
        raise InjectedBackendDown(msg)
    if entry.kind == "deadline-exceeded":
        raise InjectedDeadlineExceeded(msg)
    if entry.kind == "peer-dead":
        _die_as_peer(site, msg)
    raise FaultInjected(msg)


# ------------------------------------------------------- peer-dead injection
#: this process's rank for fault-plan ``rank`` targeting (stamped by the
#: communication bootstrap; None = entries without a rank match everything)
_fault_rank: Optional[int] = None

#: hook the supervision plane registers so a peer-dead firing stops this
#: process's heartbeats BEFORE exiting (the realistic crash shape: silence,
#: then absence); tests may stub it
_peer_dead_hook: Optional[Callable[[], None]] = None

#: the exit primitive — ``os._exit`` so no atexit handler (the clean-departure
#: marker above all) can soften the simulated crash; tests monkeypatch this
#: to observe the firing without dying
_peer_dead_exit: Callable[[int], None] = os._exit

#: exit status of a peer-dead firing, distinguishable in launcher logs
PEER_DEAD_EXIT_STATUS = 43


def set_fault_rank(rank: Optional[int]) -> None:
    """Stamp this process's rank for ``rank``-targeted fault-plan entries
    (``initialize`` stamps it with the process's rank)."""
    global _fault_rank
    with _lock:
        _fault_rank = None if rank is None else int(rank)


def _die_as_peer(site: str, msg: str) -> None:
    """The ``peer-dead`` fault kind: this rank stops heartbeating and exits
    abruptly — the deterministic stand-in for SIGKILL, so supervision paths
    are testable single-host and in chaos CI without real process murder.
    Does not return; when a test stubs ``_peer_dead_exit``, the firing
    surfaces as :class:`FaultInjected` instead of silently continuing."""
    _record_event(site, "peer-dead", msg)
    hook = _peer_dead_hook
    if hook is not None:
        hook()
    _peer_dead_exit(PEER_DEAD_EXIT_STATUS)
    raise FaultInjected(msg)


def reset(clear_breakers: bool = False) -> None:
    """Zero the site call counters (the plan itself stays armed) and, with
    ``clear_breakers=True``, drop every registered breaker — test isolation."""
    global _fired
    with _lock:
        _site_calls.clear()
        _fired = 0
        if clear_breakers:
            _breakers.clear()


# ------------------------------------------------------------------ atomic writes
_tmp_seq = 0


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (best-effort on
    filesystems that reject directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable[[str], Any], *, site: str = "io.write",
                 policy: Optional[Policy] = None):
    """Atomically produce ``path``: ``writer(tmp_path)`` writes the payload to a
    temp file in the same directory, which is fsynced and ``os.replace``d onto
    ``path`` (readers see the old file or the complete new one, never a torn
    middle). Returns ``writer``'s return value.

    Policy-driven retry: each attempt gets a fresh temp file; the ``site``
    policy (default: the module default) decides attempts/backoff. Fault
    injection: ``raise``/``timeout`` entries abort the attempt (and are
    retried); a ``torn-write`` entry truncates the temp payload to its
    ``fraction`` *before* the rename — the committed file is silently short,
    which is exactly what manifest-side partial-write detection must catch.
    """
    pol = policy or get_policy(site)
    directory = os.path.dirname(os.path.abspath(path)) or "."

    def attempt():
        global _tmp_seq
        torn: Optional[float] = None
        entry = fault_signal(site)
        if entry is not None:
            if entry.kind == "torn-write":
                torn = entry.fraction
            else:
                raise_entry(entry, site)
        with _lock:
            _tmp_seq += 1
            seq = _tmp_seq
        tmp = f"{path}.tmp.{os.getpid()}.{seq}"
        try:
            result = writer(tmp)
            if torn is not None:
                size = os.path.getsize(tmp)
                with open(tmp, "r+b") as fh:
                    fh.truncate(int(size * torn))
            fd = os.open(tmp, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, path)
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        fsync_dir(directory)
        return result

    return pol.run(site, attempt)


# ------------------------------------------------------------- supervision
def run_supervised(step_fn, manager, policy=None, **kwargs):
    """Run a training loop under the supervision plane with elastic restart
    from checkpoint — the recovery half of the typed failure vocabulary
    above. Delegates to :func:`heat_tpu_torch.core.supervision.run_supervised`
    (see there for the full contract): on :class:`PeerFailed` /
    :class:`CollectiveTimeout` / :class:`CoordinationTimeout` the harness
    drains the scheduler, re-initializes the process group at the surviving
    world size, restores the latest ``CheckpointManager`` step via
    reshard-on-restore, and resumes under ``policy``'s restart budget."""
    from . import supervision

    return supervision.run_supervised(step_fn, manager, policy, **kwargs)


# ------------------------------------------------------------------ reporting
def resilience_stats() -> dict:
    """The resilience section of ``ht.diagnostics.report()``: armed plan, site
    call counts, fault firings, registered policies and breaker snapshots."""
    with _lock:
        return {
            "armed": _armed,
            "plan": [e.as_dict() for entries in _plan.values() for e in entries],
            "site_calls": dict(_site_calls),
            "faults_fired": _fired,
            "policies": sorted(_site_policies),
            "breakers": {site: br.snapshot() for site, br in _breakers.items()},
        }


if diagnostics is not None:
    diagnostics.register_provider("resilience", resilience_stats)
    # diagnostics cannot import this module (cycle), so the atomic-dump
    # primitive is installed into it here: diagnostics.dump commits whole
    # artifacts from now on instead of risking a torn JSON mid-crash
    diagnostics._atomic_writer = atomic_write

# Env bootstrap: a plan armed by the environment applies to the whole process
# (the CI chaos job's canned plans); a malformed plan fails LOUDLY here rather
# than silently running the chaos suite fault-free.
if os.environ.get("HEAT_TPU_FAULT_PLAN"):
    arm_fault_plan(os.environ["HEAT_TPU_FAULT_PLAN"])
