"""Async dispatch scheduler: a sharded fair bounded work queue for executor forces
(the port's counterpart of heat_tpu/core/_scheduler.py, stdlib-only at load).

:mod:`_executor` plans a force under its lock (linearisation, CSE, donation
decisions, pending-value installation) and hands the *execution* — the program
call, which needs no executor state — to this scheduler as a :class:`WorkItem`.

The queue is split into N :class:`_Shard`\\ s (``HEAT_TPU_SCHED_SHARDS``, default
``min(4, cores)``, read when the executor constructs its scheduler), each with its
own condition variable, tenant deques, batch-key index and daemon drain thread.
Tenants are hash-affined to shards (one tenant's items always land on one shard,
so per-tenant FIFO order holds), and a shard that pops a batchable item below the
batch cap **work-steals** same-signature queued items from the other shards.
``HEAT_TPU_SCHED_SHARDS=1`` is the single-queue scheduler.

- **Inline fast path.** A submitter whose affined shard is empty with nothing
  executing runs its item on its own thread: single-threaded work pays one
  try-acquire for the queue's existence.
- **Fair bounded queue.** Under contention items park in per-tenant FIFO deques
  (tenant = the profiler's ambient request *tag*, else the submitting thread id)
  drained round-robin by the shard's thread. The queue is bounded per shard
  (``HEAT_TPU_DISPATCH_QUEUE``); a full shard is backpressure, resolved by the
  submitter through the ``executor.queue`` ``ht.resilience`` policy.
- **Cross-request signature batching.** A popped batchable item (same program,
  identical scalar operands, no donation) collects every matching item across
  the shard's tenant queues and steals from the other shards, so N concurrent
  requests on one cached program become ONE batched execution
  (``_Program.call_batched``). Widths are bucketed to powers of two capped by
  ``HEAT_TPU_BATCH_MAX``.

**Adaptive batch windows.** With ``HEAT_TPU_BATCH_WINDOW_US > 0`` a shard that
popped a batchable item below the cap may HOLD it for ``min(knob, 8 x gap-EWMA)``
so near-simultaneous arrivals widen the batch, never longer than half the item's
remaining deadline budget after the program's service-time EWMA. The default 0
holds nothing.

:class:`PendingValue` is the dispatch-done future the executor installs into
``Deferred.value`` while an item is queued or in flight: ``resolve()`` blocks
only until the program's kernels are *enqueued*. Every thread launches on the
device's default stream, so a consumer's later launches are ordered after them.

**Request lifecycle.** A :class:`WorkItem` carries the request's wall-clock
``deadline`` and the scheduler acts on it at **pre-dispatch** (an expired popped
item is cancelled, its futures failed with a typed
``ht.resilience.DeadlineExceeded``) and at **batch formation** (expired peers are
cancelled rather than widening a batch). The lifecycle verbs fan out over every
shard with exactly-once ledger accounting: :meth:`DispatchScheduler.cancel`,
:meth:`DispatchScheduler.drain` (stop admission, flush, or past its timeout shed
the leftovers with one typed ``DrainTimeout``), :meth:`DispatchScheduler.reopen`
and :meth:`DispatchScheduler.quiesce`; the executor registers an atexit drain.

Telemetry lives in per-shard cells mutated under that shard's ``_cv`` and folded
at :meth:`DispatchScheduler.stats`. While the profiler is active every
enqueue/dequeue records a ``queue_depth`` counter sample and every lifecycle
event a ``lifecycle.<kind>`` counter sample. No code path holds two scheduler
locks at once, and every scheduler lock stays below ``_executor._lock``.

Collective-bearing programs never reach this queue: every rank must issue a
collective in the same order, so the executor runs them inline on the calling
thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from . import forensics  # request lifecycle records; stdlib-only like us
from . import resilience
from . import supervision  # sentinel checkpoint; stdlib-only like us

__all__ = ["PendingValue", "WorkItem", "DispatchScheduler"]

#: the lifecycle ledger's keys — one per typed rejection the executor/scheduler
#: can deliver instead of a result (see ``ht.resilience``)
LIFECYCLE_KINDS = ("deadline_expired", "shed", "cancelled")


class PendingValue:
    """A dispatch-done future standing in for a forced node's concrete value.

    Installed into ``Deferred.value`` when the executor hands a planned force
    to the scheduler; carries the node's local shape and dtype so graph building can
    keep using the node (shape/dtype reads, operand signatures) without
    waiting.  :meth:`resolve` blocks until the program call *dispatched* (not
    until the device finished: the fulfilled tensor's kernels are queued on the
    device's stream)
    and either returns the value or re-raises the execution's failure.
    """

    __slots__ = ("shape", "dtype", "_event", "_value", "_error")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def fulfill(self, value) -> None:
        if self._event.is_set():
            return  # first outcome wins: a late belt-path fail/fulfill is a no-op
        self._value = value
        self._event.set()

    def fail(self, error: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def failed(self) -> bool:
        """True once the dispatch completed WITH an error. The executor treats
        a failed pending as "unforced": readers re-raise (and clear it so the
        next force retries), planners re-plan the subchain — the serialized
        path's every-read-retries failure semantics."""
        return self._event.is_set() and self._error is not None

    def resolve(self):
        self._event.wait()
        if self._error is not None:
            raise self._error
        return self._value


class WorkItem:
    """One planned force execution.

    ``execute`` runs the single-item path end to end (program call, failure
    fallback, buffer release, memoisation, future fulfilment) and NEVER raises
    — the executor builds it that way so a scheduler thread cannot die to a
    user-level failure.  ``batch_key`` is ``None`` for items that must run
    alone (donation granted, warm-up, scalar-free ineligibility); batchable
    items additionally expose the structured fields ``prog`` / ``leaves`` /
    ``complete`` / ``fail`` that ``_executor._execute_batch`` consumes.
    """

    __slots__ = (
        "seq", "tenant", "req", "execute", "batch_key", "prog", "leaves",
        "complete", "fail", "deadline", "t_submit", "t_popped", "hold_s",
        "stolen_from",
    )

    def __init__(self, tenant: str, execute: Callable[[], None], *,
                 req=None, batch_key=None, prog=None, leaves=None,
                 complete=None, fail=None, deadline: Optional[float] = None):
        self.seq = 0  # assigned by the scheduler at submit
        self.tenant = tenant
        self.req = req
        self.execute = execute
        self.batch_key = batch_key
        self.prog = prog
        self.leaves = leaves
        self.complete = complete
        self.fail = fail
        # absolute wall-clock deadline (time.monotonic() instant) or None:
        # the scheduler cancels rather than executes an item past it
        self.deadline = deadline
        # forensics timeline stamps (time.monotonic()): enqueue instant
        # (always stamped — the submit path already holds the clock value),
        # dequeue instant (stamped only while forensics is armed), leader's
        # batch-window hold, and the shard index the item was stolen from
        self.t_submit: Optional[float] = None
        self.t_popped: Optional[float] = None
        self.hold_s = 0.0
        self.stolen_from: Optional[int] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def describe(self) -> str:
        label = getattr(self.prog, "label", None) or "eager-replay"
        return f"{self.tenant}#{self.seq}:{label}"


def _bucket_width(n: int, cap: int) -> int:
    """Largest power of two <= min(n, cap): same-shard batch widths are
    bucketed so each program compiles at most log2(cap) batched variants (a
    cross-shard steal may top a group up between buckets — still <= cap)."""
    n = min(n, max(1, cap))
    w = 1
    while w * 2 <= n:
        w *= 2
    return w


class _Shard:
    """One queue shard: tenant deques, the batch-key index, a daemon drain
    thread, and the shard's telemetry + lifecycle cells.

    Everything on the shard mutates under ``self._cv`` (the
    ``_locked``-suffix convention marks helpers entered with it held);
    :class:`DispatchScheduler` folds the cells at report time.  The only
    cross-shard touch is work-stealing: another shard's drain thread calls
    :meth:`steal_batchable`, which takes THIS shard's ``_cv`` alone — no two
    scheduler locks are ever held together.
    """

    def __init__(self, sched: "DispatchScheduler", index: int):
        self.sched = sched
        self.index = index
        self._cv = threading.Condition()
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        # batch_key -> queued batchable items (insertion order): batch
        # collection is an O(width) index lookup, not an O(depth) scan of
        # every tenant deque under the lock
        self._by_key: Dict[object, List[WorkItem]] = {}
        self._depth = 0
        self._active = 0          # executions in flight (inline + thread)
        self._thread: Optional[threading.Thread] = None
        # telemetry cells (mutated under _cv; folded by DispatchScheduler.stats)
        self.queue_depth_peak = 0
        self.batched_requests = 0
        self.batch_width_hist: Dict[int, int] = {}
        self.submitted = 0
        self.inline_runs = 0
        self.queue_full_events = 0
        self.drain_rejects = 0        # submits refused: admission closed
        self.stolen_batch_items = 0   # items this shard stole FROM other shards
        self.window_holds = 0         # adaptive-window holds taken
        self.window_widened = 0       # holds during which new peers arrived
        self.window_hold_ns = 0       # wall ns spent holding
        # the shard's slice of the lifecycle ledger: every request-shaped
        # rejection is counted in exactly ONE shard's cells (totals + per
        # tenant), and the cells fold at stats() — nothing is double-counted,
        # nothing is silently dropped
        self.lifecycle: Dict[str, int] = {k: 0 for k in LIFECYCLE_KINDS}
        self.tenant_lifecycle: Dict[str, Dict[str, int]] = {}
        # adaptive-window signal: EWMA of the gap between queued submits
        # (seconds); 0 until two submits have been seen
        self._gap_ewma_s = 0.0
        self._last_submit: Optional[float] = None
        # pressure EWMAs (the autoscaler-facing contract surfaced through
        # ``executor_stats()["pressure"]``; same alpha as the gap EWMA):
        # queue-depth EWMA advances toward the post-enqueue depth on every
        # accepted submit; the shed-rate EWMA is driven toward 1.0 by each
        # shed and toward 0.0 by each accepted submit, so it reads as "the
        # recent fraction of admission decisions that shed". Both mutate
        # under ``_cv`` (exact at snapshot time, like every shard cell).
        self._depth_ewma = 0.0
        self._shed_ewma = 0.0

    # ------------------------------------------------------------- submission
    def try_inline_locked_claim(self) -> bool:
        """Claim the shard's inline fast path (empty + idle + not paused)."""
        with self._cv:
            if self._depth == 0 and self._active == 0 and not self.sched._paused:
                self._active += 1
                self.inline_runs += 1
                return True
            return False

    def end_inline(self) -> None:
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def submit(self, item: WorkItem, bound: int) -> bool:
        """Park ``item`` in its tenant's queue; False when admission is
        closed or this shard is at ``bound`` (the caller applies its
        backpressure policy).

        The ``_draining`` check happens HERE, under the shard's ``_cv`` —
        the same lock the drain's sweep takes — so no item can slip in
        after its shard was swept: a submit either enqueues before the
        sweep (which then flushes or sheds it) or observes the flag the
        drain set first and is refused. (The flag write itself is under the
        scheduler ``_gate``; the read is ordered by this shard's ``_cv``.)"""
        with self._cv:
            if self.sched._draining:
                self.drain_rejects += 1
                return False
            if self._depth >= bound:
                self.queue_full_events += 1
                return False
            item.seq = next(self.sched._seq)
            q = self._queues.get(item.tenant)
            if q is None:
                q = self._queues[item.tenant] = deque()
            q.append(item)
            if item.batch_key is not None:
                self._by_key.setdefault(item.batch_key, []).append(item)
            self._depth += 1
            self.submitted += 1
            if self._depth > self.queue_depth_peak:
                self.queue_depth_peak = self._depth
            now = time.monotonic()
            item.t_submit = now
            last = self._last_submit
            self._last_submit = now
            if last is not None:
                gap = now - last
                prev = self._gap_ewma_s
                self._gap_ewma_s = gap if prev <= 0.0 else prev + 0.25 * (gap - prev)
            self._depth_ewma += 0.25 * (self._depth - self._depth_ewma)
            self._shed_ewma += 0.25 * (0.0 - self._shed_ewma)
            depth = self._depth
            self._ensure_thread_locked()
            self._cv.notify_all()
        self._note_depth(depth)
        return True

    # ------------------------------------------------------------- drain loop
    def _ensure_thread_locked(self) -> None:
        # called under _cv (the _locked suffix is the convention the invariant
        # checker enforces for functions entered with the lock already held)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name=f"heat-tpu-dispatch-{self.index}",
                daemon=True,
            )
            self._thread.start()

    def _unindex_locked(self, item: WorkItem) -> None:
        if item.batch_key is None:
            return
        peers = self._by_key.get(item.batch_key)
        if peers is not None:
            try:
                peers.remove(item)
            except ValueError:
                pass
            if not peers:
                del self._by_key[item.batch_key]

    def _remove_item_locked(self, item: WorkItem) -> None:
        """Pull a still-queued ``item`` out of its tenant deque + the batch
        index and account the depth change. Under _cv."""
        q = self._queues.get(item.tenant)
        if q is not None:
            try:
                q.remove(item)
            except ValueError:
                return  # already popped by a racing path
            if not q:
                del self._queues[item.tenant]
        self._unindex_locked(item)
        self._depth -= 1

    def _pop_one_locked(self) -> Optional[WorkItem]:
        """Round-robin pop of one item across tenant deques. Under _cv."""
        for tenant in list(self._queues):
            q = self._queues[tenant]
            if q:
                item = q.popleft()
                self._queues.move_to_end(tenant)  # fairness: rotate the tenant
                if not q:
                    del self._queues[tenant]
                self._unindex_locked(item)
                self._depth -= 1
                if forensics._enabled:
                    item.t_popped = time.monotonic()
                return item
        return None

    def _hold_window_locked(self, item: WorkItem, batch_cap: int,
                            window_s: float) -> None:
        """The adaptive batch window: hold a batchable ``item`` (already
        popped) up to the effective window so same-signature arrivals widen
        the batch. Under _cv (the wait releases it, so submits land).

        The effective hold is EWMA-tuned — ``min(window_s, 8 x gap-EWMA)``,
        and only taken under measured queue pressure (more work already
        queued, or arrivals dense enough that the window can realistically
        catch the next one) — and bounded by the item's deadline headroom:
        never more than half the remaining budget after the program's
        service-time EWMA, so a hold cannot expire a feasible request."""
        key = item.batch_key
        gap = self._gap_ewma_s
        if not (self._depth > 0 or (0.0 < gap <= window_s)):
            return  # no pressure: holding would only add latency
        eff = window_s if gap <= 0.0 else min(window_s, 8.0 * gap)
        if item.deadline is not None:
            est = item.prog.ewma_s if item.prog is not None else 0.0
            headroom = item.deadline - time.monotonic() - est
            if headroom <= 0.0:
                return  # no headroom to spend: dispatch immediately
            eff = min(eff, headroom * 0.5)
        if eff <= 0.0:
            return
        before = len(self._by_key.get(key, ()))
        if before + 1 >= batch_cap:
            return  # already enough peers queued to fill the batch
        self.window_holds += 1
        t0 = time.monotonic()
        hold_until = t0 + eff
        while True:
            now = time.monotonic()
            if now >= hold_until:
                break
            if self.sched._draining or self.sched._paused:
                break  # a drain/pause wants the queue settled, not held
            if len(self._by_key.get(key, ())) + 1 >= batch_cap:
                break  # the batch is full: no reason to keep holding
            self._cv.wait(hold_until - now)
        held = time.monotonic() - t0
        item.hold_s = held
        self.window_hold_ns += int(held * 1e9)
        if len(self._by_key.get(key, ())) > before:
            self.window_widened += 1

    def _pop_group_locked(
        self, batch_cap: int, now: float, window_s: float = 0.0
    ) -> Tuple[List[WorkItem], List[WorkItem]]:
        """Round-robin tenant pop + same-shard batch collection, with the
        pre-dispatch deadline checkpoint: items whose deadline has passed are
        pulled out and returned separately (``expired``) instead of being
        executed or widening the batch — the caller fails their futures
        OUTSIDE the lock. Under _cv."""
        expired: List[WorkItem] = []
        item: Optional[WorkItem] = None
        while True:
            item = self._pop_one_locked()
            if item is None:
                return [], expired
            if item.expired(now):
                expired.append(item)
                continue
            break
        group = [item]
        if item.batch_key is not None and batch_cap > 1:
            if window_s > 0.0:
                # adaptive batch window: wait (bounded) for same-signature
                # arrivals before forming the batch
                self._hold_window_locked(item, batch_cap, window_s)
                now = time.monotonic()
            # gather same-signature items from EVERY tenant queue (this is the
            # cross-request half of signature batching) via the batch-key
            # index, oldest first — no full-queue scan under the lock. Expired
            # peers are cancelled here rather than batched: over-deadline work
            # must not widen (or slow) a healthy batch.
            matches = sorted(self._by_key.get(item.batch_key, ()), key=lambda w: w.seq)
            live: List[WorkItem] = []
            for w in matches:
                if w.expired(now):
                    self._remove_item_locked(w)
                    expired.append(w)
                else:
                    live.append(w)
            width = _bucket_width(1 + len(live), batch_cap)
            take = live[: width - 1]
            for w in take:
                self._remove_item_locked(w)
            group.extend(take)
        return group, expired

    def steal_batchable(
        self, batch_key, need: int, now: float
    ) -> Tuple[List[WorkItem], List[WorkItem], int]:
        """Hand up to ``need`` live queued items with ``batch_key`` (oldest
        first) to ANOTHER shard's drain thread, pulling expired peers out of
        the queue as a side effect — the pre-dispatch deadline checkpoint
        applies to stolen work too. Expired items are ledgered HERE (the
        shard that owned them — exactly-once accounting); the caller delivers
        their typed errors outside every lock. Returns
        ``(live, expired, depth_after)``."""
        live: List[WorkItem] = []
        expired: List[WorkItem] = []
        with self._cv:
            matches = sorted(self._by_key.get(batch_key, ()), key=lambda w: w.seq)
            for w in matches:
                if w.expired(now):
                    self._remove_item_locked(w)
                    self._count_lifecycle_locked("deadline_expired", w.tenant)
                    expired.append(w)
                elif len(live) < need:
                    self._remove_item_locked(w)
                    live.append(w)
            depth = self._depth
            if live or expired:
                self._cv.notify_all()
        if live or expired:
            self._note_depth(depth)
        return live, expired, depth

    def _count_lifecycle_locked(self, kind: str, tenant: Optional[str],
                                n: int = 1) -> int:
        """Account ``n`` lifecycle events of ``kind`` in THIS shard's cells;
        returns the shard's new total. Under _cv."""
        if kind == "shed":
            for _ in range(n):
                self._shed_ewma += 0.25 * (1.0 - self._shed_ewma)
        self.lifecycle[kind] += n
        if tenant is not None:
            per = self.tenant_lifecycle.get(tenant)
            if per is None:
                per = self.tenant_lifecycle[tenant] = {
                    k: 0 for k in LIFECYCLE_KINDS
                }
            per[kind] += n
        return self.lifecycle[kind]

    def _loop(self) -> None:
        from . import _executor  # late: the executor imports this module first

        sched = self.sched
        while True:
            with self._cv:
                while self._depth == 0 or sched._paused:
                    self._cv.wait()
                batch_cap = _executor.batch_max()
                # active BEFORE the pop: the adaptive window inside
                # _pop_group_locked can hold a popped (depth-decremented)
                # item across a cv wait, and drain/wait_idle must keep
                # seeing the shard as busy for that whole stretch — a
                # quiesced hot-swap may not overlap a held item's dispatch
                self._active += 1
                group, expired = self._pop_group_locked(
                    batch_cap, time.monotonic(), _executor.batch_window_s()
                )
                if expired:
                    for w in expired:
                        self._count_lifecycle_locked("deadline_expired", w.tenant)
                if not group:
                    # everything popped this round had expired: wake wait_idle
                    # / drain waiters watching the depth we just lowered
                    self._active -= 1
                    self._cv.notify_all()
                depth = self._depth
            self._note_depth(depth)
            for w in expired:
                sched._deliver_lifecycle(
                    w, "deadline_expired",
                    resilience.DeadlineExceeded(
                        f"deadline passed while queued ({w.describe()})"
                    ),
                )
            if not group:
                continue
            # ---- cross-shard work-stealing: top a batchable group up, OWN
            # queue first (the bucketed gather stopped at a power of two; a
            # steal-widened batch takes the rest, and the oldest local peers
            # must not be left behind while remote ones are taken), then the
            # other shards — one shard lock at a time, never two
            if (
                group[0].batch_key is not None
                and len(group) < batch_cap
                and len(sched._shards) > 1
            ):
                need = batch_cap - len(group)
                now = time.monotonic()
                stolen = 0
                for other in (self,
                              *(o for o in sched._shards if o is not self)):
                    if need <= 0:
                        break
                    live, exp, _ = other.steal_batchable(
                        group[0].batch_key, need, now
                    )
                    group.extend(live)
                    need -= len(live)
                    if other is not self:
                        stolen += len(live)
                        for w in live:
                            w.stolen_from = other.index
                            if w.t_popped is None:
                                w.t_popped = now
                    for w in exp:
                        sched._deliver_lifecycle(
                            w, "deadline_expired",
                            resilience.DeadlineExceeded(
                                f"deadline passed while queued ({w.describe()})"
                            ),
                        )
                if stolen:
                    with self._cv:
                        self.stolen_batch_items += stolen
            if len(group) > 1:
                with self._cv:
                    width = len(group)
                    self.batched_requests += width
                    self.batch_width_hist[width] = (
                        self.batch_width_hist.get(width, 0) + 1
                    )
            if forensics._enabled:
                # lifecycle records: queue wait / window hold / shard / width
                # / steal provenance per item — OUTSIDE self._cv (forensics'
                # lock is a strict leaf; no scheduler lock is held here)
                t_sched = time.monotonic()
                width = len(group)
                for w in group:
                    if w.req is None:
                        continue
                    tp = w.t_popped if w.t_popped is not None else t_sched
                    qw = (max(0.0, tp - w.t_submit)
                          if w.t_submit is not None else 0.0)
                    forensics.note_scheduled(
                        w.req, self.index, qw, w.hold_s, width, w.stolen_from
                    )
            if supervision._armed:
                # the scheduler's supervision checkpoint: once the abort
                # sentinel is up, queued work is SHED typed (PeerFailed /
                # CollectiveTimeout) pre-dispatch instead of walking into a
                # collective whose peer is gone — counted in the lifecycle
                # ledger like every other rejection, never silently dropped
                abort = supervision.abort_error("scheduler.dispatch")
                if abort is not None:
                    with self._cv:
                        for w in group:
                            self._count_lifecycle_locked("shed", w.tenant)
                        self._active -= 1
                        self._cv.notify_all()
                    for w in group:
                        sched._deliver_lifecycle(w, "shed", abort)
                    continue
            try:
                if len(group) == 1:
                    group[0].execute()
                else:
                    sched.batch_runner(group)
            except BaseException as exc:  # item contracts say "never raise" —
                # this is the last-ditch guard so a bug cannot strand waiters
                for w in group:
                    try:
                        if w.fail is not None:
                            w.fail(exc)
                    except BaseException:
                        pass
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    # ------------------------------------------------------------- telemetry
    def _note_depth(self, depth: int) -> None:
        from . import profiler

        if profiler._active:
            shards = self.sched._shards
            if len(shards) > 1:
                # one Perfetto counter track per shard, plus the summed
                # rollup below (the bare cross-shard reads are a relaxed
                # telemetry snapshot, not a synchronised count)
                profiler.record_counter(f"queue_depth.shard{self.index}", depth)
                total = 0
                for sh in shards:
                    total += depth if sh is self else sh._depth
                profiler.record_counter("queue_depth", total)
            else:
                profiler.record_counter("queue_depth", depth)

    def snapshot_locked_copy(self) -> dict:
        """This shard's telemetry cells, copied under its lock (stats fold)."""
        with self._cv:
            return {
                "queue_depth": self._depth,
                "queue_depth_peak": self.queue_depth_peak,
                "batched_requests": self.batched_requests,
                "batch_width_hist": dict(self.batch_width_hist),
                "submitted": self.submitted,
                "inline_runs": self.inline_runs,
                "queue_full_events": self.queue_full_events,
                "drain_rejects": self.drain_rejects,
                "stolen_batch_items": self.stolen_batch_items,
                "window_holds": self.window_holds,
                "window_widened": self.window_widened,
                "window_hold_ns": self.window_hold_ns,
                "lifecycle": dict(self.lifecycle),
                "tenant_lifecycle": {
                    t: dict(per) for t, per in self.tenant_lifecycle.items()
                },
                # pressure EWMAs: per-shard ONLY — EWMAs do not sum, so
                # DispatchScheduler.stats never folds them into the totals
                "gap_ewma_s": self._gap_ewma_s,
                "depth_ewma": self._depth_ewma,
                "shed_rate_ewma": self._shed_ewma,
            }

    def reset_stats(self) -> None:
        with self._cv:
            self.queue_depth_peak = self._depth
            self.batched_requests = 0
            self.batch_width_hist = {}
            self.submitted = 0
            self.inline_runs = 0
            self.queue_full_events = 0
            self.drain_rejects = 0
            self.stolen_batch_items = 0
            self.window_holds = 0
            self.window_widened = 0
            self.window_hold_ns = 0
            self.lifecycle = {k: 0 for k in LIFECYCLE_KINDS}
            self.tenant_lifecycle = {}
            # _gap_ewma_s is deliberately NOT reset: it is the adaptive
            # batch window's control signal, not a statistic
            self._depth_ewma = 0.0
            self._shed_ewma = 0.0


def shard_index_for(affinity, shards: int) -> int:
    """The shard index ``affinity`` (a tenant tag, or None for untagged work)
    hash-affines to among ``shards`` slots — the ONE affinity function shared
    by the dispatch queue (:meth:`DispatchScheduler._shard_for`) and the
    result cache's per-shard slices (``_result_cache``), so a tenant's cache
    shard is always the shard its dispatches drain on.  Untagged work
    normalises to the ``t<thread-id>`` fallback tenant the executor uses."""
    if shards <= 1:
        return 0
    if affinity is None:
        affinity = f"t{threading.get_ident()}"
    elif not isinstance(affinity, str):
        affinity = f"t{affinity}"
    return zlib.crc32(affinity.encode("utf-8", "surrogatepass")) % shards


class DispatchScheduler:
    """The sharded fair bounded dispatch queue plus its per-shard drain
    threads.

    ``batch_runner(items)`` is injected by the executor (avoids an import
    cycle): called with 2+ same-``batch_key`` items, it must fulfil every
    item's futures itself and never raise.  ``shards`` fixes the shard count
    for this scheduler's lifetime (the executor passes the memoised
    ``HEAT_TPU_SCHED_SHARDS`` knob; 1 reproduces the single-queue scheduler
    exactly).
    """

    def __init__(self, batch_runner: Optional[Callable[[List[WorkItem]], None]] = None,
                 shards: int = 1):
        self._gate = threading.Condition()
        self._paused = False      # test hook: hold items in the queues
        self._draining = False    # lifecycle: admission closed (drain/shutdown)
        self._drains = 0          # drain epochs: quiesce must not reopen a later drain
        self._seq = itertools.count(1)
        self.batch_runner = batch_runner
        self._shards: Tuple[_Shard, ...] = tuple(
            _Shard(self, i) for i in range(max(1, int(shards)))
        )

    @property
    def shards(self) -> int:
        return len(self._shards)

    def _shard_for(self, affinity) -> _Shard:
        """The shard ``affinity`` (a tenant tag, or None for untagged work)
        is hash-affined to. Stable within a process: one tenant's items
        always queue on one shard, preserving per-tenant FIFO order.
        Untagged work normalises to the SAME ``t<thread-id>`` string the
        executor uses as its fallback tenant, so an inline claim and a
        queued item from one untagged thread always meet on one shard."""
        shards = self._shards
        return shards[shard_index_for(affinity, len(shards))]

    # ------------------------------------------------------------- submission
    def try_inline(self, affinity=None) -> Optional[_Shard]:
        """Claim the inline fast path on the affined shard: a truthy shard
        token when that shard's queue is empty and nothing is executing there
        — the submitter runs its item on its own thread (pass the token to
        :meth:`end_inline` when done).  Under contention returns None and the
        item should be queued instead."""
        shard = self._shard_for(affinity)
        if shard.try_inline_locked_claim():
            return shard
        return None

    def end_inline(self, shard: Optional[_Shard] = None) -> None:
        (shard if shard is not None else self._shards[0]).end_inline()

    def submit(self, item: WorkItem, bound: int) -> bool:
        """Park ``item`` in its tenant's affined shard. False when that shard
        is at ``bound`` (the caller applies its backpressure policy and
        retries or executes inline) or when the scheduler is draining
        (admission closed: the caller executes inline or sheds — work is
        never dropped). The draining check lives INSIDE the shard's lock —
        see :meth:`_Shard.submit` — so admission-vs-drain stays atomic per
        shard and the submit hot path never touches a process-global lock."""
        return self._shard_for(item.tenant).submit(item, bound)

    def depth(self) -> int:
        total = 0
        for sh in self._shards:
            with sh._cv:
                total += sh._depth
        return total

    # ------------------------------------------------------------- lifecycle
    def note_lifecycle(self, kind: str, tenant: Optional[str] = None,
                       n: int = 1) -> None:
        """Count ``n`` shed/cancelled/expired requests (the executor's
        admission-side events route here too, so ``executor_stats()`` has ONE
        ledger) in the tenant's affined shard — exactly once — and mirror
        them to diagnostics counters and the profiler's cumulative
        ``lifecycle.<kind>`` counter track."""
        shard = self._shard_for(tenant)
        with shard._cv:
            shard._count_lifecycle_locked(kind, tenant, n)
        from . import diagnostics, profiler, telemetry

        if diagnostics._enabled:
            diagnostics.counter(f"executor.{kind}", n)
        if profiler._active:
            profiler.record_counter(f"lifecycle.{kind}", self._lifecycle_total(kind))
        telemetry.flight_record(  # always-on ring: post-mortems need the tail
            "lifecycle", f"scheduler.{kind}",
            f"tenant={tenant or '<none>'} n={n}", kind=kind,
        )

    def _lifecycle_total(self, kind: str) -> int:
        # relaxed cross-shard sum: the cumulative value behind the profiler
        # counter track is a telemetry snapshot, not a synchronised count
        total = 0
        for sh in self._shards:
            total += sh.lifecycle[kind]
        return total

    def _deliver_lifecycle(self, item: WorkItem, kind: str,
                           exc: BaseException) -> None:
        """Fail a cancelled/expired/shed item's futures with the typed error
        (releasing its buffer ownership through the ``fail`` closure) and
        mirror the already-ledgered event to diagnostics + the profiler
        counter track. Never raises — this runs on scheduler threads and
        in drain paths. The ledger increment itself happens under a shard's
        _cv at the site that pulled the item out of its queue."""
        # mark the error as ledger-accounted so a waiter that re-routes it
        # through fallback_after_failure (the staged one-op wrappers) does
        # not count the same rejection twice
        exc._ht_ledgered = True
        try:
            if item.fail is not None:
                item.fail(exc)
        except BaseException:  # belt: a bookkeeping bug in
            pass               # one item must not strand the rest
        from . import diagnostics, profiler, telemetry

        if diagnostics._enabled:
            diagnostics.counter(f"executor.{kind}", 1)
        if profiler._active:
            profiler.record_counter(f"lifecycle.{kind}", self._lifecycle_total(kind))
        if forensics._enabled and item.req is not None:
            forensics.note_event(
                "typed-failure", f"{kind}: {item.describe()}", rid=item.req
            )
        telemetry.flight_record(
            "lifecycle", f"scheduler.{kind}", item.describe(), kind=kind,
        )

    def cancel(self, tag: str) -> int:
        """Cancel every still-queued item of tenant ``tag``: the items never
        execute, their futures are failed with a typed
        ``ht.resilience.RequestCancelled`` (releasing their buffer ownership),
        and the cancellations land in the lifecycle ledger. The tenant's
        items all live on its affined shard, so one shard lock covers the
        sweep. In-flight executions are not interrupted (a dispatched
        call is not safely interruptible); their futures are fulfilled
        normally. Returns the number of items cancelled."""
        shard = self._shard_for(tag)
        with shard._cv:
            q = shard._queues.pop(tag, None)
            items = list(q) if q else []
            for w in items:
                shard._unindex_locked(w)
            shard._depth -= len(items)
            for w in items:
                shard._count_lifecycle_locked("cancelled", w.tenant)
            if items:
                shard._cv.notify_all()
        for w in items:
            self._deliver_lifecycle(
                w, "cancelled",
                resilience.RequestCancelled(
                    f"cancelled by DispatchScheduler.cancel({tag!r}) "
                    f"before dispatch ({w.describe()})"
                ),
            )
        return len(items)

    def drain(self, timeout: float = 30.0) -> dict:
        """Stop admitting, flush every shard, and guarantee every outstanding
        future is fulfilled with a value or a typed error.

        Admission closes immediately (``submit`` returns False — submitters
        execute inline or shed, so new work is never dropped) and any test
        ``pause`` is lifted so the drain threads can run. Then this call
        waits up to ``timeout`` seconds (one shared deadline) for every
        shard's queue to empty and in-flight executions to finish. On
        success returns ``{"flushed": True, ...}`` quietly; on timeout every
        still-queued item ACROSS ALL SHARDS is SHED — each is counted in its
        own shard's ledger (exactly once) and its futures are failed with
        the same typed :class:`~.resilience.DrainTimeout` that is then
        raised to the caller, naming the undelivered futures — so a
        timed-out drain can never leave a ``PendingValue`` blocked forever.
        Executions still in flight at the timeout are counted in the error
        too; their futures are fulfilled by the executing threads when they
        finish.

        The scheduler stays closed to admission afterwards (shutdown is the
        expected caller); use :meth:`reopen` to resume normal service."""
        with self._gate:
            self._draining = True
            self._drains += 1
            self._paused = False
            self._gate.notify_all()
        deadline = time.monotonic() + max(0.0, timeout)
        flushed = True
        leftovers: List[WorkItem] = []
        still_active = 0
        for sh in self._shards:
            with sh._cv:
                # wake + wait + pop under ONE acquisition per shard: with
                # timeout=0 the shard loop can never interleave between the
                # wake-up and the leftover sweep (the single-queue drain's
                # determinism, preserved per shard)
                sh._cv.notify_all()
                ok = sh._cv.wait_for(
                    lambda: sh._depth == 0 and sh._active == 0,
                    timeout=max(0.0, deadline - time.monotonic()),
                )
                if not ok:
                    flushed = False
                    shard_left: List[WorkItem] = []
                    while True:
                        item = sh._pop_one_locked()
                        if item is None:
                            break
                        shard_left.append(item)
                    for w in shard_left:
                        sh._count_lifecycle_locked("shed", w.tenant)
                    leftovers.extend(shard_left)
                    still_active += sh._active
                    if shard_left:
                        sh._cv.notify_all()
        if flushed:
            return {"flushed": True, "shed": 0, "in_flight": 0}
        exc = resilience.DrainTimeout(
            timeout, [w.describe() for w in leftovers], still_active
        )
        # futures FIRST: nothing downstream of this loop may strand a waiter
        for w in leftovers:
            self._deliver_lifecycle(w, "shed", exc)
        from . import diagnostics

        # always-on resilience event: a timed-out drain is a typed failure path
        diagnostics.record_resilience_event(
            "scheduler.drain", "drain-timeout", str(exc)
        )
        raise exc

    def reopen(self) -> None:
        """Re-open admission after a :meth:`drain` (tests, rolling restarts)."""
        with self._gate:
            self._draining = False
            self._gate.notify_all()
        for sh in self._shards:
            with sh._cv:
                sh._cv.notify_all()

    @contextlib.contextmanager
    def quiesce(self, timeout: float = 30.0, *, tolerate_shed: bool = False):
        """Drain, yield a quiesced scheduler for the caller's critical section
        (model hot-swap rebinds serving state here), and reopen — on a
        clean flush, on a :class:`~.resilience.DrainTimeout` (whose queued
        items were already shed with typed errors), and on a body failure
        alike, so a failed swap can never leave admission closed forever.
        While quiesced, refused submits execute inline on their caller's
        thread (``submit`` contract): requests slow down, none are dropped.

        By default a timed-out drain skips the critical section (a hot-swap
        must not rebind over a window it could not flush cleanly).
        ``tolerate_shed`` runs the body anyway: a timed-out drain has
        already delivered or shed every queued item typed, so the scheduler
        is exactly as quiesced as after a clean flush — callers whose
        critical section must execute while admission is STILL CLOSED even
        on a shed window opt in, and the ``DrainTimeout`` is re-raised on exit so the shed
        work is still accounted.

        The reopen yields to a DELIBERATE closure: if admission was already
        closed when quiesce began, or another drain ran during the window
        (the atexit shutdown drain racing a swap), the scheduler stays
        closed — reopening it would admit work into a shutting-down loop and
        strand its futures at interpreter exit."""
        with self._gate:
            was_draining = self._draining
            epoch = self._drains
        shed: Optional[BaseException] = None
        try:
            try:
                self.drain(timeout)  # epoch + 1 (increments before it can raise)
            except Exception as exc:
                if not (tolerate_shed and isinstance(exc, resilience.DrainTimeout)):
                    raise
                shed = exc
            yield self
        finally:
            reopened = False
            with self._gate:
                if not was_draining and self._drains == epoch + 1:
                    self._draining = False
                    self._gate.notify_all()
                    reopened = True
            if reopened:
                for sh in self._shards:
                    with sh._cv:
                        sh._cv.notify_all()
        if shed is not None:
            raise shed

    def draining(self) -> bool:
        with self._gate:
            return self._draining

    # ------------------------------------------------------------- telemetry
    def stats(self) -> dict:
        """The folded cross-shard telemetry (sums of the per-shard cells; the
        lifecycle ledger and per-tenant breakdowns merge by key) plus the
        per-shard breakdown under ``per_shard``.  ``queue_depth_peak`` is
        the SUM of per-shard peaks — an upper bound on the instantaneous
        global depth; each shard's own peak is in its ``per_shard`` entry."""
        per_shard = [sh.snapshot_locked_copy() for sh in self._shards]
        hist: Dict[int, int] = {}
        lifecycle = {k: 0 for k in LIFECYCLE_KINDS}
        tenant_lifecycle: Dict[str, Dict[str, int]] = {}
        sums = {
            "queue_depth": 0, "queue_depth_peak": 0, "batched_requests": 0,
            "submitted": 0, "inline_runs": 0, "queue_full_events": 0,
            "drain_rejects": 0, "stolen_batch_items": 0,
            "window_holds": 0, "window_widened": 0, "window_hold_ns": 0,
        }
        for snap in per_shard:
            for k in sums:
                sums[k] += snap[k]
            for width, count in snap["batch_width_hist"].items():
                hist[width] = hist.get(width, 0) + count
            for k, v in snap["lifecycle"].items():
                lifecycle[k] += v
            for tenant, per in snap["tenant_lifecycle"].items():
                agg = tenant_lifecycle.setdefault(
                    tenant, {k: 0 for k in LIFECYCLE_KINDS}
                )
                for k, v in per.items():
                    agg[k] += v
        with self._gate:
            draining = self._draining
        out = dict(sums)
        out["batch_width_hist"] = hist
        out["lifecycle"] = lifecycle
        out["tenant_lifecycle"] = tenant_lifecycle
        out["draining"] = draining
        out["shards"] = len(self._shards)
        out["per_shard"] = per_shard
        return out

    def reset_stats(self) -> None:
        for sh in self._shards:
            sh.reset_stats()

    # -------------------------------------------------------------- test hooks
    def pause(self) -> None:
        """Hold queued items (tests build deterministic batches this way).
        Inline fast-path claims are refused while paused, so every submission
        parks in the queue."""
        with self._gate:
            self._paused = True

    def resume(self) -> None:
        with self._gate:
            self._paused = False
            self._gate.notify_all()
        for sh in self._shards:
            with sh._cv:
                sh._cv.notify_all()

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every shard's queue is empty and nothing is executing."""
        deadline = time.monotonic() + max(0.0, timeout)
        for sh in self._shards:
            with sh._cv:
                ok = sh._cv.wait_for(
                    lambda: sh._depth == 0 and sh._active == 0,
                    timeout=max(0.0, deadline - time.monotonic()),
                )
                if not ok:
                    return False
        return True
