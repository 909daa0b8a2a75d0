"""``ht.serving`` — zero-downtime model state management for a serving pool (the
port's counterpart of heat_tpu/serving.py, line for line).

A serving deployment holds one live *generation* of model state (a pytree of
DNDarrays — params, biases, codebooks) that every request reads. Upgrading
that state under load has two failure modes this module closes (the fourth leg
of checkpoint v2):

- **a torn upgrade** — requests observing half-old half-new state. Prevented
  by staging: the new generation is loaded AND integrity-verified off to the
  side (the v2 streaming restore), then bound in one atomic reference swap
  inside a scheduler quiesce window.
- **dropped requests** — work lost across the swap boundary. Prevented by the
  scheduler's lifecycle verbs: :func:`swap_state` runs
  ``drain(timeout)`` → rebind → ``reopen()`` through
  ``DispatchScheduler.quiesce``, during which refused submits execute inline
  on their caller's thread (slower, never dropped) and a timed-out drain
  sheds its queue with TYPED errors — so ``admitted + shed + failed ==
  offered`` holds exactly across the swap, the invariant the swap-under-load
  chaos gate (heat_tpu's ``benchmarks/serving/swap_gate.py``, and ``chip_smoke.py``'s
  ``[serving_swap]`` phase on the card) enforces.

Any failure — staging, drain, rebind — rolls back to the old generation and
raises the typed :class:`~heat_tpu_torch.core.resilience.SwapFailed`; serving
continues on the old state. Every swap (and every rollback) lands in the
pool's ledger, the ``lifecycle.swap`` profiler counter track (Perfetto), the
flight-recorder ring, and — for rollbacks — the always-on resilience event
stream, where the ``swap-failed`` kind triggers an automatic post-mortem dump.

Thread-safety: ``ModelPool._state`` is a bare attribute rebound atomically
(CPython reference assignment) inside the quiesce window; request threads
read it relaxed — they see the complete old or the complete new generation,
never a mix. The guarantee is per READ: a handler must read ``pool.state``
once per request and compute against that snapshot — two reads straddling a
swap would observe two different (each complete) generations. The ledger and
generation bookkeeping mutate under the pool's ``_lock``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from .core import checkpoint as _checkpoint
from .core import (
    _result_cache, diagnostics, forensics, ops, profiler, resilience,
    supervision, telemetry,
)
from .core.resilience import SwapFailed

__all__ = ["ModelPool", "SwapFailed", "swap_state"]


def _scheduler():
    from .core import _executor

    return _executor._get_scheduler()


def _iter_array_leaves(tree: Any, path: str):
    """Depth-first ``(path, local tensor)`` pairs of a state pytree's DNDarray
    leaves (each leaf's ``larray``; the port has no padded ``parray``) —
    deterministic order, so one leaf always carries one tag."""
    from .core.dndarray import DNDarray

    if isinstance(tree, DNDarray):
        yield path, tree.larray
        return
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _iter_array_leaves(tree[key], f"{path}.{key}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _iter_array_leaves(item, f"{path}[{i}]")


class ModelPool:
    """One served model generation plus its swap bookkeeping.

    ``template`` is the restore template (the pytree shape every generation
    must match — its DNDarray leaves pin the serving split/comm/device);
    request handlers read :attr:`state`. ``load`` binds the first generation;
    :func:`swap_state` upgrades it under load.
    """

    def __init__(self, template: Any, *, name: str = "model"):
        self.name = name
        self._template = template
        self._state: Any = None
        self._generation: Optional[str] = None
        self._lock = threading.Lock()
        self._ledger: list = []
        self._swaps = 0
        self._rollbacks = 0
        self._failovers = 0
        self._swap_gen = 0  # monotonic rebind counter: the result-cache generation

    @property
    def state(self) -> Any:
        """The live generation's state tree (relaxed read: always a complete
        generation — rebinding happens atomically inside a quiesce window)."""
        return self._state

    @property
    def generation(self) -> Optional[str]:
        """Checkpoint directory of the live generation (None before load)."""
        return self._generation

    def load(self, directory: str, *, warmup: Optional[str] = None,
             **kwargs) -> "ModelPool":
        """Bind the first generation from a checkpoint (streaming restore +
        verification). Not a swap: nothing is serving yet, so no drain.

        ``warmup`` points at a persistent compile-cache / warmup-manifest
        directory (``ht.executor_save_warmup``): the recorded top signatures
        are replayed into built programs NOW — before this pool serves its
        first request — so a restarted host serves its first request from built
        programs (the cold-start elimination ``[serving_coldstart]`` measures)."""
        staged = _checkpoint.load_checkpoint(self._template, directory, **kwargs)
        if warmup is not None:
            self.warmup(warmup)
        self._rebind(staged, directory)
        return self

    def warmup(self, path: str) -> dict:
        """Replay the warmup manifest at ``path`` (``ht.executor_warmup``)
        and record the outcome in the pool's ledger.  Safe while serving:
        warmup drives ordinary dispatches, so a live pool just sees a little
        extra traffic — which is why :func:`swap_state` runs it during
        STAGING, before the quiesce window ever closes admission."""
        from .core import _executor

        stats = _executor.executor_warmup(path)
        entry = {"t": time.time(), "ok": True, "kind": "warmup",
                 "path": path, **{k: stats[k] for k in
                                  ("replayed", "aot_loaded", "failed", "skipped")}}
        with self._lock:
            self._ledger.append(entry)
        if diagnostics._enabled:
            diagnostics.counter("serving.warmup")
        telemetry.flight_record(
            "lifecycle", "serving.warmup",
            f"pool={self.name} replayed={stats['replayed']} "
            f"aot={stats['aot_loaded']} failed={stats['failed']}",
            kind="warmup",
        )
        return stats

    def _rebind(self, state: Any, generation: Optional[str]) -> None:
        with self._lock:
            self._swap_gen += 1
            gen = self._swap_gen
        # generation-wire the result cache BEFORE the reference swap: each new
        # state leaf registers under its pool tag at the bumped generation, so
        # from this point no entry keyed on an older generation can validate —
        # a racing hit fails closed and recomputes, never serves stale state
        for tag, leaf in _iter_array_leaves(state, "state"):
            _result_cache.register_generation(
                leaf, f"pool:{self.name}:{tag}", gen
            )
        self._state = state
        with self._lock:
            self._generation = generation
        # eager sweep of the stale generation's entries (the lazy per-hit
        # validation above is the correctness barrier; the sweep keeps the
        # byte budget from carrying dead weight and feeds cache_invalidations)
        _result_cache.invalidate_prefix(f"pool:{self.name}")

    def _note_swap(self, entry: dict) -> None:
        with self._lock:
            self._ledger.append(entry)
            if entry["ok"]:
                self._swaps += 1
            else:
                self._rollbacks += 1
            total = self._swaps

        if diagnostics._enabled:
            diagnostics.counter("serving.swap" if entry["ok"] else "serving.swap_rollback")
        if profiler._active:
            profiler.record_counter("lifecycle.swap", total)
        telemetry.flight_record(
            "lifecycle", "serving.swap",
            f"pool={self.name} ok={entry['ok']} stage={entry.get('stage', '-')} "
            f"from={entry['from']} to={entry['to']}",
            kind="swap" if entry["ok"] else "swap-rollback",
        )

    def swap_ledger(self) -> list:
        """Every attempted swap, oldest first: ``{t, ok, from, to, drain_s,
        total_s}`` plus ``stage``/``error`` for rollbacks (peer-failover
        entries carry ``kind: "peer-failover"`` instead of from/to)."""
        with self._lock:
            return [dict(e) for e in self._ledger]

    def set_slo(self, tenant: str, *, p99_ms: Optional[float] = None,
                success_ratio: Optional[float] = None) -> None:
        """Register ``tenant``'s serving objectives with the live operations
        plane (:func:`heat_tpu_torch.core.ops.set_slo`): the ops sampler then
        tracks 1m/5m error-budget burn rates for the tenant's
        ``profiler.request(tag)`` traffic, raises the typed ``slo-burn``
        alert (with its flight post-mortem) when both windows burn above
        1.0, and exports the ``ht_slo_burn_rate`` series. The pool is the
        natural registration point — it knows its tenants — but the SLO
        lives on the process-wide plane, not the pool."""
        ops.set_slo(tenant, p99_ms=p99_ms, success_ratio=success_ratio)

    def slo_status(self) -> dict:
        """The declared objectives with their latest burn rates and alert
        states (:func:`heat_tpu_torch.core.ops.slo_status`)."""
        return ops.slo_status()

    def explain(self, tenant: Optional[str] = None, limit: int = 5) -> dict:
        """Answer "why was this slow" for ``tenant``'s serving traffic (or
        all of it) from the request-forensics artifact
        (:func:`heat_tpu_torch.core.forensics.explain`): dominant-stage
        distribution, cost meters, and the slowest exemplars with their
        critical paths. Needs the plane armed (``HEAT_TPU_FORENSICS=1``) —
        idle it returns an empty artifact, it never raises."""
        return forensics.explain(tenant, limit=limit)

    @staticmethod
    def _forget_failed_peer(exc: BaseException) -> None:
        # which rank died: the typed error names it (PeerFailed.rank), a
        # watchdog/coordination abort may only carry it in the sentinel
        rank = getattr(exc, "rank", None)
        if rank is None:
            payload = supervision.aborted()
            if payload is not None:
                rank = payload.get("rank")
        if rank is not None:
            supervision.forget_peer(int(rank))

    def on_peer_failure(self, exc: BaseException, *,
                        drain_timeout_s: float = 5.0, scheduler=None) -> dict:
        """A peer process failed while this host was serving (a typed
        :class:`~heat_tpu_torch.core.resilience.PeerFailed` /
        ``CollectiveTimeout`` surfaced, or the supervision sentinel is up):
        fail the pool OVER instead of letting it wedge. The dispatch
        scheduler is quiesced — once the abort sentinel is installed, its
        supervision checkpoint sheds every queued item with the typed error
        pre-dispatch, and a timed-out drain sheds the rest typed
        (``DrainTimeout``'s contract) — then the sentinel is cleared and
        admission reopens: the pool keeps serving this host's generation at
        the surviving capacity, and ``admitted + shed + failed == offered``
        holds across the failure with zero untyped errors
        (heat_tpu's ``benchmarks/serving/failover_gate.py`` and ``chip_smoke.py``'s
        ``[serving_failover]`` gate exactly that).

        This is the single-host half of serving elasticity; a multi-host
        deployment pairs it with ``supervision.elastic_restart`` +
        :meth:`load` to rebuild state on the surviving world. Returns the
        ledger entry."""
        t0 = time.monotonic()
        cause = f"{type(exc).__name__}: {exc}"
        sched = scheduler if scheduler is not None else _scheduler()
        shed_at_drain = 0
        try:
            # tolerate_shed: a timed-out drain has already shed everything
            # typed, and the body MUST still run before reopen — clearing
            # the sentinel after admission reopened would shed freshly
            # admitted requests on the stale abort
            with sched.quiesce(drain_timeout_s, tolerate_shed=True):
                # inside the quiesce window (admission closed): the failed
                # peer is marked handled FIRST (or the monitor would just
                # re-detect the same silent rank and re-post), then the
                # sentinel is cleared — no request admitted after reopen can
                # observe the stale abort
                self._forget_failed_peer(exc)
                supervision.reset_abort()
        except resilience.DrainTimeout as drain_exc:
            shed_at_drain = len(drain_exc.undelivered)
        entry = {
            "t": time.time(), "ok": True, "kind": "peer-failover",
            "cause": cause, "shed_at_drain": shed_at_drain,
            "generation": self._generation,
            "total_s": round(time.monotonic() - t0, 6),
        }
        with self._lock:
            self._ledger.append(entry)
            self._failovers += 1
            total = self._failovers
        diagnostics.record_resilience_event(
            "serving.pool", "peer-failover",
            f"pool={self.name} cause={cause} shed_at_drain={shed_at_drain}",
        )
        if diagnostics._enabled:
            diagnostics.counter("serving.peer_failover")
        if profiler._active:
            profiler.record_counter("lifecycle.peer_failover", total)
        telemetry.flight_record(
            "lifecycle", "serving.pool",
            f"pool={self.name} failover after {cause}", kind="peer-failover",
        )
        return dict(entry)


def swap_state(
    pool: ModelPool,
    new_dir: str,
    *,
    drain_timeout_s: float = 30.0,
    scheduler=None,
    warmup: Optional[str] = None,
    **load_kwargs,
) -> dict:
    """Hot-swap ``pool``'s model state to the generation at ``new_dir`` with
    zero dropped requests.

    1. **Stage** — load + verify the new generation off to the side (the v2
       streaming restore; resharding onto the template's layout is allowed).
       A corrupt or unreadable generation fails HERE, before serving is
       touched at all.
    2. **Quiesce** — ``drain(drain_timeout_s)`` the dispatch scheduler:
       in-flight work retires, queued work flushes (or, past the timeout, is
       shed with typed errors — counted, never dropped); admission-refused
       submits run inline on their caller's thread meanwhile.
    3. **Rebind** — one atomic reference swap of the pool's state.
    4. **Reopen** — admission resumes (guaranteed by ``quiesce`` even on
       failure).

    Any error rolls the pool back to the old generation and raises
    :class:`~heat_tpu_torch.core.resilience.SwapFailed` naming the failed stage;
    the rollback is recorded as a ``swap-failed`` resilience event (which
    auto-dumps a flight-recorder post-mortem). Returns the ledger entry of a
    successful swap."""
    t0 = time.monotonic()
    old_state, old_gen = pool._state, pool._generation

    def _fail(stage: str, exc: BaseException) -> "SwapFailed":
        detail = f"{type(exc).__name__}: {exc}"
        diagnostics.record_resilience_event(
            "serving.swap", "swap-failed",
            f"pool={pool.name} stage={stage} to={new_dir}: {detail}",
        )
        pool._note_swap({
            "t": time.time(), "ok": False, "stage": stage, "from": old_gen,
            "to": new_dir, "error": detail,
            "total_s": round(time.monotonic() - t0, 6),
        })
        return SwapFailed(stage, pool.name, detail)

    try:
        staged = _checkpoint.load_checkpoint(pool._template, new_dir, **load_kwargs)
        if warmup is not None:
            # warmup rides the STAGING phase: the hot-swapped host builds its
            # serving signatures while the OLD generation keeps serving, so by
            # the time quiesce closes admission and reopen() follows, the first
            # post-swap request is a replay hit — never a cold build inside the
            # drain window
            pool.warmup(warmup)
    except Exception as exc:
        raise _fail("stage", exc) from exc

    sched = scheduler if scheduler is not None else _scheduler()
    t_drain = time.monotonic()
    try:
        with sched.quiesce(drain_timeout_s):
            drain_s = time.monotonic() - t_drain
            pool._rebind(staged, new_dir)
    except resilience.DrainTimeout as exc:
        # quiesce reopened admission; the rebind never ran (drain raised
        # first), but rebind defensively in case a future refactor moves it
        pool._rebind(old_state, old_gen)
        raise _fail("drain", exc) from exc
    except Exception as exc:
        pool._rebind(old_state, old_gen)
        raise _fail("rebind", exc) from exc

    entry = {
        "t": time.time(), "ok": True, "from": old_gen, "to": new_dir,
        "drain_s": round(drain_s, 6),
        "total_s": round(time.monotonic() - t0, 6),
    }
    pool._note_swap(entry)
    return dict(entry)
