"""Rule registry: ids, one-paragraph explanations (``--explain``), runners.

The ids are heat_tpu's, with the port's idiom in each explanation; the port
adds ``lock-policy-stale`` and ``import-jax`` and leaves out
``layout-pad-mask-dropped`` (:data:`NOT_PORTED` says why)."""

from __future__ import annotations

from . import (
    rules_coord,
    rules_donation,
    rules_fallbacks,
    rules_imports,
    rules_layout,
    rules_locks,
    rules_purity,
    rules_spmd,
)

RULES = {
    "spmd-divergent-collective": (
        "A conditional, loop bound, or early return/raise controlled by a "
        "rank-tainted value (dist.get_rank() / comm.rank / "
        "os.environ['RANK'] / _is_writer() and everything assigned from them) "
        "makes the emitted collective sequence differ across ranks — one rank "
        "enters a collective its peers never reach and every process blocks "
        "inside NCCL or gloo until the group's timeout. Classic MPI deadlock "
        "detection; the runtime twin is `telemetry merge --check`'s cross-rank "
        "sequence gate. Restructure rank-symmetrically: guard only the "
        "host-local work and let every rank reach the collective. (A tuple "
        "assignment taints element by element: `size, rank = self.size, "
        "self.rank` taints rank alone.)"
    ),
    "spmd-collective-in-except": (
        "A collective (or a call that transitively emits one) inside an "
        "except handler: exceptions are per-process, so ranks whose peers "
        "did not raise never enter the handler's collective and the job "
        "hangs. Move the collective out of the handler, or make the "
        "failure rank-symmetric first (e.g. agree on the error state)."
    ),
    "layout-shard-claim-mismatch": (
        "A value laid out along S1 by one of the port's relayouts "
        "(x._relayout(S1), comm.redistribute(..., S1, ...)) is wrapped in a "
        "DNDarray / wrap_result claiming split=S2 (both statically known, "
        "different): the metadata lies about the physical layout, so every "
        "downstream chunk/lshape/collective decision keyed off split is "
        "wrong. Make the claimed split the one the value was laid out along."
    ),
    "layout-resplit-roundtrip": (
        "The same value relaid out to two different splits inside one "
        "function (_relayout / redistribute / rebalance / wrap_global): each "
        "hop exchanges the whole array between the ranks. Lay out once, at "
        "the final split."
    ),
    "layout-contract": (
        "A returned DNDarray / wrap_result / wrap_global / rebalance "
        "construction claims a split that is not among the allowed forms "
        "declared for the function in analysis/layout_contracts.py (the "
        "machine-readable registry transcribed from the dispatch "
        "docstrings). Change the code's contract and the registry together, "
        "or the checker blocks — that is the point."
    ),
    "layout-contract-stale": (
        "A layout_contracts.py entry names a function that no longer "
        "exists: the contract outlived the code. Move the entry with the "
        "refactor or delete it — a dangling contract checks nothing and "
        "gives false confidence."
    ),
    "trace-env-read": (
        "No os.environ/os.getenv reads inside capture bodies (a "
        "torch.cuda.graph body, the executor's capture_begin..capture_end "
        "region, a program body its lookup builds, a function handed to "
        "torch.compile / torch.jit / torch.fx / torch.export / "
        "make_graphed_callables). A capture runs the Python once; an env value "
        "read there is frozen into every replay and the knob is silently "
        "ignored afterwards. Hoist the read to the host-side dispatch path "
        "(see _executor's memoised knob accessors)."
    ),
    "trace-time-call": (
        "No time.* / random.* / np.random.* calls inside capture bodies: "
        "capture-time wall-clock or host randomness bakes one value into the "
        "replayed program. Use torch generators on the device for randomness; "
        "host timing belongs around the dispatch, not in it."
    ),
    "trace-telemetry-unguarded": (
        "diagnostics/profiler record calls inside capture bodies must be "
        "gated on the subsystem switch (if diagnostics._enabled: ...). "
        "Ungated, they run per capture (surprising counts) and break the "
        "zero-cost-when-disabled contract every telemetry module documents."
    ),
    "trace-global-write": (
        "No mutable-global writes inside capture bodies: the write happens at "
        "capture time only, so replays never repeat it — state silently "
        "diverges between the first call and every later one."
    ),
    "trace-lazy-import": (
        "No import statements inside capture bodies: a lazy package import "
        "at capture time runs module init inside the capture and makes the "
        "first call behave differently from a warm process."
    ),
    "lock-unlocked-write": (
        "State classified locked-exact by its module's thread-safety policy "
        "(the diagnostics.py docstring pattern, transcribed into "
        "rules_locks.LOCK_POLICY) must only be written under `with <lock>`. "
        "Functions named *_locked are called with the lock held (documented "
        "convention); __init__ construction is exempt. Relaxed state is "
        "listed per module and exempt by name."
    ),
    "lock-racing-increment": (
        "`+=` on shared module-level state outside any lock is a racing "
        "read-modify-write — the undercount the executor's _stats per-thread "
        "cells (the sanctioned exemption) exist to prevent, and the one that "
        "made the kernels' launch counters inexact under the serving threads. "
        "Route increments through a per-thread cell or take the owning lock."
    ),
    "lock-order-cycle": (
        "The cross-module lock-acquisition graph (edge A->B when code "
        "holding A acquires B) must stay acyclic, or two threads can "
        "deadlock. The committed graph lives at "
        "doc/source/_static/lock_graph_torch.json (regenerate with "
        "python -m heat_tpu_torch.analysis --dump-lockgraph); scheduler work "
        "must keep it a DAG."
    ),
    "lock-policy-stale": (
        "rules_locks.LOCK_POLICY / CLASS_POLICY names a lock, a protected or "
        "relaxed global, a class or an attribute that the port's module does "
        "not have: the policy outlived (or never matched) the code and checks "
        "nothing. Move the entry with the code or delete it."
    ),
    "import-nonstdlib": (
        "diagnostics/profiler/resilience/_scheduler/telemetry/supervision/"
        "ops/forensics (and heat_tpu_torch.analysis itself) import only the "
        "stdlib at module level — no torch, no numpy — so tooling can load "
        "them by file path without the heavy stack. Heavy imports belong "
        "inside functions. tests/test_torch_analysis.py proves the same "
        "contract dynamically."
    ),
    "import-jax": (
        "The port imports nothing of jax, jaxlib or heat_tpu, at load or "
        "lazily: it is a package of its own, and the reference is held "
        "against it only by the tests. Keep a copy of what it needs."
    ),
    "silent-except": (
        "except Exception without re-raise or a diagnostics.record_fallback/"
        "record_resilience_event/fallback_after_failure/record_failure call "
        "swallows failures invisibly. Narrow the handler to the expected "
        "types, account the fallback, or pragma with a reason."
    ),
    "donation-uncontracted": (
        "A donation claim (_acquire_buffers), a write into a donated leaf "
        "(_donate_into) or a donate_leaves= request outside _executor.py "
        "bypasses the executor's buffer-ownership registry and the sanitation "
        "refcount contract (sanitize_leaf_donation) that prove no live reader "
        "holds the storage being overwritten."
    ),
    "collective-uncontracted": (
        "Direct torch.distributed collectives (all_reduce, all_gather, "
        "send/recv, barrier, ...) outside communication.py are invisible to "
        "ht.diagnostics (the per-collective telemetry contract) and to the "
        "supervision and resilience planes (_guarded). Call the "
        "TorchCommunication method instead."
    ),
    "coord-unbounded-wait": (
        "A raw store wait (Store.get / Store.wait / Store.compare_set on the "
        "job's TCPStore or FileStore) outside the supervision wrapper, or one "
        "without a bounded timeout inside it: an unbounded coordination block "
        "is exactly the hang the supervision plane eliminates. Route the wait "
        "through supervision.kv_wait/kv_barrier — bounded by "
        "HEAT_TPU_COORD_TIMEOUT_MS, sentinel-abortable mid-wait, and typed "
        "(resilience.CoordinationTimeout names the key and the ranks that "
        "never arrived; a detected peer death raises PeerFailed instead of "
        "waiting out the budget)."
    ),
    "pragma-no-reason": (
        "Every suppression pragma must carry `-- reason`: suppressions "
        "without recorded justification are how grandfathered bugs hide."
    ),
    "pragma-unknown-rule": (
        "The pragma names a rule id the checker does not know — it would "
        "never match anything and gives false confidence."
    ),
    "pragma-unused": (
        "The pragma suppresses nothing on its line. Dead pragmas silently "
        "grandfather FUTURE violations; remove them as soon as the finding "
        "they covered is fixed."
    ),
    "baseline-stale": (
        "A baseline entry matched no current finding: the offending code was "
        "fixed. Delete the entry (python -m heat_tpu_torch.analysis "
        "--write-baseline) so the grandfathered set only ever shrinks."
    ),
}

#: heat_tpu's rules that have no counterpart in the port, with the reason
NOT_PORTED = {
    "layout-pad-mask-dropped": (
        "Not a rule of the port. heat_tpu lays a ragged array out padded to "
        "equal shards and must keep the pad slots zero; the port keeps each "
        "rank's exact chunk (heat_tpu's ceil-division rule, trailing chunks "
        "short or empty) and has no padded layout, no .parray and no "
        "_zero_pads, so there is nothing to re-mask."
    ),
}

RULE_RUNNERS = [
    rules_purity.run,
    rules_locks.run_discipline,
    rules_locks.run_lock_order,
    rules_locks.run_policy_check,
    rules_imports.run,
    rules_fallbacks.run,
    rules_donation.run,
    rules_spmd.run,
    rules_layout.run,
    rules_coord.run,
]


def explain(rule: str) -> str:
    doc = RULES.get(rule, NOT_PORTED.get(rule))
    if doc is None:
        known = ", ".join(sorted(RULES))
        return f"unknown rule {rule!r}; known rules: {known}"
    return f"{rule}\n{'=' * len(rule)}\n{doc}"
