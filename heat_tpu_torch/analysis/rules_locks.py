"""Lock-discipline rules — the thread-safety policy, statically.

The port's ``diagnostics.py`` module docstring (and its siblings in
``profiler`` / ``resilience`` / ``_scheduler`` / ``_executor`` / the serving
planes) commit to heat_tpu's *locked-exact vs relaxed-documented* split:
registries mutate only under the module lock so counts are exact under the
request threads; a short, named list of switches is deliberately relaxed (bare
attribute reads on hot paths). :data:`LOCK_POLICY` transcribes that split per
module of the port — each entry cites the docstring it encodes — and these
rules enforce it:

- ``lock-unlocked-write`` — a write (assignment, ``del``, subscript store, or
  mutating method call: ``append``/``clear``/``update``/…) to locked state
  outside a ``with <lock>`` scope. Functions whose name ends in ``_locked``
  are, by the codebase's documented convention, called with the lock already
  held and count as in-scope; ``__init__`` construction is exempt.
- ``lock-racing-increment`` — an augmented assignment (``+=`` et al.) on
  module-level shared state outside any known lock: the read-modify-write
  races and undercounts. The executor's ``_stats`` per-thread accumulator
  cells are the sanctioned lock-free form and are exempt by name.
- ``lock-order-cycle`` — the cross-module lock-acquisition graph (an edge
  A→B when code holding A acquires B, found by a bounded call-graph walk)
  must stay acyclic; ``--dump-lockgraph`` exports the discovered graph, and
  the committed copy under ``doc/source/_static/lock_graph_torch.json`` is the
  ordering contract future scheduler work must respect.
- ``lock-policy-stale`` — a name of the policy (a lock, a protected or relaxed
  global, a class or one of its attributes) that the port's module lacks: a
  policy entry that matches nothing checks nothing, so it is an error of the
  policy, never a silent no-op.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .engine import Finding, ModuleIndex, Universe, dotted_chain

MUTATOR_METHODS = {
    "append", "appendleft", "extend", "clear", "update", "pop", "popitem",
    "add", "remove", "discard", "insert", "setdefault", "move_to_end",
}

_EXEC = "heat_tpu_torch.core._executor"
_SCHED = "heat_tpu_torch.core._scheduler"


class ModulePolicy:
    """Module-level state classification: ``locks`` maps each lock name to the
    set of module-level names it protects; ``relaxed`` names the documented
    lock-free exceptions; ``acquire_fns`` are helper functions that acquire
    the module lock (``_executor._lock_acquire``); ``lock_aliases`` maps
    wrapper objects to the lock they take (``_tlock`` → ``_lock``)."""

    def __init__(self, locks: Dict[str, Set[str]], relaxed: Set[str],
                 acquire_fns: Dict[str, str] = None,
                 lock_aliases: Dict[str, str] = None):
        self.locks = locks
        self.relaxed = relaxed
        self.acquire_fns = acquire_fns or {}
        self.lock_aliases = lock_aliases or {}
        self.owner: Dict[str, str] = {}
        for lock, names in locks.items():
            for n in names:
                self.owner[n] = lock


class ClassPolicy:
    """Instance-attribute classification for a lock-owning class."""

    def __init__(self, module: str, cls: str, lock_attr: str, locked: Set[str]):
        self.module = module
        self.cls = cls
        self.lock_attr = lock_attr
        self.locked = locked


# Transcribed from the thread-safety policy docstrings of the port's modules
# (each keeps heat_tpu's policy for its counterpart); when a module's policy
# changes, change it HERE TOO or the checker blocks the change — that is the point.
LOCK_POLICY: Dict[str, ModulePolicy] = {
    # diagnostics.py "Thread-safety" section: every registry exact under
    # _lock; _enabled/_tracing deliberately relaxed bare attributes.
    "heat_tpu_torch.core.diagnostics": ModulePolicy(
        locks={"_lock": {
            "_counters", "_spans", "_collectives", "_pad_gauges",
            "_compile_events", "_dispatch_events", "_fallback_events",
            "_resilience_events", "_backend_events", "_providers",
            "_backend_state",
        }},
        relaxed={"_enabled", "_tracing", "_dump_path"},
    ),
    # profiler.py "Thread-safety" section: all registries under the module
    # lock; _active is the relaxed hot-path switch, _deadline_seen the
    # set-once lifecycle gate.
    "heat_tpu_torch.core.profiler": ModulePolicy(
        locks={"_lock": {
            "_slices", "_counter_events", "_requests", "_hists", "_mem",
            "_counters",
        }},
        relaxed={"_active", "_trace_path", "_deadline_seen"},
    ),
    # telemetry.py "Thread-safety" section: window log, per-site seq +
    # duration histograms, flight ring/ledger, process/clock identity all
    # under the (strictly leaf) module _lock; _collecting is the relaxed
    # hot-path switch and _in_flight_dump the thread-local reentrancy guard.
    "heat_tpu_torch.core.telemetry": ModulePolicy(
        locks={"_lock": {
            "_windows", "_site_seq", "_durations", "_flight", "_flight_dumps",
            "_process", "_clock", "_last_auto_ns", "_auto_dumps",
        }},
        relaxed={"_collecting", "_in_flight_dump", "_flight_seq"},
    ),
    # resilience.py zero-cost contract: _armed/_active are the relaxed gate
    # attributes; plan/breaker/policy registries mutate under _lock.
    "heat_tpu_torch.core.resilience": ModulePolicy(
        locks={"_lock": {
            "_site_policies", "_breakers", "_plan", "_site_calls", "_fired",
            "_armed", "_active", "_fault_rank",
        }},
        relaxed={"_tmp_seq", "_jitter_rng", "_peer_dead_hook",
                 "_peer_dead_exit"},
    ),
    # supervision.py "Thread-safety" section: the watchdog window table, the
    # abort payload, monitor/thread handles, identity, graveyard, restart
    # count and the job's store (heat_tpu's coordination client) all under
    # the (leaf) module _lock; _armed/_aborted are the relaxed hot-path
    # switches; _knobs is the memoised env-knob cell like the executor's;
    # _watch_seq an atomic counter.
    "heat_tpu_torch.core.supervision": ModulePolicy(
        locks={"_lock": {
            "_abort", "_monitor", "_thread", "_thread_stop", "_generation",
            "_watch_windows", "_watch_fired", "_graveyard", "_rank",
            "_nprocs", "_restarts", "_owns_client", "_atexit_registered",
            "_store",
        }},
        relaxed={"_armed", "_aborted", "_knobs", "_watch_seq"},
    ),
    # _executor.py: the signature table and its satellites under _lock
    # (_tlock wraps it, _lock_acquire is the timed acquire); the donation
    # registry under _own_lock; the deferred-op aval cache under _aval_lock;
    # the storage readers' registry under _readers_lock. _knobs is the
    # memoised env-knob cell (relaxed).
    _EXEC: ModulePolicy(
        locks={
            "_lock": {"_programs", "_seen", "_quarantined",
                      "_dispatch_scheduler"},
            "_own_lock": {"_inflight_reads", "_donation_claims",
                          "_donation_epoch"},
            "_aval_lock": {"_aval_cache"},
            "_readers_lock": {"_readers", "_readers_adds"},
        },
        relaxed={"_knobs"},
        acquire_fns={"_lock_acquire": "_lock"},
        lock_aliases={"_tlock": "_lock"},
    ),
    # ops.py "Thread-safety" section: the sample ring, baseline snapshot,
    # SLO/alert tables and daemon handles mutate under the (strictly leaf)
    # module _lock; _armed is the relaxed observer gate read bare by the
    # supervision beat tee, and _knobs the memoised env-knob cell.
    "heat_tpu_torch.core.ops": ModulePolicy(
        locks={"_lock": {
            "_ring", "_prev_cum", "_samples_total", "_delta_resets",
            "_slos", "_alerts", "_thread", "_thread_stop", "_server",
            "_server_thread",
        }},
        relaxed={"_armed", "_knobs"},
    ),
    # forensics.py "Thread-safety" section: the live-record table, finished
    # ring, per-tenant exemplar reservoirs and cost meters all mutate under
    # the (strictly leaf) module _lock; _enabled is the relaxed producer gate
    # read bare on every hot path, _knobs the memoised env-knob cell.
    "heat_tpu_torch.core.forensics": ModulePolicy(
        locks={"_lock": {
            "_live", "_ring", "_reservoirs", "_meters", "_finished",
            "_dropped",
        }},
        relaxed={"_enabled", "_knobs"},
    ),
    # _compile_cache.py: the memoised cache-dir knob and the lazy in-memory
    # index mutate under the (strictly leaf) module _lock; reload() is the
    # documented re-read point. (heat_tpu's _jax_cache_applied marker has no
    # counterpart: the port has no compiled artifact to apply.)
    "heat_tpu_torch.core._compile_cache": ModulePolicy(
        locks={"_lock": {"_dir", "_index", "_index_rejected"}},
        relaxed=set(),
    ),
    # _result_cache.py: the generation registry / tag table and the
    # shard-tuple rebuild mutate under the module _lock; per-shard entry state
    # lives behind each _ShardCache._mu (class policy below); the host-hash
    # byte tally under its own leaf _hash_lock. _enabled / _budget_bytes are
    # the memoised knob cells — relaxed single-word reads on the dispatch hot
    # path, rewritten only at reload().
    "heat_tpu_torch.core._result_cache": ModulePolicy(
        locks={"_lock": {"_registry", "_tag_gen", "_shards"},
               "_hash_lock": {"_host_hash_bytes"}},
        relaxed={"_enabled", "_budget_bytes"},
    ),
}

CLASS_POLICY: List[ClassPolicy] = [
    # _scheduler.DispatchScheduler: only the admission / pause coordination
    # state lives on the scheduler, under its _gate; every queue and
    # telemetry cell lives in the per-shard class below.
    ClassPolicy(_SCHED, "DispatchScheduler", "_gate", {
        "_paused", "_draining", "_drains",
    }),
    # _scheduler._Shard: one shard's queues, batch index, depth/active,
    # telemetry cells and lifecycle-ledger slice mutate under the shard's
    # _cv ("Thread-safety policy" section of the module docstring); the
    # folds at DispatchScheduler.stats() copy each cell under its own lock.
    ClassPolicy(_SCHED, "_Shard", "_cv", {
        "_queues", "_by_key", "_depth", "_active", "_thread",
        "queue_depth_peak", "batched_requests", "batch_width_hist",
        "submitted", "inline_runs", "queue_full_events", "drain_rejects",
        "stolen_batch_items", "window_holds", "window_widened",
        "window_hold_ns", "lifecycle", "tenant_lifecycle",
        "_gap_ewma_s", "_last_submit",
        # pressure EWMAs: exact under _cv like every shard cell; surfaced
        # through executor_stats()["pressure"]
        "_depth_ewma", "_shed_ewma",
    }),
    # _executor._Stats: the cell list / retired / baseline fold under
    # _cells_lock (per-thread cells themselves are lock-free by design).
    ClassPolicy(_EXEC, "_Stats", "_cells_lock", {"_cells", "_retired", "_base"}),
    # _result_cache._ShardCache: one shard's LRU map, byte occupancy and
    # telemetry tallies mutate under the shard's own _mu (a strict leaf —
    # never held with another shard's _mu or the module _lock).
    ClassPolicy("heat_tpu_torch.core._result_cache", "_ShardCache", "_mu", {
        "_entries", "_bytes",
        "hits", "misses", "stores", "bytes_saved", "invalidations",
        "evictions", "replications", "rejects",
    }),
]

# The sanctioned lock-free accumulators: attribute writes routed through the
# per-thread cell machinery (see _executor._Stats) are exact without a lock.
RELAXED_BASES = {"_stats"}


# ---------------------------------------------------------------------------
# scope helpers


def _with_locks(mod: ModuleIndex, node: ast.AST,
                policy: Optional[ModulePolicy]) -> Set[str]:
    """The set of lock names (module-level and ``self.<attr>`` spelled as
    ``self.X``) held at ``node`` by lexically-enclosing ``with`` blocks and
    the ``_locked``-suffix convention."""
    held: Set[str] = set()
    known = set(policy.locks) if policy else set()
    aliases = policy.lock_aliases if policy else {}
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Name):
                    name = aliases.get(expr.id, expr.id)
                    held.add(name)
                elif isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
                    if expr.value.id == "self":
                        held.add(f"self.{expr.attr}")
                    else:
                        held.add(f"{expr.value.id}.{expr.attr}")
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if anc.name.endswith("_locked"):
                held.update(known)
                held.add("self.<any>")
            if anc.name == "__init__":
                held.add("<init>")
            break
    del known
    return held


def _write_targets(node: ast.AST) -> List[ast.expr]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        return [node.target]
    if isinstance(node, ast.Delete):
        return list(node.targets)
    return []


def _base_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, (ast.Subscript, ast.Attribute)):
        expr = expr.value
    if isinstance(expr, ast.Name):
        return expr.id
    return None


# ---------------------------------------------------------------------------
# rule: unlocked writes + racing increments


POLICY_PATH = "heat_tpu_torch/analysis/rules_locks.py"


def _stale(key: str, what: str) -> Finding:
    return Finding(
        "lock-policy-stale", POLICY_PATH, 0,
        f"lock policy names {what} {key!r}, which the port does not have — "
        "move the entry with the code or delete it",
        key,
    )


def run_policy_check(uni: Universe) -> List[Finding]:
    """Every name of :data:`LOCK_POLICY` and :data:`CLASS_POLICY` against the
    scanned modules: a policy whose module is scanned must name only what the
    module defines."""
    out: List[Finding] = []
    for name, policy in sorted(LOCK_POLICY.items()):
        mod = uni.modules.get(name)
        if mod is None:
            continue  # outside this universe (fixture trees, --root over a subtree)
        have = mod.toplevel_names | set(mod.functions)
        names = set(policy.locks) | set(policy.owner) | policy.relaxed | \
            set(policy.acquire_fns) | set(policy.lock_aliases)
        out.extend(_stale(f"{name}:{n}", "the global") for n in sorted(names - have))
    for cpol in CLASS_POLICY:
        mod = uni.modules.get(cpol.module)
        if mod is None:
            continue
        classes = [
            n for n in ast.walk(mod.tree)
            if isinstance(n, ast.ClassDef) and n.name == cpol.cls
        ]
        if not classes:
            out.append(_stale(f"{cpol.module}:{cpol.cls}", "the class"))
            continue
        attrs = {
            n.attr for cls in classes for n in ast.walk(cls)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "self"
        }
        for attr in sorted(({cpol.lock_attr} | cpol.locked) - attrs):
            out.append(_stale(f"{cpol.module}:{cpol.cls}.{attr}", "the attribute"))
    return out


def run_discipline(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for name, policy in LOCK_POLICY.items():
        mod = uni.modules.get(name)
        if mod is not None:
            out.extend(_check_module_policy(mod, policy))
    for cpol in CLASS_POLICY:
        mod = uni.modules.get(cpol.module)
        if mod is not None:
            out.extend(_check_class_policy(mod, cpol))
    out.extend(_check_racing_increments(uni))
    return out


def _module_writes(mod: ModuleIndex):
    """Yield ``(node, written_name, is_mutation_call)`` for every write-shaped
    statement inside a function body."""
    for node in ast.walk(mod.tree):
        fn = mod.enclosing_function(node)
        if fn is None:
            continue  # module-level init runs single-threaded at import
        for tgt in _write_targets(node):
            name = None
            if isinstance(tgt, ast.Name):
                name = tgt.id
            else:
                name = _base_name(tgt)
            if name:
                yield node, name, False
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_METHODS:
            base = _base_name(node.func)
            if base:
                yield node, base, True


def _check_module_policy(mod: ModuleIndex, policy: ModulePolicy) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[Tuple[int, str]] = set()
    for node, name, _ in _module_writes(mod):
        lock = policy.owner.get(name)
        if lock is None:
            continue
        key = (getattr(node, "lineno", 0), name)
        if key in seen:
            continue
        seen.add(key)
        held = _with_locks(mod, node, policy)
        if lock in held or "<init>" in held:
            continue
        out.append(mod.finding(
            "lock-unlocked-write", node,
            f"write to {name!r} (locked-exact under {lock!r} per the module "
            f"thread-safety policy) outside a `with {lock}` scope",
        ))
    return out


def _check_class_policy(mod: ModuleIndex, cpol: ClassPolicy) -> List[Finding]:
    out: List[Finding] = []
    cls_defs = [
        n for n in ast.walk(mod.tree)
        if isinstance(n, ast.ClassDef) and n.name == cpol.cls
    ]
    for cls in cls_defs:
        for node in ast.walk(cls):
            fn = mod.enclosing_function(node)
            if fn is None or fn.name == "__init__":
                continue
            writes: List[str] = []
            for tgt in _write_targets(node):
                if isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self" and tgt.attr in cpol.locked:
                    writes.append(tgt.attr)
                elif isinstance(tgt, (ast.Subscript, ast.Attribute)):
                    inner = tgt.value if isinstance(tgt, ast.Subscript) else None
                    if isinstance(inner, ast.Attribute) and \
                            isinstance(inner.value, ast.Name) and \
                            inner.value.id == "self" and inner.attr in cpol.locked:
                        writes.append(inner.attr)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATOR_METHODS:
                inner = node.func.value
                if isinstance(inner, ast.Attribute) and \
                        isinstance(inner.value, ast.Name) and \
                        inner.value.id == "self" and inner.attr in cpol.locked:
                    writes.append(inner.attr)
            if not writes:
                continue
            held = _with_locks(mod, node, None)
            if f"self.{cpol.lock_attr}" in held or "self.<any>" in held \
                    or "<init>" in held:
                continue
            for attr in writes:
                out.append(mod.finding(
                    "lock-unlocked-write", node,
                    f"write to self.{attr} ({cpol.cls} state locked under "
                    f"self.{cpol.lock_attr}) outside a `with "
                    f"self.{cpol.lock_attr}` scope",
                ))
    return out


def _check_racing_increments(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for mod in uni.modules.values():
        policy = LOCK_POLICY.get(mod.name)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.AugAssign):
                continue
            if mod.enclosing_function(node) is None:
                continue
            base = _base_name(node.target)
            if base is None or base in RELAXED_BASES:
                continue
            is_global_name = isinstance(node.target, ast.Name) and \
                base in mod.toplevel_names
            is_global_container = not isinstance(node.target, ast.Name) and \
                base in mod.toplevel_names and base not in mod.functions
            if not (is_global_name or is_global_container):
                continue
            if policy and base in policy.relaxed:
                continue
            # ANY held lock satisfies this rule (the discipline rule above
            # checks it is the RIGHT lock for policy-covered state)
            if _with_locks(mod, node, policy):
                continue
            out.append(mod.finding(
                "lock-racing-increment", node,
                f"augmented assignment on shared module state {base!r} outside "
                "any lock: the read-modify-write races (route through a "
                "per-thread cell or take the owning lock)",
            ))
    return out


# ---------------------------------------------------------------------------
# rule: lock-order graph + cycles


def _lock_id(mod: ModuleIndex, name: str) -> str:
    return f"{mod.name}:{name}"


def _acquisitions_in(uni: Universe, mod: ModuleIndex, fn: ast.AST,
                     depth: int = 0, seen=None) -> Set[str]:
    """Locks a call to ``fn`` may acquire (bounded transitive walk)."""
    if seen is None:
        seen = set()
    key = (mod.name, id(fn))
    if key in seen or depth > 3:
        return set()
    seen.add(key)
    policy = LOCK_POLICY.get(mod.name)
    acquired: Set[str] = set()
    for node in ast.walk(fn):
        acquired.update(_direct_acquires(mod, policy, node))
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain and policy and chain[-1] in policy.acquire_fns:
                acquired.add(_lock_id(mod, policy.acquire_fns[chain[-1]]))
            for tmod, tfn in uni.resolve_call(mod, node):
                acquired.update(
                    _acquisitions_in(uni, tmod, tfn, depth + 1, seen)
                )
    return acquired


def _direct_acquires(mod: ModuleIndex, policy: Optional[ModulePolicy],
                     node: ast.AST) -> Set[str]:
    acquired: Set[str] = set()
    exprs: List[ast.expr] = []
    if isinstance(node, ast.With):
        exprs = [item.context_expr for item in node.items]
    elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in {"acquire", "wait", "wait_for"}:
        exprs = [node.func.value]
    for expr in exprs:
        if isinstance(expr, ast.Name):
            name = expr.id
            if policy:
                name = policy.lock_aliases.get(name, name)
                if name in policy.locks:
                    acquired.add(_lock_id(mod, name))
            elif name.endswith("lock"):
                acquired.add(_lock_id(mod, name))
        elif isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and expr.value.id == "self":
            for cpol in CLASS_POLICY:
                if cpol.module == mod.name and expr.attr == cpol.lock_attr:
                    acquired.add(f"{mod.name}:{cpol.cls}.{cpol.lock_attr}")
    return acquired


def build_lock_graph(uni: Universe) -> Dict[Tuple[str, str], List[str]]:
    """Edges ``(holder, acquired) -> [site, ...]`` of the lock-acquisition
    order graph."""
    edges: Dict[Tuple[str, str], List[str]] = {}
    for mod in uni.modules.values():
        policy = LOCK_POLICY.get(mod.name)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            held = _direct_acquires(mod, policy, node)
            if not held:
                continue
            inner: Set[str] = set()
            for sub in ast.walk(node):
                if sub is node:
                    continue
                inner.update(_direct_acquires(mod, policy, sub))
                if isinstance(sub, ast.Call):
                    chain = dotted_chain(sub.func)
                    if chain and policy and chain[-1] in policy.acquire_fns:
                        inner.add(_lock_id(mod, policy.acquire_fns[chain[-1]]))
                    for tmod, tfn in uni.resolve_call(mod, sub):
                        inner.update(_acquisitions_in(uni, tmod, tfn, 1))
            for a in held:
                for b in inner:
                    if a == b:
                        continue
                    site = f"{mod.rel_path}:{node.lineno}"
                    edges.setdefault((a, b), [])
                    if site not in edges[(a, b)]:
                        edges[(a, b)].append(site)
    return edges


def _find_cycles(edges: Dict[Tuple[str, str], List[str]]) -> List[List[str]]:
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    cycles: List[List[str]] = []
    state: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(v: str) -> None:
        state[v] = 1
        stack.append(v)
        for w in sorted(graph[v]):
            if state.get(w, 0) == 0:
                dfs(w)
            elif state.get(w) == 1:
                cycles.append(stack[stack.index(w):] + [w])
        stack.pop()
        state[v] = 2

    for v in sorted(graph):
        if state.get(v, 0) == 0:
            dfs(v)
    return cycles


def run_lock_order(uni: Universe) -> List[Finding]:
    edges = build_lock_graph(uni)
    out: List[Finding] = []
    for cycle in _find_cycles(edges):
        path = " -> ".join(cycle)
        first_edge = (cycle[0], cycle[1]) if len(cycle) > 1 else None
        sites = edges.get(first_edge, ["<unknown>"]) if first_edge else ["<unknown>"]
        out.append(Finding(
            "lock-order-cycle",
            sites[0].rsplit(":", 1)[0] if ":" in sites[0] else "<graph>",
            int(sites[0].rsplit(":", 1)[1]) if ":" in sites[0] else 0,
            f"lock-acquisition-order cycle: {path} — a thread holding "
            f"{cycle[0]} can deadlock against one holding {cycle[-2] if len(cycle) > 1 else cycle[0]}",
            "",
        ))
    return out


def lock_graph_payload(uni: Universe) -> dict:
    """The ``--dump-lockgraph`` JSON payload (DOT is derived from it)."""
    edges = build_lock_graph(uni)
    nodes = sorted({n for e in edges for n in e})
    return {
        "schema": "heat-tpu-lockgraph/1",
        "nodes": nodes,
        "edges": [
            {"from": a, "to": b, "sites": sorted(sites)}
            for (a, b), sites in sorted(edges.items())
        ],
        "cycles": [list(c) for c in _find_cycles(edges)],
    }


def lock_graph_dot(payload: dict) -> str:
    lines = ["digraph heat_tpu_torch_locks {", "  rankdir=LR;"]
    for n in payload["nodes"]:
        lines.append(f'  "{n}";')
    for e in payload["edges"]:
        label = e["sites"][0] if e["sites"] else ""
        lines.append(f'  "{e["from"]}" -> "{e["to"]}" [label="{label}"];')
    lines.append("}")
    return "\n".join(lines) + "\n"
