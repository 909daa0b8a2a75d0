"""Interprocedural dataflow for the SPMD and layout rule families.

:class:`~.engine.Universe` gives the checker one parsed AST per module and
conservative cross-module call resolution; this module grows that into a
dataflow engine — the substrate ``rules_spmd`` and ``rules_layout`` share:

- **Call graph.** Every function definition in the package becomes a node
  (keyed ``module:qualname``); edges come from :meth:`Universe.resolve_call`
  (same-module names, ``module_alias.fn``, ``self.method``) so summaries can
  propagate interprocedurally. Unresolvable calls are deliberate holes — the
  analysis is conservative: what it cannot see contributes nothing, so every
  finding it DOES report is grounded in code it actually resolved.

- **Collective-site detection.** Every collective of the port runs through
  ``TorchCommunication``'s ``@_collective`` methods and the ``_guarded``
  chokepoint of ``communication.py``, which makes the site alphabet
  enumerable: the ``comm.*`` methods (``all_reduce`` … ``reduce_scatter``),
  ``_guarded(site, ...)`` by its site name (the names telemetry records), the
  raw ``torch.distributed`` calls (confined to ``communication.py`` by
  ``collective-uncontracted``, but on the wire all the same) and the store
  barrier ``supervision.kv_barrier``, which every process must reach.
  :func:`collective_site` maps a call AST to its canonical site name or
  ``None``.

- **Emission summaries.** Per function, the *ordered sequence of collective
  sites* its body may emit, with resolved package calls expanded to their own
  summaries (fixpoint; recursion contributes nothing but sets the
  ``cyclic`` flag, and sequences are capped at :data:`MAX_SEQ` sites with a
  truncation marker so pathological fan-out cannot blow up the checker).

- **Rank taint.** Values derived from the per-process identity —
  ``dist.get_rank()``, ``comm.rank`` (and ``self.rank`` inside
  communication.py), ``os.environ["RANK"]`` / ``["LOCAL_RANK"]`` and
  ``_is_writer()`` — are *rank-tainted*: a branch taken on such a value runs
  differently on different ranks, and any collective whose execution depends
  on it is the classic multi-process deadlock (one rank enters the
  collective, its peers never do). Taint propagates through local
  assignments (forward pass, iterated for loops) and, via a call-graph
  fixpoint, through functions whose *return value* is tainted. Deviation
  from heat_tpu's engine: a tuple assignment of a tuple display taints
  element by element, so ``size, rank = self.size, self.rank`` taints
  ``rank`` and not ``size``; and an attribute store taints the attribute's
  path, not its object (``self.seed = rank`` taints ``self.seed``, not every
  later read of ``self``).

- **Split flow.** For the layout rules: per function, the layout each local
  value was given by one of the port's relayouts and every DNDarray
  construction with its claimed split expression.

Everything is stdlib-only, like the rest of the checker.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .engine import ModuleIndex, Universe, dotted_chain
from .rules_donation import WRAPPED_COLLECTIVES, dist_call

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

#: cap on an expanded emission sequence; past it the summary carries the
#: truncation marker and comparisons treat the tail as unknown
MAX_SEQ = 64

#: the truncation / unknown-tail marker inside an emission sequence
ELLIPSIS = "…"

# --------------------------------------------------------------------------
# collective-site alphabet

#: TorchCommunication's collective methods whose names no other object in the
#: tree uses for something else
_UNAMBIGUOUS_COMM_METHODS = frozenset({
    "all_reduce", "all_reduce_packed", "all_gather", "all_gather_stacked",
    "all_gather_v", "agree_min", "allgather_object", "ring_shift", "all_to_all",
    "reduce_scatter",
})

#: collective methods whose names are common verbs elsewhere (``torch.take``, a
#: ``threading.Barrier``): collectives only on a communicator-shaped receiver
_AMBIGUOUS_COMM_METHODS = frozenset({
    "redistribute", "take", "exchange", "bcast", "barrier",
})

#: host-side synchronisation over the job's store that every process must reach:
#: a rank-guarded store barrier hangs exactly like a rank-guarded all-reduce
_STORE_SYNC_CALLS = frozenset({"kv_barrier"})


def _receiver_is_comm(chain: Tuple[str, ...]) -> bool:
    """Whether the receiver of ``chain[-1]`` looks like a communicator:
    ``comm.take`` / ``x.comm.take`` / ``self.comm.take`` / ``COMM_WORLD.take``;
    ``self.take`` inside communication.py is resolved by the call graph."""
    if len(chain) < 2:
        return False
    recv = chain[-2]
    return "comm" in recv.lower()


def collective_site(mod: ModuleIndex, call: ast.Call) -> Optional[str]:
    """The canonical site name of a collective/barrier call, or None.

    ``comm.<op>`` for TorchCommunication methods (the telemetry site names of
    ``_guarded``), the site string of ``_guarded(site, ...)``, ``dist.<op>``
    for raw ``torch.distributed`` collectives, ``store.kv_barrier`` for the
    supervised store barrier."""
    func = call.func
    if isinstance(func, ast.Name):
        if func.id == "_guarded" and call.args:
            site = call.args[0]
            if isinstance(site, ast.Constant) and isinstance(site.value, str):
                return site.value
        if func.id in _STORE_SYNC_CALLS:
            return f"store.{func.id}"
    op = dist_call(mod, call)
    if op is not None:
        return f"dist.{op}" if op in WRAPPED_COLLECTIVES else None
    chain = dotted_chain(func)
    if chain is None:
        # non-name receiver (e.g. ``get_comm().all_gather``): match by method name
        if isinstance(func, ast.Attribute) and func.attr in _UNAMBIGUOUS_COMM_METHODS:
            return f"comm.{func.attr}"
        return None
    name = chain[-1]
    if len(chain) == 1:
        return None
    if name in _STORE_SYNC_CALLS:
        return f"store.{name}"
    if name in _UNAMBIGUOUS_COMM_METHODS:
        return f"comm.{name}"
    if name in _AMBIGUOUS_COMM_METHODS and _receiver_is_comm(chain):
        return f"comm.{name}"
    return None


# --------------------------------------------------------------------------
# rank-taint sources

#: call names whose RESULT is per-rank identity wherever they resolve
_TAINT_CALLS = frozenset({"get_rank", "_is_writer", "is_writer"})

#: ``rank`` only taints on a communicator-shaped receiver (``comm.rank``,
#: ``self.rank`` inside communication.py) — "rank" is too common a word
_TAINT_ATTR_RANK = "rank"

#: environment variables that carry the process's rank
_TAINT_ENV = frozenset({"RANK", "LOCAL_RANK"})


#: collectives whose result is the same on every rank: their value carries no
#: rank identity, whatever went in
_SYMMETRIC = frozenset({
    "all_reduce", "all_reduce_packed", "all_gather", "all_gather_stacked",
    "all_gather_v", "all_gather_counts", "bcast", "agree_min", "allgather_object",
})

#: calls that construct a distributed array (the layout rules' constructions,
#: the sparse matrix's class and its row wrapper)
_CONSTRUCTIONS = frozenset({
    "DNDarray", "DCSR_matrix", "wrap_result", "wrap_global", "rebalance", "wrap_rows",
})


def _symmetric_result(mod: ModuleIndex, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr not in _SYMMETRIC:
        return False
    chain = dotted_chain(node.func)
    return chain is None or _receiver_is_comm(chain) or (
        chain[0] == "self" and mod.name.endswith("communication")
    )


def _is_construction(expr: ast.AST) -> bool:
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    name = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None
    return name in _CONSTRUCTIONS


def _env_rank_read(expr: ast.AST) -> bool:
    """``os.environ["RANK"]``, ``os.environ.get("LOCAL_RANK")``, ``os.getenv("RANK")``."""
    key = None
    if isinstance(expr, ast.Subscript):
        chain = dotted_chain(expr.value)
        if chain and chain[-1] == "environ":
            key = expr.slice
    elif isinstance(expr, ast.Call) and expr.args:
        chain = dotted_chain(expr.func)
        if chain and (chain[-2:] == ("environ", "get") or chain[-1] == "getenv"):
            key = expr.args[0]
    return isinstance(key, ast.Constant) and key.value in _TAINT_ENV


def _target_keys(tgt: ast.AST) -> Set[str]:
    """What an assignment to ``tgt`` taints: a name; an attribute's dotted path
    (``self.seed = r`` taints ``self.seed``, not all of ``self``); a subscript's
    container (``out[i] = r`` taints ``out``); each element of an unpacking."""
    if isinstance(tgt, ast.Name):
        return {tgt.id}
    if isinstance(tgt, ast.Attribute):
        chain = dotted_chain(tgt)
        return {".".join(chain)} if chain else set()
    if isinstance(tgt, ast.Subscript):
        return _target_keys(tgt.value)
    if isinstance(tgt, ast.Starred):
        return _target_keys(tgt.value)
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return set().union(*(_target_keys(e) for e in tgt.elts)) if tgt.elts else set()
    return set()


def _reads_tainted(node: ast.AST, tainted: Set[str]) -> bool:
    """Whether ``node`` reads a tainted name or attribute path (or a path below
    one: ``self.seed.item`` when ``self.seed`` is tainted)."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        chain = dotted_chain(node)
        return bool(chain) and any(".".join(chain[:i]) in tainted for i in range(2, len(chain) + 1))
    return False


def _element_pairs(targets, value):
    """``(target, value)`` pairs of one assignment: element by element when a
    tuple/list target of n names takes a tuple/list display of n values with
    no starred entry (``size, rank = self.size, self.rank``), else every target
    against the whole value."""
    pairs = []
    for tgt in targets:
        if (
            isinstance(tgt, (ast.Tuple, ast.List))
            and isinstance(value, (ast.Tuple, ast.List))
            and len(tgt.elts) == len(value.elts)
            and not any(isinstance(e, ast.Starred) for e in tgt.elts + value.elts)
        ):
            pairs.extend(zip(tgt.elts, value.elts))
        else:
            pairs.append((tgt, value))
    return pairs


# --------------------------------------------------------------------------
# function table / call graph


class FuncInfo:
    """One function definition: identity, AST, and its computed summaries."""

    __slots__ = (
        "module", "qualname", "node", "local_calls",
        "seq", "cyclic", "may_emit", "returns_tainted", "tainted_names",
    )

    def __init__(self, module: str, qualname: str, node: ast.AST):
        self.module = module
        self.qualname = qualname
        self.node = node
        self.local_calls: List[ast.Call] = []
        self.seq: Optional[Tuple[str, ...]] = None
        self.cyclic = False
        self.may_emit = False
        self.returns_tainted = False
        self.tainted_names: Set[str] = set()

    @property
    def key(self) -> str:
        return f"{self.module}:{self.qualname}"


class Dataflow:
    """The shared dataflow state for one :class:`Universe`. Build once via
    :func:`get` — rules_spmd and rules_layout both work off the same
    instance."""

    def __init__(self, uni: Universe):
        self.uni = uni
        self.functions: Dict[Tuple[str, int], FuncInfo] = {}
        self._by_def: Dict[int, FuncInfo] = {}
        self._index_functions()
        self._compute_taint()
        self._compute_sequences()

    # -- function table ------------------------------------------------------
    def _index_functions(self) -> None:
        for mod in self.uni.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, _FUNC_NODES):
                    continue
                cls = mod.class_of.get(node)
                qual = f"{cls}.{node.name}" if cls else node.name
                info = FuncInfo(mod.name, qual, node)
                self.functions[(mod.name, id(node))] = info
                self._by_def[id(node)] = info

    def callees(self, mod: ModuleIndex, call: ast.Call) -> List[FuncInfo]:
        """Resolved package-internal callees of one call site."""
        out = []
        for tmod, tfn in self.uni.resolve_call(mod, call):
            info = self._by_def.get(id(tfn))
            if info is not None:
                out.append(info)
        return out

    # -- ordered own-body walk ----------------------------------------------
    def _walk_own(self, fn: ast.AST) -> Iterable[ast.AST]:
        """Walk a function body in source order WITHOUT descending into
        nested defs (their bodies summarize separately and contribute via
        call edges when invoked)."""
        stack: List[ast.AST] = list(reversed(list(ast.iter_child_nodes(fn))))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, _FUNC_NODES):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(node))))

    # -- rank taint ----------------------------------------------------------
    def _is_taint_source(self, mod: ModuleIndex, expr: ast.AST) -> bool:
        if _env_rank_read(expr):
            return True
        if isinstance(expr, ast.Call):
            chain = dotted_chain(expr.func)
            name = chain[-1] if chain else (
                expr.func.attr if isinstance(expr.func, ast.Attribute) else None
            )
            if name in _TAINT_CALLS:
                return True
            if isinstance(expr.func, ast.Name) or chain is not None:
                for callee in self.callees(mod, expr):
                    if callee.returns_tainted:
                        return True
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr == _TAINT_ATTR_RANK:
                chain = dotted_chain(expr)
                if chain is not None and len(chain) >= 2:
                    recv = chain[-2]
                    if "comm" in recv.lower():
                        return True
                    if chain[0] == "self" and mod.name.endswith("communication"):
                        return True
            return False
        return False

    def expr_tainted(self, mod: ModuleIndex, info: FuncInfo, expr: ast.AST) -> bool:
        """Whether ``expr`` (inside ``info``'s body) carries rank identity:
        it contains a taint source or reads a rank-tainted local name. A
        collective whose result is the same on every rank (:data:`_SYMMETRIC`)
        ends the taint of what it was given: ``comm.agree_min(flag)`` does not
        carry the flag's rank dependence."""
        stack = [expr]
        while stack:
            node = stack.pop()
            if _symmetric_result(mod, node):
                continue
            if self._is_taint_source(mod, node):
                return True
            if _reads_tainted(node, info.tainted_names):
                return True
            stack.extend(ast.iter_child_nodes(node))
        return False

    def _taint_pass(self, mod: ModuleIndex, info: FuncInfo) -> bool:
        """One forward propagation pass; returns True when anything changed."""
        changed = False
        for node in self._walk_own(info.node):
            targets: List[ast.expr] = []
            value: Optional[ast.expr] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets, value = [node.target], node.iter
            elif isinstance(node, ast.NamedExpr):
                targets, value = [node.target], node.value
            if value is None or not targets:
                continue
            for tgt, val in _element_pairs(targets, value):
                if not self.expr_tainted(mod, info, val):
                    continue
                for name in _target_keys(tgt):
                    if name not in info.tainted_names:
                        info.tainted_names.add(name)
                        changed = True
        return changed

    def _returns_tainted(self, mod: ModuleIndex, info: FuncInfo) -> bool:
        for node in self._walk_own(info.node):
            if isinstance(node, ast.Return) and node.value is not None:
                values = node.value.elts if isinstance(node.value, ast.Tuple) else [node.value]
                # a distributed array's construction is not rank identity: its
                # metadata (gshape, split, dtype) is the same on every rank, only
                # its local chunk differs
                if any(not _is_construction(v) and self.expr_tainted(mod, info, v) for v in values):
                    return True
        return False

    def _compute_taint(self) -> None:
        # local fixpoint per function, then a global fixpoint so functions
        # returning rank identity (``_is_writer``) taint their callers. Runs
        # to CONVERGENCE: propagation is monotone (flags only ever flip on),
        # so each non-final round flips at least one ``returns_tainted`` and
        # the round count is bounded by the function count — a fixed small
        # cap would make findings depend on source definition order.
        for _ in range(len(self.functions) + 1):
            changed = False
            for info in self.functions.values():
                mod = self.uni.modules[info.module]
                while self._taint_pass(mod, info):
                    changed = True
                rt = self._returns_tainted(mod, info)
                if rt and not info.returns_tainted:
                    info.returns_tainted = True
                    changed = True
            if not changed:
                break

    # -- emission sequences --------------------------------------------------
    def node_seq(self, mod: ModuleIndex, info: FuncInfo, root: ast.AST,
                 ) -> Tuple[Tuple[str, ...], bool]:
        """The ordered collective sequence emitted by ``root`` (a statement or
        expression inside ``info``), with resolved calls expanded. Returns
        ``(sequence, exact)`` — ``exact`` is False when recursion or the
        length cap truncated the expansion."""
        seq: List[str] = []
        exact = True
        nodes = [root] if not isinstance(root, list) else root
        for top in nodes:
            for node in self._iter_with_root(top):
                if not isinstance(node, ast.Call):
                    continue
                site = collective_site(mod, node)
                if site is not None:
                    seq.append(site)
                    continue
                for callee in self.callees(mod, node):
                    sub = callee.seq or ()
                    seq.extend(sub)
                    if callee.cyclic or ELLIPSIS in sub:
                        exact = False
                if len(seq) > MAX_SEQ:
                    return tuple(seq[:MAX_SEQ]) + (ELLIPSIS,), False
        out = tuple(s for s in seq if s != ELLIPSIS)
        if len(out) != len(seq):
            exact = False
        return out, exact

    def _iter_with_root(self, root: ast.AST) -> Iterable[ast.AST]:
        yield root
        if isinstance(root, _FUNC_NODES):
            return
        stack = list(reversed(list(ast.iter_child_nodes(root))))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, _FUNC_NODES):
                continue
            stack.extend(reversed(list(ast.iter_child_nodes(node))))

    def _compute_sequences(self) -> None:
        # memoized DFS with an on-stack set: recursion contributes nothing
        # but poisons the summary as inexact (cyclic)
        state: Dict[str, int] = {}  # key-id -> 0 visiting, 1 done

        def visit(info: FuncInfo) -> Tuple[str, ...]:
            key = info.key + f"@{id(info.node)}"
            st = state.get(key)
            if st == 1:
                return info.seq or ()
            if st == 0:
                info.cyclic = True
                return ()
            state[key] = 0
            mod = self.uni.modules[info.module]
            seq: List[str] = []
            for node in self._walk_own(info.node):
                if not isinstance(node, ast.Call):
                    continue
                site = collective_site(mod, node)
                if site is not None:
                    seq.append(site)
                else:
                    for callee in self.callees(mod, node):
                        sub = visit(callee)
                        seq.extend(sub)
                        if callee.cyclic:
                            info.cyclic = True
                if len(seq) > MAX_SEQ:
                    seq = seq[:MAX_SEQ] + [ELLIPSIS]
                    break
            info.seq = tuple(seq)
            info.may_emit = bool(seq)
            state[key] = 1
            return info.seq

        for info in self.functions.values():
            visit(info)
        # may_emit closure: a cyclic function whose cycle partners emit
        for _ in range(2):
            changed = False
            for info in self.functions.values():
                if info.may_emit:
                    continue
                mod = self.uni.modules[info.module]
                for node in self._walk_own(info.node):
                    if isinstance(node, ast.Call) and any(
                        c.may_emit for c in self.callees(mod, node)
                    ):
                        info.may_emit = True
                        changed = True
                        break
            if not changed:
                break

    # -- serializable summaries (the cache's per-module section) -------------
    def module_summaries(self) -> Dict[str, Dict[str, dict]]:
        """``{rel_path: {qualname: {seq, cyclic, returns_tainted}}}`` — the
        per-module summary payload the incremental cache stores (and the
        summary-stability tests compare)."""
        out: Dict[str, Dict[str, dict]] = {}
        for info in sorted(self.functions.values(),
                           key=lambda i: (i.module, i.qualname,
                                          getattr(i.node, "lineno", 0))):
            mod = self.uni.modules[info.module]
            entry = out.setdefault(mod.rel_path, {})
            name = info.qualname
            if name in entry:  # overloads: disambiguate by line
                name = f"{info.qualname}@{getattr(info.node, 'lineno', 0)}"
            entry[name] = {
                "seq": list(info.seq or ()),
                "cyclic": info.cyclic,
                "returns_tainted": info.returns_tainted,
            }
        return out


def get(uni: Universe) -> Dataflow:
    """The memoized :class:`Dataflow` for this universe (rules share it)."""
    df = getattr(uni, "_ht_dataflow", None)
    if df is None:
        df = Dataflow(uni)
        uni._ht_dataflow = df  # type: ignore[attr-defined]
    return df
