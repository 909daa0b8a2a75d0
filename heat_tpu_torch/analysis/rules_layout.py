"""Split/layout contract verifier.

Every framework op is "a local op plus collectives keyed off ``split``", and the
split bookkeeping of the ``_operations`` dispatch wrappers and the array API's
call sites is what keeps every rank's chunk where the metadata says it is.
These rules pin it down with a small abstract interpreter over each function
body (:func:`split_flow`): the layout each local value was *given* by one of
the port's relayouts, every construction with the split it *claims*. The
relayouts (heat_tpu's ``comm.shard(v, S)``) are:

- ``x._relayout(S)`` — this rank's local tensor of ``x`` along ``S``;
- ``comm.redistribute(local, gshape, S, ...)`` — pieces along ``S`` moved to
  the canonical chunks;
- ``rebalance(local, S, proto)`` — the same, wrapped: a construction too;
- ``wrap_global(value, proto, S)`` — this rank's chunk along ``S`` of a value
  that is whole on every rank (laid out along None), wrapped: a construction
  that moves nothing, so it is no hop of a round trip.

The constructions are ``DNDarray(...)``, ``wrap_result(...)``,
``wrap_global(...)`` and ``rebalance(...)``.

- ``layout-shard-claim-mismatch`` — a value laid out along ``S1`` is wrapped
  in a construction claiming split ``S2`` where both are statically known
  (literals) and differ: "the code relaid the value out along None but the
  result claims split=0". The metadata lies about the physical layout and
  every downstream chunk/lshape computation is wrong.
- ``layout-resplit-roundtrip`` — the same value relaid out twice to different
  literal splits inside one function: each hop is a full exchange of the
  array; lay out once, at the final split.
- ``layout-contract`` — a returned construction's claimed split is not among
  the allowed forms declared for that function in :mod:`.layout_contracts`.
- ``layout-contract-stale`` — a registry entry names a function that no
  longer exists: the contract outlived the code; move it with the refactor
  or delete it.

heat_tpu's ``layout-pad-mask-dropped`` does not port: the port has no padded
layout, so there are no pad slots to re-mask (``--explain`` says so).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import dataflow, layout_contracts
from .engine import Finding, ModuleIndex, Universe

CONTRACTS_PATH = "heat_tpu_torch/analysis/layout_contracts.py"

#: constructions: name -> position of the claimed split argument
_CONSTRUCTIONS = {"DNDarray": 3, "wrap_result": 2, "wrap_global": 2, "rebalance": 1}
#: relayouts that are constructions too: their split is their claim
_WRAPPING_RELAYOUTS = frozenset({"rebalance"})


def _norm(expr: Optional[ast.AST]) -> Optional[str]:
    if expr is None:
        return None
    try:
        return " ".join(ast.unparse(expr).split())
    except (ValueError, TypeError, AttributeError, RecursionError):
        return None  # a synthetic or exotic node: statically unknown


def _is_literal_split(norm: Optional[str]) -> bool:
    if norm is None:
        return False
    if norm == "None":
        return True
    try:
        int(norm)
        return True
    except ValueError:
        return False


def _call_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _ctor_kind(call: ast.Call) -> Optional[str]:
    """The construction's name when this call builds a DNDarray."""
    name = _call_name(call)
    return name if name in _CONSTRUCTIONS else None


def _arg(call: ast.Call, pos: int, keyword: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    return call.args[pos] if len(call.args) > pos else None


def _ctor_args(call: ast.Call, kind: str) -> Tuple[Optional[ast.AST], Optional[ast.AST]]:
    """``(value_arg, split_arg)`` of a construction call."""
    keyword = "axis" if kind == "rebalance" else "split"
    return (call.args[0] if call.args else None), _arg(call, _CONSTRUCTIONS[kind], keyword)


def _relayout_args(mod: ModuleIndex, call: ast.Call) -> Optional[Tuple[Optional[ast.AST], Optional[ast.AST]]]:
    """``(value, split)`` of one of the port's relayouts, or None."""
    name = _call_name(call)
    if name == "_relayout" and isinstance(call.func, ast.Attribute):
        return call.func.value, _arg(call, 0, "axis")
    if name == "redistribute" and dataflow.collective_site(mod, call) == "comm.redistribute":
        return (call.args[0] if call.args else None), _arg(call, 2, "axis")
    if name in _WRAPPING_RELAYOUTS:
        return _ctor_args(call, name)
    return None


class SplitFlow:
    """The per-function abstract state the layout rules check."""

    def __init__(self) -> None:
        #: name -> (normalized split expr, the relayout call node)
        self.var_layout: Dict[str, Tuple[Optional[str], ast.Call]] = {}
        #: resplit round-trips found at visit time: (call, desc, prev, cur)
        self.roundtrips: List[Tuple[ast.Call, str, str, str]] = []
        #: name -> claimed split of the construction assigned to it
        self.var_ctor_split: Dict[str, Optional[str]] = {}
        #: (call, kind, name, laid-out split, claimed split)
        self.mismatches: List[Tuple[ast.Call, str, str, str, str]] = []
        #: returned claimed splits: (node, split_norm)
        self.returned: List[Tuple[ast.AST, Optional[str]]] = []


def _target_names(targets) -> List[str]:
    """Bound names of assignment targets, descending into tuple/list
    unpacking (``v, shp, fs = ...``)."""
    names: List[str] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, ast.Name):
            names.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
    return names


def split_flow(df: "dataflow.Dataflow", mod: ModuleIndex,
               info: "dataflow.FuncInfo") -> SplitFlow:
    """Run the abstract split interpreter over one function body (statement
    order; layout state is checked at visit time so reassignments see the
    layout a name had WHEN it was consumed, not the end-of-function state)."""
    flow = SplitFlow()
    checked: Set[int] = set()

    def check_relayout(call: ast.Call, value: Optional[ast.AST], split_norm: Optional[str]) -> None:
        """Visit-time checks on one relayout: nested and chained round-trips."""
        if id(call) in checked:
            return
        checked.add(id(call))
        if isinstance(value, ast.Call):
            inner = _relayout_args(mod, value)
            if inner is not None:
                a, b = _norm(inner[1]), split_norm
                if _is_literal_split(a) and _is_literal_split(b) and a != b:
                    flow.roundtrips.append((call, "nested", a, b))
        if isinstance(value, ast.Name):
            laid = flow.var_layout.get(value.id)
            if laid is not None and laid[1] is not call:
                prev = laid[0]
                if _is_literal_split(prev) and _is_literal_split(split_norm) \
                        and prev != split_norm:
                    flow.roundtrips.append((call, value.id, prev, split_norm))

    def record_call(call: ast.Call) -> None:
        relayout = _relayout_args(mod, call)
        if relayout is not None:
            check_relayout(call, relayout[0], _norm(relayout[1]))
        kind = _ctor_kind(call)
        if kind is None:
            return
        value, split = _ctor_args(call, kind)
        claimed = _norm(split)
        if isinstance(value, ast.Name) and kind not in _WRAPPING_RELAYOUTS:
            laid = flow.var_layout.get(value.id)
            if kind == "wrap_global":
                # its value must be whole on every rank (laid out along None); it
                # keeps this rank's chunk itself
                claimed = "None"
            if laid is not None and claimed is not None \
                    and laid[0] is not None and claimed != laid[0] \
                    and _is_literal_split(claimed) \
                    and _is_literal_split(laid[0]):
                flow.mismatches.append((call, kind, value.id, laid[0], claimed))

    for node in df._walk_own(info.node):
        if isinstance(node, ast.Call):
            record_call(node)
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            val = node.value
            targets = val.elts if isinstance(val, ast.Tuple) else [val]
            for t in targets:
                if isinstance(t, ast.Call) and _ctor_kind(t):
                    _, split = _ctor_args(t, _ctor_kind(t))
                    flow.returned.append((t, _norm(split)))
                elif isinstance(t, ast.Name) and t.id in flow.var_ctor_split:
                    flow.returned.append((t, flow.var_ctor_split[t.id]))
            continue
        if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        value = getattr(node, "value", None)
        if value is None:
            continue
        names = _target_names(targets)
        if isinstance(value, ast.Call):
            relayout = _relayout_args(mod, value)
            kind = _ctor_kind(value)
            if relayout is not None:
                # arg checks against the PRE-assignment state (record_call
                # re-visits the node later, deduped by call identity)
                check_relayout(value, relayout[0], _norm(relayout[1]))
            if kind is not None:
                _, split = _ctor_args(value, kind)
                for name in names:
                    flow.var_ctor_split[name] = _norm(split)
                    flow.var_layout.pop(name, None)
                continue
            if relayout is not None:
                for name in names:
                    flow.var_layout[name] = (_norm(relayout[1]), value)
                continue
        if not isinstance(value, ast.Name):
            for name in names:
                flow.var_layout.pop(name, None)
    return flow


def run(uni: Universe) -> List[Finding]:
    df = dataflow.get(uni)
    out: List[Finding] = []
    seen_contract_keys: Set[str] = set()
    for info in df.functions.values():
        mod = uni.modules[info.module]
        contract = layout_contracts.contract_for(info.module, info.qualname)
        if contract:
            seen_contract_keys.add(f"{info.module}:{info.qualname}")
        flow = split_flow(df, mod, info)
        for call, kind, name, laid, claimed in flow.mismatches:
            out.append(mod.finding(
                "layout-shard-claim-mismatch", call,
                f"{info.qualname!r} lays {name!r} out along split={laid} but "
                f"the {kind} construction claims split={claimed}: the "
                "metadata lies about the physical layout",
            ))
        seen_rt: Set[int] = set()
        for call, desc, prev, cur in flow.roundtrips:
            if id(call) in seen_rt:
                continue
            seen_rt.add(id(call))
            what = "in one expression" if desc == "nested" else f"of {desc!r}"
            out.append(mod.finding(
                "layout-resplit-roundtrip", call,
                f"{info.qualname!r} relays out {what} from split={prev} to "
                f"split={cur}: each hop exchanges the whole array — lay out "
                "once, at the final split",
            ))
        allowed = contract.get("result_split")
        if allowed:
            for node, claimed in flow.returned:
                if claimed is not None and claimed not in allowed:
                    out.append(mod.finding(
                        "layout-contract", node,
                        f"{info.qualname!r} returns a construction claiming "
                        f"split={claimed}, but its declared contract allows "
                        f"only {sorted(allowed)} (layout_contracts: "
                        f"{contract.get('origin', 'no origin recorded')})",
                    ))
    for key in sorted(set(layout_contracts.CONTRACTS) - seen_contract_keys):
        # staleness is judged per MODULE actually scanned: a contract whose
        # whole module is outside this universe (fixture trees, --root runs
        # over a subtree) is out of scope, not stale
        if key.split(":", 1)[0] not in uni.modules:
            continue
        out.append(Finding(
            "layout-contract-stale", CONTRACTS_PATH, 0,
            f"layout contract {key!r} matches no function — the contract "
            "outlived the code; move it with the refactor or delete it",
            key,
        ))
    return out
