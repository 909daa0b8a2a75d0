"""Collective-ordering / SPMD-divergence rules.

The worst multi-process failure mode is not a crash but a hang: one rank
takes a rank-dependent branch, emits a different collective sequence than
its peers, and every process blocks inside NCCL/gloo (or a store barrier)
forever. The supervision plane's watchdog can only turn that into a typed
error after the fact; these rules prevent it — the static half of the
``telemetry merge --check`` sequence gate (the runtime twin that names the
first diverging rank/site from real shards).

Built on :mod:`.dataflow`: per-function collective emission summaries
(interprocedural, through the resolved call graph) plus rank-taint tracking
(``dist.get_rank()`` / ``comm.rank`` / ``os.environ["RANK"]`` /
``_is_writer()`` and everything assigned from them). Classic MPI deadlock
detection, where the site alphabet is enumerable through
``TorchCommunication``'s ``_guarded`` chokepoint:

- ``spmd-divergent-collective`` — a conditional, loop bound, or early
  return/raise controlled by a rank-tainted value makes the emitted
  collective sequence differ across ranks: an ``if`` whose branches emit
  different sequences, a loop over a rank-dependent bound whose body emits,
  or a rank-guarded early exit that skips collectives emitted later in the
  function.
- ``spmd-collective-in-except`` — a collective (or a call that transitively
  emits one) inside an ``except`` handler: exceptions are per-process, so the
  handler's collective runs only on the ranks that raised while their peers
  never enter it.

The analysis is conservative: calls the engine cannot resolve contribute no
collectives, so silence is not proof — but every reported finding is grounded
in code the checker actually resolved. Rank-symmetric restructuring (hoist
the collective out of the guard, or guard only the host-local work) is the
fix; genuinely deliberate sites carry ``# ht: ignore[...] -- reason``
pragmas.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from . import dataflow
from .engine import Finding, ModuleIndex, Universe

_EXITS = (ast.Return, ast.Raise, ast.Break, ast.Continue)


def _fmt_seq(seq: Tuple[str, ...]) -> str:
    if not seq:
        return "(no collectives)"
    shown = ", ".join(seq[:4])
    return shown + (", …" if len(seq) > 4 else "")


def _branch_exits(body: List[ast.stmt]) -> bool:
    """Whether the branch body unconditionally leaves the enclosing flow at
    its top level (return/raise/break/continue as a direct statement)."""
    return any(isinstance(stmt, _EXITS) for stmt in body)


def _remainder_after(mod: ModuleIndex, node: ast.AST, fn: ast.AST) -> List[ast.stmt]:
    """Statements that execute AFTER ``node`` on the fall-through path, up to
    the enclosing function — the code a rank-guarded early exit would skip."""
    out: List[ast.stmt] = []
    cur: ast.AST = node
    parent = mod.parent(cur)
    while parent is not None and cur is not fn:
        for field in ("body", "orelse", "finalbody"):
            block = getattr(parent, field, None)
            if isinstance(block, list) and cur in block:
                out.extend(block[block.index(cur) + 1:])
                break
        if parent is fn:
            break
        cur = parent
        parent = mod.parent(cur)
    return out


def run(uni: Universe) -> List[Finding]:
    df = dataflow.get(uni)
    out: List[Finding] = []
    for info in df.functions.values():
        mod = uni.modules[info.module]
        out.extend(_check_function(df, mod, info))
    return out


def _check_function(df: "dataflow.Dataflow", mod: ModuleIndex,
                    info: "dataflow.FuncInfo") -> List[Finding]:
    out: List[Finding] = []
    fn = info.node
    for node in df._walk_own(fn):
        if isinstance(node, ast.If):
            out.extend(_check_if(df, mod, info, fn, node))
        elif isinstance(node, ast.IfExp):
            if df.expr_tainted(mod, info, node.test):
                body_seq, _ = df.node_seq(mod, info, node.body)
                else_seq, _ = df.node_seq(mod, info, node.orelse)
                if body_seq != else_seq:
                    out.append(mod.finding(
                        "spmd-divergent-collective", node,
                        f"rank-dependent conditional expression in "
                        f"{info.qualname!r} emits {_fmt_seq(body_seq)} on one "
                        f"arm but {_fmt_seq(else_seq)} on the other — ranks "
                        "emit different collective sequences and deadlock",
                    ))
        elif isinstance(node, ast.While):
            if df.expr_tainted(mod, info, node.test):
                seq, _ = df.node_seq(mod, info, list(node.body))
                if seq:
                    out.append(mod.finding(
                        "spmd-divergent-collective", node,
                        f"while-loop in {info.qualname!r} has a rank-dependent "
                        f"bound and its body emits {_fmt_seq(seq)}: ranks run "
                        "different collective counts",
                    ))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            # a loop over a tuple/list display runs as many times on every rank,
            # whatever its elements hold
            fixed = isinstance(node.iter, (ast.Tuple, ast.List)) and not any(
                isinstance(e, ast.Starred) for e in node.iter.elts
            )
            if not fixed and df.expr_tainted(mod, info, node.iter):
                seq, _ = df.node_seq(mod, info, list(node.body))
                if seq:
                    out.append(mod.finding(
                        "spmd-divergent-collective", node,
                        f"for-loop in {info.qualname!r} iterates over a "
                        f"rank-dependent bound and its body emits "
                        f"{_fmt_seq(seq)}: ranks run different collective "
                        "counts",
                    ))
        elif isinstance(node, ast.Try):
            for handler in node.handlers:
                seq, _ = df.node_seq(mod, info, list(handler.body))
                if seq:
                    anchor = _first_emitting_node(df, mod, handler)
                    out.append(mod.finding(
                        "spmd-collective-in-except", anchor or handler,
                        f"collective {_fmt_seq(seq)} reachable inside an "
                        f"except handler in {info.qualname!r}: exceptions are "
                        "per-process, so ranks whose peers did not raise "
                        "never enter this collective and the job hangs",
                    ))
    return out


def _check_if(df: "dataflow.Dataflow", mod: ModuleIndex,
              info: "dataflow.FuncInfo", fn: ast.AST,
              node: ast.If) -> List[Finding]:
    if not df.expr_tainted(mod, info, node.test):
        return []
    body_seq, _ = df.node_seq(mod, info, list(node.body))
    else_seq, _ = df.node_seq(mod, info, list(node.orelse))
    body_exits = _branch_exits(node.body)
    else_exits = bool(node.orelse) and _branch_exits(node.orelse)
    # effective per-rank sequence FROM this branch point: a branch that exits
    # ends there; a branch that falls through continues into the remainder.
    # This is what makes the rank-symmetric early-return idiom (both paths
    # reach the same closing barrier — checkpoint.save_checkpoint) pass while
    # a genuinely skipped collective still fails.
    if body_exits != else_exits:
        rest_seq, _ = df.node_seq(mod, info, _remainder_after(mod, node, fn))
        if body_exits:
            eff_body, eff_else = body_seq, else_seq + rest_seq
        else:
            eff_body, eff_else = body_seq + rest_seq, else_seq
    else:
        eff_body, eff_else = body_seq, else_seq
    if eff_body == eff_else:
        return []
    if body_exits != else_exits:
        exiting = eff_body if body_exits else eff_else
        falling = eff_else if body_exits else eff_body
        detail = (
            f"sees {_fmt_seq(exiting)} on the exiting path but "
            f"{_fmt_seq(falling)} on the fall-through"
        )
    else:
        detail = (
            f"emits {_fmt_seq(eff_body)} on the taken path but "
            f"{_fmt_seq(eff_else)} otherwise"
        )
    return [mod.finding(
        "spmd-divergent-collective", node,
        f"rank-dependent branch in {info.qualname!r} {detail} — ranks emit "
        "different collective sequences and deadlock; restructure "
        "rank-symmetrically (guard only the host-local work, every rank "
        "reaches the collective)",
    )]


def _first_emitting_node(df: "dataflow.Dataflow", mod: ModuleIndex,
                         root: ast.AST) -> Optional[ast.AST]:
    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            if dataflow.collective_site(mod, node) is not None:
                return node
            if any(c.may_emit for c in df.callees(mod, node)):
                return node
    return None
