"""Capture-purity rules — what a replay repeats, statically.

A CUDA graph replays the kernels its capture recorded and none of the Python
around them; a ``torch.compile``/``torch.jit`` program likewise runs its body's
Python once, at trace time. The executor's programs are captured this way on
the card (a fused chain of two or more ops), so their bodies must not grow a
host-side dependency: an ``os.environ`` read or ``time``/``random`` call bakes
one capture-time value into every replay; an *unguarded* telemetry record call
runs per capture; a mutable-global write from inside a captured body is a
capture-time side effect replays never repeat. These rules walk every function
statically reachable from a capture body (:class:`~.engine.Universe` builds
the set: ``with torch.cuda.graph(...)`` bodies, ``capture_begin``..
``capture_end`` regions, the functions handed to :data:`~.engine.TRACE_ENTRIES`,
and the bodies ``build`` callbacks hand to ``_executor.lookup``) and flag:

- ``trace-env-read`` — ``os.environ`` / ``os.getenv`` inside a capture body;
- ``trace-time-call`` — ``time.*`` / ``random.*`` / ``np.random.*`` /
  ``datetime.now`` inside a capture body;
- ``trace-telemetry-unguarded`` — a diagnostics/profiler record call not
  under an ``if <subsystem gate>`` branch (``_enabled`` / ``_tracing`` /
  ``_active`` / ``enabled()`` / ``tracing()``);
- ``trace-global-write`` — a ``global`` rebind or a subscript/attribute store
  on a module-level name inside a capture body;
- ``trace-lazy-import`` — an ``import`` statement inside a capture body.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import _FUNC_NODES, Finding, ModuleIndex, Universe, dotted_chain, root_label

TELEMETRY_MODULES = {"diagnostics", "profiler", "telemetry", "forensics"}
TELEMETRY_CALLS = {
    "counter", "span", "observe", "scope",
    "record_collective", "record_compile", "record_dispatch_event",
    "record_fallback", "record_resilience_event", "record_pad_waste",
    "record_backend_event", "record_counter", "record_force_memory",
    "collective_window", "flight_record",
    # forensics producers: same gate discipline — every call inside a
    # capture body sits under `if forensics._enabled:`
    "note_admission", "note_scheduled", "note_program", "note_batch_execute",
    "note_result_cache", "note_compile_cache", "note_collective",
    "note_event", "collective_timer",
}
GATE_ATTRS = {"_enabled", "_tracing", "_active", "_armed", "_collecting"}
GATE_CALLS = {"enabled", "tracing", "executor_enabled"}

TIME_MODULES = {"time", "random", "datetime"}


def _is_gated(mod: ModuleIndex, node: ast.AST, stop: ast.AST) -> bool:
    """Whether ``node`` sits under an If/IfExp whose test reads a telemetry
    gate, looking no further out than the capture root ``stop``."""
    cur = node
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.If, ast.IfExp)) and _test_mentions_gate(anc.test):
            return True
        if anc is stop:
            break
        cur = anc
    del cur
    return False


def _test_mentions_gate(test: ast.expr) -> bool:
    for sub in ast.walk(test):
        if isinstance(sub, ast.Attribute) and sub.attr in GATE_ATTRS:
            return True
        if isinstance(sub, ast.Name) and sub.id in GATE_ATTRS:
            return True
        if isinstance(sub, ast.Call):
            chain = dotted_chain(sub.func)
            if chain and chain[-1] in GATE_CALLS:
                return True
    return False


def _walk_skipping_nested(root: ast.AST, traced) -> "ast.AST":
    """Walk ``root`` without descending into nested defs or regions that are
    themselves in the captured set — they get their own walk, and
    double-visiting would duplicate findings."""
    yield root
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if node in traced:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def run(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for mod in uni.modules.values():
        traced = uni.traced.get(mod.name, set())
        for fn in traced:
            fn_name = root_label(fn)
            for node in _walk_skipping_nested(fn, traced):
                out.extend(_check_node(uni, mod, fn_name, fn, node))
    return out


def _check_node(uni: Universe, mod: ModuleIndex, fn_name: str,
                fn: ast.AST, node: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        out.append(mod.finding(
            "trace-lazy-import", node,
            f"import inside capture body {fn_name!r}: module init must not run "
            "at capture time",
        ))
        return out
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        chain = dotted_chain(node)
        if chain and chain[0] == "os":
            out.append(mod.finding(
                "trace-env-read", node,
                f"os.environ read inside capture body {fn_name!r}: the value is "
                "frozen into the captured program and never re-read on replay",
            ))
        return out
    if not isinstance(node, ast.Call):
        out.extend(_check_global_write(mod, fn_name, fn, node))
        return out
    chain = dotted_chain(node.func)
    if not chain:
        return out
    if chain[0] == "os" and chain[-1] == "getenv":
        out.append(mod.finding(
            "trace-env-read", node,
            f"os.getenv inside capture body {fn_name!r}",
        ))
    elif (
        chain[0] in TIME_MODULES
        and chain[0] in mod.module_aliases
        and len(chain) >= 2
    ) or (chain[:2] in (("np", "random"), ("numpy", "random")) and len(chain) >= 3):
        out.append(mod.finding(
            "trace-time-call", node,
            f"{'.'.join(chain)} inside capture body {fn_name!r}: capture-time "
            "wall-clock/randomness is frozen into the program",
        ))
    elif (
        len(chain) >= 2
        and chain[0] in TELEMETRY_MODULES
        and chain[-1] in TELEMETRY_CALLS
        and not _is_gated(mod, node, fn)
    ):
        out.append(mod.finding(
            "trace-telemetry-unguarded", node,
            f"unguarded {'.'.join(chain)} inside capture body {fn_name!r}: gate "
            "on the subsystem switch (if diagnostics._enabled / "
            "profiler._active) so idle traces stay zero-cost",
        ))
    return out


def _check_global_write(mod: ModuleIndex, fn_name: str, fn: ast.AST,
                        node: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    if not isinstance(node, (ast.Assign, ast.AugAssign)):
        return out
    # a capture region's globals are declared by its enclosing function
    scope = fn if isinstance(fn, _FUNC_NODES + (ast.Lambda,)) else (mod.enclosing_function(fn) or fn)
    declared_global = {
        name
        for sub in ast.walk(scope)
        if isinstance(sub, ast.Global)
        for name in sub.names
    }
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for tgt in targets:
        if isinstance(tgt, ast.Name) and tgt.id in declared_global:
            out.append(mod.finding(
                "trace-global-write", node,
                f"write to global {tgt.id!r} inside capture body {fn_name!r}: "
                "a capture-time side effect replays never repeat",
            ))
        elif isinstance(tgt, (ast.Subscript, ast.Attribute)):
            base = tgt.value
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                base = base.value
            if isinstance(base, ast.Name) and base.id in mod.toplevel_names \
                    and base.id not in mod.functions:
                out.append(mod.finding(
                    "trace-global-write", node,
                    f"store into module-level {base.id!r} inside capture body "
                    f"{fn_name!r}",
                ))
    return out
