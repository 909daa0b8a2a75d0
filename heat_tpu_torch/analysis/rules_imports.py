"""Import-contract rules.

The port's telemetry stack (``diagnostics`` / ``profiler`` / ``resilience`` /
``_scheduler`` / ``telemetry`` / ``supervision`` / ``ops`` / ``forensics``)
commits, in each module docstring, to importing only the stdlib at module
level, so tooling can load it by file path without torch; this checker holds
itself to the same contract. ``import-nonstdlib`` enforces that statically (a
top-level ``torch`` or ``numpy`` there is the typical violation);
``tests/test_torch_analysis.py`` proves it dynamically with a
``sys.meta_path`` hook. Relative imports *within* the stdlib-only set are fine
(``resilience`` imports ``diagnostics``); anything else at module level is an
error. Imports inside function bodies are the sanctioned lazy form and are not
flagged (unless the function is a capture body — that is
``trace-lazy-import``'s job).

``import-jax`` holds the port apart from the reference: no module of the port,
and not ``chip_smoke.py``, imports ``jax``, ``jaxlib`` or anything of
``heat_tpu``, at load or lazily.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .engine import Finding, ModuleIndex, Universe, is_stdlib

# The stdlib-only-at-load set (module docstrings state the contract).
STDLIB_ONLY: Set[str] = {
    "heat_tpu_torch.core.diagnostics",
    "heat_tpu_torch.core.profiler",
    "heat_tpu_torch.core.resilience",
    "heat_tpu_torch.core._scheduler",
    "heat_tpu_torch.core.telemetry",  # merge must run in torch-free tooling
    "heat_tpu_torch.core.supervision",  # _scheduler imports it; torch only lazily
    "heat_tpu_torch.core.ops",  # exporter/parser must run torch-free; executor lazily
    "heat_tpu_torch.core.forensics",  # record store reads shards torch-free too
    "heat_tpu_torch.analysis",  # the checker polices itself: it must stay light
}
_ANALYSIS_PREFIX = "heat_tpu_torch.analysis"

#: top-level packages no module of the port imports: the reference and its backend
REFERENCE_PACKAGES = frozenset({"jax", "jaxlib", "heat_tpu"})


def _in_contract(name: str) -> bool:
    return name in STDLIB_ONLY or name.startswith(_ANALYSIS_PREFIX)


def _toplevel_imports(mod: ModuleIndex):
    """Module-level import statements, descending into top-level If/Try
    (conditional imports still run at load) but not into functions."""
    stack = list(mod.tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            skip = False
            if isinstance(node, ast.If):
                t = node.test
                if isinstance(t, ast.Name) and t.id == "TYPE_CHECKING":
                    skip = True  # never executes at runtime
                if isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING":
                    skip = True
            if not skip:
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.stmt):
                        stack.append(sub)


def run(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for name in sorted(STDLIB_ONLY | {
        m for m in uni.modules if m.startswith(_ANALYSIS_PREFIX)
    }):
        mod = uni.modules.get(name)
        if mod is None:
            continue
        for node in _toplevel_imports(mod):
            out.extend(_check_import(uni, mod, node))
    for name in sorted(uni.modules):
        out.extend(_reference_imports(uni.modules[name]))
    return out


def _check_import(uni: Universe, mod: ModuleIndex, node: ast.AST) -> List[Finding]:
    out: List[Finding] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            if not is_stdlib(alias.name):
                out.append(mod.finding(
                    "import-nonstdlib", node,
                    f"{mod.name} is stdlib-only at module load but imports "
                    f"{alias.name!r} at top level",
                ))
    elif isinstance(node, ast.ImportFrom):
        target = mod._resolve_from(node)
        if target is None:
            return out
        if is_stdlib(target):
            return out
        if node.level > 0:
            # relative import: allowed when every imported name stays inside
            # the stdlib-only set (the telemetry planes' diagnostics/resilience web)
            ok = _in_contract(target) or all(
                _in_contract(f"{target}.{alias.name}") for alias in node.names
            )
            if ok:
                return out
        out.append(mod.finding(
            "import-nonstdlib", node,
            f"{mod.name} is stdlib-only at module load but imports "
            f"{target!r} at top level",
        ))
    return out


def _reference_imports(mod: ModuleIndex) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in REFERENCE_PACKAGES:
                out.append(mod.finding(
                    "import-jax", node,
                    f"{mod.name} imports {name!r}: the port imports nothing of jax "
                    "or heat_tpu — keep a copy of what it needs instead",
                ))
    return out
