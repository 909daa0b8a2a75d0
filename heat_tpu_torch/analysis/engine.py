"""Shared AST infrastructure for the port's invariant checker.

One parse per module, one index pass, then every rule family works off the
same :class:`ModuleIndex`: parent links for ancestor queries (is this write
inside a ``with _lock`` block? is this call under an ``if diagnostics._enabled``
guard?), import-alias maps for cross-module call resolution, a per-module
function table, and the *capture-body* set — the code statically reachable
from what runs once and is frozen into every replay: a ``torch.cuda.graph``
body, the executor's ``capture_begin``/``capture_end`` region, the programs
its ``lookup`` builds, and functions handed to ``torch.compile`` and the other
:data:`TRACE_ENTRIES` — which the purity rules police.

Everything here is stdlib-only: the checker runs as a separate process and
never imports torch (or anything else heavy) into itself.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# findings


class Finding:
    """One rule violation: ``rule`` id, repo-relative ``path``, 1-based
    ``line``, human ``message``, and the stripped source ``snippet`` (the
    stable half of a baseline entry — line numbers drift, source lines
    rarely do)."""

    __slots__ = ("rule", "path", "line", "message", "snippet")

    def __init__(self, rule: str, path: str, line: int, message: str, snippet: str = ""):
        self.rule = rule
        self.path = path
        self.line = line
        self.message = message
        self.snippet = snippet

    def key(self) -> Tuple[str, str, str]:
        """The baseline identity: line numbers are excluded so a finding does
        not go stale when unrelated code above it moves."""
        return (self.rule, self.path, self.snippet)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
        }


# ---------------------------------------------------------------------------
# module discovery + index

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# Calls that freeze host code into a replay: a function (or lambda) passed to one
# of these runs its Python once, at capture or trace time, and every later call
# replays what was recorded — the purity rules apply to everything statically
# reachable from it. ``torch.func.vmap`` is deliberately absent: it runs its body
# on every call and freezes nothing. (The ``with torch.cuda.graph(...)`` body and
# the code between ``capture_begin()`` and ``capture_end()`` are capture bodies
# too; :meth:`Universe._module_roots` seeds them.)
TRACE_ENTRIES: Set[Tuple[str, ...]] = {
    ("torch", "cuda", "make_graphed_callables"),
    ("torch", "compile"),
    ("torch", "jit", "trace"),
    ("torch", "jit", "script"),
    ("torch", "fx", "symbolic_trace"),
    ("torch", "export", "export"),
}

# heat_tpu seeds every function calling a jax.lax primitive that is legal only
# inside a trace (psum, axis_index, ...). torch has no such operation: every
# torch op also runs eagerly, so nothing marks a function as captured by what it
# calls, and the set is empty.
TRACE_ONLY_PRIMITIVES: Set[str] = set()

# the executor's program cache: a ``build`` callback handed to its ``lookup``
# returns the program body, which runs eagerly or is captured in a CUDA graph
EXECUTOR_MODULE = "heat_tpu_torch.core._executor"

def dotted_chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``torch.distributed.all_reduce`` -> ("torch", "distributed", "all_reduce");
    None for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class ModuleIndex:
    """Everything the rules need to know about one parsed module."""

    def __init__(self, name: str, path: str, rel_path: str, source: str):
        self.name = name
        self.path = path
        self.rel_path = rel_path
        self.is_package = os.path.basename(path) == "__init__.py"
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.module_aliases: Dict[str, str] = {}   # local name -> dotted module
        self.func_imports: Dict[str, Tuple[str, str]] = {}  # name -> (module, attr)
        self.functions: Dict[str, List[ast.AST]] = {}       # bare name -> defs
        self.toplevel_names: Set[str] = set()
        self.toplevel_containers: Set[str] = set()
        self.toplevel_aliases: Dict[str, Tuple[str, str]] = {}  # x = mod.attr
        self.class_of: Dict[ast.AST, Optional[str]] = {}    # def -> enclosing class
        self._annotate_parents()
        self._index()

    # -- structure -----------------------------------------------------------
    def _annotate_parents(self) -> None:
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._ht_parent = node  # type: ignore[attr-defined]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_ht_parent", None)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, _FUNC_NODES):
                return anc
        return None

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(rule, self.rel_path, line, message, self.snippet(line))

    # -- index pass ----------------------------------------------------------
    def _index(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_NODES):
                self.functions.setdefault(node.name, []).append(node)
                cls = None
                for anc in self.ancestors(node):
                    if isinstance(anc, ast.ClassDef):
                        cls = anc.name
                        break
                    if isinstance(anc, _FUNC_NODES):
                        break
                self.class_of[node] = cls
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_aliases[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(node)
                for alias in node.names:
                    local = alias.asname or alias.name
                    if base is None:
                        continue
                    # `from x import y` may bind a submodule OR a function; we
                    # record both interpretations and let resolution try each.
                    self.module_aliases.setdefault(local, f"{base}.{alias.name}")
                    self.func_imports[local] = (base, alias.name)
        for stmt in self.tree.body:
            self._index_toplevel(stmt)

    def _resolve_from(self, node: ast.ImportFrom) -> Optional[str]:
        if node.level == 0:
            return node.module
        parts = self.name.split(".")
        # for a plain module, level 1 is the containing package; for a
        # package's __init__, level 1 is the package itself
        drop = node.level - 1 if self.is_package else node.level
        base_parts = parts[: len(parts) - drop] if drop else parts
        if node.module:
            base_parts += node.module.split(".")
        return ".".join(base_parts) if base_parts else None

    def _index_toplevel(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            value = getattr(stmt, "value", None)
            for tgt in targets:
                if not isinstance(tgt, ast.Name):
                    continue
                self.toplevel_names.add(tgt.id)
                if value is not None and _is_container_ctor(value):
                    self.toplevel_containers.add(tgt.id)
                if isinstance(value, ast.Attribute):
                    chain = dotted_chain(value)
                    if chain and len(chain) == 2:
                        self.toplevel_aliases[tgt.id] = (chain[0], chain[1])
        elif isinstance(stmt, (ast.If, ast.Try, ast.With)):
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.stmt):
                    self._index_toplevel(sub)


def _is_container_ctor(node: ast.expr) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp)):
        return True
    if isinstance(node, ast.Call):
        chain = dotted_chain(node.func)
        if chain and chain[-1] in {
            "dict", "list", "set", "deque", "OrderedDict", "defaultdict", "Counter",
        }:
            return True
    return False


# ---------------------------------------------------------------------------
# universe


class Universe:
    """Every parsed module of the package (plus the configured extra files),
    with cross-module call resolution and the traced-body set."""

    def __init__(self, package_root: str, extra_files: Sequence[str] = ()):
        self.package_root = os.path.abspath(package_root)
        self.repo_root = os.path.dirname(self.package_root)
        self.modules: Dict[str, ModuleIndex] = {}
        for path in sorted(self._iter_py_files()):
            rel = os.path.relpath(path, self.repo_root).replace(os.sep, "/")
            name = rel[:-3].replace("/", ".")
            if name.endswith(".__init__"):
                name = name[: -len(".__init__")]
            self._load(name, path, rel)
        for path in extra_files:
            path = os.path.abspath(path)
            if not os.path.exists(path):
                continue
            rel = os.path.relpath(path, self.repo_root).replace(os.sep, "/")
            self._load(os.path.basename(path)[:-3], path, rel)
        self.traced: Dict[str, Set[ast.AST]] = {}
        self._build_traced_sets()

    def _iter_py_files(self):
        for dirpath, dirnames, filenames in os.walk(self.package_root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)

    def _load(self, name: str, path: str, rel: str) -> None:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        self.modules[name] = ModuleIndex(name, path, rel, source)

    # -- call resolution -----------------------------------------------------
    def resolve_call(self, mod: ModuleIndex, call: ast.Call) -> List[Tuple[ModuleIndex, ast.AST]]:
        """Resolve a call to candidate function defs — same-module names,
        ``module_alias.fn`` attributes into sibling package modules, and
        ``self.method`` within the enclosing class. Unresolvable calls return
        [] (the walk is deliberately conservative)."""
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in mod.functions:
                return [(mod, d) for d in mod.functions[name]]
            target = mod.func_imports.get(name)
            if target:
                return self._resolve_in_module(target[0], target[1])
            return []
        if isinstance(func, ast.Attribute):
            chain = dotted_chain(func)
            if chain is None:
                if isinstance(func.value, ast.Name) and func.value.id == "self":
                    return [(mod, d) for d in mod.functions.get(func.attr, [])]
                return []
            if chain[0] == "self":
                return [(mod, d) for d in mod.functions.get(chain[-1], [])]
            alias = mod.module_aliases.get(chain[0])
            if alias and len(chain) == 2:
                return self._resolve_in_module(alias, chain[1])
        return []

    def _resolve_in_module(self, modname: str, attr: str, depth: int = 0
                           ) -> List[Tuple[ModuleIndex, ast.AST]]:
        target = self.modules.get(modname)
        if target is None or depth > 2:
            return []
        if attr in target.functions:
            return [(target, d) for d in target.functions[attr]]
        reexport = target.func_imports.get(attr)
        if reexport:
            return self._resolve_in_module(reexport[0], reexport[1], depth + 1)
        alias = target.toplevel_aliases.get(attr)
        if alias:
            inner = target.module_aliases.get(alias[0])
            if inner:
                return self._resolve_in_module(inner, alias[1], depth + 1)
        return []

    # -- capture-body discovery ----------------------------------------------
    def _build_traced_sets(self) -> None:
        # The stdlib-only telemetry modules are a hard boundary: they import no
        # torch, so nothing inside them can put work into a CUDA graph — their
        # internals are host-side by construction (and separately policed by the
        # import-contract rules). Without the cut, the telemetry hooks on the
        # dispatch path would drag the whole diagnostics/resilience machinery
        # into the captured set and drown the purity rules in noise.
        from .rules_imports import STDLIB_ONLY

        roots: List[Tuple[ModuleIndex, ast.AST]] = []
        for mod in self.modules.values():
            roots.extend(self._module_roots(mod))
        seen: Set[Tuple[str, int]] = set()
        queue = list(roots)
        while queue:
            mod, fn = queue.pop()
            if mod.name in STDLIB_ONLY:
                continue
            key = (mod.name, id(fn))
            if key in seen:
                continue
            seen.add(key)
            self.traced.setdefault(mod.name, set()).add(fn)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    for tmod, tfn in self.resolve_call(mod, node):
                        queue.append((tmod, tfn))

    def _module_roots(self, mod: ModuleIndex) -> List[Tuple[ModuleIndex, ast.AST]]:
        roots: List[Tuple[ModuleIndex, ast.AST]] = []
        entry_tails = {c[-2:] for c in TRACE_ENTRIES if len(c) >= 2}

        def local_def(name_node: ast.expr) -> Optional[ast.AST]:
            if isinstance(name_node, ast.Name) and name_node.id in mod.functions:
                return mod.functions[name_node.id][0]
            return None

        def is_entry(expr: ast.expr) -> bool:
            chain = dotted_chain(expr.func if isinstance(expr, ast.Call) else expr)
            return bool(chain) and (chain in TRACE_ENTRIES or (
                len(chain) > 1 and chain[-2:] in entry_tails and chain[0] in mod.module_aliases
            ))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                if is_entry(node):
                    for arg in list(node.args) + [kw.value for kw in node.keywords]:
                        fn = local_def(arg)
                        if fn is not None:
                            roots.append((mod, fn))
                        elif isinstance(arg, ast.Lambda):
                            roots.append((mod, arg))
                elif _is_executor_lookup(mod, node):
                    # the executor's lookup protocol: the function a `build`
                    # callback RETURNS is the program body (run eagerly, or
                    # captured in a CUDA graph). The callback is the call's
                    # second argument: a local `def build`, or a call of a
                    # factory whose nested `def build` it returns
                    # (``_plan_build(pl)``). A `build` that never reaches
                    # lookup (the kernels' compiler ``_nvcc.build``) seeds
                    # nothing.
                    cb = node.args[1] if len(node.args) >= 2 else next(
                        (kw.value for kw in node.keywords if kw.arg == "build"), None
                    )
                    for build in self._build_callbacks(mod, cb):
                        roots.extend(self._build_bodies(mod, build))
            elif isinstance(node, ast.With):
                if any(is_entry(item.context_expr) or _is_graph_ctx(item.context_expr)
                       for item in node.items):
                    roots.append((mod, node))  # `with torch.cuda.graph(g):`
            elif isinstance(node, _FUNC_NODES):
                if any(is_entry(dec) for dec in node.decorator_list):
                    roots.append((mod, node))  # @torch.compile / @torch.jit.script
            for block in _stmt_blocks(node):
                roots.extend((mod, stmt) for stmt in _capture_region(block))
        return roots

    def _build_callbacks(self, mod: ModuleIndex, cb: Optional[ast.expr]) -> List[ast.AST]:
        if isinstance(cb, ast.Name) and cb.id in mod.functions:
            return list(mod.functions[cb.id])
        if isinstance(cb, ast.Call):
            out = []
            for _, factory in self.resolve_call(mod, cb):
                for sub in ast.walk(factory):
                    if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Name):
                        out.extend(
                            d for d in ast.walk(factory)
                            if isinstance(d, _FUNC_NODES) and d.name == sub.value.id
                        )
            return out
        return []

    @staticmethod
    def _build_bodies(mod: ModuleIndex, build: ast.AST) -> List[Tuple[ModuleIndex, ast.AST]]:
        roots = []
        nested = {d.name: d for d in ast.walk(build) if isinstance(d, _FUNC_NODES)}
        for sub in ast.walk(build):
            if isinstance(sub, ast.Return) and sub.value is not None:
                cand = sub.value
                if isinstance(cand, ast.Tuple) and cand.elts:
                    cand = cand.elts[0]
                if isinstance(cand, ast.Name):
                    fn = nested.get(cand.id) or next(
                        (d for d in mod.tree.body if isinstance(d, _FUNC_NODES) and d.name == cand.id), None
                    )
                    if fn is not None:
                        roots.append((mod, fn))
        return roots


def _is_executor_lookup(mod: ModuleIndex, call: ast.Call) -> bool:
    """``lookup(key, build, ...)`` inside the executor, or ``_executor.lookup(...)``
    from a module that imported it (the result cache's own ``lookup`` takes no
    callback and is not this)."""
    chain = dotted_chain(call.func)
    if not chain or chain[-1] != "lookup":
        return False
    if len(chain) == 1:
        return mod.name == EXECUTOR_MODULE
    return mod.module_aliases.get(chain[-2]) == EXECUTOR_MODULE or chain[-2] == "_executor"


def _is_graph_ctx(expr: ast.expr) -> bool:
    """``torch.cuda.graph(g)`` (or ``cuda.graph(g)`` / ``graph(g)`` imported from
    torch.cuda): the context manager that captures its body."""
    if not isinstance(expr, ast.Call):
        return False
    chain = dotted_chain(expr.func)
    return bool(chain) and chain[-1] == "graph" and (len(chain) == 1 or chain[-2] == "cuda")


def _stmt_blocks(node: ast.AST):
    for field in ("body", "orelse", "finalbody"):
        block = getattr(node, field, None)
        if isinstance(block, list) and block and isinstance(block[0], ast.stmt):
            yield block


def _is_capture_call(stmt: ast.stmt, name: str) -> bool:
    return (
        isinstance(stmt, ast.Expr)
        and isinstance(stmt.value, ast.Call)
        and isinstance(stmt.value.func, ast.Attribute)
        and stmt.value.func.attr == name
    )


def _capture_region(block: List[ast.stmt]) -> List[ast.stmt]:
    """The statements between a ``g.capture_begin(...)`` statement and the next
    ``g.capture_end()`` statement of the same block: the executor's manual capture.
    The statements after ``capture_begin`` up to the end of the block count when
    no ``capture_end`` follows there."""
    out: List[ast.stmt] = []
    inside = False
    for stmt in block:
        if _is_capture_call(stmt, "capture_begin"):
            inside = True
        elif _is_capture_call(stmt, "capture_end"):
            inside = False
        elif inside:
            out.append(stmt)
    return out


def root_label(fn: ast.AST) -> str:
    """A capture root's name in findings: the function's, or what the region is."""
    if isinstance(fn, ast.With):
        return "<torch.cuda.graph body>"
    if isinstance(fn, ast.Lambda):
        return "<lambda>"
    if isinstance(fn, ast.stmt) and not isinstance(fn, _FUNC_NODES):
        return "<capture_begin..capture_end>"
    return getattr(fn, "name", "<lambda>")


# ---------------------------------------------------------------------------
# stdlib classification (for the import-contract rules)

_STDLIB = set(getattr(sys, "stdlib_module_names", ())) | {"__future__"}


def is_stdlib(module: Optional[str]) -> bool:
    if not module:
        return False
    return module.split(".")[0] in _STDLIB


# ---------------------------------------------------------------------------
# orchestration


def default_extra_files(package_root: str) -> List[str]:
    """The files scanned beside the package: the repo's ``chip_smoke.py``."""
    repo_root = os.path.dirname(os.path.abspath(package_root))
    return [os.path.join(repo_root, "chip_smoke.py")]


def run_analysis(package_root: Optional[str] = None,
                 extra_files: Optional[Sequence[str]] = None) -> Tuple[List[Finding], "object"]:
    """Run every rule family over the package. Returns ``(findings, universe)``
    — findings are pragma-filtered and sorted, with pragma misuse (missing
    reason, unknown rule, unused pragma) appended as findings of their own."""
    from . import pragmas, rules

    if package_root is None:
        package_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if extra_files is None:
        extra_files = default_extra_files(package_root)
    uni = Universe(package_root, extra_files)
    raw: List[Finding] = []
    for rule_fn in rules.RULE_RUNNERS:
        raw.extend(rule_fn(uni))
    pragma_table = {name: pragmas.collect(mod) for name, mod in uni.modules.items()}
    by_path = {m.rel_path: m for m in uni.modules.values()}
    kept: List[Finding] = []
    uni.suppressed = []  # what the pragmas suppressed: the report counts it by rule
    for f in raw:
        mod = by_path.get(f.path)
        if mod is not None and pragmas.suppressed(pragma_table[mod.name], f):
            uni.suppressed.append(f)
            continue
        kept.append(f)
    for name, table in pragma_table.items():
        kept.extend(pragmas.misuse_findings(uni.modules[name], table))
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept, uni
