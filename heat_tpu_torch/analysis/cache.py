"""Incremental analysis cache: content-hash-keyed findings and summaries.

The dataflow pass makes the blocking ``--check`` meaningfully more expensive
than per-node pattern rules; this cache keeps the common cases fast. Layout,
in ``.analysis_cache_torch.json`` at the repository's root (listed in
``.gitignore``; heat_tpu's checker keeps its own under ``benchmarks/out/``):

- ``modules``: one entry per scanned file, keyed by repo-relative path,
  holding the file's content hash, the findings attributed to that path, and
  the module's dataflow summaries (per-function collective sequences /
  taint facts) — everything keyed on the content hash so tooling can trust
  an entry exactly as long as the file is byte-identical.
- ``code_hash``: a fingerprint of the analysis package ITSELF — a rule edit
  invalidates everything (the checker must never serve findings computed by
  older rules).

Reuse is deliberately all-or-nothing: the new rule families are
*interprocedural* (a one-module edit can create or fix a finding reported in
a different module), so per-module findings reuse on a partial hash match
would be unsound. A full match — every file byte-identical and the rules
unchanged — serves the stored findings without running a single rule, which
is the case that matters (CI re-runs, repeated local ``--check``); any
mismatch re-runs everything and rewrites the cache. ``--no-cache`` is the
escape hatch, and the stale-cache test in ``tests/test_torch_analysis.py``
proves an edit is never masked.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

from .engine import Finding

SCHEMA = "heat-tpu-analysis-cache/1"

CACHE_NAME = ".analysis_cache_torch.json"


def default_path(package_root: str) -> str:
    repo_root = os.path.dirname(os.path.abspath(package_root))
    return os.path.join(repo_root, CACHE_NAME)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def code_fingerprint() -> str:
    """Hash of the analysis package's own sources: a rule change must never
    serve findings computed by the old rules."""
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for name in sorted(os.listdir(here)):
        if name.endswith(".py"):
            h.update(name.encode())
            h.update(_sha256_file(os.path.join(here, name)).encode())
    return h.hexdigest()


def module_hashes(package_root: str,
                  extra_files: Sequence[str] = ()) -> Dict[str, str]:
    """Repo-relative path -> content hash for every file the engine scans
    (mirrors ``Universe``'s discovery: the package's ``.py`` tree plus the
    configured extra files)."""
    package_root = os.path.abspath(package_root)
    repo_root = os.path.dirname(package_root)
    out: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
                out[rel] = _sha256_file(path)
    for path in extra_files:
        path = os.path.abspath(path)
        if os.path.exists(path):
            rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
            out[rel] = _sha256_file(path)
    return out


def load(path: str) -> Optional[dict]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return None
    if data.get("schema") != SCHEMA:
        return None
    return data


def lookup(cached: Optional[dict], package_root: str, code_hash: str,
           hashes: Dict[str, str]) -> Optional[List[Finding]]:
    """The stored findings when EVERYTHING matches — same package root, same
    rule code, every scanned file byte-identical (no additions, deletions,
    or edits) — else None."""
    if not cached:
        return None
    if cached.get("package_root") != os.path.abspath(package_root):
        return None
    if cached.get("code_hash") != code_hash:
        return None
    modules = cached.get("modules", {})
    if {rel: m.get("hash") for rel, m in modules.items()} != hashes:
        return None
    findings: List[Finding] = []
    for rel in modules:
        for f in modules[rel].get("findings", ()):
            findings.append(Finding(
                f["rule"], f["path"], f.get("line", 0), f.get("message", ""),
                f.get("snippet", ""),
            ))
    for f in cached.get("global_findings", ()):
        findings.append(Finding(
            f["rule"], f["path"], f.get("line", 0), f.get("message", ""),
            f.get("snippet", ""),
        ))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def store(path: str, package_root: str, code_hash: str,
          hashes: Dict[str, str], findings: List[Finding],
          summaries: Dict[str, Dict[str, dict]],
          lock_graph: Optional[dict] = None) -> bool:
    """Write the cache (best effort: an unwritable scratch dir degrades to a
    cold run next time, never an error)."""
    modules: Dict[str, dict] = {
        rel: {"hash": h, "findings": [], "summaries": summaries.get(rel, {})}
        for rel, h in sorted(hashes.items())
    }
    global_findings: List[dict] = []
    for f in findings:
        entry = modules.get(f.path)
        if entry is not None:
            entry["findings"].append(f.as_dict())
        else:
            # findings anchored outside the scanned set (e.g. a stale
            # layout-contract entry reported against the registry path)
            global_findings.append(f.as_dict())
    payload = {
        "schema": SCHEMA,
        "package_root": os.path.abspath(package_root),
        "code_hash": code_hash,
        "modules": modules,
        "global_findings": global_findings,
    }
    if lock_graph is not None:
        payload["lock_graph"] = lock_graph
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
    except OSError:
        return False
    return True
