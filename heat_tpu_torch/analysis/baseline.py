"""Checked-in baseline for grandfathered findings.

The baseline keys findings on ``(rule, path, snippet)`` — the stripped source
line — so entries survive unrelated edits above them but go *stale* the moment
the offending line is fixed or removed. Stale entries are themselves errors
(``--check`` fails): the grandfathered set can only shrink, never silently
pad out. Regenerate with ``python -m heat_tpu_torch.analysis --write-baseline``.
"""

from __future__ import annotations

import json
from typing import List, Tuple

from .engine import Finding

SCHEMA = "heat-tpu-analysis-baseline/1"


def load(path: str) -> List[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if data.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unknown baseline schema {data.get('schema')!r}")
    return list(data.get("findings", []))


def save(path: str, findings: List[Finding]) -> None:
    payload = {
        "schema": SCHEMA,
        "findings": [
            {"rule": f.rule, "path": f.path, "snippet": f.snippet}
            for f in sorted(findings, key=lambda f: (f.path, f.rule, f.snippet))
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply(findings: List[Finding], entries: List[dict]
          ) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    """Split ``findings`` against the baseline. Returns ``(new, grandfathered,
    stale)`` where ``stale`` holds synthetic findings for baseline entries that
    matched nothing (each one means the offending code was fixed — delete the
    entry)."""
    budget: dict = {}
    for e in entries:
        key = (e.get("rule"), e.get("path"), e.get("snippet"))
        budget[key] = budget.get(key, 0) + 1
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = f.key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = [
        Finding(
            "baseline-stale", key[1] or "<baseline>", 0,
            f"baseline entry for [{key[0]}] {key[2]!r} matches no finding — "
            "the code was fixed; delete the entry (--write-baseline)",
            key[2] or "",
        )
        for key, n in sorted(budget.items(), key=lambda kv: (kv[0][1] or "", kv[0][0] or ""))
        if n > 0
        for _ in range(n)
    ]
    return new, old, stale
