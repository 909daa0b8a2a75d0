"""Per-line pragma suppressions: ``# ht: ignore[<rule-id>] -- reason``.

A pragma lives on the finding's own line (for multi-line statements: the line
the checker reports, i.e. the AST node's ``lineno``). Several rules may be
listed comma-separated. The ``-- reason`` is mandatory — a suppression without
a recorded justification is itself a finding (``pragma-no-reason``), and a
pragma that suppresses nothing is dead weight that would silently grandfather
a future regression, so it is a finding too (``pragma-unused``). Unknown rule
ids fail as ``pragma-unknown-rule`` rather than silently never matching.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from .engine import Finding, ModuleIndex

_PRAGMA_RE = re.compile(
    r"#\s*ht:\s*ignore\[(?P<rules>[a-zA-Z0-9_,\s-]+)\]"
    r"(?:\s*--\s*(?P<reason>\S.*))?"
)


class Pragma:
    __slots__ = ("line", "rules", "reason", "used")

    def __init__(self, line: int, rules: List[str], reason: str):
        self.line = line
        self.rules = rules
        self.reason = reason
        self.used: set = set()  # rule ids that actually suppressed a finding


def collect(mod: ModuleIndex) -> Dict[int, Pragma]:
    table: Dict[int, Pragma] = {}
    for i, text in enumerate(mod.lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        table[i] = Pragma(i, rules, (m.group("reason") or "").strip())
    return table


def suppressed(table: Dict[int, Pragma], finding: Finding) -> bool:
    pragma = table.get(finding.line)
    if pragma is None or finding.rule not in pragma.rules:
        return False
    if not pragma.reason:
        return False  # a reasonless pragma suppresses nothing
    pragma.used.add(finding.rule)
    return True


def misuse_findings(mod: ModuleIndex, table: Dict[int, Pragma]) -> List[Finding]:
    from .rules import RULES

    out: List[Finding] = []
    for pragma in table.values():
        snippet = mod.snippet(pragma.line)
        if not pragma.reason:
            out.append(Finding(
                "pragma-no-reason", mod.rel_path, pragma.line,
                "pragma has no '-- reason'; justifications are mandatory",
                snippet,
            ))
            continue
        for rule in pragma.rules:
            if rule not in RULES:
                out.append(Finding(
                    "pragma-unknown-rule", mod.rel_path, pragma.line,
                    f"pragma names unknown rule {rule!r}", snippet,
                ))
            elif rule not in pragma.used:
                out.append(Finding(
                    "pragma-unused", mod.rel_path, pragma.line,
                    f"pragma for {rule!r} suppresses nothing — remove it",
                    snippet,
                ))
    return out


# ---------------------------------------------------------------------------
# mechanical removal of unused pragmas (python -m heat_tpu_torch.analysis
# --fix-unused-pragmas [--write])

_RULE_IN_MESSAGE = re.compile(r"pragma for '([^']+)' suppresses nothing")


def plan_unused_removals(findings, repo_root: str):
    """Turn ``pragma-unused`` findings into file edits. Returns a list of
    ``(abs_path, line_no, old_line, new_line)`` — ``new_line`` is None when
    the whole line should be deleted (it held nothing but the pragma).

    Unused rule ids are dropped from the pragma's rule list; a pragma whose
    every rule is unused is removed outright. ``pragma-no-reason`` /
    ``pragma-unknown-rule`` are NOT touched: those need a human to supply
    the missing reason or the right rule id."""
    by_site = {}
    for f in findings:
        if f.rule != "pragma-unused":
            continue
        m = _RULE_IN_MESSAGE.search(f.message)
        if not m:
            continue
        by_site.setdefault((f.path, f.line), set()).add(m.group(1))
    edits = []
    for (rel_path, line_no), dead_rules in sorted(by_site.items()):
        path = os.path.join(repo_root, rel_path)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                lines = fh.read().splitlines(keepends=True)
        except OSError:
            continue
        if not (1 <= line_no <= len(lines)):
            continue
        old = lines[line_no - 1]
        m = _PRAGMA_RE.search(old)
        if not m:
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        kept = [r for r in rules if r not in dead_rules]
        if kept:
            reason = (m.group("reason") or "").strip()
            replacement = f"# ht: ignore[{', '.join(kept)}]"
            if reason:
                replacement += f" -- {reason}"
            new = old[: m.start()] + replacement + old[m.end():]
        else:
            new = (old[: m.start()] + old[m.end():]).rstrip() \
                + ("\n" if old.endswith("\n") else "")
            if not new.strip():
                new = None  # the line held only the pragma: delete it
        edits.append((path, line_no, old, new))
    return edits


def apply_removals(edits) -> int:
    """Apply :func:`plan_unused_removals` edits; returns lines changed."""
    by_file = {}
    for path, line_no, old, new in edits:
        by_file.setdefault(path, []).append((line_no, old, new))
    changed = 0
    for path, file_edits in by_file.items():
        with open(path, "r", encoding="utf-8") as fh:
            lines = fh.read().splitlines(keepends=True)
        for line_no, old, new in sorted(file_edits, reverse=True):
            if lines[line_no - 1] != old:
                continue  # the file moved underneath us: skip, never corrupt
            if new is None:
                del lines[line_no - 1]
            else:
                lines[line_no - 1] = new
            changed += 1
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("".join(lines))
    return changed
