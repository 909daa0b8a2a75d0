"""Silent-fallback ban.

heat_tpu turned its silent ``except Exception`` fallbacks into counted,
explained events (``diagnostics.record_fallback``); the port keeps them so,
and this rule holds it there. A handler catching ``Exception`` (or
everything, via a bare ``except:``) must do one of:

- re-raise (any ``raise`` inside the handler),
- account the failure through one of the sanctioned telemetry routes
  (``record_fallback`` / ``record_resilience_event`` /
  ``fallback_after_failure`` / a circuit breaker's ``record_failure``),
- or carry a pragma with a reason.

Typed handlers (``except (OSError, ValueError):``) are the preferred fix and
pass by construction. Deliberate ``except BaseException`` belt-guards around
future-delivery paths are out of scope — they exist to *propagate* errors to
waiters, and narrowing them would strand threads.
"""

from __future__ import annotations

import ast
from typing import List

from .engine import Finding, Universe, dotted_chain

ACCOUNTING_CALLS = {
    "record_fallback", "record_resilience_event", "fallback_after_failure",
    "record_failure",
}


def _catches_everything(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    if isinstance(t, ast.Name) and t.id == "Exception":
        return True
    if isinstance(t, ast.Attribute) and t.attr == "Exception":
        return True
    if isinstance(t, ast.Tuple):
        return any(
            (isinstance(e, ast.Name) and e.id == "Exception")
            or (isinstance(e, ast.Attribute) and e.attr == "Exception")
            for e in t.elts
        )
    return False


def _handler_accounts(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            chain = dotted_chain(node.func)
            if chain and chain[-1] in ACCOUNTING_CALLS:
                return True
    return False


def run(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for mod in uni.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _catches_everything(node):
                continue
            if _handler_accounts(node):
                continue
            out.append(mod.finding(
                "silent-except", node,
                "except Exception swallows the failure silently: narrow to the "
                "expected exception types, re-raise, or account it via "
                "diagnostics.record_fallback (pragma with a reason if the "
                "swallow is genuinely deliberate)",
            ))
    return out
