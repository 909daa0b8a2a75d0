"""Coordination-store discipline: ``coord-unbounded-wait``.

The job's ``torch.distributed`` store (a ``TCPStore`` or ``FileStore``) is the
port's cross-process transport outside the collectives, and a raw wait on it
is exactly the unbounded, un-abortable block the supervision plane exists to
eliminate. Every coordination wait routes through the supervision-aware
wrappers — ``supervision.kv_wait`` / ``supervision.kv_barrier`` — which chunk
the block so the abort sentinel is polled mid-wait, bound it by the unified
``HEAT_TPU_COORD_TIMEOUT_MS`` budget, and raise typed
``resilience.CoordinationTimeout`` / ``PeerFailed`` instead.

Statically (heat_tpu's rule, with ``Store.get`` / ``Store.wait`` /
``Store.compare_set`` in place of ``blocking_key_value_get`` /
``wait_at_barrier``):

- a call of a raw store primitive on a store-shaped receiver (a name or
  attribute named ``store`` or ``*_store``, or a call so named) OUTSIDE
  ``heat_tpu_torch.core.supervision`` is a finding — call the wrapper;
- inside ``supervision`` itself, the raw call must pass an explicit bounded
  timeout argument (the wrapper's chunked-wait contract). ``Store.wait`` takes
  one; ``get`` and ``compare_set`` take none, so each use there carries a
  pragma saying why it cannot block.

The committed baseline stays empty: there are no grandfathered raw waits.
"""

from __future__ import annotations

import ast
import re
from typing import List

from .engine import Finding, Universe, dotted_chain

#: the raw store primitives, each with the argument position of its timeout
#: (None: it takes none)
RAW_WAITS = {"get": None, "wait": 1, "compare_set": None}

#: a store-shaped name: ``store``, ``_store``, ``tcp_store``, ``_default_store``,
#: ``TCPStore`` (not ``_open_restores``)
_STORE_NAME = re.compile(r"(^|_)store$|Store$")

#: the one module allowed to touch them (the supervision-aware wrapper)
WRAPPER_MODULE = "heat_tpu_torch.core.supervision"


def _store_receiver(func: ast.Attribute) -> bool:
    recv = func.value
    if isinstance(recv, ast.Call):
        recv = recv.func
    chain = dotted_chain(recv)
    return bool(chain) and _STORE_NAME.search(chain[-1]) is not None


def _bounded(node: ast.Call, position) -> bool:
    if position is None:
        return False
    values = list(node.args[position:position + 1]) + [
        kw.value for kw in node.keywords if kw.arg in ("timeout", "timeout_ms")
    ]
    return bool(values) and not any(
        isinstance(v, ast.Constant) and v.value is None for v in values
    )


def run(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for name in sorted(uni.modules):
        mod = uni.modules[name]
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute) or func.attr not in RAW_WAITS:
                continue
            if not _store_receiver(func):
                continue
            if name != WRAPPER_MODULE:
                out.append(mod.finding(
                    "coord-unbounded-wait", node,
                    f"raw store wait {func.attr!r} outside the supervision "
                    "wrapper: route it through supervision.kv_wait/kv_barrier "
                    "so the block is bounded (HEAT_TPU_COORD_TIMEOUT_MS), "
                    "sentinel-abortable, and typed "
                    "(resilience.CoordinationTimeout/PeerFailed)",
                ))
                continue
            if not _bounded(node, RAW_WAITS[func.attr]):
                out.append(mod.finding(
                    "coord-unbounded-wait", node,
                    f"store {func.attr!r} inside the supervision wrapper without "
                    "an explicit bounded timeout (the chunked-wait contract)",
                ))
    return out
