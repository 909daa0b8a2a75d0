"""Donation and collective discipline.

- ``donation-uncontracted``: a donated leaf's storage is overwritten by the
  program that consumes it. The only code allowed to claim a donation or to
  write into a donated leaf lives in ``_executor.py``, where every claim goes
  through the per-buffer ownership registry (``_acquire_buffers``) and the
  refcount contract in ``sanitation.py`` (``sanitize_leaf_donation``). A claim,
  a write into a donated leaf (``_donate_into``) or a ``donate_leaves=`` request
  elsewhere has no such proof and can overwrite a tensor a live DNDarray still
  wraps. (heat_tpu's form of the same contract is ``donate_argnums`` outside
  ``_executor.py``.)

- ``collective-uncontracted``: every ``torch.distributed`` collective of the
  port goes through ``TorchCommunication`` in ``communication.py``, so it is
  (a) recorded in ``ht.diagnostics`` (op, participants, bytes — the
  observability contract) and (b) guarded by the supervision, resilience,
  telemetry, forensics and profiler planes through ``_guarded``. A direct
  ``torch.distributed.all_reduce`` elsewhere is invisible to all of them; call
  the corresponding ``comm`` method instead. The process group's lifecycle
  (``init_process_group``, ``destroy_process_group``, ``new_group``) is not a
  collective of this set: supervision and communication make and tear down
  the group.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .engine import Finding, ModuleIndex, Universe, dotted_chain

DONATION_HOME = "heat_tpu_torch.core._executor"
COLLECTIVE_HOME = "heat_tpu_torch.core.communication"

#: calls that claim a donation or write into a donated leaf's storage
DONATION_CALLS = frozenset({"_acquire_buffers", "_donate_into"})
#: the program-call keyword that asks for leaf donation
DONATION_KEYWORDS = frozenset({"donate_leaves"})

#: the torch.distributed calls that move data or synchronise the ranks
WRAPPED_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast", "gather", "scatter",
    "send", "recv", "isend", "irecv", "batch_isend_irecv", "P2POp",
    "barrier", "monitored_barrier", "all_gather_object", "broadcast_object_list",
})

DIST_MODULE = "torch.distributed"


def dist_call(mod: ModuleIndex, call: ast.Call) -> Optional[str]:
    """The name of the ``torch.distributed`` function ``call`` invokes, or None:
    ``torch.distributed.x(...)``, ``dist.x(...)`` under ``import
    torch.distributed as dist``, or ``x(...)`` under ``from torch.distributed
    import x``."""
    chain = dotted_chain(call.func)
    if not chain:
        return None
    if len(chain) == 1:
        target = mod.func_imports.get(chain[0])
        return target[1] if target and target[0] == DIST_MODULE else None
    base = mod.module_aliases.get(chain[0])
    if base is None:
        return None
    receiver = ".".join((base,) + chain[1:-1])
    return chain[-1] if receiver == DIST_MODULE else None


def run(uni: Universe) -> List[Finding]:
    out: List[Finding] = []
    for mod in uni.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if mod.name != DONATION_HOME:
                chain = dotted_chain(node.func)
                name = chain[-1] if chain else (
                    node.func.attr if isinstance(node.func, ast.Attribute) else None
                )
                asked = [kw.arg for kw in node.keywords if kw.arg in DONATION_KEYWORDS]
                if name in DONATION_CALLS or asked:
                    what = name if name in DONATION_CALLS else f"{asked[0]}="
                    out.append(mod.finding(
                        "donation-uncontracted", node,
                        f"{what} outside _executor.py: a donation must be claimed "
                        "in the executor's ownership registry and pass the "
                        "sanitation refcount contract (sanitize_leaf_donation)",
                    ))
            if mod.name != COLLECTIVE_HOME:
                op = dist_call(mod, node)
                if op in WRAPPED_COLLECTIVES:
                    out.append(mod.finding(
                        "collective-uncontracted", node,
                        f"direct torch.distributed.{op} outside communication.py: "
                        "route it through a TorchCommunication method so the "
                        "collective is diagnostics-recorded and guarded by the "
                        "supervision and resilience planes",
                    ))
    return out
