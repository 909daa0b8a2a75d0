"""Machine-readable split/layout contracts for the port's dispatch layer and
the array API's call sites.

Every entry transcribes a contract the code already states in prose — the
``origin`` field cites where — into a form ``rules_layout`` can verify with
its abstract split interpreter. Change the code's contract, change the entry,
or the checker blocks the change (the same transcription discipline as
``rules_locks.LOCK_POLICY``).

Entry schema (keyed ``module:qualname``):

- ``result_split``: the allowed *claimed-split expressions* (normalized
  source text) a returned ``DNDarray(...)`` / ``wrap_result(...)`` /
  ``wrap_global(...)`` / ``rebalance(...)`` construction in this function may
  carry. The verifier collects every returned construction and checks its
  split argument against this set — catching "the code relaid the value out
  along one axis but the wrapper claims another".
- ``origin``: the prose source of the contract (docstring / doc section).

heat_tpu's entries also carry ``returns: "padded-physical"`` and
``pads: "handled"``: the port has no padded layout, so neither field exists
here (``layout-pad-mask-dropped`` does not port). Its staged forms
(``_local_jit``, ``_reduce_jit``, ``_cum_jit``) and ``_padded_reduce`` have no
entry, nor has ``_binary_jit``: the port's staged programs return local
tensors, and ``binary_op`` / ``local_op`` / ``reduce_op`` / ``cum_op``, whose
entries follow, wrap them. ``sort`` wraps through ``manipulations._wrap``.
"""

from __future__ import annotations

from typing import Dict

CONTRACTS: Dict[str, dict] = {
    # ---------------------------------------------------------------- dispatch
    "heat_tpu_torch.core._operations:wrap_result": {
        "result_split": ["split"],
        "origin": "wrap_result docstring: wraps this rank's local value with "
                  "the split it was laid out along (an out-of-range split "
                  "becomes None)",
    },
    "heat_tpu_torch.core._operations:wrap_global": {
        "result_split": ["split"],
        "origin": "wrap_global docstring: the global value, keeping this "
                  "rank's chunk along split",
    },
    "heat_tpu_torch.core._operations:rebalance": {
        "result_split": ["axis"],
        "origin": "rebalance docstring: the ranks' pieces along axis as a "
                  "split array with the canonical chunks (one redistribute)",
    },
    "heat_tpu_torch.core._operations:binary_op": {
        "result_split": ["out_split"],
        "origin": "__binary_op reference semantics: the dominant-operand "
                  "split rule (_out_split_binary) defines the output split",
    },
    "heat_tpu_torch.core._operations:local_op": {
        "result_split": ["x.split"],
        "origin": "__local_op docstring: elementwise, no communication — the "
                  "input split is preserved",
    },
    "heat_tpu_torch.core._operations:reduce_op": {
        "result_split": ["out_split"],
        "origin": "__reduce_op docstring: split bookkeeping via "
                  "_out_split_reduce (axis covering the split reduces to "
                  "None; earlier axes shift it)",
    },
    "heat_tpu_torch.core._operations:cum_op": {
        "result_split": ["x.split"],
        "origin": "__cum_op docstring: one scan along the axis, split "
                  "unchanged",
    },
    # ---------------------------------------------------------------- array API
    "heat_tpu_torch.core.signal:convolve": {
        "result_split": ["a.split"],
        "origin": "convolve: the result rides the first operand's split "
                  "(a 1-D array: 0 when distributed, else None)",
    },
    "heat_tpu_torch.core.manipulations:_wrap": {
        "result_split": ["split"],
        "origin": "manipulations' wrap helper: wrap_result of this rank's "
                  "chunk along split",
    },
    "heat_tpu_torch.core.factories:_from_global": {
        "result_split": ["split"],
        "origin": "factories' wrap helper (heat_tpu's factories._wrap): this "
                  "rank's chunk of the global value along split",
    },
    "heat_tpu_torch.core.factories:__factory": {
        "result_split": ["split"],
        "origin": "the shape factories (zeros, ones, full, empty): this "
                  "rank's chunk along split",
    },
    "heat_tpu_torch.core.random:rand": {
        "result_split": ["split"],
        "origin": "random's draws (heat_tpu's random._wrap): this rank's "
                  "chunk of the stream along split",
    },
    "heat_tpu_torch.core.random:randint": {
        "result_split": ["split"],
        "origin": "random's draws: this rank's chunk along split",
    },
    "heat_tpu_torch.core.random:standard_normal": {
        "result_split": ["split"],
        "origin": "random's draws: this rank's chunk along split",
    },
    "heat_tpu_torch.core.random:randperm": {
        "result_split": ["split"],
        "origin": "random's draws: this rank's chunk of the permutation",
    },
    "heat_tpu_torch.core.linalg.basics:_wrap_local": {
        "result_split": ["split"],
        "origin": "linalg wrap helper (heat_tpu's basics._wrap_like): this "
                  "rank's local value along split",
    },
    # ------------------------------------------------------------ checkpoint
    "heat_tpu_torch.core.checkpoint:_dndarray": {
        "result_split": ["split"],
        "origin": "checkpoint restore (heat_tpu's _restore_split_leaf and "
                  "_rebuild_tree): the restore template decides the target "
                  "split; this rank's slab is read for exactly that split",
    },
    # ------------------------------------------------------------ comm planner
    "heat_tpu_torch.core.linalg.comm_plan:try_matmul": {
        "result_split": ["split"],
        "origin": "try_matmul docstring: the planned product's local value "
                  "with the split its plan lays it out along (heat_tpu's "
                  "comm_plan._execute)",
    },
}


def contract_for(module: str, qualname: str) -> dict:
    """The contract entry for ``module:qualname`` (empty dict when none)."""
    return CONTRACTS.get(f"{module}:{qualname}", {})
