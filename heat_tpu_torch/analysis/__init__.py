"""``heat_tpu_torch.analysis`` — the port's invariant checker.

heat_tpu's stdlib-only static analysis (``heat_tpu/analysis/``), retargeted at
the PyTorch/CUDA port: it turns the prose invariants the port's modules state —
collectives confined to ``communication.py``, no silent fallback, the
locked-vs-relaxed thread-safety policy of the serving threads' state, the
stdlib-only-at-load planes, collective sequences that are the same on every
rank, capture bodies free of host state — into blocking rules. It keeps
heat_tpu's flags, exit-status contract, rule ids and schemas (report
``heat-tpu-analysis/1``, baseline ``heat-tpu-analysis-baseline/1``) and imports
only the stdlib: nothing of torch, numpy, jax or heat_tpu.

Run it as a separate process (``heat_tpu_torch/__init__.py`` does not import
this package, so the checker adds no runtime cost)::

    python -m heat_tpu_torch.analysis [--check] [--baseline P] [--explain RULE]
                                      [--json P] [--dump-lockgraph P] [--root P]
                                      [--no-cache] [--cache P]
                                      [--fix-unused-pragmas [--write]]

It scans ``heat_tpu_torch/`` and the repository's ``chip_smoke.py`` against
``analysis_baseline_torch.json``; the lock graph is committed at
``doc/source/_static/lock_graph_torch.json`` (and ``.dot``).

How each of heat_tpu's rule families maps onto the port:

==============================  ==================================================
heat_tpu (JAX)                  port
==============================  ==================================================
``TRACE_ENTRIES``: ``jax.jit``, capture bodies, where host code runs once and is
``shard_map``, ``lax.scan``,    frozen into every replay: the body of ``with
``pallas_call``, ...            torch.cuda.graph(...)``; the statements between
                                ``capture_begin()`` and ``capture_end()``; the
                                functions passed to
                                ``torch.cuda.make_graphed_callables``,
                                ``torch.compile``, ``torch.jit.trace``/``script``,
                                ``torch.fx.symbolic_trace`` or
                                ``torch.export.export`` (or decorated by one).
                                ``torch.func.vmap`` runs its body on every call
                                and freezes nothing: no entry.
the ``build`` convention        only ``build`` callbacks handed to the executor's
                                ``lookup`` (directly, or returned by a factory
                                such as ``_plan_build``); not the kernels'
                                compiler ``_nvcc.build``
``TRACE_ONLY_PRIMITIVES``       none: every torch op runs eagerly too
``collective-uncontracted``:    ``torch.distributed`` collectives outside
``jax.lax.psum``/...            ``communication.py``: ``all_reduce``,
                                ``all_gather``, ``all_gather_into_tensor``,
                                ``reduce_scatter_tensor``, ``all_to_all_single``,
                                ``broadcast``, ``gather``, ``scatter``, ``send``,
                                ``recv``, ``isend``, ``irecv``,
                                ``batch_isend_irecv``, ``P2POp``, ``barrier``,
                                ``monitored_barrier``, ``all_gather_object``,
                                ``broadcast_object_list`` (the process group's
                                lifecycle is not in the set)
``coord-unbounded-wait``:       a raw ``Store.get`` / ``Store.wait`` /
``blocking_key_value_get``,     ``Store.compare_set`` outside
``wait_at_barrier``             ``supervision.py``, or one there without a
                                bounded timeout
``donation-uncontracted``:      ``_acquire_buffers``, ``_donate_into`` or a
``donate_argnums``              ``donate_leaves=`` request outside
                                ``_executor.py``
SPMD sites: MeshCommunication   ``TorchCommunication``'s ``@_collective``
methods; taint:                 methods and ``_guarded(site, ...)``, raw
``jax.process_index()``,        ``torch.distributed`` collectives,
``_is_writer``, ``comm.rank``   ``supervision.kv_barrier``; taint:
                                ``dist.get_rank()``, ``comm.rank``, ``self.rank``
                                in communication.py, ``os.environ["RANK"]`` /
                                ``["LOCAL_RANK"]``, ``_is_writer``. Deviation: a
                                tuple assignment of a tuple display taints
                                element by element
``comm.shard(v, S)`` in the     the port's relayouts: ``_relayout``,
layout rules                    ``redistribute``, ``rebalance``, ``wrap_global``
``layout-pad-mask-dropped``     does not port: no padded layout (``--explain``
                                says why)
``layout_contracts.py``         the same contracts keyed by the port's functions
``LOCK_POLICY`` / class         the same policies keyed by the port's modules;
policies                        a name the port lacks is ``lock-policy-stale``
``STDLIB_ONLY``                 diagnostics, profiler, resilience, _scheduler,
                                telemetry, supervision, ops, forensics and this
                                package: no torch or numpy at load; and
                                ``import-jax``: no jax or heat_tpu anywhere
``silent-except``, pragmas,     the same, with the port's accounting calls
baseline staleness, the cache,  (``record_fallback``, ``record_resilience_event``,
``--fix-unused-pragmas``        ``fallback_after_failure``, ``record_failure``)
==============================  ==================================================

Suppressions are per-line pragmas with a mandatory reason, written
``# ht: ignore[<rule-id>] -- why this is safe`` on the offending line (angle
brackets stand for the actual rule id). An unused pragma is itself an error,
and so is a baseline entry that no longer matches a finding — the suppression
surface can only shrink.
"""

from .engine import Finding, run_analysis  # noqa: F401  (stdlib-only)
from .rules import RULES, explain  # noqa: F401

__all__ = ["Finding", "run_analysis", "RULES", "explain"]
