"""Self-check of ``heat_tpu_torch.analysis``, the port's invariant checker, in the
layers of ``tests/test_analysis.py``:

- **rule fixtures** — every rule family has a violating and a conforming snippet in
  torch idiom, compiled through a throwaway package tree whose root is named
  ``heat_tpu_torch``, so the lock policy, the import contract and the donation,
  collective and store homes line up with the real module names; several of them are
  also run through heat_tpu's checker, which misses them: the mapping is what finds
  them;
- **pragma and baseline round-trips**;
- **the whole-tree gate** — the port's tree and ``chip_smoke.py`` are clean against
  ``analysis_baseline_torch.json``, and the lock graph equals the committed
  ``doc/source/_static/lock_graph_torch.json`` and is acyclic;
- **the runtime import contract** — the stdlib-only modules load by file path under a
  ``sys.meta_path`` hook that raises on torch, numpy or jax;
- **the CLI**, the incremental cache and ``--fix-unused-pragmas``;
- **parity with heat_tpu's checker** on a rule-neutral fixture;
- **the repairs** its first run found (the kernels' launch counters, the result
  cache's host-hash tally).
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest

from heat_tpu_torch.analysis import baseline as baseline_mod
from heat_tpu_torch.analysis import rules
from heat_tpu_torch.analysis.__main__ import REPORT_SCHEMA, main
from heat_tpu_torch.analysis.engine import Finding, run_analysis
from heat_tpu_torch.analysis.rules_locks import lock_graph_payload

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(root, package, files):
    pkg = os.path.join(str(root), package)
    for rel, src in files.items():
        path = os.path.join(pkg, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(textwrap.dedent(src))
    return pkg


def run_fixture(tmp_path, files):
    """The port's checker over a throwaway ``heat_tpu_torch`` tree of ``files``
    (paths relative to the package root)."""
    findings, _ = run_analysis(package_root=write_tree(tmp_path, "heat_tpu_torch", files), extra_files=[])
    return findings


def run_reference(tmp_path, files):
    """heat_tpu's checker over the same files under a ``heat_tpu`` root."""
    from heat_tpu.analysis.engine import run_analysis as ref_run

    findings, _ = ref_run(package_root=write_tree(tmp_path / "ref", "heat_tpu", files), extra_files=[])
    return findings


def rule_ids(findings):
    return sorted({f.rule for f in findings})


# ----------------------------------------------------------------- capture purity
GRAPH_BAD = """
    import os
    import time
    import torch

    def capture(g, x):
        with torch.cuda.graph(g):
            if os.environ.get("KNOB"):
                x = x + 1
            time.time()
            y = x * 2
        return y
"""
GRAPH_GOOD = """
    import os
    import time
    import torch

    KNOB = os.environ.get("KNOB")  # host-side, at import

    def capture(g, x):
        t0 = time.time()  # around the capture, not in it
        with torch.cuda.graph(g):
            y = x * 2
        return y, t0
"""


def test_env_read_and_time_call_in_cuda_graph_body(tmp_path):
    ids = rule_ids(run_fixture(tmp_path, {"core/x.py": GRAPH_BAD}))
    assert "trace-env-read" in ids and "trace-time-call" in ids
    good = rule_ids(run_fixture(tmp_path / "good", {"core/x.py": GRAPH_GOOD}))
    assert "trace-env-read" not in good and "trace-time-call" not in good
    # heat_tpu's checker seeds from jax.jit and never sees the graph body
    ref = rule_ids(run_reference(tmp_path, {"core/x.py": GRAPH_BAD}))
    assert "trace-env-read" not in ref and "trace-time-call" not in ref


def test_capture_begin_end_region_and_what_it_calls(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        import time

        def stamp():
            return time.perf_counter()

        def capture(graph, body, x):
            graph.capture_begin()
            out = body(x)
            stamp()
            graph.capture_end()
            time.perf_counter()  # after the capture: host code again
            return out
    """})
    assert [(f.rule, f.line) for f in bad if f.rule == "trace-time-call"] == [("trace-time-call", 5)]


def test_functions_handed_to_torch_compile_and_jit(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        import torch

        _memo = {}

        def body(v):
            import os
            _memo[1] = v
            return v

        @torch.compile
        def decorated(v):
            global _state
            _state = 1
            return v

        def stage():
            return torch.compile(body), torch.jit.trace(lambda v: v, (1,))
    """})
    ids = rule_ids(bad)
    assert {"trace-lazy-import", "trace-global-write"} <= set(ids)
    assert len([f for f in bad if f.rule == "trace-global-write"]) == 2
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        import torch

        def body(v):
            local = {}
            local[1] = v
            return v

        def stage():
            return torch.compile(body)
    """})
    assert "trace-global-write" not in rule_ids(good)


def test_vmap_is_no_capture_entry(tmp_path):
    # torch.func.vmap runs its body on every call: nothing is frozen
    out = run_fixture(tmp_path, {"core/x.py": """
        import os
        import torch

        def body(v):
            return v if os.environ.get("KNOB") else -v

        def batched(x):
            return torch.func.vmap(body)(x)
    """})
    assert "trace-env-read" not in rule_ids(out)


def test_unguarded_telemetry_in_capture_body(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        import torch
        from . import diagnostics

        def capture(g, x):
            with torch.cuda.graph(g):
                diagnostics.counter("ops")
                return x * 2
    """})
    assert "trace-telemetry-unguarded" in rule_ids(bad)
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        import torch
        from . import diagnostics

        def capture(g, x):
            with torch.cuda.graph(g):
                if diagnostics._enabled:
                    diagnostics.counter("ops")
                return x * 2
    """})
    assert "trace-telemetry-unguarded" not in rule_ids(good)


LOOKUP_FILES = {
    "core/_executor.py": """
        def lookup(key, build, label=None, spec=None):
            return build()
    """,
    "core/x.py": """
        import time
        from . import _executor

        def staged(key):
            def build():
                def body(v):
                    time.monotonic()
                    return v
                return body, None, "staged", {}

            return _executor.lookup(key, build)
    """,
    "core/kernels/_nvcc.py": """
        import time

        def build(source):
            def loader():
                time.perf_counter()
                return source
            return loader
    """,
}


def test_build_convention_seeds_only_lookup_callbacks(tmp_path):
    out = [f for f in run_fixture(tmp_path, LOOKUP_FILES) if f.rule == "trace-time-call"]
    # the program body handed to the executor's lookup is seeded; the compiler's
    # build, which heat_tpu's convention would take for a program factory, is not
    assert [f.path for f in out] == ["heat_tpu_torch/core/x.py"]
    ref = [f.path for f in run_reference(tmp_path, LOOKUP_FILES) if f.rule == "trace-time-call"]
    assert "heat_tpu/core/kernels/_nvcc.py" in ref


def test_build_returned_by_a_factory_is_seeded(tmp_path):
    out = run_fixture(tmp_path, {"core/_executor.py": """
        import time

        def lookup(key, build):
            return build()

        def _plan_build(plan):
            def build():
                def body(v):
                    time.monotonic()
                    return v
                return body, None, "defer", {}
            return build

        def force(plan):
            return lookup(plan, _plan_build(plan))
    """})
    assert "trace-time-call" in rule_ids(out)


# ----------------------------------------------------------------- locks
DIAG_BAD = """
    import threading

    _lock = threading.RLock()
    _counters = {}

    def bump():
        _counters["x"] = 1
"""
DIAG_GOOD = """
    import threading

    _lock = threading.RLock()
    _counters = {}

    def bump():
        with _lock:
            _counters["x"] = 1

    def _fold_locked():
        _counters["y"] = 2  # _locked suffix: caller holds the lock
"""


def test_unlocked_write_to_locked_diagnostics_state(tmp_path):
    assert "lock-unlocked-write" in rule_ids(run_fixture(tmp_path, {"core/diagnostics.py": DIAG_BAD}))
    assert "lock-unlocked-write" not in rule_ids(run_fixture(tmp_path / "good", {"core/diagnostics.py": DIAG_GOOD}))


def test_racing_increment(tmp_path):
    bad = run_fixture(tmp_path, {"core/kernels/k.py": """
        import types

        launches = 0
        other = types.SimpleNamespace(launches=0)

        def launch():
            global launches
            launches += 1
            other.launches += 1
    """})
    assert len([f for f in bad if f.rule == "lock-racing-increment"]) == 2
    good = run_fixture(tmp_path / "good", {"core/kernels/k.py": """
        import threading
        import types

        _count_lock = threading.Lock()
        launches = 0
        other = types.SimpleNamespace(launches=0)

        def launch():
            global launches
            with _count_lock:
                launches += 1
                other.launches += 1
    """})
    assert "lock-racing-increment" not in rule_ids(good)


def test_lock_order_cycle(tmp_path):
    files = {
        "core/diagnostics.py": """
            import threading
            from . import profiler

            _lock = threading.RLock()

            def a():
                with _lock:
                    profiler.pb()

            def pa():
                with _lock:
                    pass
        """,
        "core/profiler.py": """
            import threading
            from . import diagnostics

            _lock = threading.RLock()

            def pb():
                with _lock:
                    pass

            def b():
                with _lock:
                    diagnostics.pa()
        """,
    }
    assert "lock-order-cycle" in rule_ids(run_fixture(tmp_path, files))
    files["core/profiler.py"] = """
        import threading

        _lock = threading.RLock()

        def pb():
            with _lock:
                pass
    """
    assert "lock-order-cycle" not in rule_ids(run_fixture(tmp_path / "good", files))


def test_lock_policy_names_a_global_the_module_lacks(tmp_path):
    out = run_fixture(tmp_path, {"core/_compile_cache.py": """
        import threading

        _lock = threading.Lock()
        _dir = None
        _index = None
    """})
    stale = sorted(f.snippet for f in out if f.rule == "lock-policy-stale")
    assert stale == ["heat_tpu_torch.core._compile_cache:_index_rejected"]


# ----------------------------------------------------------------- imports
def test_toplevel_torch_in_a_stdlib_only_plane(tmp_path):
    bad = run_fixture(tmp_path, {"core/resilience.py": """
        import json
        import torch
    """})
    assert "import-nonstdlib" in rule_ids(bad)
    good = run_fixture(tmp_path / "good", {"core/resilience.py": """
        import json

        try:
            from . import diagnostics
        except ImportError:
            diagnostics = None

        def probe():
            import torch  # lazy: sanctioned
            return torch
    """})
    assert "import-nonstdlib" not in rule_ids(good)


def test_no_module_imports_jax_or_heat_tpu(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        def f():
            import jax.numpy as jnp
            from heat_tpu.core import dndarray
            return jnp, dndarray
    """})
    assert len([f for f in bad if f.rule == "import-jax"]) == 2
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        import torch
        from heat_tpu_torch.core import dndarray
    """})
    assert "import-jax" not in rule_ids(good)


# ----------------------------------------------------------------- fallbacks
def test_silent_except_vs_typed_vs_accounted(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        def f():
            try:
                return 1
            except Exception:
                return None
    """})
    assert "silent-except" in rule_ids(bad)
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        from . import diagnostics

        def typed():
            try:
                return 1
            except (OSError, ValueError):
                return None

        def reraises():
            try:
                return 1
            except Exception as exc:
                raise RuntimeError("wrapped") from exc

        def accounted(breaker):
            try:
                return 1
            except Exception as exc:
                diagnostics.record_fallback("site", str(exc))
                breaker.record_failure(str(exc))
                return None
    """})
    assert "silent-except" not in rule_ids(good)


# ----------------------------------------------------------------- donation, collectives, store
def test_donation_outside_the_executor(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        from . import _executor

        def f(prog, leaves):
            _executor._acquire_buffers(list(leaves), leaves)
            return prog(*leaves, donate_leaves=(0,))
    """})
    assert len([f for f in bad if f.rule == "donation-uncontracted"]) == 2
    good = run_fixture(tmp_path / "good", {"core/_executor.py": """
        def _acquire_buffers(read_leaves, donate_leaves):
            return donate_leaves

        def f(prog, leaves):
            granted = _acquire_buffers(list(leaves), leaves)
            return prog(*leaves, donate_leaves=tuple(range(len(granted))))
    """})
    assert "donation-uncontracted" not in rule_ids(good)


COLLECTIVE_BAD = """
    import torch
    import torch.distributed as dist
    from torch.distributed import all_gather

    def f(x, xs):
        torch.distributed.all_reduce(x)
        dist.barrier()
        all_gather(xs, x)
        dist.init_process_group("gloo")  # the group's lifecycle, not a collective
"""


def test_torch_distributed_collective_outside_communication(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": COLLECTIVE_BAD})
    assert [f.line for f in bad if f.rule == "collective-uncontracted"] == [7, 8, 9]
    good = run_fixture(tmp_path / "good", {"core/communication.py": COLLECTIVE_BAD})
    assert "collective-uncontracted" not in rule_ids(good)
    # heat_tpu's checker looks only for jax.lax collectives
    assert "collective-uncontracted" not in rule_ids(run_reference(tmp_path, {"core/x.py": COLLECTIVE_BAD}))


def test_raw_store_wait_outside_supervision(tmp_path):
    bad_src = """
        import datetime

        def wait(store, key):
            store.wait([key])
            return store.get(key)
    """
    bad = run_fixture(tmp_path, {"core/checkpoint.py": bad_src})
    assert len([f for f in bad if f.rule == "coord-unbounded-wait"]) == 2
    assert "coord-unbounded-wait" not in rule_ids(run_reference(tmp_path, {"core/checkpoint.py": bad_src}))
    inside = run_fixture(tmp_path / "inside", {"core/supervision.py": """
        import datetime

        def bounded(store, key, ms):
            store.wait([key], datetime.timedelta(milliseconds=ms))

        def unbounded(store, key):
            store.wait([key])

        def restores(_open_restores, d):
            return _open_restores.get(d, 0)  # a dict, not a store
    """})
    assert [f.line for f in inside if f.rule == "coord-unbounded-wait"] == [8]


# ----------------------------------------------------------------- SPMD
COMM_RING = """
    class TorchCommunication:
        def ring(self, block):
            size, rank = self.size, self.rank
            for i in range(size):
                block = self.ring_shift(block, 1)
            return block

        def by_rank(self, block):
            rank = self.rank
            for i in range(rank):
                block = self.ring_shift(block, 1)
            return block
"""


def test_tuple_unpacked_size_and_rank(tmp_path):
    out = run_fixture(tmp_path, {"core/communication.py": COMM_RING})
    # `size, rank = self.size, self.rank` taints rank alone: the loop over size is
    # the same on every rank, the loop over rank is not
    assert [f.line for f in out if f.rule == "spmd-divergent-collective"] == [11]
    # heat_tpu's engine taints the whole tuple target: the loop over size too
    ref = run_reference(tmp_path, {"core/communication.py": COMM_RING})
    assert [f.line for f in ref if f.rule == "spmd-divergent-collective"] == [5, 11]


def test_rank_guarded_collectives(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        import os
        import torch.distributed as dist

        def guarded(comm, x):
            if dist.get_rank() == 0:
                comm.all_reduce(x)
            return x

        def by_env(comm, x):
            if int(os.environ["RANK"]) > 0:
                return x
            return comm.bcast(x)

        def in_handler(comm, x):
            try:
                return x.item()
            except ValueError:
                return comm.all_gather_stacked(x)
    """})
    assert [(f.rule, f.line) for f in bad if f.rule.startswith("spmd")] == [
        ("spmd-divergent-collective", 6),
        ("spmd-divergent-collective", 11),
        ("spmd-collective-in-except", 19),
    ]
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        def symmetric(comm, x, flag):
            if comm.agree_min(flag):  # the same answer on every rank
                comm.all_reduce(x)
            if comm.rank == 0:
                x = x + 1  # host-local work only
            for lo, hi in ((0, comm.rank), (comm.rank, 9)):  # two passes on every rank
                comm.all_reduce(x[lo:hi])
            return comm.all_reduce(x)
    """})
    assert not [f for f in good if f.rule.startswith("spmd")]


# ----------------------------------------------------------------- layout
def test_relayout_claim_mismatch_and_roundtrip(tmp_path):
    bad = run_fixture(tmp_path, {"core/x.py": """
        from .dndarray import DNDarray
        from ._operations import wrap_global
        def gathered(x):
            v = x._relayout(None)
            return DNDarray(v, x.gshape, x.dtype, 0, x.device, x.comm, True)

        def twice(x, comm, counts, dst):
            v = x._relayout(0)
            return comm.redistribute(v, x.gshape, 1, counts, dst)

        def chunk_as_global(x):
            v = x._relayout(0)
            return wrap_global(v, x, 0)  # wrap_global wants the whole value
    """})
    assert [(f.rule, f.line) for f in bad] == [
        ("layout-shard-claim-mismatch", 6), ("layout-resplit-roundtrip", 10), ("layout-shard-claim-mismatch", 14)
    ]
    good = run_fixture(tmp_path / "good", {"core/x.py": """
        from .dndarray import DNDarray
        from ._operations import wrap_global

        def gathered(x):
            v = x._relayout(None)
            return DNDarray(v, x.gshape, x.dtype, None, x.device, x.comm, True)

        def chunk_of_global(x):
            v = x._relayout(None)
            return wrap_global(v, x, 0)  # keeps this rank's chunk: no mismatch
    """})
    assert not [f for f in good if f.rule.startswith("layout")]


def test_layout_contract_and_staleness(tmp_path):
    bad = run_fixture(tmp_path, {"core/signal.py": """
        from .dndarray import DNDarray

        def convolve(a, v):
            res = a
            res = DNDarray(res.larray, res.gshape, a.dtype, 0, a.device, a.comm, True)
            return res
    """})
    assert "layout-contract" in rule_ids(bad)
    good = run_fixture(tmp_path / "good", {"core/signal.py": """
        from .dndarray import DNDarray

        def convolve(a, v):
            res = DNDarray(a.larray, a.gshape, a.dtype, a.split, a.device, a.comm, True)
            return res
    """})
    assert "layout-contract" not in rule_ids(good)
    stale = run_fixture(tmp_path / "stale", {"core/signal.py": """
        def correlate(a, v):
            return a
    """})
    assert [f.snippet for f in stale if f.rule == "layout-contract-stale"] == ["heat_tpu_torch.core.signal:convolve"]


def test_pad_mask_rule_is_not_ported():
    assert "layout-pad-mask-dropped" not in rules.RULES
    text = rules.explain("layout-pad-mask-dropped")
    assert "Not a rule of the port" in text and "no padded layout" in text
    assert main(["--explain", "layout-pad-mask-dropped"]) == 0


# ----------------------------------------------------------------- the mapping finds them
@pytest.mark.parametrize(
    "files, rule",
    [
        ({"core/x.py": COLLECTIVE_BAD}, "collective-uncontracted"),
        ({"core/x.py": GRAPH_BAD}, "trace-env-read"),
        ({"core/x.py": GRAPH_BAD}, "trace-time-call"),
        ({"core/checkpoint.py": "def wait(store, key):\n    store.wait([key])\n"}, "coord-unbounded-wait"),
        ({"core/resilience.py": "import json\nimport torch\n"}, "import-nonstdlib"),
        ({"core/diagnostics.py": DIAG_BAD}, "lock-unlocked-write"),
    ],
    ids=["torch-distributed-collective", "graph-env-read", "graph-time-call", "raw-store-wait",
         "torch-in-stdlib-plane", "unlocked-diagnostics-write"],
)
def test_the_mapping_is_what_finds_it(tmp_path, files, rule):
    """The port's checker finds each violation; heat_tpu's checker, run over the very
    same ``heat_tpu_torch`` tree, does not: its entries, policies and homes name
    heat_tpu's modules and JAX's calls."""
    from heat_tpu.analysis.engine import run_analysis as ref_run

    pkg = write_tree(tmp_path, "heat_tpu_torch", files)
    assert rule in rule_ids(run_analysis(package_root=pkg, extra_files=[])[0])
    assert rule not in rule_ids(ref_run(package_root=pkg, extra_files=[])[0])


# ----------------------------------------------------------------- pragmas, baseline
BAD_BODY = """
    def f():
        try:
            return 1
        except Exception:{pragma}
            return None
"""


@pytest.mark.parametrize(
    "pragma, expected",
    [
        ("  # ht: ignore[silent-except] -- fixture: deliberate swallow", []),
        ("  # ht: ignore[silent-except]", ["pragma-no-reason", "silent-except"]),
        ("  # ht: ignore[no-such-rule] -- whatever", ["pragma-unknown-rule", "silent-except"]),
        ("  # ht: ignore[import-jax] -- nothing of jax here", ["pragma-unused", "silent-except"]),
    ],
    ids=["reasoned", "reasonless", "unknown-rule", "unused"],
)
def test_pragmas(tmp_path, pragma, expected):
    out = run_fixture(tmp_path, {"core/x.py": BAD_BODY.format(pragma=pragma)})
    assert rule_ids(out) == expected


def test_baseline_round_trip_staleness_and_schema(tmp_path):
    path = str(tmp_path / "baseline.json")
    found = [Finding("silent-except", "heat_tpu_torch/core/x.py", 4, "msg", "except Exception:")]
    baseline_mod.save(path, found)
    entries = baseline_mod.load(path)
    assert [len(part) for part in baseline_mod.apply(found, entries)] == [0, 1, 0]
    # a finding that moved lines stays grandfathered
    drifted = [Finding("silent-except", "heat_tpu_torch/core/x.py", 400, "msg", "except Exception:")]
    assert [len(part) for part in baseline_mod.apply(drifted, entries)] == [0, 1, 0]
    # the offending line was fixed: the entry goes stale and fails
    new, old, stale = baseline_mod.apply([], entries)
    assert (new, old, [f.rule for f in stale]) == ([], [], ["baseline-stale"])
    with open(path, "w") as fh:
        json.dump({"schema": "bogus/9", "findings": []}, fh)
    with pytest.raises(ValueError, match="unknown baseline schema"):
        baseline_mod.load(path)


# ----------------------------------------------------------------- the whole tree
@pytest.fixture(scope="module")
def whole_tree():
    return run_analysis()


def test_tree_is_clean_against_committed_baseline(whole_tree):
    findings, uni = whole_tree
    assert "chip_smoke" in uni.modules and "heat_tpu_torch.analysis.engine" in uni.modules
    entries = baseline_mod.load(os.path.join(REPO_ROOT, "analysis_baseline_torch.json"))
    assert entries == []
    new, _, stale = baseline_mod.apply(findings, entries)
    assert new + stale == [], "\n".join(f.render() for f in new + stale)


def test_first_run_repairs_hold(whole_tree):
    """The repairs of the first run are fixes, not pragmas: no racing increment in the
    kernels or the result cache, and convolve claims its operand's split."""
    _, uni = whole_tree
    fixed = {
        "heat_tpu_torch/core/kernels/flash_attention.py", "heat_tpu_torch/core/kernels/kmeans.py",
        "heat_tpu_torch/core/_result_cache.py", "heat_tpu_torch/core/signal.py",
    }
    rules_fixed = {"lock-racing-increment", "lock-unlocked-write", "layout-contract"}
    assert not [f.render() for f in uni.suppressed if f.path in fixed and f.rule in rules_fixed]


def test_lock_graph_matches_committed_artifact_and_is_acyclic(whole_tree):
    _, uni = whole_tree
    payload = lock_graph_payload(uni)
    assert payload["cycles"] == []
    with open(os.path.join(REPO_ROOT, "doc", "source", "_static", "lock_graph_torch.json")) as fh:
        committed = json.load(fh)
    assert committed == payload, (
        "lock graph changed: review the new edges and regenerate with `python -m "
        "heat_tpu_torch.analysis --dump-lockgraph doc/source/_static/lock_graph_torch.json` (and .dot)"
    )
    edges = {(e["from"], e["to"]) for e in payload["edges"]}
    assert ("heat_tpu_torch.core._executor:_lock", "heat_tpu_torch.core._executor:_own_lock") in edges
    assert ("heat_tpu_torch.core._executor:_lock", "heat_tpu_torch.core.diagnostics:_lock") in edges
    with open(os.path.join(REPO_ROOT, "doc", "source", "_static", "lock_graph_torch.dot")) as fh:
        dot = fh.read()
    assert dot.startswith("digraph heat_tpu_torch_locks") and all(n in dot for n in payload["nodes"])


def test_capture_bodies_of_the_port(whole_tree):
    """The executor's capture region, its program bodies and the staged builds are
    seeded; the kernels' compiler callback is not."""
    _, uni = whole_tree
    traced = {(name, getattr(fn, "name", type(fn).__name__)) for name, fns in uni.traced.items() for fn in fns}
    assert ("heat_tpu_torch.core._executor", "_run_plan") in traced
    assert any(name == "heat_tpu_torch.core._executor" and kind == "Try" for name, kind in traced)
    assert not [t for t in traced if t[0] == "heat_tpu_torch.core.kernels._nvcc"]


def test_check_cli_json_over_the_tree(tmp_path):
    report_path = str(tmp_path / "report.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--check", "--no-cache", "--json", report_path])
    assert rc == 0, out.getvalue()
    with open(report_path) as fh:
        report = json.load(fh)
    assert report["schema"] == REPORT_SCHEMA == "heat-tpu-analysis/1"
    assert report["new_findings"] == [] and report["stale_baseline"] == [] and report["cache_hit"] is False
    assert report["modules_scanned"] > 100 and report["rule_counts"] == {}
    for rule in ("collective-uncontracted", "coord-unbounded-wait", "donation-uncontracted", "trace-time-call",
                 "spmd-divergent-collective", "layout-contract", "lock-racing-increment", "lock-policy-stale",
                 "import-nonstdlib", "import-jax", "silent-except"):
        assert rule in report["rules"]
    # the pragmas of the first run's findings are counted where they suppress
    assert report["suppressed_counts"]["silent-except"] >= 6
    assert report["lock_graph"]["cycles"] == []


def test_rule_catalogue_has_explanations():
    for rule in rules.RULES:
        assert "unknown rule" not in rules.explain(rule)
    assert "known rules" in rules.explain("definitely-not-a-rule")
    assert main(["--explain", "silent-except"]) == 0
    assert main(["--explain", "nope"]) == 1


# ----------------------------------------------------------------- runtime import contract
STDLIB_ONLY_FILES = [
    "diagnostics.py", "profiler.py", "resilience.py", "_scheduler.py", "telemetry.py", "supervision.py",
    "ops.py", "forensics.py",
]


def test_stdlib_only_modules_load_without_torch_numpy_or_jax():
    code = textwrap.dedent("""
        import importlib.util
        import os
        import sys

        FORBIDDEN = ("torch", "numpy", "jax", "jaxlib", "heat_tpu", "heat_tpu_torch")

        class Guard:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("forbidden import at module load: " + name)
                return None

        sys.meta_path.insert(0, Guard())
        import importlib
        import types

        root = sys.argv[1]
        # heat_tpu_torch/core by file path, as a package of another name whose
        # __init__ never runs (it imports torch): each module loads with its
        # stdlib-only siblings and nothing else
        core = types.ModuleType("_probe_core")
        core.__path__ = [os.path.join(root, "heat_tpu_torch", "core")]
        sys.modules["_probe_core"] = core
        for name in sys.argv[2:]:
            importlib.import_module("_probe_core." + name[:-3])
            print("LOADED", name)
        # the checker likewise, with its own __init__
        adir = os.path.join(root, "heat_tpu_torch", "analysis")
        spec = importlib.util.spec_from_file_location(
            "_probe_analysis", os.path.join(adir, "__init__.py"), submodule_search_locations=[adir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules["_probe_analysis"] = pkg
        spec.loader.exec_module(pkg)
        for fn in sorted(os.listdir(adir)):
            if fn.endswith(".py") and fn != "__init__.py":
                importlib.import_module("_probe_analysis." + fn[:-3])
                print("LOADED", "analysis/" + fn)
        print("STDLIB_ONLY_OK")
    """)
    env = {k: v for k, v in os.environ.items() if not k.startswith("HEAT_TPU_")}
    proc = subprocess.run([sys.executable, "-c", code, REPO_ROOT, *STDLIB_ONLY_FILES],
                          capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "STDLIB_ONLY_OK" in proc.stdout
    for name in STDLIB_ONLY_FILES + ["analysis/engine.py", "analysis/__main__.py", "analysis/rules.py"]:
        assert f"LOADED {name}" in proc.stdout
    assert proc.stdout.count("LOADED analysis/") == 16


# ----------------------------------------------------------------- CLI on fixtures
def test_json_report_carries_per_rule_counts(tmp_path):
    pkg = write_tree(tmp_path, "heat_tpu_torch", {"core/x.py": """
        def f(comm, v):
            try:
                return v
            except Exception:
                return comm.all_gather_stacked(v)
    """})
    report_path = str(tmp_path / "report.json")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--root", pkg, "--no-cache", "--json", report_path]) == 1
    with open(report_path) as fh:
        report = json.load(fh)
    assert report["rule_counts"] == {"silent-except": 1, "spmd-collective-in-except": 1}
    assert report["suppressed_counts"] == {} and not report["cache_hit"]


def test_dump_lockgraph_json_and_dot(tmp_path):
    pkg = write_tree(tmp_path, "heat_tpu_torch", {"core/diagnostics.py": DIAG_GOOD})
    jpath, dpath = str(tmp_path / "g.json"), str(tmp_path / "g.dot")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--root", pkg, "--dump-lockgraph", jpath]) == 0
        assert main(["--root", pkg, "--dump-lockgraph", dpath]) == 0
    with open(jpath) as fh:
        assert json.load(fh)["schema"] == "heat-tpu-lockgraph/1"
    with open(dpath) as fh:
        assert "digraph heat_tpu_torch_locks" in fh.read()


FIX_BODY = """
    def f():  # ht: ignore[silent-except] -- covered nothing, remove me
        return 1


    def g():
        try:
            return 1
        except Exception:  # ht: ignore[silent-except, trace-env-read] -- the swallow is deliberate
            return None
"""


@pytest.mark.parametrize("write", [False, True], ids=["dry-run", "write"])
def test_fix_unused_pragmas(tmp_path, write):
    pkg = write_tree(tmp_path, "heat_tpu_torch", {"core/x.py": FIX_BODY})
    target = os.path.join(pkg, "core", "x.py")
    before = open(target).read()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["--root", pkg, "--no-cache", "--fix-unused-pragmas"] + (["--write"] if write else []))
    assert rc == 0
    after = open(target).read()
    if not write:
        assert after == before
        return
    assert "covered nothing" not in after and "trace-env-read" not in after
    assert "ht: ignore[silent-except] -- the swallow is deliberate" in after
    findings, _ = run_analysis(package_root=pkg, extra_files=[])
    assert [f for f in findings if f.rule.startswith("pragma")] == []


CLEAN = """
    def f():
        return 1
"""
VIOLATING = """
    def f():
        try:
            return 1
        except Exception:
            return None
"""


def _cache_fixture(tmp_path, body=CLEAN):
    pkg = write_tree(tmp_path, "heat_tpu_torch", {"core/x.py": body})
    return pkg, os.path.join(pkg, "core", "x.py"), str(tmp_path / "cache.json")


def _quiet_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_cache_warm_hit_and_no_cache(tmp_path):
    pkg, _, cache_path = _cache_fixture(tmp_path)
    assert _quiet_main(["--root", pkg, "--cache", cache_path])[0] == 0
    assert os.path.exists(cache_path)
    rc, out = _quiet_main(["--root", pkg, "--cache", cache_path])
    assert rc == 0 and "cache hit" in out
    rc, out = _quiet_main(["--root", pkg, "--cache", cache_path, "--no-cache"])
    assert rc == 0 and "cache hit" not in out


def test_stale_cache_never_masks_an_edit(tmp_path):
    pkg, target, cache_path = _cache_fixture(tmp_path)
    assert _quiet_main(["--root", pkg, "--cache", cache_path])[0] == 0
    with open(target, "w") as fh:
        fh.write(textwrap.dedent(VIOLATING))
    assert _quiet_main(["--root", pkg, "--cache", cache_path])[0] == 1
    with open(target, "w") as fh:
        fh.write(textwrap.dedent(CLEAN))
    assert _quiet_main(["--root", pkg, "--cache", cache_path])[0] == 0


def test_cache_rule_code_change_invalidates_and_stores_summaries(tmp_path):
    from heat_tpu_torch.analysis import cache as cache_mod

    pkg, _, cache_path = _cache_fixture(tmp_path, """
        def emit(comm, v):
            return comm.all_reduce(v)
    """)
    assert _quiet_main(["--root", pkg, "--cache", cache_path])[0] == 0
    with open(cache_path) as fh:
        payload = json.load(fh)
    assert payload["modules"]["heat_tpu_torch/core/x.py"]["summaries"]["emit"]["seq"] == ["comm.all_reduce"]
    payload["code_hash"] = "stale-rules"
    hashes = cache_mod.module_hashes(pkg, [])
    assert cache_mod.lookup(payload, pkg, cache_mod.code_fingerprint(), hashes) is None
    assert cache_mod.default_path(pkg) == os.path.join(str(tmp_path), ".analysis_cache_torch.json")


def test_cache_path_is_ignored_and_outside_benchmarks():
    from heat_tpu_torch.analysis import cache as cache_mod

    path = cache_mod.default_path(os.path.join(REPO_ROOT, "heat_tpu_torch"))
    assert os.path.relpath(path, REPO_ROOT) == ".analysis_cache_torch.json"
    with open(os.path.join(REPO_ROOT, ".gitignore")) as fh:
        assert ".analysis_cache_torch.json" in fh.read().split()


# ----------------------------------------------------------------- parity with heat_tpu
PARITY_FILES = {
    "core/x.py": """
        _total = 0


        def bump():
            global _total
            _total += 1


        def swallowed():
            try:
                return 1
            except Exception:
                return None


        def reasoned():
            try:
                return 1
            except Exception:  # ht: ignore[silent-except] -- fixture: deliberate swallow
                return None


        def reasonless():
            try:
                return 1
            except Exception:  # ht: ignore[silent-except]
                return None


        def unknown():
            try:
                return 1
            except Exception:  # ht: ignore[no-such-rule] -- whatever
                return None


        def unused():  # ht: ignore[silent-except] -- nothing to suppress here
            return 1
    """,
}


def test_parity_with_heat_tpu_checker(tmp_path):
    from heat_tpu.analysis import baseline as ref_baseline
    from heat_tpu.analysis.__main__ import REPORT_SCHEMA as REF_REPORT_SCHEMA

    def keyed(findings, package):
        out = set()
        for f in findings:
            assert f.path.startswith(package + "/"), f.path
            out.add((f.rule, f.path[len(package) + 1:], f.line))
        return out

    port = run_fixture(tmp_path, PARITY_FILES)
    ref = run_reference(tmp_path, PARITY_FILES)
    got = keyed(port, "heat_tpu_torch")
    assert got == keyed(ref, "heat_tpu")
    assert {r for r, _, _ in got} == {
        "lock-racing-increment", "silent-except", "pragma-no-reason", "pragma-unknown-rule", "pragma-unused",
    }
    # a stale baseline entry: the same synthetic finding from both
    def stale(mod, package):
        entries = [{"rule": "silent-except", "path": f"{package}/core/x.py", "snippet": "gone()"}]
        return keyed(mod.apply([], entries)[2], package)

    assert stale(baseline_mod, "heat_tpu_torch") == stale(ref_baseline, "heat_tpu") == {
        ("baseline-stale", "core/x.py", 0)
    }
    assert REPORT_SCHEMA == REF_REPORT_SCHEMA and baseline_mod.SCHEMA == ref_baseline.SCHEMA


# ----------------------------------------------------------------- the repairs
def test_launch_counters_count_under_their_lock():
    """Every increment of a kernel's launch counter sits inside ``with _count_lock``
    (the race itself is held on the card by chip_smoke.py's [launch_counts_threaded]),
    and the counts read and reset through the package's helpers."""
    from heat_tpu_torch.core import kernels

    for mod in (kernels.flash_attention, kernels.kmeans):
        tree = ast.parse(open(mod.__file__).read())
        parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
        incs = [n for n in ast.walk(tree) if isinstance(n, ast.AugAssign)
                and ast.unparse(n.target).endswith("launches")]
        assert incs
        for node in incs:
            anc = parents[node]
            assert isinstance(anc, ast.With) and ast.unparse(anc.items[0].context_expr) == "_count_lock", (
                mod.__name__, node.lineno)
    saved = kernels.launch_counts()
    try:
        kernels.reset_launch_counts()
        assert set(kernels.launch_counts().values()) == {0}
        with kernels.flash_attention._count_lock:
            kernels.flash_attention.bwd_dq.launches += 3
        assert kernels.launch_counts()["flash_attention_bwd_dq"] == 3
        kernels.reset_launch_counts()
        assert kernels.launch_counts()["flash_attention_bwd_dq"] == 0
    finally:
        for name, mod in kernels.KERNELS.items():
            mod.launches = saved[name]


def test_host_hash_tally_is_exact():
    import torch

    from heat_tpu_torch.core import _result_cache

    _result_cache.reset_stats()
    assert _result_cache.host_hash_bytes() == 0
    t = torch.arange(16, dtype=torch.float32)
    assert _result_cache._digest_one(t)[0] == "h"
    assert _result_cache._digest_one(t[:4].clone())[0] == "h"
    assert _result_cache.host_hash_bytes() == 16 * 4 + 4 * 4
    _result_cache.reset_stats()
    assert _result_cache.host_hash_bytes() == 0
