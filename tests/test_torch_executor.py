"""The port's signature-cached executor and its deferred expression graph
(heat_tpu_torch/core/_executor.py) against heat_tpu's (tests/test_executor.py).

Each scenario runs the same numpy inputs through heat_tpu (on its test mesh, or on one
device where XLA's padding would change a byte count) and through the port on the
CPU, and holds

- the values: gshape, split, dtype, and values within 4 ulp of heat_tpu's; the port's
  executor results are BIT-equal to its own eager path (``HEAT_TPU_EAGER_DISPATCH=1``);
- the counters: hits, misses, retraces, fused forces and nodes, interior outputs,
  CSE collapses, donation grants (bytes) and refusals, unsupported signatures, eager
  fallbacks — equal to heat_tpu's ``executor_stats()`` on the same sequence of calls.
"""

import contextlib
import gc
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import heat_tpu as ht
from heat_tpu.core import _executor as heat_executor

import heat_tpu_torch as htt
from _torch_array_cases import CASES, Arrays, splits_of
from heat_tpu_torch.core import _executor, _operations, resilience, sanitation

COUNTERS = ("hits", "misses", "retraces", "interior_outputs", "reexec_avoided", "reexecuted", "cse_hits",
            "eager_fallbacks", "donation_refusals")
_EVEN = (8, 4)
_RAGGED = (7, 5)
# donated bytes are physical in heat_tpu: 24 rows split 0 pad on no test mesh of 1, 2, 3,
# 4, 6 or 8 devices, so the byte counts compare
_UNPADDED = (24, 4)


@pytest.fixture(autouse=True, scope="module")
def _production_threshold():
    # the suite's conftest raises the warm-up threshold; these tests, like heat_tpu's
    # executor tests, hold the production default (build on first miss)
    old = os.environ.get("HEAT_TPU_JIT_THRESHOLD")
    os.environ["HEAT_TPU_JIT_THRESHOLD"] = "1"
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()
    yield
    if old is None:
        os.environ.pop("HEAT_TPU_JIT_THRESHOLD", None)
    else:
        os.environ["HEAT_TPU_JIT_THRESHOLD"] = old
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()


@pytest.fixture(autouse=True)
def _clean():
    htt.use_device("cpu")
    for ex in (_executor, heat_executor):
        sched = ex._dispatch_scheduler
        if sched is not None:
            sched.reopen()
            sched.resume()
            assert sched.wait_idle(30.0)
        ex.clear_executor_cache()
    yield
    for ex in (_executor, heat_executor):
        sched = ex._dispatch_scheduler
        if sched is not None:
            sched.reopen()
            sched.resume()
            assert sched.wait_idle(30.0), "scheduler stuck busy"


@contextlib.contextmanager
def env(name, value):
    """Set one knob for both packages (their knobs are memoised)."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    _executor.reload_env_knobs()
    heat_executor.reload_env_knobs()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old
        _executor.reload_env_knobs()
        heat_executor.reload_env_knobs()


def eager():
    return env("HEAT_TPU_EAGER_DISPATCH", "1")


def force(x):
    """Read the local (port) or physical (heat_tpu) value: a deferred payload forces."""
    return x.larray if isinstance(x, htt.DNDarray) else x.parray


def _np_pair(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(dtype)
    b = (rng.standard_normal(shape) + 1.5).astype(dtype)
    return a, b


def both(scenario):
    """Run ``scenario(m)`` on the port then on heat_tpu, each from a cleared cache;
    returns ((port stats, port result), (heat_tpu stats, heat_tpu result))."""
    out = []
    for m, ex in ((htt, _executor), (ht, heat_executor)):
        ex.clear_executor_cache()
        res = scenario(m)
        out.append((ex.executor_stats(top=4), res))
    return out


def assert_counters_equal(mine, theirs, names=COUNTERS):
    assert {k: mine[k] for k in names} == {k: theirs[k] for k in names}


def assert_close_to_heat(got, want, ulps=4):
    """Values within ``ulps`` of heat_tpu's (the elementwise rule; ``ulps=None`` for a
    reduction or scan, which sums in another order: within 1e-5 of the value), dtype,
    gshape and split equal."""
    assert got.dtype.__name__ == want.dtype.__name__
    assert got.gshape == want.gshape and got.split == want.split
    g, w = got.numpy(), want.numpy()
    if np.issubdtype(w.dtype, np.floating) and ulps is None:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    elif np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_max_ulp(g, w, maxulp=ulps)
    else:
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------- stats
def test_top_level_exports():
    stats = htt.executor_stats()
    for key in ("hits", "misses", "retraces", "programs", "graphs", "graph_pool_bytes"):
        assert key in stats
    assert set(heat_executor.executor_stats()) - set(stats) <= {
        "result_cache", "cache_hits", "cache_misses", "cache_bytes_saved", "cache_invalidations", "tenant_cost"}
    for name in ("executor_stats", "reset_executor_stats", "clear_executor_cache", "reload_env_knobs",
                 "rebuild_scheduler", "profiler"):
        assert hasattr(htt, name) and hasattr(htt.core, name)
    htt.reset_executor_stats()
    assert htt.executor_stats()["hits"] == 0


def test_second_identical_call_is_zero_retraces():
    np_a, np_b = _np_pair(_RAGGED)

    def scenario(m):
        a, b = m.array(np_a, split=0), m.array(np_b, split=0)
        force(m.add(a, b))
        first = {k: m.executor_stats()[k] for k in ("hits", "misses", "retraces")}
        m.reset_executor_stats()
        force(m.add(a, b))
        return first

    (mine, first), (theirs, first_ref) = both(scenario)
    assert first == first_ref and first["misses"] >= 1
    assert mine["retraces"] == 0 and mine["misses"] == 0 and mine["hits"] >= 1
    assert_counters_equal(mine, theirs)


def test_new_signature_is_a_counted_retrace():
    def scenario(m):
        force(m.exp(m.array(np.arange(8, dtype=np.float32), split=0)))
        m.reset_executor_stats()
        force(m.exp(m.array(np.arange(16, dtype=np.float32), split=0)))

    (mine, _), (theirs, _) = both(scenario)
    assert mine["retraces"] == 1
    assert_counters_equal(mine, theirs)


def test_eager_flag_bypasses_executor():
    a = htt.array(np.arange(8, dtype=np.float32), split=0)
    with eager():
        assert not _executor.executor_enabled()
        htt.reset_executor_stats()
        r = htt.add(a, a)
        assert isinstance(r._payload, torch.Tensor)
        stats = htt.executor_stats()
    assert stats["hits"] == stats["misses"] == 0
    assert _executor.executor_enabled()


def test_unsupported_signature_cached_once():
    assert _executor.kwargs_sig({"a": []}) is _executor.UNSUPPORTED
    calls = []

    def build():
        calls.append(1)
        return _executor.UNSUPPORTED

    key = ("test-unsupported", object())
    assert _executor.lookup(key, build) is None
    assert _executor.lookup(key, build) is None
    assert len(calls) == 1


def test_clear_cache_drops_programs_and_reset_keeps_them():
    a = htt.array(np.arange(8, dtype=np.float32), split=0)
    force(htt.mul(a, a))
    force(htt.mul(a, a))
    before = htt.executor_stats(top=5)
    assert before["programs"] > 0 and before["top_signatures"][0]["hits"] >= 1
    htt.reset_executor_stats()
    after = htt.executor_stats(top=5)
    assert (after["hits"], after["misses"], after["retraces"]) == (0, 0, 0)
    assert after["programs"] == before["programs"]
    assert after["top_signatures"][0]["hits"] == before["top_signatures"][0]["hits"]
    htt.clear_executor_cache()
    cleared = htt.executor_stats(top=5)
    assert (cleared["hits"], cleared["misses"], cleared["retraces"], cleared["programs"]) == (0, 0, 0, 0)
    assert cleared["top_signatures"] == []


def test_top_signature_breakdown_equals_heat_tpu():
    def scenario(m):
        a = m.array(np.arange(8, dtype=np.float32), split=0)
        for _ in range(3):
            force(m.add(a, a))

    (mine, _), (theirs, _) = both(scenario)
    top, top_ref = mine["top_signatures"][0], theirs["top_signatures"][0]
    assert top["label"] == top_ref["label"] == "defer:add..add[1]"
    assert top["hits"] == top_ref["hits"] == 2
    assert top["compile_s"] > 0.0
    assert "top_signatures" not in htt.executor_stats()
    assert_counters_equal(mine, theirs)


def test_equal_hit_signatures_sort_by_label():
    def scenario(m):
        x = m.array(_np_pair(_EVEN)[0], split=0)
        m.sum(x).numpy()
        m.cumsum(x, axis=0).numpy()

    (mine, _), (theirs, _) = both(scenario)
    labels = [e["label"] for e in mine["top_signatures"]]
    assert labels == [e["label"] for e in theirs["top_signatures"]]
    assert labels.index("c:cumsum") < labels.index("r:sum")


# ---------------------------------------------------------------------- parity
def _assert_parity(fn, build_args, ulps=4):
    """Executor results bit-equal to the port's eager path, the second executor run
    pure replay (zero retraces), and the values within ``ulps`` of heat_tpu's."""

    def forced(results):
        results = results if isinstance(results, tuple) else (results,)
        for r in results:
            force(r)
        return results

    staged = forced(fn(htt, *build_args(htt)))
    htt.reset_executor_stats()
    staged2 = forced(fn(htt, *build_args(htt)))
    assert htt.executor_stats()["retraces"] == 0, "second identical call must be pure replay"
    with eager():
        plain = forced(fn(htt, *build_args(htt)))
        assert all(isinstance(r._payload, torch.Tensor) for r in plain)
    ref = forced(fn(ht, *build_args(ht)))
    for s, s2, e, w in zip(staged, staged2, plain, ref):
        assert (s.split, s.dtype, s.gshape) == (e.split, e.dtype, e.gshape)
        assert s.numpy().tobytes() == e.numpy().tobytes(), "executor != eager bits"
        assert s.numpy().tobytes() == s2.numpy().tobytes(), "replay changed bits"
        assert_close_to_heat(s, w, ulps)


PARITY = {  # name: (fn, ulps against heat_tpu; None for a reduction or scan)
    "binary_core": (lambda m, a, b: m.add(a, b), 4),
    "binary_scalar": (lambda m, a, b: a + 2.5, 4),
    "binary_scalar_first": (lambda m, a, b: 2 - a, 4),
    "binary_div": (lambda m, a, b: m.div(a, b), 4),
    "local_core": (lambda m, a, b: m.exp(a), 4),
    "local_floor": (lambda m, a, b: m.floor(a), 4),
    "reduce_core": (lambda m, a, b: m.sum(a, axis=0), None),
    "reduce_keepdims": (lambda m, a, b: m.sum(a, axis=1, keepdims=True), None),
    "reduce_all": (lambda m, a, b: m.sum(a), None),
    "reduce_max": (lambda m, a, b: m.max(a, axis=1), 0),
    "cum_core": (lambda m, a, b: m.cumsum(a, 0), None),
    "cum_prod": (lambda m, a, b: m.cumprod(a, 1), None),
    "chain": (lambda m, a, b: ((a + b) * 0.5 - b) + 1.0, 4),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [_EVEN, _RAGGED])
@pytest.mark.parametrize("case", sorted(PARITY))
def test_eager_parity(case, shape, split):
    fn, ulps = PARITY[case]
    np_a, np_b = _np_pair(shape)
    _assert_parity(fn, lambda m: (m.array(np_a, split=split), m.array(np_b, split=split)), ulps=ulps)


@pytest.mark.parametrize("dtype", [np.int32, np.int8, np.float64])
def test_eager_parity_dtypes(dtype):
    np_a, np_b = _np_pair(_RAGGED)
    np_a, np_b = (np_a * 5).astype(dtype), (np_b * 5).astype(dtype)
    _assert_parity(lambda m, a, b: (m.add(a, b), m.sum(a, axis=0), a // 3, a * True),
                   lambda m: (m.array(np_a, split=0), m.array(np_b, split=0)), ulps=None)


def test_binary_mixed_splits_and_broadcast():
    np_a, _ = _np_pair(_RAGGED)
    np_r = np.arange(_RAGGED[1], dtype=np.float32) + 1.0
    _assert_parity(lambda m, a, r: m.add(a, r), lambda m: (m.array(np_a, split=0), m.array(np_r, split=None)))


def test_binary_where():
    np_a, np_b = _np_pair(_RAGGED)
    mask = np_a > 0
    _assert_parity(lambda m, a, b, w: m.add(a, b, where=w),
                   lambda m: (m.array(np_a, split=0), m.array(np_b, split=0), m.array(mask, split=0)))


@pytest.mark.parametrize("case", ["binary", "local", "reduce", "cum"])
def test_out_parity(case):
    np_a, np_b = _np_pair(_RAGGED)
    fns = {
        "binary": (lambda m, a, b, o: m.add(a, b, out=o), lambda m: m.zeros(_RAGGED, dtype=m.float64, split=0)),
        "local": (lambda m, a, b, o: m.exp(a, out=o), lambda m: m.zeros(_RAGGED, split=0)),
        "reduce": (lambda m, a, b, o: m.sum(a, axis=0, out=o), lambda m: m.zeros(_RAGGED[1:], split=None)),
        "cum": (lambda m, a, b, o: m.cumsum(a, 0, out=o), lambda m: m.zeros(_RAGGED, dtype=m.float64, split=0)),
    }
    fn, make_out = fns[case]
    _assert_parity(fn, lambda m: (m.array(np_a, split=0), m.array(np_b, split=0), make_out(m)),
                   ulps=4 if case in ("binary", "local") else None)


def test_cum_dtype_accumulator():
    np_a = np.arange(14, dtype=np.int8).reshape(7, 2)
    _assert_parity(lambda m, a: m.cumsum(a, 0, dtype=m.int64), lambda m: (m.array(np_a, split=0),))


ELEMENTWISE_CASES = ["maximum", "where", "where_kw", "edge_sign_nan", "edge_int_div_zero", "cumsum0", "cumsum1",
                     "cumprod0", "all0", "any", "nansum", "diff0", "diff1"]


@pytest.mark.parametrize("name,split", [(n, s) for n in ELEMENTWISE_CASES for s in splits_of(n)])
def test_array_case_bit_equal_to_eager(name, split):
    """The shared array cases that run through the dispatch wrappers: executor
    results bit-equal to the eager path's."""
    with eager():
        want = CASES[name](htt, Arrays(htt), split)
    got = CASES[name](htt, Arrays(htt), split)
    want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple) else (got,))
    for g, w in zip(got, want):
        assert (g.dtype, g.gshape, g.split) == (w.dtype, w.gshape, w.split)
        assert g.numpy().tobytes() == w.numpy().tobytes()


# ---------------------------------------------------------------------- out= donation
def test_sole_owner_out_buffer_is_written_in_place():
    np_a, np_b = _np_pair(_EVEN)
    a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
    o = htt.zeros(_EVEN, split=0)
    ptr = o.larray.data_ptr()
    for _ in range(2):  # first call builds, second replays: both donate
        htt.add(a, b, out=o)
    np.testing.assert_allclose(o.numpy(), np_a + np_b, rtol=1e-6)
    assert o.larray.data_ptr() == ptr


def test_aliased_operand_refuses_donation():
    np_a, np_b = _np_pair(_EVEN)
    a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
    htt.add(a, b, out=a)
    np.testing.assert_allclose(a.numpy(), np_a + np_b, rtol=1e-6)
    np.testing.assert_array_equal(b.numpy(), np_b)


def test_external_reference_keeps_its_bits():
    np_a, np_b = _np_pair(_EVEN)
    a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
    o = htt.zeros(_EVEN, split=0)
    held = o.larray
    htt.add(a, b, out=o)
    np.testing.assert_allclose(o.numpy(), np_a + np_b, rtol=1e-6)
    np.testing.assert_array_equal(held.numpy(), np.zeros(_EVEN))


def test_sanitize_donation_contract():
    o = htt.zeros(_EVEN, split=0)
    assert not sanitation.sanitize_donation(o, [o.larray])
    view = o.larray[1:]  # a live view shares the storage
    assert not sanitation.sanitize_donation(o, [])
    del view
    assert sanitation.sanitize_donation(o, [])
    holder = o.larray
    assert not sanitation.sanitize_donation(o, [])
    del holder
    assert sanitation.sanitize_donation(o, [])
    g = htt.zeros(_EVEN, split=0)
    g.larray.requires_grad_(True)
    assert not sanitation.sanitize_donation(g, [])


def test_out_dtype_cast_stays_correct_under_replay():
    np_a, np_b = _np_pair(_EVEN)
    for _ in range(3):
        a, b = htt.array(np_a, split=0), htt.array(np_b, split=0)
        o = htt.zeros(_EVEN, dtype=htt.float64, split=0)
        htt.mul(a, b, out=o)
        np.testing.assert_array_equal(o.numpy(), (np_a * np_b).astype(np.float64))


# ---------------------------------------------------------------------- scalars
def test_equal_but_distinct_scalar_leaves():
    np_a, _ = _np_pair(_RAGGED)
    a = htt.array(np_a, split=0)
    c = htt.copysign(a + 0.0, -0.0)  # one graph holding both 0.0 and -0.0
    np.testing.assert_array_equal(c.numpy(), np.copysign(np_a + 0.0, -0.0))


def test_bool_scalar_not_deduped_with_int():
    np_a, _ = _np_pair(_RAGGED)
    a = htt.array(np_a, split=0)
    r = (a * True) + 1
    np.testing.assert_array_equal(r.numpy(), (np_a * True) + 1)
    i = htt.array(np.arange(6, dtype=np.int8), split=0)
    assert ((i + True) * 1).dtype is htt.int8 and ((i + 1) * True).dtype is htt.int8
    np.testing.assert_array_equal(((i + True) * 1).numpy(), np.arange(6, dtype=np.int8) + 1)


# ---------------------------------------------------------------------- multi-output graphs
def _diamond(m, np_a, np_b):
    a, b = m.array(np_a, split=0), m.array(np_b, split=0)
    t = a + b
    return a, b, t, t * 2.0, t * 3.0


def test_diamond_shared_subchain_runs_once():
    np_a, np_b = _np_pair(_RAGGED)

    def scenario(m):
        a, b, t, u, v = _diamond(m, np_a, np_b)
        m.reset_executor_stats()
        force(u)
        force(v)
        force(t)
        return t.numpy(), u.numpy(), v.numpy()

    (mine, got), (theirs, want) = both(scenario)
    assert mine["retraces"] == 2 and mine["reexecuted"] == 0
    assert mine["interior_outputs"] >= 1 and mine["reexec_avoided"] >= 2
    assert_counters_equal(mine, theirs)
    with eager():
        plain = [x.numpy() for x in _diamond(htt, np_a, np_b)[2:]]
    for g, p, w in zip(got, plain, want):
        assert g.tobytes() == p.tobytes()
        np.testing.assert_array_max_ulp(g, w, maxulp=4)


def test_single_consumer_chain_stays_single_output():
    np_a, _ = _np_pair(_RAGGED)

    def scenario(m):
        y = m.array(np_a, split=0)
        for _ in range(4):
            y = y * 0.5
            y = y + 1.0
        m.reset_executor_stats()
        force(y)

    (mine, _), (theirs, _) = both(scenario)
    assert mine["interior_outputs"] == 0 and mine["reexecuted"] == 0
    progs = [e for k, e in _executor._programs.items() if k[0] == "defer"]
    assert len(progs) == 1
    assert_counters_equal(mine, theirs)


def test_shared_node_safe_after_all_wrappers_die():
    np_a, np_b = _np_pair(_UNPADDED)

    def scenario(m):
        a, b = m.array(np_a, split=0), m.array(np_b, split=0)
        t = a + b
        u, v = t * 2.0, t * 3.0
        del a, b, t
        m.reset_executor_stats()
        force(u)
        st = m.executor_stats()
        force(v)
        return st, u.numpy(), v.numpy()

    (mine, (st, u, v)), (theirs, (st_ref, _, _)) = both(scenario)
    assert st["interior_outputs"] >= 1 and st["donated_bytes"] > 0
    assert st["donated_bytes"] == st_ref["donated_bytes"]
    assert mine["reexecuted"] == 0
    np.testing.assert_array_equal(u, (np_a + np_b) * 2.0)
    np.testing.assert_array_equal(v, (np_a + np_b) * 3.0)


def test_separately_built_identical_chains_share_one_program():
    np_a, np_b = _np_pair(_RAGGED)

    def scenario(m):
        a, b = m.array(np_a, split=0), m.array(np_b, split=0)
        force((a + b) * 2.0)
        m.reset_executor_stats()
        force((a + b) * 2.0)

    (mine, _), (theirs, _) = both(scenario)
    assert mine["retraces"] == 0 and mine["hits"] >= 1
    assert_counters_equal(mine, theirs)


def test_structural_cse_collapses_in_graph_duplicates():
    np_a, np_b = _np_pair(_RAGGED)

    def scenario(m):
        a, b = m.array(np_a, split=0), m.array(np_b, split=0)
        m.reset_executor_stats()
        w = (a + b) * 2.0 + (a + b) * 2.0
        force(w)
        return w.numpy()

    (mine, w), (theirs, w_ref) = both(scenario)
    assert mine["cse_hits"] >= 2 and mine["retraces"] == 1
    assert "[3]" in mine["top_signatures"][0]["label"]
    assert_counters_equal(mine, theirs)
    np.testing.assert_array_equal(w, ((np_a + np_b) * 2.0) * 2.0)


def test_leaf_donated_when_plan_is_sole_reader():
    np_a, _ = _np_pair(_UNPADDED)

    def scenario(m):
        x = m.array(np_a, split=0)
        ptr = x.larray.data_ptr() if m is htt else None
        y = x * 2.0
        del x
        m.reset_executor_stats()
        force(y)
        return ptr, y

    (mine, (ptr, y)), (theirs, _) = both(scenario)
    assert mine["donated_bytes"] == theirs["donated_bytes"] == 24 * 4 * 4
    assert y.larray.data_ptr() == ptr, "the output must live in the donated leaf's storage"
    np.testing.assert_array_equal(y.numpy(), np_a * 2.0)
    assert_counters_equal(mine, theirs)


def test_leaf_donation_refused_when_dndarray_or_holder_still_reads():
    np_a, _ = _np_pair(_EVEN)

    def scenario(m):
        x = m.array(np_a, split=0)
        y = x * 2.0
        m.reset_executor_stats()
        force(y)
        held_x = m.array(np_a, split=0)
        held = force(held_x)
        z = held_x * 2.0
        del held_x
        force(z)
        return x.numpy(), np.asarray(held)[: _EVEN[0]] if m is ht else held.numpy()

    (mine, (x, held)), (theirs, _) = both(scenario)
    assert mine["donated_bytes"] == theirs["donated_bytes"] == 0
    np.testing.assert_array_equal(x, np_a)
    np.testing.assert_array_equal(held, np_a)


def test_sanitize_leaf_donation_contract():
    t = torch.arange(8.0)
    holders = [t]
    assert sanitation.sanitize_leaf_donation(t, 2)
    extra = t
    assert not sanitation.sanitize_leaf_donation(t, 2)
    del extra
    assert sanitation.sanitize_leaf_donation(t, 2)
    v = t[2:]  # a view shares the storage without a Python reference to t
    assert not sanitation.sanitize_leaf_donation(t, 2)
    del v
    assert sanitation.sanitize_leaf_donation(t, 2)
    chunk = torch.arange(16.0).reshape(4, 4)[1:3]  # a view of a base nothing else holds
    assert sanitation.sanitize_leaf_donation(chunk, 1)
    big = torch.arange(16.0)
    held_chunk = big[4:8]  # the base is still held: a write would show through it
    assert not sanitation.sanitize_leaf_donation(held_chunk, 1)
    del holders


def test_warmup_eager_replay_memoises_interior_values():
    np_a, np_b = _np_pair(_RAGGED)
    with env("HEAT_TPU_JIT_THRESHOLD", "4"):
        def scenario(m):
            a, b, t, u, v = _diamond(m, np_a, np_b)
            m.reset_executor_stats()
            force(u)
            st = m.executor_stats()
            assert t._payload.value is not None
            force(v)
            force(t)
            return st, (t.numpy(), u.numpy(), v.numpy())

        (mine, (st, got)), (theirs, (st_ref, _)) = both(scenario)
    assert st["retraces"] == 0 and st["interior_outputs"] >= 1
    assert_counters_equal(st, st_ref)
    assert_counters_equal(mine, theirs)
    with eager():
        plain = [x.numpy() for x in _diamond(htt, np_a, np_b)[2:]]
    for g, p in zip(got, plain):
        assert g.tobytes() == p.tobytes()


def test_deep_diamond_dag_stays_one_program():
    np_a = (np.random.default_rng(0).standard_normal(_EVEN) * 1e-6).astype(np.float32)

    def scenario(m):
        x = m.array(np_a, split=0)
        for _ in range(40):
            x = x + x
        m.reset_executor_stats()
        force(x)
        return x.numpy()

    (mine, x), (theirs, _) = both(scenario)
    assert mine["retraces"] == 1 and mine["reexecuted"] == 0
    assert_counters_equal(mine, theirs)
    np.testing.assert_allclose(x, np_a * float(2 ** 40), rtol=1e-6)


def test_window_spill_forces_multi_output_and_stays_correct():
    np_a, _ = _np_pair(_EVEN)
    n = _executor._MAX_FUSED_NODES + 44
    assert n == heat_executor._MAX_FUSED_NODES + 44

    def scenario(m):
        x = m.array(np_a, split=0)
        for _ in range(n):
            x = x * 1.0009
        m.reset_executor_stats()
        force(x)
        return x.numpy()

    (mine, x), (theirs, _) = both(scenario)
    assert mine["reexecuted"] == 0
    assert_counters_equal(mine, theirs)
    ref = np_a.copy()
    for _ in range(n):
        ref = (ref * np.float32(1.0009)).astype(np.float32)
    np.testing.assert_allclose(x, ref, rtol=1e-5)


def test_live_intermediate_memoised_for_later_read():
    np_a, _ = _np_pair(_RAGGED)

    def scenario(m):
        x = m.array(np_a, split=0)
        mid = x * 0.5
        tip = mid + 1.0
        m.reset_executor_stats()
        force(tip)
        retraces = m.executor_stats()["retraces"]
        force(mid)
        assert m.executor_stats()["retraces"] == retraces
        return mid.numpy(), tip.numpy()

    (mine, (mid, tip)), (theirs, _) = both(scenario)
    assert mine["interior_outputs"] >= 1
    assert_counters_equal(mine, theirs)
    np.testing.assert_array_equal(mid, np_a * 0.5)
    np.testing.assert_array_equal(tip, np_a * 0.5 + 1.0)


# ---------------------------------------------------------------------- torch-only hazards
def test_in_place_write_settles_pending_reads():
    """A deferred read of a tensor sees the value the op was issued on, whatever is
    written into the tensor (or a view of its storage) afterwards."""
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    y = x + 1.0  # pending read of x's tensor
    x[0] = 100.0  # writes through larray, which settles y first
    np.testing.assert_array_equal(y.numpy(), np_a + 1.0)
    t = x * 2.0
    u = t + 1.0  # pending read of t's value once t is forced
    t.larray.zero_()
    np.testing.assert_array_equal(u.numpy(), (np.where(np.arange(8)[:, None] == 0, 100.0, np_a) * 2.0 + 1.0)
                                  .astype(np.float32))


def test_write_outside_larray_raises_instead_of_reading_changed_data():
    x = htt.array(np.arange(8, dtype=np.float32), split=0)
    raw = x.larray
    y = x * 2.0
    raw.add_(1.0)  # bypasses larray: the version counter moved
    with pytest.raises(RuntimeError, match="written in place"):
        y.numpy()


def test_grad_tensors_stay_eager():
    x = htt.array(np.arange(4.0, dtype=np.float32), split=None)
    t = x.larray.requires_grad_(True)
    y = x * 2.0  # autograd records at call time: no deferral
    assert isinstance(y._payload, torch.Tensor) and y.larray.requires_grad
    y.larray.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full(4, 2.0))


def test_in_place_operators_stay_deferred():
    np_a, _ = _np_pair(_EVEN)
    x = htt.array(np_a, split=0)
    for _ in range(3):
        x += 1.0
        x *= 2.0
    assert isinstance(x._payload, _executor.Deferred)
    with eager():
        e = htt.array(np_a, split=0)
        for _ in range(3):
            e += 1.0
            e *= 2.0
    assert x.numpy().tobytes() == e.numpy().tobytes()


def test_fallbacks_and_quarantine_equal_heat_tpu():
    """A fault plan at ``executor.execute`` on both packages: every call falls back to
    the eager path with its values kept, and the signature is quarantined after the
    same number of failures."""
    from heat_tpu.core import resilience as heat_resilience

    np_a, _ = _np_pair(_EVEN)
    plan = [{"site": "executor.execute", "on_call": 1, "count": 99, "kind": "raise"}]

    def scenario(m):
        res = resilience if m is htt else heat_resilience
        x = m.array(np_a, split=0)
        force(x * 5.0 + 1.0)
        m.reset_executor_stats()
        res.arm_fault_plan(plan)
        try:
            got = [(x * 5.0 + 1.0).numpy() for _ in range(4)]
        finally:
            res.disarm_fault_plan()
        return got

    (mine, got), (theirs, want) = both(scenario)
    assert mine["eager_fallbacks"] == theirs["eager_fallbacks"] == 3
    assert len(mine["quarantined"]) == len(theirs["quarantined"]) == 1
    assert_counters_equal(mine, theirs)
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g, w, maxulp=4)
        assert g.tobytes() == got[0].tobytes()
