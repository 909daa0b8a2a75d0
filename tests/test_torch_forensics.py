"""The port's request-forensics plane (heat_tpu_torch/core/forensics.py, ``ht.explain``)
against heat_tpu's.

The same sequence of ``note_*`` calls (request ids, tenants and durations from a seeded
numpy generator) into either package gives equal ``explain``, ``tenant_cost`` and
``totals``; a request through the port's executor under ``HEAT_TPU_FORENSICS=1``
records the stages heat_tpu's records for the same request. Excluded from comparisons:
``deadline_headroom_s`` (measured against the monotonic clock at finish) and, for the
executor requests, every duration (wall time): the stage NAMES, the counts and the
critical-path legs are compared.
"""

import os

import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.core import _executor as jexec
from heat_tpu.core import forensics as jfor
from heat_tpu.core import profiler as jprof

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, forensics, profiler

EXCLUDED = ("deadline_headroom_s",)


@pytest.fixture(autouse=True)
def _clean():
    htt.use_device("cpu")
    for f, p in ((forensics, profiler), (jfor, jprof)):
        f.reset()
        f.arm()
        p.reset()
    yield
    for f, p in ((forensics, profiler), (jfor, jprof)):
        f.disarm()
        f.reset()
        p.disable()
        p.reset()


def _script(f):
    """Open, feed and close 12 records over 3 tenants, with unattributed work too."""
    rng = np.random.default_rng(11)
    for i in range(12):
        rid = 1000 + i
        tenant = ("tenantA", "tenantB", "tenantC")[i % 3]
        f.begin_request(rid, tenant, None)
        f.note_admission("force", "admitted", float(rng.uniform(0.01, 0.5)), rid=rid)
        f.note_scheduled(rid, i % 2, float(rng.uniform(0, 1e-3)), float(rng.uniform(0, 2e-4)),
                         1 + i % 3, 1 if i % 4 == 0 else None)
        f.note_program("defer:add..multiply[4]", float(rng.uniform(1e-4, 1e-3)),
                       "compile" if i == 0 else "execute", rid=rid)
        f.note_result_cache("hit" if i % 3 == 0 else "miss", nbytes=4096.0 if i % 3 == 0 else 0.0, rid=rid)
        if i % 5 == 0:
            f.note_result_cache("bypass", "undigestable-operand", rid=rid)
        f.note_compile_cache("miss", rid=rid)
        f.note_event("eager-replay" if i == 7 else "retry", "unit", rid=rid)
        f.finish_request(rid, float(rng.uniform(2e-3, 9e-3)))
    f.note_program("r:sum", 2e-4, "execute")  # outside any request: tenant "-"
    f.note_batch_execute([None, None], "l:exp", 4e-4)


def _strip(tree):
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items() if k not in EXCLUDED}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


def test_scripted_notes_match_heat_tpu():
    _script(jfor)
    _script(forensics)
    assert forensics.tenant_cost() == jfor.tenant_cost()
    assert forensics.totals() == jfor.totals()
    for tag in (None, "tenantA", "tenantB", "tenantC", "nobody"):
        assert _strip(forensics.explain(tag)) == _strip(jfor.explain(tag)), tag
    assert _strip(forensics.records(limit=64)) == _strip(jfor.records(limit=64))
    mine, theirs = forensics.forensics_stats(), jfor.forensics_stats()
    assert set(mine) == set(theirs)
    for k in ("live", "ring", "finished", "dropped", "knobs", "tenant_cost", "totals"):
        assert mine[k] == theirs[k], k
    assert forensics.__all__ == jfor.__all__
    assert htt.explain is forensics.explain


def _executor_request(mod, prof, exec_):
    x = mod.array(np.arange(24.0, dtype=np.float32).reshape(6, 4), split=0)
    with prof.request("tenantX"):
        y = (x * 2.0 + 1.0).sum(axis=1)
        y.numpy()
    return exec_


def _stage_names(f):
    recs = f.records("tenantX")
    assert len(recs) == 2
    return [(sorted(r["stages"]), sorted(r["result_cache"]["bypass"]), r["compile_cache"]) for r in recs]


@pytest.fixture
def _threshold_one(monkeypatch):
    monkeypatch.setenv("HEAT_TPU_JIT_THRESHOLD", "1")
    for ex in (_executor, jexec):
        ex.clear_executor_cache()
    yield
    monkeypatch.undo()
    for ex in (_executor, jexec):
        ex.clear_executor_cache()


def test_executor_request_records_heat_tpus_stages(_threshold_one):
    comm1 = ht.MeshCommunication(__import__("jax").devices()[:1])
    for _ in range(2):  # a cold request (compile) and a warm one (execute)
        x = ht.array(np.arange(24.0, dtype=np.float32).reshape(6, 4), split=0, comm=comm1)
        with jprof.request("tenantX"):
            (x * 2.0 + 1.0).sum(axis=1).numpy()
        x = htt.array(np.arange(24.0, dtype=np.float32).reshape(6, 4), split=0)
        with profiler.request("tenantX"):
            (x * 2.0 + 1.0).sum(axis=1).numpy()
    mine, theirs = forensics.records("tenantX"), jfor.records("tenantX")
    assert len(mine) == len(theirs) == 2
    for m, t in zip(mine, theirs):
        assert set(m) == set(t)
        assert m["tenant"] == t["tenant"] == "tenantX"
        assert {"compile", "execute"} & set(m["stages"]) == {"compile", "execute"} & set(t["stages"])
        assert m["result_cache"]["bypass"] == t["result_cache"]["bypass"]
        assert m["compile_cache"] == t["compile_cache"]
        assert m["dominant"] in m["stages"]
    assert "compile" in mine[0]["stages"] and "execute" in mine[1]["stages"]
    cost = _executor.executor_stats()["tenant_cost"]
    assert cost["tenantX"]["requests"] == 2 and cost["tenantX"]["device_seconds"] > 0.0


def test_env_knob_arms_the_plane(monkeypatch):
    forensics.disarm()
    monkeypatch.setenv("HEAT_TPU_FORENSICS", "1")
    _executor.reload_env_knobs()
    try:
        assert forensics.armed()
    finally:
        monkeypatch.delenv("HEAT_TPU_FORENSICS")
        _executor.reload_env_knobs()
