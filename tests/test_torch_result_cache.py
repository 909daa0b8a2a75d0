"""The port's cross-request result cache (heat_tpu_torch/core/_result_cache.py) against
heat_tpu's.

Each scenario runs the same calls on the same numpy inputs in both packages (heat_tpu on
a one-device mesh, where nothing pads) and holds the values bit-equal and the cache's
tallies — stores, hits, misses, invalidations, rejects — equal: hit, miss and bypass
labels, generation invalidation, donation invalidation, RNG labels never cached, the
poisoned entry rejected typed, ``stats()`` keys. Two cases are the port's own (a torch
tensor can be written in place, a ``jax.Array`` cannot): an in-place write into a
registered buffer, and into a cached result handed out by a hit, both fail closed.
Excluded from comparisons: ``bytes``/``bytes_saved`` (XLA and torch may pad a buffer
differently) — compared as ``> 0``.
"""

import itertools

import numpy as np
import pytest
import torch

import heat_tpu as ht
from heat_tpu.core import _executor as jexec
from heat_tpu.core import _result_cache as jrc
from heat_tpu.core import diagnostics as jdiag

import heat_tpu_torch as htt
from heat_tpu_torch.core import _executor, _result_cache, diagnostics

N = 1024
TALLIES = ("stores", "hits", "misses", "invalidations", "rejects", "entries")
_TAGS = itertools.count()


class _Pkg:
    """One package's handles: module, executor, result cache, the raw buffer of an array."""

    def __init__(self, mod, exec_, rc, raw, comm=None):
        self.mod, self.exec, self.rc, self.raw, self.comm = mod, exec_, rc, raw, comm

    def array(self, values):
        kw = {"comm": self.comm} if self.comm is not None else {}
        return self.mod.array(values, split=0, **kw)

    def stats(self):
        return self.exec.executor_stats()["result_cache"]


def _fresh(rc) -> None:
    """A result cache with no entries, no tallies and no registrations. ``clear()`` keeps
    the tallies and the generation table, and heat_tpu's own tests name their tag families
    ``t0``, ``t1``, ... as this file does: a tag that an earlier file of the same process
    raised to generation 2 keeps that live generation (``register_generation`` takes the
    larger), so this file's generation-1 entries under the same name would fail closed."""
    rc.reset_stats()
    with rc._lock:
        rc._registry.clear()
        rc._tag_gen.clear()


@pytest.fixture
def pkgs(monkeypatch):
    import jax

    htt.use_device("cpu")
    monkeypatch.setenv("HEAT_TPU_JIT_THRESHOLD", "1")
    monkeypatch.setenv("HEAT_TPU_RESULT_CACHE", "1")
    for ex in (_executor, jexec):
        ex.clear_executor_cache()
    for rc in (_result_cache, jrc):
        _fresh(rc)
    comm1 = ht.MeshCommunication(jax.devices()[:1])
    yield (_Pkg(ht, jexec, jrc, lambda a: a.parray, comm1), _Pkg(htt, _executor, _result_cache, lambda a: a.larray))
    monkeypatch.undo()
    for ex in (_executor, jexec):
        ex.clear_executor_cache()


def _staged(p, tag):
    a = p.array(np.arange(N, dtype=np.float32))
    b = p.array(np.full(N, 2.0, np.float32))
    p.rc.register_generation(p.raw(a), f"{tag}:a", 1)
    p.rc.register_generation(p.raw(b), f"{tag}:b", 1)
    return a, b


def _force(a, b):
    return (a * b + b).numpy().copy()  # a CPU tensor's numpy() shares its memory


def _tallies(p):
    st = p.stats()
    return {k: st[k] for k in TALLIES}


def _both(pkgs, scenario):
    """Run ``scenario(p, tag)`` in both packages; equal values and equal tallies."""
    tag = f"t{next(_TAGS)}"
    outs = [scenario(p, tag) for p in pkgs]
    assert [[np.asarray(v).tobytes() for v in o] for o in outs][0] == [
        [np.asarray(v).tobytes() for v in o] for o in outs][1]
    assert _tallies(pkgs[1]) == _tallies(pkgs[0])
    return outs[1]


def test_stats_keys_and_default_off(monkeypatch):
    monkeypatch.delenv("HEAT_TPU_RESULT_CACHE", raising=False)
    htt.use_device("cpu")
    for ex in (_executor, jexec):
        ex.clear_executor_cache()
    assert set(_result_cache.stats()) == set(jrc.stats())
    assert not _result_cache.enabled()
    a = htt.array(np.arange(64, dtype=np.float32), split=0)
    _result_cache.register_generation(a.larray, "off:a", 1)
    for _ in range(3):
        (a + 1.0).numpy()
    st = htt.executor_stats()
    assert (st["result_cache"]["hits"], st["result_cache"]["stores"]) == (0, 0)
    for k in ("cache_hits", "cache_misses", "cache_bytes_saved", "cache_invalidations"):
        assert st[k] == 0


def test_store_then_hit(pkgs):
    def scenario(p, tag):
        a, b = _staged(p, tag)
        return [_force(a, b), _force(a, b), _force(a, b)]

    _both(pkgs, scenario)
    st = pkgs[1].stats()
    assert st["stores"] >= 1 and st["hits"] >= 2 and st["bytes_saved"] > 0


def test_generation_bump_fails_closed(pkgs):
    def scenario(p, tag):
        a, b = _staged(p, tag)
        first = _force(a, b)
        _force(a, b)
        p.rc.register_generation(p.raw(a), f"{tag}:a", 2)
        again = _force(a, b)
        swept = p.rc.invalidate_prefix(f"{tag}:a")
        return [first, again, np.array(swept)]

    _both(pkgs, scenario)


def test_donation_invalidates_exactly_the_aliasing_entries(pkgs):
    def scenario(p, tag):
        a, b = _staged(p, tag)
        v0 = _force(a, b)
        c = p.array(np.full(N, 5.0, np.float32))
        p.rc.register_generation(p.raw(c), f"{tag}:c", 1)
        v1 = (c + 1.0).numpy()
        dropped = p.rc.note_donation([id(p.raw(a))])
        v2 = (c + 1.0).numpy()
        v3 = _force(a, b)
        return [v0, v1, np.array(dropped), v2, v3]

    _both(pkgs, scenario)


def test_poisoned_entry_rejected_typed(pkgs):
    def corrupt_events(diag):
        with diag._lock:
            return [e for e in diag._resilience_events
                    if e.get("kind") == "cache-corrupt" and e.get("site") == "executor.result_cache"]

    def scenario(p, tag):
        a, b = _staged(p, tag)
        clean = _force(a, b)
        _force(a, b)
        poisoned = p.rc._poison_one()
        value = _force(a, b)
        return [clean, value, np.array(poisoned >= 1)]

    ev0 = len(corrupt_events(diagnostics))
    _both(pkgs, scenario)
    events = corrupt_events(diagnostics)
    assert len(events) == ev0 + 1 and "ResultCacheCorrupt" in events[-1]["detail"]
    assert pkgs[1].stats()["rejects"] == 1
    assert len(corrupt_events(jdiag)) >= 1


def test_uncacheable_labels_and_operands(pkgs):
    for label in ("rand[2]", "defer:normal..add[3]", "dropout", "defer:mul..add[2]"):
        assert _result_cache.uncacheable_label(label) == jrc.uncacheable_label(label)

    def scenario(p, tag):
        big = p.array(np.zeros((256, 256), np.float32))
        outs = [(big + 1.0).numpy() for _ in range(2)]
        return outs + [np.array(p.rc.digest_args((p.raw(big),)) is None)]

    _both(pkgs, scenario)
    a, _ = _staged(pkgs[1], "digest")
    d = _result_cache.digest_args((1.5, a.larray))
    assert d[0] == ("s", "float", "1.5") and d[1] == ("g", "digest:a", 1)


def test_forensic_bypass_labels(pkgs):
    from heat_tpu.core import forensics as jfor
    from heat_tpu.core import profiler as jprof
    from heat_tpu_torch.core import forensics, profiler

    for f in (forensics, jfor):
        f.reset()
        f.arm()
    try:
        for p, prof in zip(pkgs, (jprof, profiler)):
            a, b = _staged(p, "fx")
            big = p.array(np.zeros((256, 256), np.float32))
            with prof.request("tenantR"):
                _force(a, b)
                _force(a, b)
                (big + 1.0).numpy()
        mine, theirs = forensics.records("tenantR"), jfor.records("tenantR")
        assert [r["result_cache"] for r in mine] == [r["result_cache"] for r in theirs]
    finally:
        for f in (forensics, jfor):
            f.disarm()
            f.reset()


def test_in_place_write_into_a_registered_buffer_fails_closed(pkgs):
    p = pkgs[1]
    a, b = _staged(p, "inplace-reg")
    first = _force(a, b)
    _force(a, b)
    st0 = p.stats()
    assert st0["hits"] >= 1
    a.larray.add_(1.0)  # the registered tensor changes behind the cache's back
    after = _force(a, b)
    want = (np.arange(N, dtype=np.float32) + 1.0) * 2.0 + 2.0
    assert after.tobytes() == want.tobytes() and after.tobytes() != first.tobytes()
    st1 = p.stats()
    assert st1["hits"] == st0["hits"]  # never served
    assert st1["invalidations"] >= st0["invalidations"] + 1
    # no longer a named generation: a small CPU tensor digests by its content
    assert _result_cache.digest_args((a.larray,))[0][0] == "h"


def test_in_place_write_into_a_cached_result_fails_closed(pkgs):
    p = pkgs[1]
    a, b = _staged(p, "inplace-res")
    want = _force(a, b)
    hit = a * b + b
    hit_t = hit.larray  # served by a hit: the cache's own tensor
    assert p.stats()["hits"] >= 1
    hit_t.mul_(0.0)  # the caller writes into what the hit handed out
    st0 = p.stats()
    again = _force(a, b)
    assert again.tobytes() == want.tobytes()
    st1 = p.stats()
    assert st1["hits"] == st0["hits"] and st1["invalidations"] == st0["invalidations"] + 1


@pytest.mark.parametrize("order", ["newest_on_a_later_shard", "newest_on_the_first_shard"])
def test_poison_takes_the_newest_use_across_shards(monkeypatch, order):
    """With several shards, ``_poison_one`` corrupts the entry used last by any tenant,
    not the last of the first shard that holds one: a request on another shard that
    poisons its own last result is then rejected typed."""
    from heat_tpu_torch.core import _scheduler

    monkeypatch.setenv("HEAT_TPU_RESULT_CACHE", "1")
    monkeypatch.setenv("HEAT_TPU_SCHED_SHARDS", "4")
    _result_cache.reload()
    _result_cache.clear()
    _result_cache.reset_stats()
    try:
        tenants = {}
        for i in range(64):
            tenants.setdefault(_scheduler.shard_index_for(f"tenant{i}", 4), f"tenant{i}")
        first, later = tenants[0], tenants[2]
        keys = {first: ("first", ()), later: ("later", ())}
        for tenant, key in keys.items():
            assert _result_cache.store(key, torch.arange(4.0), tenant=tenant)
        newest, other = (later, first) if order == "newest_on_a_later_shard" else (first, later)
        assert _result_cache.lookup(keys[newest], tenant=newest) is not _result_cache.MISS
        assert _result_cache._poison_one() == 1
        assert _result_cache.lookup(keys[newest], tenant=newest) is _result_cache.MISS
        assert _result_cache.stats()["rejects"] == 1
        assert _result_cache.lookup(keys[other], tenant=other) is not _result_cache.MISS
    finally:
        _result_cache.clear()
        _result_cache.reset_stats()
        monkeypatch.undo()
        _result_cache.reload()
