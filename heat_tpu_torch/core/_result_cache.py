"""Cross-request result memoization (the ``HEAT_TPU_RESULT_CACHE=1`` tier; the port's
counterpart of heat_tpu/core/_result_cache.py).

Dispatch is deterministic: a cached program is a pure function of its replay spec, so
a (program, inputs) pair seen twice computes the same value twice. This module
memoises at the VALUE level: a bounded, content-addressed map from

    (program fingerprint, input digest) -> result tensors

consulted by ``_Program.__call__`` and the fused-force path BEFORE execution.

Keying / bypass rules (heat_tpu's "uncacheable" contract):

* The program half of the key is ``_compile_cache.fingerprint(prog.spec)``: the
  sha256 of the canonical replay spec. A program with no spec (warmup gap, ``out=``
  signature) is uncacheable.
* The input half is, per operand: the REGISTERED GENERATION id for staged serving
  buffers (:func:`register_generation`; rotation / ``swap_state`` bumps it); a
  host-side content hash for small CPU tensors (``nbytes`` <= 64 KiB); and type +
  ``repr`` for Python/numpy scalars. Any other operand — a large unregistered
  tensor, a CUDA tensor that is not registered, a value still pending from an
  earlier async force — makes the call uncacheable (:func:`digest_args` returns
  None).
* Donation-bearing calls never consult or fill, RNG-consuming labels never consult
  (:func:`uncacheable_label`), and deadline-expired requests are rejected by
  admission before any cache code runs.

**Mutable tensors (the port's own rule).** A ``jax.Array`` cannot change; a torch
tensor can be written in place. So a registration records the tensor's version
counter (``_version``) and storage address, and so does every cached result, leaf
by leaf:

* a registered tensor whose version or storage moved since it was registered is a
  new, unnamed value: its registration is dropped, its tag's generation is bumped
  (every entry keyed on the old one fails closed) and those entries are swept,
  counted as ``invalidations``; the call digests as uncacheable and recomputes;
* a cached result whose version or storage moved since it was stored (a caller
  wrote into the tensor a hit handed out) is dropped at its next hit, counted as an
  invalidation, and recomputed.

So a caller that writes in place into a cached result, or into a registered buffer,
is never served a stale value. A tensor made under ``torch.inference_mode`` keeps no
version counter, so it is neither registered nor cached.

**Host hashing (a recorded decision).** heat_tpu hashes small replicated operands on
the host. For a CUDA tensor that is a device-to-host copy and a stream sync on every
call, so the port hashes only CPU tensors; on the card an operand is cacheable when it
is registered (or a scalar). :func:`host_hash_bytes` counts the bytes hashed.

Invalidation (a stale or poisoned entry is NEVER served): every hit re-validates the
(tag, generation) pairs of its digest against the live generation table and its
result tensors' versions; donation of any registered or cached tensor
(:func:`note_donation`, wired into the executor's ownership registry and the ``out=``
donation sites) drops exactly the entries whose inputs or outputs alias it;
``clear_executor_cache()`` drops every entry (:func:`clear`); an entry whose tensors
fail the structural re-check at hit time (recorded shape/dtype mismatch) is a typed
``cache-corrupt`` rejection through the always-on resilience stream, and the caller
recomputes.

Hot entries replicate across the scheduler shards: the cache is sharded exactly like
the dispatch scheduler (``_scheduler.shard_index_for`` over the request tenant), each
shard an LRU bounded by ``HEAT_TPU_RESULT_CACHE_BYTES // shards``, and an entry
promoted past ``_PROMOTE_AFTER`` hits is copied into every other shard.

The whole tier is OFF — every dispatch-path hook one relaxed-flag read — unless
``HEAT_TPU_RESULT_CACHE=1``. The knobs are memoised and re-read at
``reload_env_knobs()`` / ``clear_executor_cache()`` (:func:`reload`).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import _scheduler
from . import diagnostics
from . import profiler


class ResultCacheCorrupt(Exception):
    """A cached result failed its structural re-check at hit time."""


#: Sentinel distinguishing "no cached value" from a legitimately cached None.
MISS = object()

_DEFAULT_BUDGET = 256 << 20   # HEAT_TPU_RESULT_CACHE_BYTES default: 256 MiB
_SMALL_BYTES = 64 << 10       # host-digest fallback cutoff for replicated operands
_PROMOTE_AFTER = 4            # hits on one shard before cross-shard replication
_MAX_ENTRIES = 256            # per-shard entry cap (beyond the byte budget)
_REGISTRY_MAX = 8192          # generation-registry size before dead-ref pruning

# program labels that consume RNG: memoizing them would freeze randomness
_RNG_MARKERS = (
    "rand", "normal", "uniform", "shuffle", "permutation", "choice", "sample",
    "dropout",
)

# Module lock: guards the generation registry / tag table and the shard tuple
# rebuild.  Per-shard entry state lives behind each shard's own _mu (leaf
# locks — never held together, never while holding _lock).
_lock = threading.Lock()
# id(tensor) -> (tag, gen, weakref, (version, storage address) at registration)
_registry: Dict[int, Tuple[str, int, Any, Tuple[int, int]]] = {}
_tag_gen: Dict[str, int] = {}                    # tag -> live generation
_shards: Tuple["_ShardCache", ...] = ()
# stamps each entry at store, hit and replication, so the newest use across
# shards is known (each shard's LRU order is its own)
_use_stamp = itertools.count()

# memoised knobs — relaxed single-word reads on the dispatch hot path
_enabled = False
_budget_bytes = _DEFAULT_BUDGET

# bytes of CPU tensors hashed on the host for digests, exact under its own leaf
# lock (request threads hash concurrently)
_hash_lock = threading.Lock()
_host_hash_bytes = 0


class _Entry:
    """One memoised result: the value buffers, the structural avals recorded
    at store time (re-checked on every hit), the generation pairs its digest
    was keyed on (re-validated on every hit), and the output buffer ids the
    donation sweep matches against."""

    __slots__ = ("key", "value", "avals", "nbytes", "gens", "out_ids", "hits", "marks", "used")

    def __init__(self, key, value, avals, nbytes, gens, out_ids, marks):
        self.key = key
        self.value = value
        self.avals = avals
        self.nbytes = nbytes
        self.gens = gens
        self.out_ids = out_ids
        self.hits = 0
        self.marks = marks  # each result tensor's (version, storage address) when stored
        self.used = 0


class _ShardCache:
    """One scheduler-shard's LRU slice of the cache (own leaf lock)."""

    __slots__ = (
        "_mu", "_entries", "_bytes", "_budget",
        "hits", "misses", "stores", "bytes_saved", "invalidations",
        "evictions", "replications", "rejects",
    )

    def __init__(self, budget: int):
        self._mu = threading.Lock()
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self._bytes = 0
        self._budget = max(1, budget)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.bytes_saved = 0
        self.invalidations = 0
        self.evictions = 0
        self.replications = 0
        self.rejects = 0

    def _drop_locked(self, key: Any) -> Optional[_Entry]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry.nbytes
        return entry

    def _insert_locked(self, entry: _Entry) -> bool:
        """LRU-insert under the byte budget and entry cap.  False when the
        entry alone exceeds the shard budget (not stored)."""
        if entry.nbytes > self._budget:
            return False
        while self._entries and (
            self._bytes + entry.nbytes > self._budget
            or len(self._entries) >= _MAX_ENTRIES
        ):
            _, old = self._entries.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1
        entry.used = next(_use_stamp)
        self._entries[entry.key] = entry
        self._bytes += entry.nbytes
        return True

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "bytes_saved": self.bytes_saved,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "replications": self.replications,
                "rejects": self.rejects,
            }


# --------------------------------------------------------------------- knobs


def reload() -> None:
    """Re-read ``HEAT_TPU_RESULT_CACHE`` / ``HEAT_TPU_RESULT_CACHE_BYTES``
    (the documented re-read point — wired into ``ht.reload_env_knobs``).
    Turning the tier off drops every entry; resizing the budget or the shard
    count rebuilds the shard slices empty (a result cache refills in one
    request wave — correctness never depends on its contents)."""
    global _enabled, _budget_bytes, _shards
    enabled = os.environ.get("HEAT_TPU_RESULT_CACHE") == "1"
    try:
        budget = max(1, int(os.environ.get(
            "HEAT_TPU_RESULT_CACHE_BYTES", str(_DEFAULT_BUDGET)
        )))
    except ValueError:
        budget = _DEFAULT_BUDGET
    try:
        nshards = max(1, int(os.environ.get(
            "HEAT_TPU_SCHED_SHARDS", str(min(4, os.cpu_count() or 1))
        )))
    except ValueError:
        nshards = max(1, min(4, os.cpu_count() or 1))
    with _lock:
        if not enabled:
            _shards = ()
        elif len(_shards) != nshards or budget != _budget_bytes:
            _shards = tuple(
                _ShardCache(budget // nshards) for _ in range(nshards)
            )
        _enabled = enabled
        _budget_bytes = budget


def enabled() -> bool:
    """Whether the result-memoization tier is on (``HEAT_TPU_RESULT_CACHE=1``;
    memoised — see :func:`reload`)."""
    return _enabled


# ---------------------------------------------------------------- generations


def _mark(t) -> Optional[Tuple[int, int]]:
    """A tensor's (version counter, storage address): what an in-place write or a
    re-bound storage moves. None for a tensor without a version counter (made under
    ``torch.inference_mode``)."""
    try:
        return (t._version, t.untyped_storage().data_ptr())
    except (RuntimeError, AttributeError):
        return None


def register_generation(value: Any, tag: str, gen: int) -> None:
    """Key future digests of ``value`` on ``(tag, gen)`` — the no-readback
    identity for pre-staged serving buffers.  Re-registering a tag at a
    higher generation (batch rotation, ``swap_state``) makes every cached
    entry keyed on an older generation fail validation closed.  The tensor's
    version and storage are recorded: a later in-place write unregisters it
    (see the module header).  A value that cannot be weak-referenced, or keeps
    no version counter, is left unregistered (it digests as uncacheable)."""
    try:
        ref = weakref.ref(value)
    except TypeError:
        return
    mark = _mark(value)
    if mark is None:
        return
    gen = int(gen)
    with _lock:
        _registry[id(value)] = (tag, gen, ref, mark)
        prev = _tag_gen.get(tag)
        _tag_gen[tag] = gen if prev is None else max(prev, gen)
        if len(_registry) > _REGISTRY_MAX:
            for i in [i for i, (_, _, r, _) in _registry.items() if r() is None]:
                del _registry[i]


def uncacheable_label(label: Optional[str]) -> bool:
    """Whether a program label names an RNG-consuming dispatch (never
    memoised — a cached sample is not a sample).  Substring belt over the
    op-derived labels; a false positive only costs a cache bypass."""
    if not label:
        return False
    low = label.lower()
    return any(m in low for m in _RNG_MARKERS)


def digest_args(args) -> Optional[Tuple]:
    """The content digest of one call's operands, or None when any operand is
    uncacheable.  Per operand: ``("g", tag, gen)`` for registered staged
    buffers (no readback), ``("h", shape, dtype, sha1)`` for small CPU
    tensors (host-side hash), ``("s", type, repr)`` for scalars."""
    parts = []
    for v in args:
        d = _digest_one(v)
        if d is None:
            return None
        parts.append(d)
    return tuple(parts)


def _digest_one(v) -> Optional[Tuple]:
    global _host_hash_bytes
    if isinstance(v, (bool, int, float, complex, str, bytes, type(None),
                      np.number, np.bool_)):
        return ("s", type(v).__name__, repr(v))
    if not isinstance(v, torch.Tensor):
        return None  # pending async value / unknown operand: uncacheable
    reg = _registry.get(id(v))
    if reg is not None and reg[2]() is v:
        if _mark(v) == reg[3]:
            return ("g", reg[0], reg[1])
        _written_in_place(id(v), reg)
        return None
    if v.device.type != "cpu":
        return None  # no device-to-host copy on the dispatch path
    nbytes = v.numel() * v.element_size()
    if nbytes > _SMALL_BYTES:
        return None
    try:
        h = hashlib.sha1(v.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()
    except Exception:  # ht: ignore[silent-except] -- any digest failure (exotic dtype, a view torch refuses) means "uncacheable", the documented fallback; the call executes normally
        return None
    with _hash_lock:
        _host_hash_bytes += nbytes
    return ("h", str(tuple(v.shape)), str(v.dtype), h)


def _written_in_place(i: int, reg) -> None:
    """A registered tensor moved (an in-place write, a new storage) since it was
    registered: drop the registration, bump its tag's generation past every entry
    keyed on it, and sweep those entries (counted as invalidations)."""
    tag, gen = reg[0], reg[1]
    with _lock:
        if _registry.get(i) is reg:
            del _registry[i]
        _tag_gen[tag] = max(_tag_gen.get(tag, gen), gen) + 1
    dropped = 0
    for sh in _shards:
        with sh._mu:
            dead = [k for k, e in sh._entries.items() if any(t == tag for t, _ in e.gens)]
            for k in dead:
                sh._drop_locked(k)
            sh.invalidations += len(dead)
            dropped += len(dead)
    if dropped and diagnostics._enabled:
        diagnostics.counter("executor.result_cache_invalidation", dropped)


def host_hash_bytes() -> int:
    """Bytes of CPU tensors hashed on the host for digests since the last
    :func:`reset_stats` (always 0 for CUDA operands: they are never hashed)."""
    return _host_hash_bytes


# ------------------------------------------------------------- lookup / store


def _leaves_of(value) -> Optional[Tuple]:
    leaves = value if isinstance(value, (tuple, list)) else (value,)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            return None
    return tuple(leaves)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def result_nbytes(value) -> int:
    """Total buffer bytes of a cached result value (the same leaf fold
    :func:`store` records as the entry's ``nbytes``). The executor's
    forensics hooks use this to credit a hit's bytes-saved to the serving
    tenant's cost meter without re-entering any shard lock."""
    leaves = _leaves_of(value)
    if leaves is None:
        return 0
    return sum(_nbytes(leaf) for leaf in leaves)


def _entry_corrupt(entry: _Entry) -> Optional[str]:
    """Structural re-check at hit time: None when sound, else the rejection
    detail.  Catches poisoned entries (recorded shapes/dtypes no longer match
    the tensors) — the entry must never be served."""
    leaves = _leaves_of(entry.value)
    if leaves is None or len(leaves) != len(entry.avals):
        return "cached value lost its buffer structure"
    for leaf, (shape, dtype) in zip(leaves, entry.avals):
        if str(tuple(leaf.shape)) != shape or str(leaf.dtype) != dtype:
            return (
                f"cached aval mismatch: stored ({shape}, {dtype}), "
                f"found ({tuple(leaf.shape)}, {leaf.dtype})"
            )
    return None


def _written_since_stored(entry: _Entry) -> bool:
    leaves = _leaves_of(entry.value)
    return leaves is None or tuple(_mark(leaf) for leaf in leaves) != entry.marks


def _reject(detail: str, *, fingerprint_: str = "") -> None:
    """Record one typed result-cache rejection (corruption is never silent
    and never fatal: the caller recomputes) — the compile cache's contract,
    one tier up."""
    diagnostics.record_resilience_event(
        "executor.result_cache", "cache-corrupt",
        f"ResultCacheCorrupt: {detail}"
        + (f" (fingerprint {fingerprint_[:12]})" if fingerprint_ else ""),
    )
    if diagnostics._enabled:
        diagnostics.counter("executor.result_cache_reject")
        diagnostics.record_fallback(
            "executor.result_cache", f"ResultCacheCorrupt: {detail}"
        )


def _shard_for(tenant) -> Optional[_ShardCache]:
    shards = _shards
    if not shards:
        return None
    return shards[_scheduler.shard_index_for(tenant, len(shards))]


def lookup(key: Tuple[str, Tuple], tenant=None, count_miss: bool = True):
    """The cached value for ``key`` on the tenant's shard, or :data:`MISS`.

    Every hit re-validates: the generation pairs in the entry's digest
    against the live tag table (stale → invalidated, counted, MISS) and the
    buffer structure against the stored avals (corrupt → typed rejection,
    dropped, MISS).  A hit that crosses the promotion threshold replicates
    the entry to the other shards after the shard lock is released.
    ``count_miss=False`` keeps a pre-dispatch consult (the force path peeks
    before queueing; the program call consults again) from double-counting
    one execution's miss."""
    sh = _shard_for(tenant)
    if sh is None:
        return MISS
    corrupt = None
    promote = False
    with sh._mu:
        entry = sh._entries.get(key)
        if entry is None:
            if count_miss:
                sh.misses += 1
            return MISS
        if (any(_tag_gen.get(tag) != gen for tag, gen in entry.gens)
                or _written_since_stored(entry)):
            sh._drop_locked(key)
            sh.invalidations += 1
            sh.misses += 1
            return MISS
        corrupt = _entry_corrupt(entry)
        if corrupt is not None:
            sh._drop_locked(key)
            sh.rejects += 1
            sh.misses += 1
        else:
            entry.hits += 1
            sh.hits += 1
            sh.bytes_saved += entry.nbytes
            entry.used = next(_use_stamp)
            sh._entries.move_to_end(key)
            promote = entry.hits == _PROMOTE_AFTER
            value = entry.value
    if corrupt is not None:
        _reject(corrupt, fingerprint_=key[0])
        return MISS
    if promote:
        _replicate(entry)
    if diagnostics._enabled:
        diagnostics.counter("executor.result_cache_hit")
    if profiler._active:
        total = 0
        for s in _shards:
            total += s.bytes_saved
        # counter track: cumulative result bytes served without execution
        profiler.record_counter("result_cache.bytes_saved", total)
    return value


def store(key: Tuple[str, Tuple], value, tenant=None) -> bool:
    """Memoise one successful plain-path execution under ``key`` on the
    tenant's shard.  Values whose leaves are not array buffers are refused;
    the entry records the structural avals and generation pairs it must
    re-validate on every hit.  The stored strong reference doubles as the
    donation guard: refcount sanitation (``sanitize_leaf_donation``) can
    never prove sole ownership of a buffer the cache still holds."""
    sh = _shard_for(tenant)
    if sh is None:
        return False
    leaves = _leaves_of(value)
    if leaves is None:
        return False
    marks = tuple(_mark(leaf) for leaf in leaves)
    if None in marks:
        return False
    nbytes = 0
    for leaf in leaves:
        nbytes += _nbytes(leaf)
    avals = tuple((str(tuple(leaf.shape)), str(leaf.dtype)) for leaf in leaves)
    gens = tuple((d[1], d[2]) for d in key[1] if d[0] == "g")
    entry = _Entry(key, value, avals, nbytes,
                   gens, tuple(id(leaf) for leaf in leaves), marks)
    with sh._mu:
        if key in sh._entries:
            sh._entries[key].used = next(_use_stamp)
            sh._entries.move_to_end(key)
            return True
        if not sh._insert_locked(entry):
            return False
        sh.stores += 1
    if diagnostics._enabled:
        diagnostics.counter("executor.result_cache_store")
    return True


def _replicate(entry: _Entry) -> None:
    """Copy a promoted hot entry into every shard that lacks it (one leaf
    lock at a time — never two shard locks together).  Replicas start their
    own hit count; validation at lookup keeps a replica that raced an
    invalidation sweep from ever being served."""
    for sh in _shards:
        with sh._mu:
            if entry.key in sh._entries:
                continue
            clone = _Entry(entry.key, entry.value, entry.avals, entry.nbytes,
                           entry.gens, entry.out_ids, entry.marks)
            if sh._insert_locked(clone):
                sh.replications += 1


# ---------------------------------------------------------------- invalidation


def note_donation(buffer_ids) -> int:
    """Invalidate exactly the entries touching donated buffers: drop the
    buffers' generation registrations, bump their tags (entries keyed on
    them fail validation closed even on other shards' in-flight lookups),
    and eagerly sweep entries whose recorded input tags or output buffer ids
    alias the donation.  Returns the number of entries dropped.  Wired into
    ``_acquire_buffers`` (fused-force leaf donation) and the staged out=
    donation sites."""
    if not _enabled:
        return 0
    idset = set(buffer_ids)
    if not idset:
        return 0
    tags = set()
    with _lock:
        for i in idset:
            reg = _registry.pop(i, None)
            if reg is not None:
                tags.add(reg[0])
                _tag_gen[reg[0]] = _tag_gen.get(reg[0], reg[1]) + 1
    dropped = 0
    for sh in _shards:
        with sh._mu:
            dead = [
                k for k, e in sh._entries.items()
                if not idset.isdisjoint(e.out_ids)
                or any(tag in tags for tag, _ in e.gens)
            ]
            for k in dead:
                sh._drop_locked(k)
            sh.invalidations += len(dead)
            dropped += len(dead)
    if dropped and diagnostics._enabled:
        diagnostics.counter("executor.result_cache_invalidation", dropped)
    return dropped


def invalidate_prefix(prefix: str) -> int:
    """Sweep every entry keyed on a stale generation of a ``prefix``-tagged
    buffer family (``swap_state`` wiring: the pool re-registers its state
    leaves at the new generation first, then sweeps the old one out).  Exact:
    entries whose recorded (tag, gen) pairs all still match the live table —
    including post-swap entries — survive.  Returns the number dropped."""
    if not _enabled:
        return 0
    want = prefix + ":"
    dropped = 0
    for sh in _shards:
        with sh._mu:
            dead = [
                k for k, e in sh._entries.items()
                if any(
                    (tag == prefix or tag.startswith(want))
                    and _tag_gen.get(tag) != gen
                    for tag, gen in e.gens
                )
            ]
            for k in dead:
                sh._drop_locked(k)
            sh.invalidations += len(dead)
            dropped += len(dead)
    if dropped and diagnostics._enabled:
        diagnostics.counter("executor.result_cache_invalidation", dropped)
    return dropped


def clear() -> None:
    """Drop every cached entry on every shard (``clear_executor_cache``'s
    result-cache leg).  Generation registrations survive — they are buffer
    identity metadata, not cached results — so pre-staged serving state stays
    cacheable after the clear; the first post-clear read of any key is a
    guaranteed recompute."""
    for sh in _shards:
        with sh._mu:
            sh._entries.clear()
            sh._bytes = 0


# ------------------------------------------------------------------ telemetry


def stats() -> dict:
    """Folded cache telemetry (the ``result_cache`` block of
    ``executor_stats()``): entry/byte occupancy and the hit / miss / store /
    bytes-saved / invalidation / eviction / replication / reject tallies,
    summed over shards with the per-shard breakdown alongside."""
    shards = _shards
    per_shard = [sh.snapshot() for sh in shards]
    out = {
        "enabled": _enabled,
        "shards": len(shards),
        "budget_bytes": _budget_bytes,
        "entries": 0, "bytes": 0, "hits": 0, "misses": 0, "stores": 0,
        "bytes_saved": 0, "invalidations": 0, "evictions": 0,
        "replications": 0, "rejects": 0,
    }
    for snap in per_shard:
        for field in ("entries", "bytes", "hits", "misses", "stores",
                      "bytes_saved", "invalidations", "evictions",
                      "replications", "rejects"):
            out[field] += snap[field]
    out["per_shard"] = per_shard
    return out


def reset_stats() -> None:
    """Zero the tallies and the host-hash byte count (entries are kept — they
    are cache contents, not statistics; ``clear_executor_cache`` drops both)."""
    global _host_hash_bytes
    with _hash_lock:
        _host_hash_bytes = 0
    for sh in _shards:
        with sh._mu:
            sh.hits = 0
            sh.misses = 0
            sh.stores = 0
            sh.bytes_saved = 0
            sh.invalidations = 0
            sh.evictions = 0
            sh.replications = 0
            sh.rejects = 0


def _poison_one() -> int:
    """TEST HOOK: corrupt the most-recently-used cached entry in place
    (recorded avals mangled) — every cross-shard replica of its key too — so
    the next hit on it exercises the typed ``cache-corrupt`` rejection path.
    Returns how many entry copies were poisoned.  The newest use is taken
    across shards: each shard's last entry is its own newest, and the shard
    a request fills depends on its tenant (or thread)."""
    key, newest = None, -1
    for sh in _shards:
        with sh._mu:
            if sh._entries:
                last = sh._entries[next(reversed(sh._entries))]
                if last.used > newest:
                    key, newest = last.key, last.used
    if key is None:
        return 0
    poisoned = 0
    for sh in _shards:
        with sh._mu:
            entry = sh._entries.get(key)
            if entry is not None:
                entry.avals = tuple(
                    ("poisoned", "poisoned") for _ in entry.avals
                )
                poisoned += 1
    return poisoned


reload()
