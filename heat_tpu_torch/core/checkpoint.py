"""Sharded checkpoint and resume (counterpart of heat_tpu/core/checkpoint.py, on disk the
same format: a checkpoint written by either package restores in the other).

Schema ``heat-tpu-checkpoint/2`` stores every split DNDarray leaf as **chunk files** on
the canonical chunk grid: chunk ``i`` holds rows ``[i*c, min((i+1)*c, n))`` along the
leaf's split, ``c = ceil(n / shards)``, which is exactly rank ``i``'s chunk. So:

- **Parallel writes.** Each rank writes its own chunk (a rank with no rows writes none),
  device to host and to disk on a small writer pool (``HEAT_TPU_CKPT_WRITERS``, default
  ``min(8, cpu)``), every leaf's chunks queued at once: host memory peaks at one chunk a
  writer thread (heat_tpu waits leaf by leaf). Replicated DNDarrays, torch tensors, numpy
  arrays and Python scalars are one chunk that rank 0 writes.
- **Resharding on restore.** The manifest records every chunk's (offset, rows, nbytes,
  sha256). :func:`load_checkpoint` takes a template whose split or rank count may differ
  from the writer's; each rank reads only the byte ranges of the chunks that overlap its
  target rows (contiguous row ranges for split-0 grids, whole chunks otherwise) and
  copies them to its device once. ``strict="layout"`` refuses a layout change
  (:class:`CheckpointLayoutMismatch`).

Payloads are raw little-endian buffers with their dtype named in the manifest. bfloat16
is written as torch's bytes (viewed as int16) under the name ``"bfloat16"`` and read back
into ``torch.bfloat16``, so it needs no ml_dtypes.

The tree is flattened as ``jax.tree.flatten`` does, so both packages number the leaves
alike: dict keys sorted (``OrderedDict`` in insertion order), lists, tuples and
namedtuples in order, ``None`` no leaf. Strings are no leaf either (they come back from
the template; heat_tpu cannot restore a string leaf). Leaves restore as the template's:
DNDarrays with its split, comm and device; torch tensors on its device; numpy arrays;
Python scalars as their type.

Failure contract (heat_tpu's):

- **Atomic commit.** A checkpoint is assembled in ``<dir>.tmp.v2``: chunks written under
  the ``checkpoint.chunk_write`` site, the manifest LAST (``checkpoint.manifest``), then
  committed under ``checkpoint.commit`` by renaming the previous generation aside, the
  new one in, and deleting the old. A crash at any point leaves the previous generation
  or the new one restorable; the next save sweeps what it left (:func:`_sweep_stale`).
- **Partial-write detection.** :func:`verify_checkpoint` checks every chunk's length and
  SHA-256 (in parallel) and the chunk grid; :func:`load_checkpoint` verifies before it
  restores and raises :class:`CheckpointCorrupt` naming each torn, missing or
  mismatched file.
- **Degradation ladder.** Chunk writes that exhaust their retry policy feed the
  ``checkpoint.chunk_write`` circuit breaker and degrade the save to the serialized v1
  single-writer path (schema ``heat-tpu-checkpoint/1``), recorded as a ``fallback``
  resilience event and a ``diagnostics.record_fallback``; an open breaker sends later
  saves to v1 until its cooldown.
- **Agreement.** heat_tpu agrees across processes over its coordination service
  through the supervised ``kv_barrier``/``kv_wait``. Here, while the supervision plane
  is armed on the job's store, the barriers and the MIN agreement are the same
  supervised waits over that store (abortable mid-wait, typed on timeout, naming the
  ranks that never arrived); otherwise they are collectives of the world communicator
  (``TorchCommunication.barrier``/``agree_min``). Either runs rank-symmetrically on
  every exit path, so a failed write on any rank raises
  :class:`CheckpointWriteFailed` or the original error on every rank, never a hang.
  Ranks other than 0 publish their chunk metadata in ``chunkmeta.p{rank}.json``
  sidecars, which rank 0 folds into the manifest.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import diagnostics, resilience, supervision
from . import types as _types
from .communication import COMM_WORLD, sanitize_comm
from .devices import sanitize_device
from .dndarray import DNDarray

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "CheckpointManager",
    "CheckpointCorrupt",
    "CheckpointLayoutMismatch",
    "CheckpointWriteFailed",
    "last_restore_stats",
    "SCHEMA",
    "SCHEMA_V1",
    "MANIFEST_NAME",
]

SCHEMA = "heat-tpu-checkpoint/2"
SCHEMA_V1 = "heat-tpu-checkpoint/1"
MANIFEST_NAME = "manifest.json"

_WRITE_SITE = "checkpoint.write"  # v1 serialized leaf writes
_MANIFEST_SITE = "checkpoint.manifest"
_CHUNK_WRITE_SITE = "checkpoint.chunk_write"
_CHUNK_READ_SITE = "checkpoint.chunk_read"
_COMMIT_SITE = "checkpoint.commit"
_PRUNE_SITE = "checkpoint.prune"
_META_SITE = "checkpoint.chunk_meta"  # the ranks' sidecar metadata

#: repeated exhausted chunk writes open the breaker; later saves then go straight to the
#: serialized v1 path (recorded) until the cooldown admits a parallel trial
_CHUNK_BREAKER_THRESHOLD = 3
_CHUNK_BREAKER_COOLDOWN_S = 60.0

_state_lock = threading.Lock()
_open_restores: Dict[str, int] = {}
_restore_stats: Dict[str, int] = {"read_bytes": 0, "host_bytes_peak": 0}
_hold_seq = 0


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification on restore. ``problems`` lists one
    finding per torn, missing or mismatched file."""

    def __init__(self, directory: str, problems: List[str]):
        self.directory = directory
        self.problems = list(problems)
        super().__init__(f"checkpoint at {directory!r} is corrupt or partially written: {'; '.join(self.problems)}")


class CheckpointLayoutMismatch(ValueError):
    """``load_checkpoint(strict="layout")`` found the stored layout (split, shard count)
    differing from the template's; ``strict="reshard"`` (the default) allows it."""


class CheckpointWriteFailed(RuntimeError):
    """A distributed save failed on some rank: every rank raises this (or the original
    error) instead of hanging at the commit barrier."""


# ------------------------------------------------------------------ the tree
def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``jax.tree.flatten``'s leaves and a structure to rebuild the tree from: dict keys
    sorted, ``OrderedDict`` in insertion order, lists, tuples and namedtuples in order;
    None and strings are no leaf."""
    leaves: List[Any] = []

    def walk(node):
        if node is None or isinstance(node, str):
            return ("const", node)
        if isinstance(node, dict):
            keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
            return ("dict", type(node), keys, [walk(node[k]) for k in keys], getattr(node, "default_factory", None))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), [walk(v) for v in node])
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, [walk(v) for v in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def _unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "const":
            return d[1]
        if kind == "dict":
            _, cls, keys, subs, factory = d
            items = [(k, build(s)) for k, s in zip(keys, subs)]
            if cls is collections.defaultdict:
                return collections.defaultdict(factory, items)
            try:
                return cls(items)
            except TypeError:
                return dict(items)
        if kind == "namedtuple":
            return d[1](*[build(s) for s in d[2]])
        values = [build(s) for s in d[1]]
        return values if kind == "list" else tuple(values)

    return build(treedef)


# ------------------------------------------------------------------ dtypes and bytes
def _dtype_name(dtype) -> str:
    """The manifest's name of a torch or numpy dtype (numpy's, and ``"bfloat16"``)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype.name
    return np.dtype(dtype).name


def _carrier(name: str) -> np.dtype:
    """The numpy dtype whose bytes a payload of ``name`` is read as (int16 for bfloat16,
    which numpy lacks without ml_dtypes)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _contiguous(arr) -> np.ndarray:
    """``arr`` as a C-contiguous array, 0-d kept 0-d (``np.ascontiguousarray`` makes it 1-d)."""
    arr = np.asarray(arr)
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _as_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """A payload read as its carrier dtype, as a torch tensor of the dtype ``name``."""
    t = torch.from_numpy(_contiguous(arr))
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _as_numpy(arr: np.ndarray, name: str) -> np.ndarray:
    """A payload read as its carrier dtype, as numpy's array of ``name`` (bfloat16 through
    ml_dtypes, as heat_tpu returns it)."""
    if name == "bfloat16":
        import ml_dtypes

        return arr.view(ml_dtypes.bfloat16)
    return arr


def _host_array(value: Any) -> Tuple[np.ndarray, str]:
    """A leaf's value on the host, as an array of its carrier dtype, and its dtype name."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().cpu()
        name = _dtype_name(t.dtype)
        return (t.view(torch.int16) if name == "bfloat16" else t).numpy(), name
    arr = _contiguous(value)
    name = arr.dtype.name
    return (arr.view(np.int16) if name == "bfloat16" else arr), name


def _payload(host: np.ndarray) -> np.ndarray:
    """Raw bytes of a host array without a copy."""
    return host.reshape(-1).view(np.uint8)


# ------------------------------------------------------------------ agreement
def _world():
    return COMM_WORLD


def _is_writer() -> bool:
    return _world().rank == 0


# The supervised coordination waits: one namespace per barrier/agreement, numbered in
# call order (every rank calls them in one order). A rank entering wait ``n`` has
# seen every rank publish ``n - 1``, so every rank has finished reading ``n - 2``:
# its own keys of ``n - 2`` are deleted then.
_coord_seq = 0
_coord_mine: Dict[int, List[str]] = {}


def _reset_coordination() -> None:
    """Restart the wait numbering (an elastic restart's new generation)."""
    global _coord_seq
    with _state_lock:
        _coord_seq = 0
        _coord_mine.clear()


def _coord_monitor():
    """The armed supervision monitor when its coordinator is the world's store, else
    None (single process, or the plane off: the waits are collectives)."""
    if not supervision._armed:
        return None
    mon = supervision.current_monitor()
    if (mon is None or mon.nprocs <= 1 or mon.nprocs != _world().size
            or not isinstance(mon.coordinator, supervision.ClientCoordinator)):
        return None
    return mon


def _coord_publish(mon, kind: str, value: str) -> str:
    """Publish this rank's key of the next wait namespace; returns the namespace."""
    global _coord_seq
    with _state_lock:
        _coord_seq += 1
        seq = _coord_seq
        stale = [k for s in list(_coord_mine) if s <= seq - 2 for k in _coord_mine.pop(s)]
        ns = f"heat_tpu/ckpt/{seq}/{kind}"
        _coord_mine[seq] = [f"{ns}/{mon.rank}"]
    for key in stale:
        try:
            mon.coordinator.store.delete_key(key)
        except Exception as exc:  # a leftover key costs bytes, not correctness
            diagnostics.record_resilience_event("checkpoint.coord", "sweep-failed",
                                                f"{type(exc).__name__}: {exc}")
    mon.coordinator.set(f"{ns}/{mon.rank}", value)
    return ns


def _barrier(tag: str) -> None:
    """Every rank of the world reaches this point (``tag`` names it for the reader)."""
    mon = _coord_monitor()
    if mon is None:
        _world().barrier()
        return
    ns = _coord_publish(mon, "barrier", "1")
    supervision.kv_barrier(ns, nprocs=mon.nprocs, rank=mon.rank, site="checkpoint.barrier",
                           coordinator=mon.coordinator)


def _agree_min(flag: int) -> int:
    """The least of every rank's ``flag``, the same on every rank: a branch on it cannot
    split the ranks' collectives. The agreement that turns one rank's failure into every
    rank's typed exception instead of a distributed hang."""
    mon = _coord_monitor()
    if mon is None:
        return _world().agree_min(flag)
    ns = _coord_publish(mon, "agree", str(int(flag)))
    return min(
        int(supervision.kv_wait(f"{ns}/{i}", site="checkpoint.agree", coordinator=mon.coordinator))
        for i in range(mon.nprocs)
    )


def _writer_pool_size() -> int:
    """Writer and verifier pool width: ``HEAT_TPU_CKPT_WRITERS`` or ``min(8, cpu)``."""
    try:
        n = int(os.environ.get("HEAT_TPU_CKPT_WRITERS", "") or 0)
    except ValueError:
        n = 0
    return n if n >= 1 else min(8, os.cpu_count() or 1)


def _chunk_breaker() -> resilience.CircuitBreaker:
    return resilience.breaker(
        _CHUNK_WRITE_SITE, failure_threshold=_CHUNK_BREAKER_THRESHOLD, cooldown_s=_CHUNK_BREAKER_COOLDOWN_S
    )


def _sweep_stale(directory: str) -> None:
    """Clean up what a crashed earlier save left: ``.tmp.*`` assembly dirs are deleted (a
    partial chunk set lives only there); a ``.old.*`` backup is renamed back when the
    crash stranded it (the commit died between its two renames and the target is gone),
    else deleted."""
    base = os.path.basename(directory)
    parent = os.path.dirname(directory) or "."
    try:
        names = os.listdir(parent)
    except FileNotFoundError:
        return
    for name in sorted(names):
        full = os.path.join(parent, name)
        if name.startswith(f"{base}.tmp."):
            shutil.rmtree(full, ignore_errors=True)
        elif name.startswith(f"{base}.old."):
            if not os.path.exists(directory):
                try:
                    os.rename(full, directory)
                    diagnostics.record_resilience_event(
                        "checkpoint.save", "recovered", f"restored crash-stranded backup {name} to {directory}"
                    )
                    continue
                except OSError:
                    pass
            shutil.rmtree(full, ignore_errors=True)


def _commit_dir(tmpdir: str, directory: str) -> None:
    """Commit an assembled checkpoint dir: the previous generation renamed aside, the new
    one in, then the old deleted. The ``checkpoint.commit`` fault site fires once before
    each rename, so a plan can kill the commit at either point."""
    backup = None
    if os.path.exists(directory):
        backup = f"{directory}.old.{os.getpid()}"
        shutil.rmtree(backup, ignore_errors=True)
        if resilience._armed:
            resilience.maybe_fault(_COMMIT_SITE)
        os.rename(directory, backup)
    try:
        if resilience._armed:
            resilience.maybe_fault(_COMMIT_SITE)
        os.rename(tmpdir, directory)
    except BaseException:
        if backup is not None:
            try:
                os.rename(backup, directory)
            except OSError:
                pass  # the old bits stay recoverable at the backup path
        raise
    if backup is not None:
        shutil.rmtree(backup, ignore_errors=True)
    resilience.fsync_dir(os.path.dirname(directory) or ".")


def _write_manifest(tmpdir: str, manifest: dict) -> None:
    def write(tmp_path: str) -> None:
        with open(tmp_path, "w") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")

    # the manifest LAST: its presence marks the payload set complete
    resilience.atomic_write(os.path.join(tmpdir, MANIFEST_NAME), write, site=_MANIFEST_SITE)
    resilience.fsync_dir(tmpdir)


# ------------------------------------------------------------------ v1 save
def _split_code(leaf: Any) -> int:
    if isinstance(leaf, DNDarray):
        return leaf.split if leaf.split is not None else -1
    return -2  # a plain leaf, restored as the template's


def _save_v1(tree: Any, directory: str) -> None:
    """The serialized single-writer path (schema ``heat-tpu-checkpoint/1``): every
    DNDarray gathered on every rank, rank 0 writes everything. The target of the
    degradation ladder, and kept readable."""
    leaves, _ = _flatten(tree)
    host = [_host_array(leaf._global() if isinstance(leaf, DNDarray) else leaf) for leaf in leaves]
    if not _is_writer():
        _barrier(f"save:{directory}")
        return
    _sweep_stale(directory)
    tmpdir = f"{directory}.tmp.{os.getpid()}"
    shutil.rmtree(tmpdir, ignore_errors=True)
    os.makedirs(tmpdir)
    try:
        entries = []
        for i, (leaf, (value, name)) in enumerate(zip(leaves, host)):
            fname = f"leaf_{i}.bin"
            payload = _payload(value)

            def write(tmp_path: str, _payload=payload) -> None:
                with open(tmp_path, "wb") as fh:
                    fh.write(_payload)

            resilience.atomic_write(os.path.join(tmpdir, fname), write, site=_WRITE_SITE)
            entries.append({
                "file": fname,
                "shape": [int(s) for s in value.shape],
                "dtype": name,
                "split": int(_split_code(leaf)),
                "nbytes": len(payload),
                "sha256": hashlib.sha256(payload).hexdigest(),
            })
        _write_manifest(tmpdir, {"schema": SCHEMA_V1, "leaves": entries})
        _commit_dir(tmpdir, directory)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        # the barrier runs even when the writer failed: the other ranks wait in theirs,
        # and the error must surface as this exception, never as a hang
        _barrier(f"save:{directory}")


# ------------------------------------------------------------------ v2 save
def _chunk_file(leaf_idx: int, chunk_idx: int) -> str:
    return f"leaf_{leaf_idx}.c{chunk_idx:05d}.bin"


def _leaf_chunks(leaf_idx: int, leaf: Any) -> Tuple[dict, List[dict]]:
    """One leaf's manifest skeleton and the chunk jobs of this rank: a split DNDarray's
    chunk is this rank's (none when it holds no rows); any other leaf is one chunk that
    rank 0 writes. The device-to-host copy happens on the writer pool."""
    jobs: List[dict] = []
    if isinstance(leaf, DNDarray) and leaf.split is not None and leaf.ndim > 0:
        split = int(leaf.split)
        shards = int(leaf.comm.size)
        n = int(leaf.gshape[split])
        c = -(-n // shards) if n else 0
        entry = {
            "shape": [int(s) for s in leaf.gshape],
            "dtype": _dtype_name(leaf.larray.dtype),
            "split": split,
            "shards": shards,
        }
        if shards == 1 and not _is_writer():
            return entry, jobs  # a communicator of one rank: its single chunk is rank 0's to write
        for index, value in leaf.iter_shards():
            off = int(index[split].start)
            jobs.append({"file": _chunk_file(leaf_idx, off // c), "offset": off,
                         "rows": int(index[split].stop) - off, "value": value})
        return entry, jobs
    value = leaf.larray if isinstance(leaf, DNDarray) else leaf
    if isinstance(value, torch.Tensor):
        shape, name = tuple(value.shape), _dtype_name(value.dtype)
    else:
        arr = np.asarray(value)
        shape, name = arr.shape, arr.dtype.name
    entry = {"shape": [int(s) for s in shape], "dtype": name, "split": -1 if isinstance(leaf, DNDarray) else -2,
             "shards": 1}
    if _is_writer():
        jobs.append({"file": _chunk_file(leaf_idx, 0), "offset": 0, "rows": int(shape[0]) if shape else 1,
                     "value": value})
    return entry, jobs


def _write_chunk(tmpdir: str, job: dict) -> dict:
    """Copy one chunk to the host and write and fsync it, on a writer-pool thread, under
    the ``checkpoint.chunk_write`` site policy. The file is written in place inside the
    uncommitted assembly dir (the manifest-last rule and the commit rename own
    atomicity). An injected ``torn-write`` truncates the bytes after the sha256 below is
    taken: the silently short chunk that verification must catch."""
    host, _ = _host_array(job["value"])
    payload = _payload(host)
    path = os.path.join(tmpdir, job["file"])

    def attempt() -> None:
        cut = None
        entry = resilience.fault_signal(_CHUNK_WRITE_SITE)
        if entry is not None:
            if entry.kind == "torn-write":
                cut = int(len(payload) * entry.fraction)
            else:
                resilience.raise_entry(entry, _CHUNK_WRITE_SITE)
        with open(path, "wb") as fh:
            fh.write(payload if cut is None else payload[:cut])
            fh.flush()
            os.fsync(fh.fileno())

    resilience.get_policy(_CHUNK_WRITE_SITE).run(_CHUNK_WRITE_SITE, attempt)
    return {
        "file": job["file"],
        "offset": int(job["offset"]),
        "rows": int(job["rows"]),
        "nbytes": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest(),
        "_gathered": host.nbytes,
    }


def _expected_offsets(entry: dict) -> List[int]:
    """The complete chunk-offset grid a leaf's manifest entry must cover."""
    if entry["split"] < 0:
        return [0]
    n = int(entry["shape"][entry["split"]])
    shards = int(entry["shards"])
    c = -(-n // shards) if n else 0
    return [i * c for i in range(shards) if i * c < n]


def _save_v2(tree: Any, directory: str) -> Optional[str]:
    """The parallel chunked save, rank-symmetric: writer-only blocks (sweep, manifest,
    commit) hold no collectives, and the agreements and the closing barrier run on every
    exit path. Returns None on commit, or the reason to degrade when every rank agreed
    the chunk writes failed retriably (the caller then runs v1 outside any handler)."""
    leaves, _ = _flatten(tree)
    if _is_writer():
        _sweep_stale(directory)
    tmpdir = f"{directory}.tmp.v2"
    if _is_writer():
        shutil.rmtree(tmpdir, ignore_errors=True)
        os.makedirs(tmpdir)
    _barrier(f"save-v2-setup:{directory}")
    breaker = _chunk_breaker()
    status = 0  # 0 ok | 1 degradable (chunk write) | 2 hard
    first_error: Optional[BaseException] = None
    entries: List[dict] = []
    my_chunks: Dict[int, List[dict]] = {}
    gathered = written = 0
    pending: List[Tuple[int, list]] = []
    pool = ThreadPoolExecutor(max_workers=_writer_pool_size(), thread_name_prefix="heat-tpu-ckpt")
    try:
        for i, leaf in enumerate(leaves):
            try:
                entry, jobs = _leaf_chunks(i, leaf)
            except Exception as exc:
                if status != 2:
                    status, first_error = 2, exc
                    diagnostics.record_resilience_event(
                        "checkpoint.save", "hard-failure", f"{directory}: leaf {i}: {type(exc).__name__}: {exc}"
                    )
                entries.append({})
                continue
            entries.append(entry)
            if jobs:
                # every leaf's chunks go to the pool at once: a queued job holds only its
                # tensor, and each writer thread one host copy at a time, so host memory
                # stays one chunk a thread while small leaves overlap their writes
                pending.append((i, [pool.submit(_write_chunk, tmpdir, job) for job in jobs]))
        for i, futures in pending:
            metas: List[dict] = []
            for fut in futures:
                try:
                    metas.append(fut.result())
                except Exception as exc:
                    breaker.record_failure(f"{type(exc).__name__}: {exc}")
                    if status == 0:
                        status, first_error = 1, exc
            if status == 0:
                gathered += sum(m.pop("_gathered") for m in metas)
                my_chunks[i] = metas
                written += sum(m["nbytes"] for m in metas)
    finally:
        pool.shutdown(wait=True)
    if diagnostics._enabled:
        diagnostics.counter("checkpoint.gathered_bytes", gathered)
        diagnostics.counter("checkpoint.written_bytes", written)
    # the other ranks' chunk metadata reaches the manifest through sidecars on the shared
    # filesystem, written BEFORE the agreement so a sidecar failure is part of the verdict
    if _world().size > 1 and not _is_writer() and status == 0:
        sidecar = os.path.join(tmpdir, f"chunkmeta.p{_world().rank}.json")

        def write_meta(tmp_path: str) -> None:
            with open(tmp_path, "w") as fh:
                json.dump({str(k): v for k, v in my_chunks.items()}, fh)

        try:
            resilience.atomic_write(sidecar, write_meta, site=_META_SITE)
        except Exception as exc:
            status, first_error = 2, exc
            diagnostics.record_resilience_event(
                "checkpoint.save", "hard-failure", f"{directory}: chunk-metadata sidecar: {type(exc).__name__}: {exc}"
            )
    # encoded so that MIN yields the worst rank's verdict: 0 hard, 1 degrade, 2 ok
    verdict = _agree_min({0: 2, 1: 1, 2: 0}[status])
    try:
        if verdict != 2:
            breaker.abandon_probe()  # no commit will deliver a verdict
        if verdict == 1:
            return "chunk writes exhausted their retry policy (" + (
                f"{type(first_error).__name__}: {first_error}" if first_error is not None else "peer failure"
            ) + ")"
        if verdict == 0:
            if first_error is not None:
                raise first_error
            raise CheckpointWriteFailed(
                f"peer process reported a hard failure while assembling {directory!r}; this rank's chunks were fine"
            )
        _barrier(f"save-v2-chunks:{directory}")  # every rank's chunks and sidecars landed
        commit_error: Optional[BaseException] = None
        if _is_writer():
            try:
                _assemble_and_commit_v2(directory, tmpdir, entries, my_chunks)
            except BaseException as exc:
                commit_error = exc
        committed = _agree_min(1 if commit_error is None else 0)
        if commit_error is not None:
            raise commit_error
        if not committed:
            raise CheckpointWriteFailed(
                f"the writer process failed to commit {directory!r}; the previous generation (if any) is still "
                "restorable"
            )
        breaker.record_success()
        return None
    finally:
        if _is_writer():
            shutil.rmtree(tmpdir, ignore_errors=True)
        _barrier(f"save:{directory}")


def _assemble_and_commit_v2(directory: str, tmpdir: str, entries: List[dict], my_chunks: Dict[int, List[dict]]) -> None:
    """Rank 0: fold every rank's chunk metadata into the manifest, check the chunk grid
    is complete, write the manifest last, commit."""
    merged: Dict[int, List[dict]] = {k: list(v) for k, v in my_chunks.items()}
    for name in os.listdir(tmpdir):
        if not name.startswith("chunkmeta.p"):
            continue
        with open(os.path.join(tmpdir, name)) as fh:
            side = json.load(fh)
        for key, metas in side.items():
            merged.setdefault(int(key), []).extend(metas)
        os.unlink(os.path.join(tmpdir, name))
    manifest_leaves = []
    for i, entry in enumerate(entries):
        chunks = sorted(merged.get(i, []), key=lambda c: c["offset"])
        have = [c["offset"] for c in chunks]
        want = _expected_offsets(entry)
        if have != want:
            raise CheckpointWriteFailed(
                f"leaf {i}: chunk grid incomplete — have offsets {have}, the canonical grid needs {want}"
            )
        manifest_leaves.append({**entry, "chunks": chunks})
    _write_manifest(tmpdir, {"schema": SCHEMA, "processes": _world().size, "leaves": manifest_leaves})
    _commit_dir(tmpdir, directory)


def save_checkpoint(tree: Any, directory: str, *, force: bool = True, parallel: bool = True) -> None:
    """Write a tree of DNDarrays, torch tensors, numpy arrays and Python scalars to
    ``directory`` atomically (see the module's failure contract). Every rank calls it.

    ``parallel=False`` takes the serialized v1 single-writer path (schema 1), the target
    of the degradation ladder."""
    directory = os.path.abspath(directory)
    if os.path.exists(directory) and not force:
        raise FileExistsError(f"checkpoint directory {directory} exists (force=False)")
    degrade_reason = ""
    if parallel and not _chunk_breaker().allows():
        degrade_reason = f"circuit breaker {_CHUNK_WRITE_SITE!r} is open after repeated chunk-write failures"
    # v1 and v2 run different collectives: any rank wanting v1 degrades them all
    use_v1 = _agree_min(0 if (not parallel or degrade_reason) else 1) == 0
    if use_v1:
        if parallel:  # degraded, not asked for: never silent
            if not degrade_reason:
                _chunk_breaker().abandon_probe()
            _record_degraded(directory, degrade_reason or "peer breaker open")
        _save_v1(tree, directory)
        return
    degrade = _save_v2(tree, directory)
    if degrade is not None:
        _record_degraded(directory, degrade)
        _save_v1(tree, directory)


def _record_degraded(directory: str, reason: str) -> None:
    """Account one degradation to the serialized v1 path: an always-on resilience event
    and the fallback counter and event."""
    diagnostics.record_resilience_event(
        "checkpoint.save", "fallback", f"{directory}: degraded to serialized v1 single-writer — {reason}"
    )
    diagnostics.record_fallback("checkpoint.save", reason)


# ------------------------------------------------------------------ manifest
def read_manifest(directory: str, *, record: bool = True) -> dict:
    """The parsed manifest of a checkpoint directory (schema 1 or 2), or
    :class:`CheckpointCorrupt` when it is absent, unparseable or foreign. A corrupt
    verdict is recorded as a resilience event first, unless ``record=False`` (the
    manager's scan records its own ``corrupt-step`` event)."""
    path = os.path.join(os.path.abspath(directory), MANIFEST_NAME)
    if not os.path.exists(path):
        raise _corrupt(directory, f"{MANIFEST_NAME} missing (incomplete or torn checkpoint)", record)
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise _corrupt(directory, f"{MANIFEST_NAME} missing (incomplete or torn checkpoint)", record)
    except ValueError as exc:
        raise _corrupt(directory, f"{MANIFEST_NAME} unparseable: {exc}", record)
    if manifest.get("schema") not in (SCHEMA, SCHEMA_V1):
        raise _corrupt(directory, f"unknown manifest schema {manifest.get('schema')!r}", record)
    return manifest


def _corrupt(directory: str, problem: str, record: bool) -> CheckpointCorrupt:
    if record:
        diagnostics.record_resilience_event("checkpoint.manifest", "corrupt", f"{directory}: {problem}")
    return CheckpointCorrupt(directory, [problem])


def _verify_one(directory: str, file: str, nbytes: int, sha256: str) -> Optional[str]:
    """One streamed integrity check (existence, length, SHA-256), 1 MiB at a time."""
    path = os.path.join(directory, file)
    if not os.path.exists(path):
        return f"{file}: missing"
    size = os.path.getsize(path)
    if size != nbytes:
        return f"{file}: torn write — {size} bytes on disk, manifest expects {nbytes}"
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            digest.update(block)
    if digest.hexdigest() != sha256:
        return f"{file}: sha256 mismatch (silent corruption)"
    return None


def _manifest_files(manifest: dict) -> List[Tuple[str, int, str]]:
    """Every payload file a manifest names, as (file, nbytes, sha256)."""
    out = []
    for entry in manifest["leaves"]:
        if "chunks" in entry:
            out.extend((ch["file"], int(ch["nbytes"]), ch["sha256"]) for ch in entry["chunks"])
        else:
            out.append((entry["file"], int(entry["nbytes"]), entry["sha256"]))
    return out


def _grid_problems(manifest: dict) -> List[str]:
    """Chunk-grid completeness of a v2 manifest, checked on the read side too: a manifest
    that lost an entry must never restore uninitialized rows."""
    if manifest.get("schema") != SCHEMA:
        return []
    problems = []
    for i, entry in enumerate(manifest.get("leaves", [])):
        have = sorted(int(c["offset"]) for c in entry.get("chunks", []))
        want = _expected_offsets(entry)
        if have != want:
            problems.append(f"leaf_{i}: chunk grid incomplete — manifest lists offsets {have}, the canonical grid "
                            f"needs {want}")
    return problems


def verify_checkpoint(directory: str, manifest: Optional[dict] = None) -> List[str]:
    """Integrity-check every payload against the manifest (existence, length, SHA-256,
    the v2 chunk grid), chunks in parallel on the writer pool. Returns the problems;
    empty means sound."""
    directory = os.path.abspath(directory)
    if manifest is None:
        manifest = read_manifest(directory)
    grid = _grid_problems(manifest)
    if grid:
        return grid
    files = _manifest_files(manifest)
    if not files:
        return []
    if len(files) == 1:
        results = [_verify_one(directory, *files[0])]
    else:
        with ThreadPoolExecutor(max_workers=min(len(files), _writer_pool_size()),
                                thread_name_prefix="heat-tpu-ckpt-verify") as pool:
            results = list(pool.map(lambda f: _verify_one(directory, *f), files))
    return [p for p in results if p is not None]


# ------------------------------------------------------------------ restore
class _ChunkReader:
    """Reads of one leaf's chunk set that touch only the byte ranges overlapping the
    request. Chunks partition ``axis`` (the writer's split, or axis 0 for one chunk); for
    ``axis == 0`` a chunk's rows are contiguous on disk and only that range is read,
    otherwise the whole chunk (one writer rank's, never the leaf) is read and sliced, with
    a one-chunk cache. Reads run under the ``checkpoint.chunk_read`` site when a plan or a
    policy is armed."""

    def __init__(self, directory: str, entry: dict):
        self.directory = directory
        self.shape = tuple(int(s) for s in entry["shape"])
        self.dtype = _carrier(entry["dtype"])
        self.axis = int(entry["split"]) if int(entry["split"]) >= 0 else 0
        self.chunks = sorted(entry["chunks"], key=lambda c: int(c["offset"]))
        self.read_bytes = 0
        self.peak_bytes = 0
        self._cache: Tuple[Optional[str], Optional[np.ndarray]] = (None, None)

    def _note(self, nbytes: int) -> None:
        self.read_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, nbytes)

    def _read_range(self, file: str, offset: int, nbytes: int) -> bytes:
        path = os.path.join(self.directory, file)

        def attempt() -> bytes:
            if resilience._armed:
                resilience.maybe_fault(_CHUNK_READ_SITE)
            with open(path, "rb") as fh:
                fh.seek(offset)
                data = fh.read(nbytes)
            if len(data) != nbytes:
                raise CheckpointCorrupt(
                    self.directory,
                    [f"{file}: short read — wanted [{offset}, {offset + nbytes}) but the file ends early (torn chunk)"],
                )
            return data

        if resilience._active:
            return resilience.guard(_CHUNK_READ_SITE, attempt, inject=False)
        return attempt()

    def _chunk_shape(self, ch: dict) -> Tuple[int, ...]:
        s = list(self.shape)
        if s:
            s[self.axis] = int(ch["rows"])
        return tuple(s)

    def _read_rows(self, ch: dict, r0: int, r1: int) -> np.ndarray:
        """Rows ``[r0, r1)`` of one chunk along ``axis``, whole along the others."""
        cshape = self._chunk_shape(ch)
        if self.axis == 0 and len(cshape) >= 1:
            rowbytes = int(np.prod(cshape[1:], dtype=np.int64)) * self.dtype.itemsize
            data = self._read_range(ch["file"], r0 * rowbytes, (r1 - r0) * rowbytes)
            self._note(len(data))
            return np.frombuffer(data, self.dtype).reshape((r1 - r0,) + cshape[1:])
        cached_file, cached = self._cache
        if cached_file != ch["file"]:
            data = self._read_range(ch["file"], 0, int(ch["nbytes"]))
            self._note(len(data))
            cached = np.frombuffer(data, self.dtype).reshape(cshape)
            self._cache = (ch["file"], cached)
        sel = [slice(None)] * len(cshape)
        sel[self.axis] = slice(r0, r1)
        return cached[tuple(sel)]

    def read(self, idx: Tuple[slice, ...]) -> np.ndarray:
        """The hyperslab ``idx`` (slices within the logical shape) from the overlapping
        chunks."""
        w = self.axis
        lo, hi = idx[w].start or 0, idx[w].stop
        out = np.empty(tuple(s.stop - (s.start or 0) for s in idx), self.dtype)
        for ch in self.chunks:
            clo = int(ch["offset"])
            chi = clo + int(ch["rows"])
            a, b = max(lo, clo), min(hi, chi)
            if a >= b:
                continue
            block = self._read_rows(ch, a - clo, b - clo)
            sel = tuple(slice(None) if d == w else idx[d] for d in range(len(idx)))
            dst = tuple(slice(a - lo, b - lo) if d == w else slice(None) for d in range(len(idx)))
            out[dst] = block[sel]
        return out


def _note_restore(read_bytes: int, peak_bytes: int) -> None:
    with _state_lock:
        _restore_stats["read_bytes"] += read_bytes
        _restore_stats["host_bytes_peak"] = max(_restore_stats["host_bytes_peak"], peak_bytes)


def _read_full(directory: str, entry: dict) -> np.ndarray:
    """One leaf whole on the host, as its carrier dtype (plain leaves and unsplit
    targets, which need the whole value)."""
    shape = tuple(int(s) for s in entry["shape"])
    reader = _ChunkReader(directory, entry)
    if not shape or len(entry["chunks"]) == 1:
        ch = entry["chunks"][0] if entry["chunks"] else None
        if ch is None:
            return np.zeros(shape, reader.dtype)
        data = reader._read_range(ch["file"], 0, int(ch["nbytes"]))
        _note_restore(len(data), len(data))
        return np.frombuffer(data, reader.dtype).reshape(shape).copy()
    out = reader.read(tuple(slice(0, s) for s in shape))
    _note_restore(reader.read_bytes, reader.peak_bytes)
    return out


def last_restore_stats() -> Dict[str, int]:
    """Read-traffic gauges of the last :func:`load_checkpoint` on this rank:
    ``read_bytes`` (the chunk bytes this rank read: the byte-range property of the
    resharding restore is measured here) and ``host_bytes_peak`` (the largest host
    buffer it held)."""
    with _state_lock:
        return dict(_restore_stats)


def _dndarray(slab: torch.Tensor, gshape, split, comm, device) -> DNDarray:
    dtype = _types.canonical_heat_type(slab.dtype)
    return DNDarray(slab.to(device.torch_device), tuple(gshape), dtype, split, device, comm, True)


def _split_slab(directory: str, entry: dict, split_ax: int, comm) -> np.ndarray:
    """This rank's rows of one leaf along ``split_ax`` of ``comm``, read from the byte ranges
    of the overlapping chunks: the leaf is never whole on any host."""
    gshape = tuple(int(s) for s in entry["shape"])
    reader = _ChunkReader(directory, entry)
    _, lshape, slices = comm.chunk(gshape, split_ax)
    host = np.zeros(lshape, reader.dtype) if 0 in lshape else reader.read(slices)
    _note_restore(reader.read_bytes, max(reader.peak_bytes, host.nbytes))
    return host


def _restored_plain(template: Any, host: np.ndarray, name: str) -> Any:
    """A plain leaf as the template's kind: a torch tensor on its device, a Python scalar
    of its type, else a numpy array (heat_tpu's form)."""
    if isinstance(template, torch.Tensor):
        return _as_torch(host, name).to(template.device)
    value = _as_numpy(host, name)
    if isinstance(template, (bool, int, float, complex)):
        return type(template)(value.reshape(()).item())
    return value


def _restored_dndarray(host: np.ndarray, name: str, split, comm, device) -> DNDarray:
    """A DNDarray of the whole value ``host`` with the target split: this rank's chunk."""
    _, _, slices = comm.chunk(host.shape, split)
    return _dndarray(_as_torch(host[slices], name), host.shape, split, comm, device)


def _template_leaves(tree: Any, entries: List[dict], directory: str) -> Tuple[List[Any], Any]:
    leaves, treedef = _flatten(tree)
    if len(entries) != len(leaves):
        raise CheckpointCorrupt(
            directory, [f"leaf count mismatch: checkpoint holds {len(entries)}, template tree has {len(leaves)}"]
        )
    return leaves, treedef


def _load_v1(tree: Any, directory: str, manifest: dict, comm, device, strict: str) -> Any:
    """Restore a schema-1 checkpoint (whole-leaf payloads); the template decides the
    distribution."""
    entries = manifest["leaves"]
    leaves, treedef = _template_leaves(tree, entries, directory)
    out = []
    for i, (leaf, entry) in enumerate(zip(leaves, entries)):
        stored_split = int(entry["split"])
        is_array = stored_split != -2 and isinstance(leaf, DNDarray)
        if strict == "layout" and is_array:
            stored = stored_split if stored_split >= 0 else None
            if stored != leaf.split:
                raise CheckpointLayoutMismatch(
                    f"leaf {i}: checkpoint layout (split={stored}) differs from the template's (split={leaf.split}) "
                    'and strict="layout" forbids resharding-on-restore'
                )
        with open(os.path.join(directory, entry["file"]), "rb") as fh:
            payload = fh.read()
        if len(payload) != int(entry["nbytes"]):
            raise CheckpointCorrupt(
                directory,
                [f"{entry['file']}: torn read — {len(payload)} bytes on disk, manifest expects {entry['nbytes']}"],
            )
        _note_restore(len(payload), len(payload))
        host = np.frombuffer(payload, dtype=_carrier(entry["dtype"])).reshape(tuple(entry["shape"])).copy()
        if is_array:
            out.append(_restored_dndarray(host, entry["dtype"], leaf.split,
                                          comm if comm is not None else leaf.comm,
                                          device if device is not None else leaf.device))
        else:
            out.append(_restored_plain(leaf, host, entry["dtype"]))
    return _unflatten(treedef, out)


def _load_v2(tree: Any, directory: str, manifest: dict, comm, device, strict: str) -> Any:
    entries = manifest["leaves"]
    leaves, treedef = _template_leaves(tree, entries, directory)
    plans = []  # (template, entry, target split, comm, device); comm None: a plain leaf
    for i, (leaf, entry) in enumerate(zip(leaves, entries)):
        stored_split = int(entry["split"])
        if stored_split == -2 or not isinstance(leaf, DNDarray):
            plans.append((leaf, entry, None, None, None))
            continue
        split_ax = leaf.split
        leaf_comm = comm if comm is not None else leaf.comm
        if strict == "layout":
            stored = stored_split if stored_split >= 0 else None
            # the shard count shapes the grid of split leaves only
            shards_differ = stored_split >= 0 and int(entry.get("shards", 1)) != leaf_comm.size
            if stored != split_ax or shards_differ:
                raise CheckpointLayoutMismatch(
                    f"leaf {i}: checkpoint layout (split={stored}, shards={entry.get('shards', 1)}) differs from the "
                    f"template's (split={split_ax}, shards={leaf_comm.size}) and strict=\"layout\" forbids "
                    "resharding-on-restore"
                )
        plans.append((leaf, entry, split_ax, leaf_comm, device if device is not None else leaf.device))

    def read(plan) -> np.ndarray:
        _, entry, split_ax, leaf_comm, _ = plan
        if leaf_comm is None or split_ax is None:
            return _read_full(directory, entry)
        return _split_slab(directory, entry, int(split_ax), leaf_comm)

    # the host reads run ahead on the pool, a bounded window in leaf order, while this
    # thread copies each block to its device (heat_tpu double-buffers its shard reads
    # against the device transfer the same way)
    out = []
    workers = _writer_pool_size()
    with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="heat-tpu-ckpt-read") as pool:
        todo = iter(plans)
        pending = collections.deque((plan, pool.submit(read, plan)) for plan in itertools.islice(todo, 2 * workers))
        while pending:
            plan, fut = pending.popleft()
            host = fut.result()
            nxt = next(todo, None)
            if nxt is not None:
                pending.append((nxt, pool.submit(read, nxt)))
            leaf, entry, split_ax, leaf_comm, leaf_device = plan
            if leaf_comm is None:
                out.append(_restored_plain(leaf, host, entry["dtype"]))
            elif split_ax is None:
                out.append(_restored_dndarray(host, entry["dtype"], None, leaf_comm, leaf_device))
            else:
                out.append(_dndarray(_as_torch(host, entry["dtype"]), entry["shape"], int(split_ax), leaf_comm,
                                     leaf_device))
    return _unflatten(treedef, out)


class _hold_restore:
    """Marks a directory as held by a restore in flight, so a concurrent
    :class:`CheckpointManager` prune defers it to the next save: in this process's
    registry and, at several ranks, as a ``<dir>.hold.*`` sentinel file beside it on the
    shared filesystem (rank 0 prunes, so a hold on any rank must reach it). A place where
    the sentinel cannot be made keeps the local hold, recorded by ``record_fallback``."""

    def __init__(self, directory: str):
        self.directory = directory
        self._sentinel: Optional[str] = None

    def __enter__(self):
        global _hold_seq
        with _state_lock:
            _open_restores[self.directory] = _open_restores.get(self.directory, 0) + 1
            _hold_seq += 1
            seq = _hold_seq
        if _world().size > 1:
            path = f"{self.directory}.hold.p{_world().rank}.{os.getpid()}.{seq}"
            try:
                with open(path, "x") as fh:
                    fh.write("in-flight restore hold\n")
                self._sentinel = path
            except OSError as exc:
                diagnostics.record_fallback("checkpoint.restore_hold", f"{path}: {type(exc).__name__}: {exc}")
        return self

    def __exit__(self, *exc):
        with _state_lock:
            left = _open_restores.get(self.directory, 1) - 1
            if left <= 0:
                _open_restores.pop(self.directory, None)
            else:
                _open_restores[self.directory] = left
        if self._sentinel is not None:
            try:
                os.unlink(self._sentinel)
            except OSError:
                pass  # already gone; a stray sentinel defers pruning loudly
        return False


def _restore_holds(directory: str) -> bool:
    with _state_lock:
        if _open_restores.get(directory, 0) > 0:
            return True
    base = os.path.basename(directory)
    parent = os.path.dirname(directory) or "."
    try:
        return any(n.startswith(f"{base}.hold.") for n in os.listdir(parent))
    except FileNotFoundError:
        return False


def load_checkpoint(tree: Any, directory: str, *, device=None, comm=None, strict: str = "reshard",
                    verify: bool = True) -> Any:
    """Restore a checkpoint written by :func:`save_checkpoint` (either schema, either
    package).

    ``tree`` gives the structure and, for DNDarray leaves, the target split, comm and
    device (``comm=``/``device=`` override them for every leaf); torch tensors come back
    on the template's device. The stored layout may differ from the target's: each rank
    reads only the byte ranges of its target rows. ``strict="layout"`` refuses a layout
    change instead.

    ``verify=True`` checks every chunk's SHA-256 (on every rank) before any state is
    touched and raises :class:`CheckpointCorrupt` on a torn or corrupt checkpoint;
    ``verify=False`` trusts the manifest and checks only the lengths of the reads."""
    if strict not in ("reshard", "layout"):
        raise ValueError(f'strict must be "reshard" or "layout", got {strict!r}')
    directory = os.path.abspath(directory)
    comm = sanitize_comm(comm) if comm is not None else None
    device = sanitize_device(device) if device is not None else None
    with _hold_restore(directory):
        manifest = read_manifest(directory)
        grid = _grid_problems(manifest)
        if grid:
            diagnostics.record_resilience_event("checkpoint.restore", "corrupt", f"{directory}: " + "; ".join(grid))
            raise CheckpointCorrupt(directory, grid)
        if verify:
            problems = verify_checkpoint(directory, manifest)
            if problems:
                diagnostics.record_resilience_event(
                    "checkpoint.restore", "corrupt", f"{directory}: " + "; ".join(problems)
                )
                raise CheckpointCorrupt(directory, problems)
        with _state_lock:
            _restore_stats["read_bytes"] = 0
            _restore_stats["host_bytes_peak"] = 0
        if manifest["schema"] == SCHEMA_V1:
            return _load_v1(tree, directory, manifest, comm, device, strict)
        return _load_v2(tree, directory, manifest, comm, device, strict)


# ------------------------------------------------------------------ manager
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    """Rolling step-numbered checkpoints with retention (heat_tpu's).

    Each step lives in its own atomically committed ``step_<n>`` directory. ``all_steps``
    and ``latest_step`` count only directories whose manifest parses; a corrupt one is
    skipped and recorded. Every deletion runs under the ``checkpoint.prune`` site with a
    recorded ``pruned`` event; a step a restore holds open is deferred
    (``prune-deferred``) to the next save; a deletion that fails records
    ``prune-failed`` and raises."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self._directory = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._directory, f"step_{int(step)}")

    def _prune(self, path: str, reason: str) -> bool:
        """Delete one step directory through ht.resilience; False when a restore holds it
        (deferred to the next save). Failures are recorded and raised."""
        if _restore_holds(path):
            diagnostics.record_resilience_event(
                _PRUNE_SITE, "prune-deferred", f"{path}: held open by an in-flight restore; retrying next save"
            )
            return False

        def rm() -> None:
            shutil.rmtree(path)

        try:
            if resilience._active:
                resilience.guard(_PRUNE_SITE, rm)
            else:
                rm()
        except FileNotFoundError:
            return True  # already gone: the goal state
        except Exception as exc:
            diagnostics.record_resilience_event(_PRUNE_SITE, "prune-failed", f"{path}: {type(exc).__name__}: {exc}")
            raise
        diagnostics.record_resilience_event(_PRUNE_SITE, "pruned", f"{path}: {reason}")
        return True

    def save(self, step: int, tree: Any, *, parallel: bool = True) -> None:
        save_checkpoint(tree, self._step_dir(step), force=True, parallel=parallel)
        steps = self.all_steps()
        if _is_writer():
            # corrupt step dirs do not count toward retention, but must not leak disk
            valid = set(steps)
            for name in os.listdir(self._directory):
                m = _STEP_RE.match(name)
                if m and int(m.group(1)) not in valid:
                    self._prune(os.path.join(self._directory, name), "corrupt step GC")
        while len(steps) > self._max_to_keep:
            oldest = steps.pop(0)
            if _is_writer():
                self._prune(self._step_dir(oldest), "retention rotation")
        # every rank returns after rank 0's rotation, so no rank lists a step being deleted
        _barrier(f"rotate:{self._directory}")

    def restore(self, tree: Any, step: Optional[int] = None, *, device=None, comm=None, strict: str = "reshard") -> Any:
        if step is None:
            step = self.latest_step
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self._directory}")
        return load_checkpoint(tree, self._step_dir(step), device=device, comm=comm, strict=strict)

    def all_steps(self) -> List[int]:
        """Sorted steps with a readable manifest; corrupt step directories are skipped
        and recorded, never fatal."""
        try:
            names = os.listdir(self._directory)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            m = _STEP_RE.match(name)
            if not m:
                continue
            step = int(m.group(1))
            try:
                read_manifest(os.path.join(self._directory, name), record=False)
            except CheckpointCorrupt as exc:
                diagnostics.record_resilience_event(
                    "checkpoint.scan", "corrupt-step", f"step {step} at {self._directory}: {exc.problems[0]}"
                )
                continue
            steps.append(step)
        return sorted(steps)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Kept for API parity with heat_tpu's manager."""
