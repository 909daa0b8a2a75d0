"""Persistent per-signature replay manifest + warmup at boot (the port's counterpart
of heat_tpu/core/_compile_cache.py).

heat_tpu pays trace + XLA compile for every signature on a fresh process's first
request, and removes that cold start with two layers. The port keeps the manifest
layer and its file format, and has no artifact to keep:

1. **Persistent signature index** (``HEAT_TPU_EXEC_CACHE=<dir>``): a JSON index
   (``index.json``, schema ``heat-tpu-compile-cache/1``) plus a content-addressed
   blob directory (``blobs/<sha256>.bin``). Each entry maps a **signature
   fingerprint** (the sha256 of the signature's canonical JSON *replay spec* — jnp
   op names, avals, splits, kwargs, mesh shape: everything process-portable) to the
   spec, its label and its hit count. The port writes the same spec dict as heat_tpu
   for the same signature, so the fingerprints agree and a manifest written by either
   package replays in the other.

   **Recorded deviation: no compiled artifact.** heat_tpu stores a serialized XLA
   executable under ``blobs/`` and loads it in place of the jit build. The port has
   no such thing: its program is a closure of torch calls, and a captured CUDA graph
   cannot be saved. So :func:`executor_save_warmup` writes no blob, and
   :func:`load_program` loads none: a blob named by an index (one heat_tpu wrote)
   is verified against its content address — a mismatch is a typed
   :class:`CompileCacheCorrupt` rejection (resilience event kind
   ``cache-corrupt``) — and an intact one is an XLA executable this backend cannot
   run, recorded as ``artifact-incompatible``. ``aot_loaded`` is 0 in the port.
   ``HEAT_TPU_COMPILE_CACHE`` names JAX's compilation cache, which the port has no
   counterpart of: the port does not read it.

2. **Warmup** (``ht.executor_warmup(path)``): replays the recorded specs — ordered
   by (hits desc, label asc), the ``executor_stats(top=N)`` order — through the
   public dispatch path at boot, as heat_tpu's ``_replay_staged``/``_replay_defer``
   do: staged ``l``/``r``/``c`` specs re-enter their wrappers over zeros of the
   recorded layout, ``mm`` specs the communication plan
   (``linalg.comm_plan.replay_warmup``), and fused-graph specs rebuild the same
   deferred graph through the public functions heat_tpu's jnp names resolve to
   (``_operations.JNP_OPS``) and force it. The executor's signature table ends up
   keyed exactly as live traffic keys it. What the port removes from a cold start is
   each program's build and, on the card, the capture of its CUDA graph — not an
   XLA compile. A spec this topology cannot reproduce (its physical shape is not the
   unpadded global shape: heat_tpu's ragged layouts pad; another mesh) is counted
   as skipped, never fatal.

Observability: ``warmup.replayed`` / ``warmup.failed`` / ``executor.cache_reject``
diagnostics counters, fallback events at ``executor.compile_cache`` /
``executor.warmup``, and ``executor.warmup`` / ``executor.compile_cache`` resilience
events (``warmup-saved``, ``warmup-complete``, ``cache-corrupt``,
``artifact-incompatible``) on the always-on stream.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Dict, Optional

import numpy as np

from . import diagnostics, resilience

__all__ = [
    "CompileCacheCorrupt", "armed", "cache_dir", "reload",
    "load_program", "executor_save_warmup", "executor_warmup",
]

SCHEMA = "heat-tpu-compile-cache/1"

#: default number of top signatures saved/replayed when the caller gives none
DEFAULT_TOP = 32


class CompileCacheCorrupt(RuntimeError):
    """A persistent-cache artifact failed verification (truncated blob, hash
    mismatch) or the index itself is unreadable. Never propagates out of a
    dispatch: the loader records it (resilience event kind ``cache-corrupt`` and an
    ``executor.compile_cache`` fallback) and the executor builds the program."""


# memoised knobs; _dir / the in-memory index mutate under _lock; reload() is the
# documented re-read point (ht.reload_env_knobs)
_lock = threading.Lock()
_dir: Optional[str] = None
_index: Optional[Dict[str, Any]] = None   # fingerprint -> entry (lazy-loaded)
_index_rejected = False                   # corrupt index: stop retrying reads


def reload() -> None:
    """Re-read ``HEAT_TPU_EXEC_CACHE`` from the environment (``HEAT_TPU_COMPILE_CACHE``
    names JAX's compilation cache, which the port has no counterpart of, and is not
    read). Changing the cache directory drops the in-memory index so the next lookup
    reads the new location."""
    global _dir, _index, _index_rejected
    with _lock:
        new = os.environ.get("HEAT_TPU_EXEC_CACHE") or None
        if new != _dir:
            _dir = new
            _index = None
            _index_rejected = False


def armed() -> bool:
    """Whether the persistent signature cache is on (``HEAT_TPU_EXEC_CACHE``)."""
    return _dir is not None


def cache_dir() -> Optional[str]:
    return _dir


def fingerprint(spec: dict) -> str:
    """The content fingerprint of a replay spec: sha256 over its canonical JSON,
    heat_tpu's function, so both packages fingerprint a spec alike."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _reject(detail: str, *, fingerprint_: str = "") -> None:
    """Record one typed cache rejection (never silent, never fatal)."""
    exc = CompileCacheCorrupt(detail)
    diagnostics.record_resilience_event(
        "executor.compile_cache", "cache-corrupt",
        f"{type(exc).__name__}: {detail}"
        + (f" (fingerprint {fingerprint_[:12]})" if fingerprint_ else ""),
    )
    if diagnostics._enabled:
        diagnostics.counter("executor.cache_reject")
        diagnostics.record_fallback("executor.compile_cache", f"{type(exc).__name__}: {detail}")


def _index_path(base: Optional[str] = None) -> str:
    return os.path.join(base or _dir, "index.json")


def _blob_path(sha: str, base: Optional[str] = None) -> str:
    return os.path.join(base or _dir, "blobs", f"{sha}.bin")


def _parse_index(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        raise CompileCacheCorrupt(f"unexpected schema {doc.get('schema') if isinstance(doc, dict) else doc!r} in {path}")
    return dict(doc.get("entries") or {})


def _load_index_locked() -> Dict[str, Any]:
    """The fingerprint -> entry map, read once per directory. A corrupt index is a
    typed rejection and reads as empty."""
    global _index, _index_rejected
    if _index is not None:
        return _index
    path = _index_path()
    entries: Dict[str, Any] = {}
    if os.path.exists(path) and not _index_rejected:
        try:
            entries = _parse_index(path)
        except (OSError, ValueError, CompileCacheCorrupt) as exc:
            _index_rejected = True
            _reject(f"unreadable index {path}: {type(exc).__name__}: {exc}")
            entries = {}
    _index = entries
    return entries


def _read_index(base: Optional[str]) -> Dict[str, Any]:
    """Read the index of ``base`` (save/warmup paths that may differ from the armed
    knob); a corrupt file is typed-rejected and reads as empty."""
    if base is None or base == _dir:
        with _lock:
            return dict(_load_index_locked())
    path = _index_path(base)
    if not os.path.exists(path):
        return {}
    try:
        return _parse_index(path)
    except (OSError, ValueError, CompileCacheCorrupt) as exc:
        _reject(f"unreadable index {path}: {type(exc).__name__}: {exc}")
        return {}


def _write_index(base: str, entries: Dict[str, Any]) -> None:
    global _index
    payload = json.dumps({"schema": SCHEMA, "entries": entries}, indent=1, sort_keys=True)
    os.makedirs(base, exist_ok=True)

    def writer(tmp: str) -> None:
        with open(tmp, "w") as f:
            f.write(payload)

    resilience.atomic_write(_index_path(base), writer, site="executor.compile_cache")
    with _lock:
        if base == _dir:
            _index = dict(entries)


# ---------------------------------------------------------------------------
# the _Program first-call hook


def load_program(prog) -> Optional[Any]:
    """A loaded artifact for ``prog``'s fingerprint: always None in the port (see
    the module header). With the cache armed, an index entry that names a blob is
    still verified: a blob that fails its content address is a typed rejection, an
    intact one is recorded as ``artifact-incompatible``, and the entry is dropped
    from this process's index so the check runs once."""
    if _dir is None or prog.spec is None:
        return None
    fp = prog.fingerprint
    if fp is None:
        fp = prog.fingerprint = fingerprint(prog.spec)
    with _lock:
        entry = _load_index_locked().get(fp)
    sha = entry.get("blob") if entry else None
    if not sha:
        return None
    path = _blob_path(sha)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        _reject(f"artifact unreadable: {type(exc).__name__}: {exc}", fingerprint_=fp)
        blob = None
    if blob is not None and hashlib.sha256(blob).hexdigest() != sha:
        _reject(f"artifact {os.path.basename(path)} fails its content address ({len(blob)} bytes on disk)",
                fingerprint_=fp)
    elif blob is not None:
        diagnostics.record_resilience_event(
            "executor.compile_cache", "artifact-incompatible",
            f"an XLA executable has no loader in the port (fingerprint {fp[:12]})",
        )
    with _lock:
        if _index is not None:
            _index.pop(fp, None)
    return None


# ---------------------------------------------------------------------------
# save (warm process -> manifest)


def executor_save_warmup(path: Optional[str] = None, top: int = DEFAULT_TOP, aot: bool = True) -> dict:
    """Record the executor's hottest signatures into a persistent warmup manifest at
    ``path`` (default: the armed ``HEAT_TPU_EXEC_CACHE`` dir), ordered by (hits desc,
    label asc); only signatures with a replay spec are saved. ``aot`` is heat_tpu's
    artifact switch: the port produces no artifact (``artifacts`` is 0), and keeps a
    blob reference an existing entry already has. Returns ``{"saved", "artifacts",
    "skipped", "path"}``."""
    from . import _executor

    base = path or _dir
    if base is None:
        raise ValueError("executor_save_warmup needs a path (or HEAT_TPU_EXEC_CACHE set)")
    with _executor._lock:
        progs = [entry for entry in _executor._programs.values() if entry is not _executor.UNSUPPORTED]
    progs.sort(key=lambda e: (-e.hits, e.label or ""))
    entries = _read_index(base)
    saved = skipped = 0
    for prog in progs:
        if saved >= max(1, top):
            break
        spec = prog.spec
        if spec is None:
            skipped += 1
            continue
        fp = prog.fingerprint or fingerprint(spec)
        prog.fingerprint = fp
        entry = {"label": prog.label, "hits": prog.hits, "spec": spec}
        prior = entries.get(fp)
        if prior and prior.get("blob"):
            entry["blob"] = prior["blob"]
            entry["nbytes"] = prior.get("nbytes")
        entries[fp] = entry
        saved += 1
    _write_index(base, entries)
    diagnostics.record_resilience_event(
        "executor.warmup", "warmup-saved", f"{saved} signatures (0 artifacts) -> {base}"
    )
    return {"saved": saved, "artifacts": 0, "skipped": skipped, "path": base}


# ---------------------------------------------------------------------------
# warmup (fresh process -> programs built before the first request)


def _np_scalar(entry: dict):
    if "np" in entry:
        return np.dtype(entry["np"]).type(entry["scalar"])
    return {"bool": bool, "int": int, "float": float}.get(entry.get("py"), lambda v: v)(entry["scalar"])


def _zeros_dnd(gshape, split, np_dtype_str):
    """A zeros DNDarray of the recorded layout, on the default device and
    communicator. Its physical shape is ``gshape`` (the port pads nothing); callers
    compare it with the recorded one."""
    from . import factories, types

    return factories.zeros(tuple(gshape), dtype=types.canonical_heat_type(np.dtype(np_dtype_str)), split=split)


def _phys(d) -> list:
    return list(d.gshape)


def _built(spec: dict) -> bool:
    """Whether the executor's table now holds a program for ``spec``."""
    from . import _executor

    fp = fingerprint(spec)
    with _executor._lock:
        for e in _executor._programs.values():
            if e is not _executor.UNSUPPORTED and e.spec is not None:
                if e.fingerprint is None:
                    e.fingerprint = fingerprint(e.spec)
                if e.fingerprint == fp:
                    return True
    return False


def _replay_staged(spec: dict) -> bool:
    """Re-dispatch one staged ``l``/``r``/``c``/``mm`` signature through its wrapper
    over zeros of the recorded layout."""
    from . import _operations

    if spec["family"] == "mm":
        from .linalg import comm_plan

        return comm_plan.replay_warmup(spec, _zeros_dnd) and _built(spec)
    x = _zeros_dnd(spec["gshape"], spec["split"], spec["dtype"])
    if _phys(x) != list(spec["phys"]) or spec.get("mesh") != _operations.mesh_spec(x.comm):
        return False  # a layout or mesh this process can never hit
    kwargs = dict(spec.get("kwargs") or {})
    family = spec["family"]
    if family == "l":
        try:
            fn = _operations.resolve_jnp(spec["op"])
        except KeyError as exc:
            raise CompileCacheCorrupt(f"spec op {spec['op']!r} has no port function") from exc
        with _operations.staged_only():
            fn(x, **kwargs)
    elif family == "r":
        axis = spec.get("axis")
        axis = tuple(axis) if isinstance(axis, list) else axis
        _operations.reduce_op(spec["op"], x, axis, None, bool(spec.get("keepdims")))
    elif family == "c":
        kind = {"cumsum": "sum", "cumprod": "prod"}.get(spec["op"])
        if kind is None:
            raise CompileCacheCorrupt(f"unknown scan {spec['op']!r}")
        target = spec.get("target")
        _operations.cum_op(kind, x, spec.get("axis"), None, np.dtype(target) if target else None)
    else:
        raise CompileCacheCorrupt(f"unknown staged family {family!r}")
    return _built(spec)


def _replay_defer(spec: dict) -> bool:
    """Rebuild the recorded fused graph entry by entry through the public functions
    (same ops, same sharing, the recorded emission set held alive) and force its
    roots, building the identical program."""
    from . import _operations

    gshape = tuple(spec["gshape"])
    split = spec["split"]
    leaf_vals = []
    for lf in spec["leaves"]:
        if "shape" in lf:
            d = _zeros_dnd(gshape, split, lf["dtype"])
            if _phys(d) != list(lf["shape"]) or spec.get("mesh") != _operations.mesh_spec(d.comm):
                return False
            leaf_vals.append(d)
        else:
            leaf_vals.append(_np_scalar(lf))
    if not spec["entries"] or not any(not np.isscalar(v) for v in leaf_vals):
        return False
    results: list = []
    for e in spec["entries"]:
        try:
            fn = _operations.resolve_jnp(e["op"])
        except KeyError as exc:
            raise CompileCacheCorrupt(f"spec op {e['op']!r} has no port function") from exc
        args = [leaf_vals[i] if kind == "L" else results[i] for kind, i in e["refs"]]
        results.append(fn(*args, **dict(e.get("kwargs") or {})))
    keep = {i: results[i] for i in spec["out_idxs"]}
    roots = [keep[i] for i in spec["root_idxs"]]
    # drop every other result: interior emission follows liveness, and a stray
    # reference would emit more than the recorded set (another signature). The
    # zeros leaves stay alive through the force: a sole-reader leaf would be
    # donated, and the donating variant is not the one traffic calls.
    del results, args
    for r in roots:
        r.larray  # noqa: B018 - forces the graph under r
    del keep, roots, leaf_vals
    return _built(spec)


def executor_warmup(path: Optional[str] = None, top: Optional[int] = None) -> dict:
    """Warmup: replay the manifest at ``path`` (default: the armed
    ``HEAT_TPU_EXEC_CACHE`` dir) so a fresh process builds its serving signatures —
    and, on the card, captures their CUDA graphs — BEFORE the first request.

    Entries replay in (hits desc, label asc) order, ``top`` limiting how many (None =
    all). Each replay drives the public dispatch path; a replay that cannot reproduce
    its signature here is counted as skipped, one that raises as failed — never
    fatal. Returns ``{"replayed", "aot_loaded", "failed", "skipped", "path"}``
    (``aot_loaded`` is 0: the port loads no artifact) and records a
    ``warmup-complete`` resilience event with the same numbers."""
    base = path or _dir
    if base is None:
        raise ValueError("executor_warmup needs a path (or HEAT_TPU_EXEC_CACHE set)")
    entries = _read_index(base)
    ordered = sorted(entries.values(), key=lambda e: (-int(e.get("hits", 0)), str(e.get("label") or "")))
    if top is not None:
        ordered = ordered[: max(0, top)]
    replayed = failed = skipped = 0
    for entry in ordered:
        spec = entry.get("spec")
        if not isinstance(spec, dict):
            skipped += 1
            continue
        try:
            ok = _replay_defer(spec) if spec.get("family") == "defer" else _replay_staged(spec)
        except Exception as exc:
            failed += 1
            if diagnostics._enabled:
                diagnostics.counter("warmup.failed")
            diagnostics.record_fallback("executor.warmup", f"{entry.get('label')}: {type(exc).__name__}: {exc}")
            continue
        if ok:
            replayed += 1
            if diagnostics._enabled:
                diagnostics.counter("warmup.replayed")
        else:
            skipped += 1
    diagnostics.record_resilience_event(
        "executor.warmup", "warmup-complete",
        f"replayed={replayed} aot_loaded=0 failed={failed} skipped={skipped} path={base}",
    )
    return {"replayed": replayed, "aot_loaded": 0, "failed": failed, "skipped": skipped, "path": base}


reload()
