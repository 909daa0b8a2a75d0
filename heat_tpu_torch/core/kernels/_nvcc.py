"""Build and load the package's CUDA kernels: ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.

A library is built at first use into ``_build/`` beside this file (listed in .gitignore),
keyed by a hash of its source, every header (``*.cuh``) beside it and the flags, so a
fresh checkout builds it once, later processes reuse it, and an edited header rebuilds
it. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "build", "load", "nvcc_path"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH")


def _library_path(source: Path) -> Path:
    """Where the library of ``source`` is built: its name carries a hash of the source,
    of every ``*.cuh`` header in the source's directory (name and bytes) and of the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> dict:
    """Compile ``source`` unless its library is already built. Returns the library's
    ``path``, whether it was ``built`` now, the build's wall ``seconds`` and the
    compiler's ``log`` (``-Xptxas -v``: registers, shared memory, spills)."""
    source = Path(source).resolve()
    lib = _library_path(source)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": lib, "built": False, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source.name}:\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: concurrent builds of one source, by processes or threads, agree
    return {"path": lib, "built": True, "seconds": seconds, "log": log}


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    path = build(source)["path"]
    lib = _LOADED.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        _LOADED[path] = lib
    return lib
