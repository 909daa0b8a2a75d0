"""Carry state across from the JAX package as plain numpy data.

The port imports nothing of heat_tpu, so state crosses as numpy arrays and dicts: a
caller gathers a heat_tpu DNDarray with ``.numpy()`` and a fitted heat_tpu ``KMeans``
into the dict :func:`kmeans_from_state` reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cluster.kmeans import KMeans
from .core import factories, types
from .core.dndarray import DNDarray

__all__ = ["dndarray_from_numpy", "kmeans_from_state"]


def dndarray_from_numpy(a: np.ndarray, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """A DNDarray of the global numpy array ``a``, dtype kept, chunked along ``split``."""
    a = np.asarray(a)
    return factories.array(a, dtype=types.canonical_heat_type(a.dtype), split=split, device=device, comm=comm)


def kmeans_from_state(state: dict, device=None, comm=None) -> KMeans:
    """A fitted port ``KMeans`` from ``{"cluster_centers": (k, d) array,
    "n_clusters": k, "n_iter": int, "inertia": float}``, as read off a fitted heat_tpu
    ``KMeans`` (``cluster_centers_.numpy()``, ``n_clusters``, ``n_iter_``, ``inertia_``)."""
    centers = dndarray_from_numpy(state["cluster_centers"], split=None, device=device, comm=comm)
    k = int(state["n_clusters"])
    if centers.gshape[0] != k:
        raise ValueError(f"cluster_centers has {centers.gshape[0]} rows, n_clusters is {k}")
    km = KMeans(n_clusters=k, init=centers)
    km._cluster_centers = centers
    km._n_iter = int(state["n_iter"])
    km._inertia = float(state["inertia"])
    return km
