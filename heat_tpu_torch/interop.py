"""Carry state across from the JAX package as plain numpy data.

The port imports nothing of heat_tpu, so state crosses as numpy arrays and dicts: a
caller gathers a heat_tpu DNDarray with ``.numpy()``, a fitted heat_tpu ``KMeans`` into
the dict :func:`kmeans_from_state` reads, and a heat_tpu module's parameter tree into the
nested dicts of numpy arrays :func:`load_jax_params` reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .cluster.kmeans import KMeans
from .core import factories, types
from .core.dndarray import DNDarray

__all__ = ["dndarray_from_numpy", "kmeans_from_state", "load_jax_params"]


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


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        for name, sub in tree.items():
            _flatten(sub, f"{prefix}.{name}" if prefix else str(name), out)
    elif isinstance(tree, (tuple, list)) and not tree:
        pass  # a module without parameters (heat_tpu's init gives ())
    else:
        out[prefix] = np.asarray(tree)
    return out


def load_jax_params(module: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load heat_tpu's parameter tree of the same architecture into ``module`` and return it.

    ``params`` is heat_tpu's tree as nested dicts of numpy arrays (``init``'s result with
    each leaf passed through ``np.asarray``). Its dotted paths are the port's
    ``state_dict`` keys: the attention modules keep heat_tpu's names and the layer stacks
    name their layers "0", "1", ... as heat_tpu does. The one layout change: heat_tpu's
    ``Linear`` weight is (in, out) and torch's (out, in), so the weight of every
    ``torch.nn.Linear`` is transposed; the projection weights of ``MultiheadAttention``
    are in torch's layout already. Raises ``ValueError`` on a missing or extra key and on
    a shape that disagrees."""
    flat = _flatten(params, "", {})
    state = module.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing {missing}, extra {extra}")
    loaded = {}
    for name, target in state.items():
        a = flat[name]
        owner, _, leaf = name.rpartition(".")
        if leaf == "weight" and isinstance(module.get_submodule(owner), torch.nn.Linear):
            a = a.T
        if tuple(a.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_params: {name} has shape {tuple(a.shape)}, the module wants {tuple(target.shape)}")
        loaded[name] = torch.tensor(np.ascontiguousarray(a), dtype=target.dtype, device=target.device)
    module.load_state_dict(loaded)
    return module
