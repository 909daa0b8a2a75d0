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
    """heat_tpu's tree as dotted paths: dicts by key, lists (``Sequential``,
    ``ModuleList``) by index; ``()`` is a module without parameters."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (tuple, list)) else None
    if items is None:
        out[prefix] = np.asarray(tree)
        return out
    for name, sub in items:
        _flatten(sub, f"{prefix}.{name}" if prefix else str(name), out)
    return out


def _port_path(module: torch.nn.Module, path: str) -> str:
    """The ``state_dict`` key of heat_tpu's dotted ``path``: a ``Remat``'s tree is its
    wrapped module's own, which the port holds under ``module``."""
    from .nn.modules import Remat

    parts, out, m = path.split("."), [], module
    for i, name in enumerate(parts):
        while isinstance(m, Remat):
            out.append("module")
            m = m.module
        out.append(name)
        if i < len(parts) - 1:
            m = m._modules.get(name) if m is not None else None
    return ".".join(out)


def load_jax_params(module: torch.nn.Module, params, buffers: Optional[dict] = None) -> torch.nn.Module:
    """Load heat_tpu's parameter tree of the same architecture into ``module`` and return it.

    ``params`` is heat_tpu's tree as nested dicts and lists of numpy arrays (``init``'s
    result with each leaf passed through ``np.asarray``). Its dotted paths are the port's
    ``state_dict`` keys: the modules keep heat_tpu's parameter names (torch's), containers
    and layer stacks name their children "0", "1", ... as heat_tpu does, and a ``Remat``'s
    tree is its wrapped module's. The one layout change: heat_tpu's ``Linear`` weight is
    (in, out) and torch's (out, in), so the weight of every ``torch.nn.Linear`` is
    transposed; convolution, norm, recurrent and attention weights share torch's layout.

    heat_tpu keeps BatchNorm's running statistics on the module, not in the tree
    (modules.py:395-396): ``buffers`` carries them, ``{"path.running_mean": array,
    "path.running_var": array}``, read off heat_tpu's modules; buffers that neither names
    keep the module's values (a fresh module's equal heat_tpu's fresh ones). Raises
    ``ValueError`` on a missing or extra parameter or buffer and on a shape that disagrees."""
    flat = {_port_path(module, k): v for k, v in _flatten(params, "", {}).items()}
    flat.update({_port_path(module, k): np.asarray(v) for k, v in (buffers or {}).items()})
    state = module.state_dict()
    names = {n for n, _ in module.named_parameters()}
    missing = sorted(n for n in set(state) - set(flat) if n in names)
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise ValueError(f"load_jax_params: missing {missing}, extra {extra}")
    loaded = {}
    for name, target in state.items():
        if name not in flat:
            loaded[name] = target
            continue
        a = flat[name]
        owner, _, leaf = name.rpartition(".")
        if leaf == "weight" and isinstance(module.get_submodule(owner), torch.nn.Linear):
            a = a.T
        if tuple(a.shape) != tuple(target.shape):
            raise ValueError(f"load_jax_params: {name} has shape {tuple(a.shape)}, the module wants {tuple(target.shape)}")
        loaded[name] = torch.tensor(np.ascontiguousarray(a), dtype=target.dtype, device=target.device)
    module.load_state_dict(loaded)
    return module
