"""Batch-parallel k-clustering and the greedy ++ seeding (counterpart of
heat_tpu/cluster/batchparallelclustering.py).

Every rank runs a whole single-block k-means (p = 2) or k-medians (p = 1) on its own
canonical chunk of the rows, with the key ``split(key, P + 1)[rank]``: what heat_tpu's
loop over the shard blocks computes (heat_tpu/cluster/batchparallelclustering.py:
183-195). The ranks then all-gather their k × d centroid sets, and every rank runs the
merge tree identically (:197-208); the merge needs no other collective.

:func:`_plus_plus` is heat_tpu's greedy k-means++ (:87-105): 2 + ⌊ln k⌋ candidates a step,
drawn by ``jax.random.choice`` with the probabilities d²/Σd², and the candidate that
minimises the potential wins. On a row-split x (KMeans' ``init="kmeans++"``) each rank
holds its rows' d², Σd² is one all-reduce, the cumulative sum is a local scan plus an
exclusive scan of the ranks' totals, every rank searches its own chunk for the same
targets and an all-reduce keeps the lowest global index; the candidates' rows come from
their owners (``TorchCommunication.take``) and their potentials are all-reduced.
"""

from __future__ import annotations

from typing import Optional, Tuple
from warnings import warn

import numpy as np
import torch

from ..core import random, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..spatial.distance import _pairwise
from ._kcluster import CHECK_EVERY, _Rows

__all__ = ["BatchParallelKMeans", "BatchParallelKMedians"]


def _cdist_p(x: torch.Tensor, y: torch.Tensor, p: int, xx: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _pairwise(x, y, "manhattan" if p == 1 else "euclidean", xx)


def _choice(key, m: int, probs: torch.Tensor, rows: Optional[_Rows]) -> torch.Tensor:
    """``jax.random.choice(key, n, (m,), p=probs)`` over the rows of every rank (global
    int64 indices, the same on every rank); ``probs`` holds this rank's rows."""
    if rows is None or not rows.distributed:
        return random._key_choice(key, m, probs)
    cuml = random._xla_cumsum(probs)
    comm = rows.comm
    rank = comm.rank
    # the local scan plus the exclusive scan of the ranks' totals
    total = cuml[-1] if cuml.shape[0] else cuml.new_zeros(())
    totals = comm.all_gather_stacked(total)
    if rank:
        cuml = cuml + totals[:rank].sum(0)
    last_rank = max(r for r, c in enumerate(rows.counts) if c) if rows.n else 0
    last = totals[last_rank] if last_rank == 0 else totals[:last_rank].sum(0) + totals[last_rank]
    targets = random._choice_draws(key, m, last)
    local = torch.searchsorted(cuml, targets)
    picks = torch.where(local < cuml.shape[0], local + rows.offset, rows.n)
    return rows.reduce(picks, "min")  # the lowest index whose cumulative sum reaches a target


def _take_rows(x: torch.Tensor, index: torch.Tensor, rows: Optional[_Rows]) -> torch.Tensor:
    """The rows at global ``index``, on every rank."""
    if rows is None or not rows.distributed:
        return x.index_select(0, index)
    return rows.comm.take(x, 0, rows.counts, index, replicate=True)


def _plus_plus(X: torch.Tensor, k: int, p: int, key, rows: Optional[_Rows] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy k-means++ seeding (heat_tpu's ``_plus_plus``): the (k, d) centers, the same
    on every rank, and their global row indices. ``X`` is this rank's rows; ``rows``
    says how the rows lie on the ranks (None: ``X`` is all of them)."""
    n_candidates = 2 + int(np.log(max(k, 2)))
    keys = random._split(key, k)
    n = rows.n if rows is not None else X.shape[0]
    first = random._key_randint(keys[0], (1,), 0, n, X.device)
    centers = _take_rows(X, first, rows)
    picks = [first]
    xx = torch.sum(X * X, dim=1) if p != 1 else None  # kept across the steps
    d = _cdist_p(X, centers, p, xx).amin(dim=1) ** 2 if X.shape[0] else X.new_zeros(0)
    for i in range(1, k):
        total = torch.sum(d).reshape(1)
        if rows is not None:
            rows.sum(total)
        probs = d / torch.clamp_min(total[0], 1e-30)
        cand = _choice(keys[i], n_candidates, probs, rows)
        cand_x = _take_rows(X, cand, rows)
        # the potential of each candidate: Σ min(d, its distance²)
        cand_d = _cdist_p(X, cand_x, p, xx) ** 2
        potentials = torch.sum(torch.minimum(d[:, None], cand_d), dim=0)
        if rows is not None:
            rows.sum(potentials)
        best = torch.argmin(potentials)
        picks.append(cand[best].reshape(1))
        centers = torch.cat([centers, cand_x[best].reshape(1, -1)])
        d = torch.minimum(d, cand_d[:, best])
    return centers, torch.cat(picks)


def _update(X: torch.Tensor, labels: torch.Tensor, old: torch.Tensor, p: int) -> torch.Tensor:
    """One block's centroid update: the coordinate-wise median (p = 1) or the mean of each
    cluster; an empty cluster keeps its old center."""
    if p == 1:
        from .kmedians import _medians

        return _medians(X, labels, old, None)
    k = old.shape[0]
    sums = torch.zeros_like(old).index_add_(0, labels, X)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(0, labels, torch.ones_like(X[:, 0]))
    return torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), old)


def _kmex_loop(X: torch.Tensor, centers: torch.Tensor, p: int, max_iter: int, tol: float):
    """heat_tpu's single-block ``while_loop`` (``_kmex_loop``): a pass assigns by
    ``_cdist_p``, updates, and stops the loop once every center moved by at most
    ``tol + 1e-5·|old|`` (``allclose``). Masked passes as in the Lloyd loop of
    ``_kcluster.py`` (``i`` stays below ``max_iter`` inside the loop, so ``active`` is
    ``not done``); the host reads the flag every ``CHECK_EVERY`` passes."""
    i = torch.zeros((), dtype=torch.int64, device=X.device)
    done = torch.zeros((), dtype=torch.bool, device=X.device)
    for q in range(max_iter):
        active = ~done
        if q and q % CHECK_EVERY == 0 and not bool(active):  # ht: ignore[spmd-divergent-collective] -- a block's loop runs on this rank's data alone: _update hands _medians no communicator, so no collective runs inside it and the ranks may stop at different passes
            break
        labels = torch.argmin(_cdist_p(X, centers, p), dim=1)
        new = _update(X, labels, centers, p)
        close = torch.all(torch.abs(new - centers) <= tol + 1e-5 * torch.abs(centers))
        centers = torch.where(active, new, centers)
        done = torch.where(active, close, done)
        i = i + active.to(torch.int64)
    return centers, i


def _kmex(X: torch.Tensor, p: int, n_clusters: int, init, max_iter: int, tol: float, key) -> Tuple[torch.Tensor, int]:
    """Single-block k-means (p = 2) or k-medians (p = 1) (heat_tpu's ``_kmex``): the
    centers and the passes run."""
    if isinstance(init, torch.Tensor):
        centers = init
    elif init == "++":
        centers, _ = _plus_plus(X, n_clusters, p, key)
    elif init == "random":
        idx = random._key_randint(key, (n_clusters,), 0, X.shape[0], X.device)
        centers = X[idx]
    else:
        raise ValueError("init must be an array of initial centers, '++', or 'random'")
    centers, it = _kmex_loop(X, centers, p, max_iter, tol)
    return centers, int(it)


class _BatchParallelKCluster(ClusteringMixin, BaseEstimator):
    """Base class of the batch-parallel estimators."""

    def __init__(
        self,
        p: int,
        n_clusters: int,
        init: str,
        max_iter: int,
        tol: float,
        random_state: Optional[int],
        n_procs_to_merge: Optional[int],
    ):
        if not isinstance(n_clusters, int):
            raise TypeError(f"n_clusters must be int, but was {type(n_clusters)}")
        if n_clusters <= 0:
            raise ValueError(f"n_clusters must be positive, but was {n_clusters}")
        if not isinstance(max_iter, int):
            raise TypeError(f"max_iter must be int, but was {type(max_iter)}")
        if max_iter <= 0:
            raise ValueError(f"max_iter must be positive, but was {max_iter}")
        if not isinstance(tol, float):
            raise TypeError(f"tol must be float, but was {type(tol)}")
        if tol <= 0:
            raise ValueError(f"tol must be positive, but was {tol}")
        if random_state is not None and not isinstance(random_state, int):
            raise TypeError(f"random_state must be int or None, but was {type(random_state)}")
        if n_procs_to_merge is not None and not isinstance(n_procs_to_merge, int):
            raise TypeError(f"procs_to_merge must be int or None, but was {type(n_procs_to_merge)}")
        if n_procs_to_merge is not None and n_procs_to_merge <= 1:
            raise ValueError(f"If an integer, procs_to_merge must be > 1, but was {n_procs_to_merge}.")

        self.n_clusters = n_clusters
        self._init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state
        self.n_procs_to_merge = n_procs_to_merge
        if p not in (1, 2):
            warn(
                "p should be 1 (k-Medians) or 2 (k-Means). For other choice of p, "
                "we proceed as for p=2 and hope for the best.",
                UserWarning,
            )
        self._p = p
        self._cluster_centers = None
        self._n_iter = None
        self._labels = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def n_iter_(self):
        return self._n_iter

    def fit(self, x: DNDarray) -> "_BatchParallelKCluster":
        """A local solve on every rank's chunk, then the merge tree on every rank."""
        if not isinstance(x, DNDarray):
            raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.split != 0:
            raise ValueError(f"input needs to be split along the sample axis (split=0), but was {x.split}")
        if self.random_state is not None:
            seed = self.random_state
        else:
            seed = int(random.randint(0, 2**31 - 1, (1,), device=x.device, comm=x.comm).larray.item())
        key = random._key(seed)
        dtype = x.dtype if x.dtype in (types.float32, types.float64) else types.float32
        xv = x.larray.to(dtype.torch_type())

        comm = x.comm
        nblocks = comm.size if x.is_distributed() else 1
        keys = random._split(key, nblocks + 1)
        rank = comm.rank if nblocks > 1 else 0
        c, it = _kmex(xv, self._p, self.n_clusters, self._init, self.max_iter, self.tol, keys[rank])
        if nblocks > 1:
            centers_list = list(comm.all_gather_stacked(c.contiguous()).unbind(0))
            iters = comm.all_gather_stacked(torch.tensor(it, dtype=torch.int64, device=xv.device)).tolist()
        else:
            centers_list, iters = [c], [it]

        # the merge tree: cluster the concatenated centroid sets, group-wise
        arity = max(self.n_procs_to_merge or len(centers_list) or 2, 2)
        level_key = keys[-1]
        while len(centers_list) > 1:  # ht: ignore[spmd-divergent-collective] -- centers_list is every rank's centers from one all-gather (or this rank's alone at one block): its length, and so the merge tree, is the same on every rank, and _kmex runs no collective
            merged = []
            for i in range(0, len(centers_list), arity):  # ht: ignore[spmd-divergent-collective] -- centers_list is every rank's centers from one all-gather (or this rank's alone at one block): its length, and so the merge tree, is the same on every rank, and _kmex runs no collective
                cat = torch.cat(centers_list[i : i + arity], dim=0)
                level_key, sub = random._split(level_key)
                c, it = _kmex(cat, self._p, self.n_clusters, "++", self.max_iter, self.tol, sub)
                merged.append(c)
                iters.append(it)
            centers_list = merged

        k, d = centers_list[0].shape
        self._cluster_centers = DNDarray(centers_list[0], (k, d), dtype, None, x.device, comm, True)
        self._n_iter = int(np.max(iters))
        self._labels = self.predict(x)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The nearest merged centroid of each row, under the estimator's metric."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        if x.split not in (None, 0):
            x = x.resplit(0)
        dtype = types.promote_types(types.promote_types(x.dtype, types.float32), self._cluster_centers.dtype)
        tt = dtype.torch_type()
        xv, centers = x.larray.to(tt), self._cluster_centers.larray.to(tt)
        if xv.shape[0]:
            labels = torch.argmin(_cdist_p(xv, centers, self._p), dim=1)
        else:
            labels = torch.zeros(0, dtype=torch.int64, device=xv.device)
        return DNDarray(labels, (x.gshape[0],), types.int64, x.split, x.device, x.comm, True)


class BatchParallelKMeans(_BatchParallelKCluster):
    """Batch-parallel K-Means: k-means on every rank's chunk, then the merge tree."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: str = "k-means++",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        n_procs_to_merge: Optional[int] = None,
    ):
        init_map = {"k-means++": "++", "random": "random"}
        if init not in init_map:
            raise ValueError(f"init must be 'k-means++' or 'random', but was {init}")
        super().__init__(
            p=2, n_clusters=n_clusters, init=init_map[init], max_iter=max_iter,
            tol=tol, random_state=random_state, n_procs_to_merge=n_procs_to_merge,
        )


class BatchParallelKMedians(_BatchParallelKCluster):
    """Batch-parallel K-Medians: k-medians on every rank's chunk, then the merge tree."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: str = "k-medians++",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        n_procs_to_merge: Optional[int] = None,
    ):
        init_map = {"k-medians++": "++", "random": "random"}
        if init not in init_map:
            raise ValueError(f"init must be 'k-medians++' or 'random', but was {init}")
        super().__init__(
            p=1, n_clusters=n_clusters, init=init_map[init], max_iter=max_iter,
            tol=tol, random_state=random_state, n_procs_to_merge=n_procs_to_merge,
        )
