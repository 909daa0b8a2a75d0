"""Base class for k-statistics clustering (counterpart of heat_tpu/cluster/_kcluster.py).

The Lloyd loop keeps heat_tpu's ``while_loop`` semantics (heat_tpu/cluster/_kcluster.py:
194-226): ``cond = (i < max_iter) & (shift > tol)``, and ``n_iter`` counts the updates
applied. ``i``, the centers and ``shift`` are tensors on the data's device; every pass
computes ``active`` there and applies its update under ``torch.where(active, ...)``, so
a pass after convergence changes nothing. The host reads ``active`` once every
:data:`CHECK_EVERY` passes (never when ``tol < 0``, where only a NaN shift could stop the
loop before ``max_iter``) and the results once at the end: after an early convergence
the loop runs up to ``CHECK_EVERY - 1`` idle passes.

Each pass runs one assignment step per rank — the fused kernel K1 where the estimator
offers it (KMeans), else the estimator's metric and argmin — and then the estimator's
centroid update (:meth:`_update_centroids_local`): for KMeans ONE ``all_reduce`` of the
packed (k·d + k + 1) record of sums, counts and sse, the single collective of
heat_tpu/cluster/kmeans.py:80-97.

Phases (``ht.profiler``, recorded while it is enabled or a ``torch.profiler`` session
runs): ``fit.entry`` up to the first pass; one ``lloyd.pass`` a pass, in two parts,
``lloyd.assign`` (the assignment step) and ``lloyd.update`` (the reduction, the masked
mean, the loop's ``where`` and shift); ``lloyd.check``, each host read of ``active``;
``fit.readback``, the final assignment and the reads of the results. The counter
``lloyd.host_reads`` counts the loop's reads of the device: each ``active`` and the two
results (the initialisation's own, for ``"kmeans++"`` or ``"random"``, are not counted).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core import profiler, types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.statistics import argmin
from ..spatial.distance import _pairwise

__all__ = ["_KCluster"]

CHECK_EVERY = 8
"""Passes of the Lloyd loop between two host reads of its ``active`` flag."""


class _Rows(NamedTuple):
    """How the rows of a row-split (or whole) x lie on the ranks."""

    comm: object
    counts: Tuple[int, ...]  # rows of every rank
    offset: int  # this rank's first global row
    distributed: bool

    @property
    def n(self) -> int:
        return sum(self.counts)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (in place)."""
        return self.comm.all_reduce(t, "sum") if self.distributed else t

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        return self.comm.all_reduce(t, op) if self.distributed else t


def _rows_of(x: DNDarray) -> _Rows:
    if x.split == 0 and x.is_distributed():
        counts, displs = x.counts_displs()
        return _Rows(x.comm, tuple(counts), displs[x.comm.rank], True)
    return _Rows(x.comm, (x.lshape[0],), 0, False)


class _KCluster(ClusteringMixin, BaseEstimator):
    """Shared machinery of the k-clustering estimators."""

    _check_every = CHECK_EVERY

    def __init__(
        self,
        metric: Callable,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int] = None,
    ):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._metric = metric
        self._metric_kind = "euclidean"  # the local metric of the Lloyd loop
        self._seed_p = 2  # metric exponent of the ++ seeding (1: manhattan)
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> None:
        """Pick the initial centroids (heat_tpu/cluster/_kcluster.py:72-106): an explicit
        DNDarray; ``"random"`` rows of x from heat_tpu's stream (:meth:`_random_rows`);
        ``"probability_based"``/``"kmeans++"``, the greedy ++ seeding under the key
        ``random.randint(0, 2**31 - 1)`` draws; or ``"batchparallel"``, the centers of a
        :class:`BatchParallelKMeans` fit. ``random_state`` seeds the stream first, as
        heat_tpu's does."""
        from ..core import random

        if self.random_state is not None:
            random.seed(self.random_state)
        k = self.n_clusters
        if isinstance(self.init, DNDarray):
            if self.init.gshape != (k, x.gshape[1]):
                raise ValueError(
                    f"passed centroids must have shape ({k}, {x.gshape[1]}), got {self.init.gshape}"
                )
            self._cluster_centers = self.init.resplit(None)
            return
        if not isinstance(self.init, str):
            raise ValueError(f"unsupported initialization method {self.init!r}")
        if self.init == "random":
            self._cluster_centers = self._random_rows(x, k)
            return
        if self.init in ("probability_based", "kmeans++"):
            from .batchparallelclustering import _plus_plus

            seed = int(random.randint(0, 2**31 - 1, (1,), device=x.device, comm=x.comm).larray.item())
            xv = x.larray.to(torch.float32)
            rows = _rows_of(x)
            centers, _ = _plus_plus(xv, k, self._seed_p, random._key(seed), rows)
            dtype = x.dtype
            self._cluster_centers = DNDarray(centers.to(dtype.torch_type()), (k, x.gshape[1]), dtype, None,
                                             x.device, x.comm, True)
            return
        if self.init == "batchparallel":
            from .batchparallelclustering import BatchParallelKMeans

            bpk = BatchParallelKMeans(n_clusters=k, init="k-means++", max_iter=25)
            bpk.fit(x)
            self._cluster_centers = bpk.cluster_centers_
            return
        raise ValueError(f"unsupported initialization method {self.init!r}")

    def _random_rows(self, x: DNDarray, k: int) -> DNDarray:
        """``k`` distinct rows of x, the same on every rank: the first ``k`` of heat_tpu's
        ``random.randperm(n)`` (heat_tpu/cluster/_kcluster.py:84-88), fetched from the
        ranks that hold them."""
        from ..core import random

        return x[random.randperm(x.gshape[0], device=x.device, comm=x.comm)[:k]]

    def _fused_step(self, x: DNDarray, dtype) -> Optional[Callable]:
        """The fused assignment+accumulation step ``fn(xv, centers) -> (labels, packed)``
        for this fit, or None for the generic step. Subclasses override where a kernel
        exists (KMeans)."""
        return None

    def _assign_local(self, xv: torch.Tensor, centers: torch.Tensor):
        """(labels, each row's distance to its center) under the estimator's metric:
        heat_tpu's generic Lloyd body (``_pairwise`` and ``argmin``)."""
        dist = _pairwise(xv, centers, self._metric_kind)
        if xv.shape[0] == 0:
            return torch.zeros(0, dtype=torch.int64, device=xv.device), dist.new_zeros(0)
        return torch.argmin(dist, dim=1), torch.amin(dist, dim=1)

    def _update_centroids_local(self, xv: torch.Tensor, labels: torch.Tensor, old: torch.Tensor, rows: _Rows):
        """The new centers (k, d), the same on every rank, from this rank's rows ``xv``
        and their ``labels``; an empty cluster keeps its ``old`` center. Subclasses
        implement it (heat_tpu's per-estimator ``_update_centroids_local``)."""
        raise NotImplementedError()

    def _pass(self, xv: torch.Tensor, centers: torch.Tensor, rows: _Rows, step, update: bool = True):
        """One Lloyd pass: (labels, the updated centers or None, the sse on every rank)."""
        profiler.part("lloyd.assign")
        labels, mind = self._assign_local(xv, centers)
        profiler.part("lloyd.update")
        sse = rows.sum(torch.sum(mind**2).reshape(1))[0]
        new = self._update_centroids_local(xv, labels, centers, rows) if update else None
        return labels, new, sse

    def fit(self, x: DNDarray):
        """Lloyd iterations until the squared centroid shift drops to ``tol`` or
        ``max_iter`` updates are applied, then one final assignment for the labels and
        the inertia."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        with profiler.phase("fit.entry"):
            if x.split not in (None, 0):
                x = x.resplit(0)  # the loop runs over row chunks
            self._initialize_cluster_centers(x)
            promoted = types.promote_types(x.dtype, types.float32)
            tt = promoted.torch_type()
            xv = x.larray.to(tt).contiguous()
            centers = self._cluster_centers.larray.to(device=xv.device, dtype=tt).contiguous()
            rows = _rows_of(x)
            step = self._fused_step(x, promoted)
            tol = float(self.tol)
            i = torch.zeros((), dtype=torch.int64, device=xv.device)
            shift = torch.full((), float("inf"), dtype=tt, device=xv.device)
        for p in range(self.max_iter):
            active = shift > tol  # and i < max_iter, which holds: i <= p
            if p and p % self._check_every == 0 and tol >= 0:
                with profiler.phase("lloyd.check"):
                    profiler.count("lloyd.host_reads")
                    go = bool(active)  # the host's read of the loop's condition
                if not go:
                    break
            with profiler.phase("lloyd.pass", parts=True):
                _, new, _ = self._pass(xv, centers, rows, step)
                moved = torch.sum((centers - new) ** 2)
                centers = torch.where(active, new, centers)
                shift = torch.where(active, moved, shift)
                i = i + active.to(torch.int64)
        with profiler.phase("fit.readback"):
            labels, _, sse = self._pass(xv, centers, rows, step, update=False)
            k, d = centers.shape
            profiler.count("lloyd.host_reads", 2)
            self._n_iter = int(i)
            self._cluster_centers = DNDarray(centers, (k, d), promoted, None, x.device, x.comm, True)
            self._labels = DNDarray(labels.to(torch.int64), (x.gshape[0],), types.int64, x.split, x.device, x.comm,
                                    True)
            self._inertia = float(sse)
        return self

    def _assign_to_cluster(self, x: DNDarray, eval_functional_value: bool = False) -> DNDarray:
        """Nearest-centroid assignment through the estimator's metric and a global argmin;
        with ``eval_functional_value`` also sets ``inertia_``, the sum of the squared
        distances to the nearest centroid (heat_tpu/cluster/_kcluster.py:111-117)."""
        distances = self._metric(x, self._cluster_centers)
        labels = argmin(distances, axis=1)
        if eval_functional_value:
            from ..core.arithmetics import sum as _sum
            from ..core.statistics import min as _min

            self._inertia = float(_sum(_min(distances, axis=1) ** 2).item())
        return labels

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid for each sample, under the estimator's metric."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._assign_to_cluster(x)
