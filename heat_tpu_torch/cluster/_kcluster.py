"""Base class for k-statistics clustering (counterpart of heat_tpu/cluster/_kcluster.py).

The Lloyd loop is a Python loop over device tensors. Each iteration runs one assignment
step per rank — the fused kernel K1 where the estimator offers it (:meth:`_fused_step`),
else the generic cdist + argmin + segment sums — and then ONE ``all_reduce`` of the
packed (k·d + k + 1) record of sums, counts and sse, the single collective of
heat_tpu/cluster/kmeans.py:80-97.

Unlike heat_tpu, whose whole loop is one jitted ``while_loop`` on the device, the
convergence test ``shift > tol`` reads one scalar back to the host every iteration.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray
from ..core.kernels.kmeans import unpack
from ..core.statistics import argmin
from ..spatial.distance import _pairwise

__all__ = ["_KCluster"]


class _KCluster(ClusteringMixin, BaseEstimator):
    """Shared machinery of the k-clustering estimators."""

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
        """Pick the initial centroids: an explicit DNDarray, or ``"random"`` rows of x
        drawn from heat_tpu's stream (:meth:`_random_rows`); ``random_state`` seeds that
        stream first, as heat_tpu's does."""
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
        if self.init in ("probability_based", "kmeans++", "batchparallel"):
            raise NotImplementedError(
                f"init={self.init!r} is not ported yet (ROADMAP.md Queue 1 item 6); "
                "pass init='random' or explicit centers"
            )
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

    @staticmethod
    def _generic_step(xv: torch.Tensor, centers: torch.Tensor):
        """cdist + argmin + segment sums: (labels, packed sums/counts/sse), the
        counterpart of heat_tpu's generic Lloyd body and ``_update_centroids_local``."""
        k = centers.shape[0]
        dist = _pairwise(xv, centers)
        labels = torch.argmin(dist, dim=1)
        sums = torch.zeros_like(centers).index_add_(0, labels, xv)
        counts = torch.zeros(k, dtype=xv.dtype, device=xv.device).index_add_(
            0, labels, torch.ones(xv.shape[0], dtype=xv.dtype, device=xv.device)
        )
        sse = torch.sum(torch.amin(dist, dim=1) ** 2) if xv.shape[0] else xv.new_zeros(())
        return labels, torch.cat([sums.reshape(-1), counts, sse.reshape(1)])

    def fit(self, x: DNDarray):
        """Lloyd iterations until the squared centroid shift drops to ``tol`` or
        ``max_iter`` is reached, then one final assignment for labels and inertia."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        self._initialize_cluster_centers(x)
        if x.split not in (None, 0):
            x = x.resplit(0)  # the loop runs over row chunks
        promoted = types.promote_types(x.dtype, types.float32)
        tt = promoted.torch_type()
        xv = x.larray.to(tt).contiguous()
        centers = self._cluster_centers.larray.to(device=xv.device, dtype=tt).contiguous()
        step = self._fused_step(x, promoted) or self._generic_step
        k, d = centers.shape
        reduce = x.is_distributed()

        def assign(c):
            labels, packed = step(xv, c)
            if reduce:
                x.comm.all_reduce(packed, "sum")  # the one collective per iteration
            return labels, unpack(packed, k, d)

        n_iter, shift = 0, float("inf")
        while n_iter < self.max_iter and shift > self.tol:
            _, (sums, counts, _) = assign(centers)
            new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), centers)
            # the host reads the shift back every iteration (heat_tpu keeps the loop on
            # the device)
            shift = float(torch.sum((centers - new) ** 2))
            centers = new
            n_iter += 1
        labels, (_, _, sse) = assign(centers)

        self._n_iter = n_iter
        self._cluster_centers = DNDarray(centers, (k, d), promoted, None, x.device, x.comm, True)
        self._labels = DNDarray(labels.to(torch.int64), (x.gshape[0],), types.int64, x.split, x.device, x.comm, True)
        self._inertia = float(sse)
        return self

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Nearest-centroid assignment through the metric and a global argmin."""
        return argmin(self._metric(x, self._cluster_centers), axis=1)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest learned centroid for each sample."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        return self._assign_to_cluster(x)
