"""K-Medoids clustering (counterpart of heat_tpu/cluster/kmedoids.py).

The centers are samples: each pass takes the mean of every cluster and snaps it to the
nearest sample of that cluster (heat_tpu/cluster/kmedoids.py:38-51); ``tol`` is 0, so the
fit stops when no medoid moves. Across ranks the sums and counts are one all-reduce; each
rank's (least distance, lowest global row) per cluster is merged by two min all-reduces,
the lowest row winning ties as ``jnp.argmin`` does; and the k medoid rows come from
their owners in one sum all-reduce, the owner contributing the row and the others zeros.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..spatial.distance import cdist
from ._kcluster import _KCluster, _Rows

__all__ = ["KMedoids"]


class KMedoids(_KCluster):
    """k-medoids: a mean update snapped to the nearest sample of each cluster.
    ``init="kmedoids++"`` is the greedy ++ seeding."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedoids++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: cdist(x, y),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=0.0,
            random_state=random_state,
        )

    def _update_centroids_local(self, xv: torch.Tensor, labels: torch.Tensor, old: torch.Tensor, rows: _Rows):
        """Mean per cluster, then the closest sample of the same cluster (squared
        distance summed over the features, lowest row on ties)."""
        k, d = old.shape
        n_local = xv.shape[0]
        packed = torch.zeros(k * d + k, dtype=xv.dtype, device=xv.device)
        packed[: k * d].view(k, d).index_add_(0, labels, xv)
        packed[k * d :].index_add_(0, labels, torch.ones(n_local, dtype=xv.dtype, device=xv.device))
        rows.sum(packed)
        sums, counts = packed[: k * d].view(k, d), packed[k * d :]
        means = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), old)
        # each row's squared distance to its own cluster's mean
        near = torch.sum((xv - means[labels]) ** 2, dim=1)
        least = torch.full((k,), float("inf"), dtype=xv.dtype, device=xv.device).scatter_reduce(
            0, labels, near, "amin"
        )
        rows.reduce(least, "min")
        index = torch.arange(rows.offset, rows.offset + n_local, device=xv.device)
        tied = torch.where(near == least[labels], index, rows.n)
        nearest = torch.full((k,), rows.n, dtype=torch.int64, device=xv.device).scatter_reduce(
            0, labels, tied, "amin"
        )
        rows.reduce(nearest, "min")
        local = nearest - rows.offset
        mine = (local >= 0) & (local < n_local)
        if n_local:
            snapped = torch.where(mine[:, None], xv[local.clamp(0, n_local - 1)], 0.0)
        else:
            snapped = torch.zeros_like(old)
        rows.sum(snapped)
        return torch.where(counts[:, None] > 0, snapped, old)
