"""K-Means clustering (counterpart of heat_tpu/cluster/kmeans.py)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core import profiler, types
from ..core.dndarray import DNDarray
from ..core.kernels import kmeans as k1
from ..spatial.distance import _pairwise, cdist
from ._kcluster import _KCluster, _Rows

__all__ = ["KMeans"]


class KMeans(_KCluster):
    """Lloyd's algorithm over a row-split point set. Each iteration is one K1 pass per
    rank and one all_reduce of the packed (k, d) sums, (k,) counts and sse.
    ``init="kmeans++"`` is heat_tpu's greedy ++ seeding (``"probability_based"``)."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmeans++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: cdist(x, y, quadratic_expansion=True),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def _fused_step(self, x: DNDarray, dtype):
        """K1 (core/kernels/kmeans.py) for f32 fits within the kernel's shared-memory
        gate; f64 fits and larger shapes take the generic step, as heat_tpu's do."""
        if dtype is not types.float32 or not k1.fits_smem(x.gshape[1], self.n_clusters):
            return None
        return k1.fused_assign_update_packed

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

    def _pass(self, xv: torch.Tensor, centers: torch.Tensor, rows: _Rows, step, update: bool = True):
        """One pass: K1 (or the generic step) per rank, then the one all_reduce of the
        packed record; the masked mean keeps an empty cluster's old center."""
        k, d = centers.shape
        profiler.part("lloyd.assign")
        labels, packed = (step or self._generic_step)(xv, centers)
        profiler.part("lloyd.update")
        rows.sum(packed)  # the one collective of the pass
        sums, counts, sse = k1.unpack(packed, k, d)
        new = None
        if update:
            new = torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts[:, None], 1.0), centers)
        return labels, new, sse
