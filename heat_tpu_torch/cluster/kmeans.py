"""K-Means clustering (counterpart of heat_tpu/cluster/kmeans.py)."""

from __future__ import annotations

from typing import Optional, Union

from ..core import types
from ..core.dndarray import DNDarray
from ..core.kernels import kmeans as k1
from ..spatial.distance import cdist
from ._kcluster import _KCluster

__all__ = ["KMeans"]


class KMeans(_KCluster):
    """Lloyd's algorithm over a row-split point set. Each iteration is one K1 pass per
    rank and one all_reduce of the packed (k, d) sums, (k,) counts and sse."""

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
