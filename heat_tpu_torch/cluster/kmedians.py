"""K-Medians clustering (counterpart of heat_tpu/cluster/kmedians.py).

Rows are assigned by the manhattan distance, and each center moves to the
coordinate-wise median of its cluster (heat_tpu/cluster/kmedians.py:41-54): ``jnp``'s
``nanmedian``, the *midpoint* of the two middle values of each column, NaN skipped.

The medians come from one sort of the whole (n, d) array, not k masked ones: for float32
each element becomes an int64 key, its cluster in the high 32 bits and its value's bits,
mapped to an order-preserving integer, in the low 32 (every NaN after every number), so a
sort along axis 0 leaves each column grouped by cluster and sorted within each group.
The middle elements of group c then lie at the group's start (the counts of the clusters
before it) plus ⌊(m − 1)/2⌋ and ⌊m/2⌋, m the group's numbers that are not NaN. Across
ranks the sort is the distributed one (``core/dist_sort.py``) and each rank contributes
the middle elements it holds to one max all-reduce of the keys. Float64 data, whose keys
would need 64 bits for the value, is sorted at one rank by value and then stably by
cluster; across ranks, one distributed sort a cluster of x with the other clusters'
elements made NaN.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..core.dndarray import DNDarray
from ..spatial.distance import manhattan
from ._kcluster import _KCluster, _Rows

__all__ = ["KMedians"]

M32 = 0xFFFFFFFF
_SIGN = 0x80000000


def _keys(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """int64 keys of float32 ``x`` (n, d): cluster << 32 | the value's order-preserving
    bits (negative numbers' bits inverted, the others' sign bit set; NaN made positive,
    so it sorts after +inf)."""
    x = torch.where(torch.isnan(x), float("nan"), x)
    b = x.view(torch.int32).to(torch.int64) & M32
    ordered = torch.where(b >= _SIGN, (~b) & M32, b | _SIGN)
    return (labels.to(torch.int64)[:, None] << 32) | ordered


def _values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of :func:`_keys`' keys."""
    ordered = keys & M32
    b = torch.where(ordered >= _SIGN, ordered ^ _SIGN, (~ordered) & M32)
    return torch.where(b >= _SIGN, b - 2**32, b).to(torch.int32).view(torch.float32)


def _masked_medians(x: torch.Tensor, labels: torch.Tensor, present: torch.Tensor, rows: _Rows):
    """The two middle values of every (cluster, column) of float64 data across ranks: one
    distributed sort a cluster of x with the other clusters' elements made NaN (sorted
    last), each middle element contributed by the rank that holds it to a sum
    all-reduce."""
    from ..core.dist_sort import distributed_sort

    k, d = present.shape
    n = rows.n
    begin = rows.comm.chunk((n, d), 0)[0]
    xs = torch.where(torch.isnan(x), float("nan"), x)
    ends = [(torch.clamp_min(present - 1, 0) // 2).clamp(max=n - 1), (present // 2).clamp(max=n - 1)]
    low, high = (torch.empty((k, d), dtype=x.dtype, device=x.device) for _ in range(2))
    for c in range(k):
        ordered, _ = distributed_sort(rows.comm, torch.where((labels == c)[:, None], xs, float("nan")), n, 0)
        for pos, out in zip(ends, (low, high)):
            local = pos[c] - begin
            inside = (local >= 0) & (local < ordered.shape[0])
            if ordered.shape[0]:
                got = ordered.gather(0, local.clamp(0, ordered.shape[0] - 1)[None, :])[0]
            else:
                got = torch.zeros(d, dtype=x.dtype, device=x.device)
            out[c] = rows.sum(torch.where(inside, got, 0.0))
    return low, high


def _medians(x: torch.Tensor, labels: torch.Tensor, old: torch.Tensor, rows: Optional[_Rows]) -> torch.Tensor:
    """The (k, d) coordinate-wise medians of the clusters, NaN skipped, the midpoint of
    the two middle values, the same on every rank; an empty cluster keeps ``old``."""
    k, d = old.shape
    distributed = rows is not None and rows.distributed
    counts = torch.zeros(k, dtype=torch.int64, device=x.device).index_add_(0, labels, torch.ones_like(labels))
    present = torch.zeros((k, d), dtype=torch.int64, device=x.device).index_add_(
        0, labels, (~torch.isnan(x)).to(torch.int64)
    )
    if distributed:
        rows.sum(counts)
        rows.sum(present)
    starts = torch.cumsum(counts, 0) - counts
    n = rows.n if rows is not None else x.shape[0]
    last = max(n - 1, 0)
    lo = (starts[:, None] + torch.clamp_min(present - 1, 0) // 2).clamp(max=last)
    hi = (starts[:, None] + present // 2).clamp(max=last)
    if x.dtype == torch.float32:
        if distributed:
            from ..core.dist_sort import distributed_sort

            ordered, _ = distributed_sort(rows.comm, _keys(x, labels), n, 0)
            # this rank's chunk of the sorted keys: the canonical one
            begin = rows.comm.chunk((n, d), 0)[0]
            picked = []
            for pos in (lo, hi):
                local = pos - begin
                inside = (local >= 0) & (local < ordered.shape[0])
                if ordered.shape[0]:
                    got = ordered.gather(0, local.clamp(0, ordered.shape[0] - 1))
                else:
                    got = torch.zeros_like(local)
                picked.append(rows.reduce(torch.where(inside, got, -1), "max"))
            low, high = (_values(p) for p in picked)
        else:
            ordered = torch.sort(_keys(x, labels), dim=0).values
            low, high = _values(ordered.gather(0, lo)), _values(ordered.gather(0, hi))
    elif distributed:
        low, high = _masked_medians(x, labels, present, rows)
    else:
        xs = torch.where(torch.isnan(x), float("nan"), x)
        values, index = torch.sort(xs, dim=0, stable=True)
        by_cluster = torch.sort(labels[index], dim=0, stable=True).indices
        ordered = values.gather(0, by_cluster)
        low, high = ordered.gather(0, lo), ordered.gather(0, hi)
    med = (low + high) * 0.5
    return torch.where(counts[:, None] > 0, med.to(old.dtype), old)


class KMedians(_KCluster):
    """k-medians: manhattan assignment and coordinate-wise medians of the clusters.
    ``init="kmedians++"`` is the greedy ++ seeding under the manhattan metric."""

    # a pass sorts the whole array, which outweighs a read of the loop's flag: check each pass
    _check_every = 1

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init == "kmedians++":
            init = "probability_based"
        super().__init__(
            metric=lambda x, y: manhattan(x, y),
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )
        self._seed_p = 1  # seed with the manhattan metric the estimator optimizes
        self._metric_kind = "manhattan"

    def _update_centroids_local(self, xv: torch.Tensor, labels: torch.Tensor, old: torch.Tensor, rows: _Rows):
        """Coordinate-wise median per cluster (heat_tpu/cluster/kmedians.py:41-54)."""
        return _medians(xv, labels, old, rows)
