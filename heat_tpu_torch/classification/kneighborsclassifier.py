"""K-nearest-neighbour classifier (counterpart of
heat_tpu/classification/kneighborsclassifier.py): the distances to the training set
(``cdist``), the k nearest by ``topk`` (ties to the lowest index), the one-hot rows of
their labels taken and summed, and the most voted class (ties to the lowest class).

When the training set is split, the rows of the nearest neighbours may live on other
ranks: they come by the port's ``take`` (one all-to-all, each rank sending only the
rows asked of it) after one all-gather of the neighbours' indices.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import core as ht
from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray
from ..spatial.distance import cdist

__all__ = ["KNeighborsClassifier"]


class KNeighborsClassifier(BaseEstimator, ClassificationMixin):
    """Vote among the ``n_neighbors`` nearest training samples."""

    def __init__(self, n_neighbors: int = 5, effective_metric_: Optional[Callable] = None):
        self.n_neighbors = n_neighbors
        self.effective_metric_ = effective_metric_ or cdist
        self.x = None
        self.y = None

    @staticmethod
    def one_hot_encoding(x: DNDarray) -> DNDarray:
        """One-hot float32 rows of integer labels; as many columns as the largest label
        plus one."""
        labels = x._relayout(0 if x.split is not None else None).reshape(-1).to(torch.int64)
        n_classes = int(ht.max(x).item()) + 1 if x.size else 0
        enc = (labels[:, None] == torch.arange(n_classes, device=labels.device)[None, :]).to(torch.float32)
        split = 0 if x.split is not None else None
        return DNDarray(enc, (x.gshape[0], n_classes), types.float32, split, x.device, x.comm, True)

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Keep the training set; 1-D labels (or a column of them) are one-hot encoded."""
        self.x = x
        if y.ndim == 1 or (y.ndim == 2 and y.gshape[1] == 1):
            self.y = self.one_hot_encoding(y)
        else:
            self.y = y
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """The most voted class of each sample's nearest training samples."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        if x.split not in (None, 0):
            x = x.resplit(0)
        _, indices = ht.topk(self.effective_metric_(x, self.x), self.n_neighbors, largest=False)
        idx, comm, k = indices.larray, indices.comm, self.n_neighbors
        onehot = self.y
        if onehot.is_distributed() and onehot.split == 0:
            # every rank's neighbour indices, then the rows they name from whichever ranks
            # hold them; each rank keeps its own queries' rows
            flat = comm.all_gather_v(idx.reshape(-1)) if indices.is_distributed() else idx.reshape(-1)
            counts, _ = onehot.counts_displs()
            rows = comm.take(onehot.larray, 0, counts, flat, replicate=True)
            if indices.is_distributed():
                lo = comm.chunk(indices.gshape, 0)[0] * k
                rows = rows[lo : lo + idx.numel()]
        else:
            rows = onehot._relayout(None).index_select(0, idx.reshape(-1))
        votes = rows.reshape(idx.shape[0], k, -1).sum(1)
        labels = torch.argmax(votes, dim=1).to(torch.int64)
        split = 0 if x.split is not None else None
        return DNDarray(labels, (x.gshape[0],), types.int64, split, x.device, x.comm, True)
