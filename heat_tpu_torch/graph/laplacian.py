"""Graph Laplacians (counterpart of heat_tpu/graph/laplacian.py).

The similarity matrix keeps its split (rbf and cdist of a row-split x are split 0): each
rank builds its own rows of the Laplacian, sets the diagonal at its rows' global
offsets, and only the degree vector (n floats, heat_tpu's ``resplit(None)``) is
replicated.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


def _degree(A: DNDarray) -> torch.Tensor:
    """The row sums of A, whole on every rank (a gather of n values)."""
    local = torch.sum(A.larray, dim=1)
    if A.split == 0 and A.is_distributed():
        return A.comm.all_gather_v(local, A.counts_displs()[0])
    return local


def _diagonal(A: DNDarray):
    """(local rows, their global columns) of the diagonal entries on this rank."""
    offset = A.comm.chunk(A.gshape, 0)[0] if A.split == 0 else 0
    rows = torch.arange(A.lshape[0], device=A.larray.device)
    return rows, rows + offset


class Laplacian:
    """Adjacency construction and the simple (D − A) or normalized symmetric
    (I − D^{-1/2} A D^{-1/2}) Laplacian of a similarity graph."""

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError("Only simple and normalized symmetric Laplacians are supported")
        self.definition = definition
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError("Only eNeighbour and fully-connected graphs are supported")
        self.mode = mode
        if threshold_key not in ("upper", "lower"):
            raise ValueError(f"threshold_key must be 'upper' or 'lower', got {threshold_key}")
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def _normalized_symmetric_L(self, A: DNDarray) -> DNDarray:
        """L_sym = I − D^{-1/2} A D^{-1/2} (a zero degree counts as 1)."""
        degree = _degree(A)
        deg = torch.where(degree == 0, 1.0, degree)
        rows, cols = _diagonal(A)
        lv = A.larray / torch.sqrt(deg[cols])[:, None]
        lv = lv / torch.sqrt(deg)[None, :]
        lv = -lv
        lv[rows, cols] = 1.0
        return DNDarray(lv, A.gshape, A.dtype, A.split, A.device, A.comm, True)

    def _simple_L(self, A: DNDarray) -> DNDarray:
        """L = D − A."""
        degree = _degree(A)
        rows, cols = _diagonal(A)
        D = torch.zeros_like(A.larray)
        D[rows, cols] = degree[cols]
        return DNDarray(D - A.larray, A.gshape, A.dtype, A.split, A.device, A.comm, True)

    def construct(self, X: DNDarray) -> DNDarray:
        """The Laplacian of the similarity graph of ``X``'s rows."""
        S = self.similarity_metric(X)
        if S.split not in (None, 0):
            S = S.resplit(0)
        if self.mode == "eNeighbour":
            key, value = self.epsilon
            sv = S.larray
            keep = sv < value if key == "upper" else sv > value
            adj = torch.where(keep, sv if self.weighted else torch.ones_like(sv), torch.zeros_like(sv))
            rows, cols = _diagonal(S)
            adj[rows, cols] = 0.0
            S = DNDarray(adj, S.gshape, S.dtype, S.split, S.device, S.comm, True)
        if self.definition == "simple":
            return self._simple_L(S)
        return self._normalized_symmetric_L(S)
