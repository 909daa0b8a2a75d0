"""Spectral clustering (counterpart of heat_tpu/cluster/spectral.py).

The similarity kernel (rbf or euclidean) gives the graph Laplacian; ``linalg.lanczos``
from v0 = 1/√n gives (V, T); the eigenvectors of T, from ``torch.linalg.eigh``, give the
embedding V·evecs (TF32 off), and ``KMeans(init="kmeans++")`` clusters its first k
columns. heat_tpu's rbf similarity is float64 (``sigma`` is a NumPy float64), so this
pipeline is too, and its KMeans takes the generic float64 Lloyd step. LAPACK's signs of
the eigenvectors may differ from jnp's; distances do not see a column's sign.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import factories
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray
from ..core.linalg import lanczos
from ..graph import Laplacian
from ..spatial.distance import cdist, rbf

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering on the graph Laplacian of a similarity matrix."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        if metric == "rbf":
            sig = np.sqrt(1.0 / (2.0 * gamma))
            sim = lambda x: rbf(x, sigma=sig)  # noqa: E731
        elif metric == "euclidean":
            sim = lambda x: cdist(x)  # noqa: E731
        else:
            raise NotImplementedError(f"metric {metric!r} not supported")
        if laplacian == "eNeighbour":
            self._laplacian = Laplacian(
                sim, definition="norm_sym", mode="eNeighbour", threshold_key=boundary, threshold_value=threshold
            )
        elif laplacian == "fully_connected":
            self._laplacian = Laplacian(sim, definition="norm_sym", mode="fully_connected")
        else:
            raise NotImplementedError(f"laplacian {laplacian!r} not supported")

        self._labels = None
        self._cluster = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """(eigenvalues (m,), embedding (n, m)), both whole on every rank: the Lanczos
        vectors times T's eigenvectors, eigenvalues ascending."""
        L = self._laplacian.construct(x)
        n = L.gshape[0]
        m = min(self.n_lanczos, n)
        v0 = factories.full((n,), 1.0 / np.sqrt(n), dtype=L.dtype, device=L.device, comm=x.comm)
        V, T = lanczos(L, m, v0)
        evals, evecs = torch.linalg.eigh(T.larray)
        with full_fp32_matmul():
            components = V.larray @ evecs
        eigenvalues = DNDarray(evals, (m,), T.dtype, None, L.device, x.comm, True)
        return eigenvalues, DNDarray(components, (n, m), T.dtype, None, L.device, x.comm, True)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed and cluster with ``KMeans(init="kmeans++", max_iter=300)``; without
        ``n_clusters`` the largest gap between consecutive eigenvalues sets it."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        eigenvalues, eigenvectors = self._spectral_embedding(x)
        if self.n_clusters is None:
            diff = np.diff(eigenvalues.numpy())
            self.n_clusters = int(np.argmax(diff)) + 1
        k = max(self.n_clusters, 1)
        components = eigenvectors[:, :k].resplit(x.split)
        if self.assign_labels != "kmeans":
            raise NotImplementedError(f"assign_labels {self.assign_labels!r} not supported")
        from .kmeans import KMeans

        self._cluster = KMeans(n_clusters=k, init="kmeans++", max_iter=300)
        self._cluster.fit(components)
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError("Spectral clustering cannot predict on unseen data; use fit_predict")
