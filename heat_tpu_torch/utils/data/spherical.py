"""Spherical cluster fixtures (counterpart of heat_tpu/utils/data/spherical.py)."""

from __future__ import annotations

from ...core import random, types
from ...core.dndarray import DNDarray
from ...core.manipulations import concatenate

__all__ = ["create_spherical_dataset"]


def create_spherical_dataset(
    num_samples_cluster: int,
    radius: float = 1.0,
    offset: float = 4.0,
    dtype=None,
    random_state: int = 1,
) -> DNDarray:
    """Four Gaussian balls in 3-D at -2, -1, 1 and 2 times ``offset`` on the diagonal,
    ``num_samples_cluster`` points each, split=0, from heat_tpu's random stream seeded by
    ``random_state``: the fixture of heat_tpu's cluster benchmark and tests."""
    dtype = types.canonical_heat_type(dtype or types.float32)
    random.seed(random_state)
    clusters = []
    for c in (-2.0, -1.0, 1.0, 2.0):
        pts = random.randn(num_samples_cluster, 3, dtype=dtype, split=0) * radius + c * offset
        clusters.append(pts)
    return concatenate(clusters, axis=0).resplit(0)
