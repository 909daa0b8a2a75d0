"""Clustering algorithms (counterpart of heat_tpu/cluster/: KMeans so far)."""

from .kmeans import *
from . import kmeans
