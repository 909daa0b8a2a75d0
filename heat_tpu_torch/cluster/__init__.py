"""Clustering algorithms (counterpart of heat_tpu/cluster/)."""

from .batchparallelclustering import *
from .kmeans import *
from .kmedians import *
from .kmedoids import *
from .spectral import *
from . import batchparallelclustering, kmeans, kmedians, kmedoids, spectral
