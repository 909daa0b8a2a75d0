"""Graph algorithms (counterpart of heat_tpu/graph/)."""

from .laplacian import *
from . import laplacian
