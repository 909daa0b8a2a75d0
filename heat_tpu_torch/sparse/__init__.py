"""Distributed sparse matrices (counterpart of heat_tpu/sparse/)."""

from .arithmetics import *
from .dcsr_matrix import *
from .factories import *
from .manipulations import *
from . import arithmetics, dcsr_matrix, factories, manipulations
