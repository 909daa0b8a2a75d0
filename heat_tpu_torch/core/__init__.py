"""Core of heat_tpu_torch: types, devices, communication, the DNDarray, its operations and
linear algebra."""

from .constants import *
from .types import *
from .devices import *
from .communication import *
from .dndarray import *
from .factories import *
from .arithmetics import *
from .relational import *
from .statistics import *
from .base import *
from . import linalg
from .linalg import *  # in the flat namespace too, as heat_tpu does
from . import (
    arithmetics,
    base,
    communication,
    constants,
    devices,
    dndarray,
    factories,
    kernels,
    relational,
    sanitation,
    statistics,
    stride_tricks,
    tiling,
    types,
)
