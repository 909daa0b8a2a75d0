"""Core of heat_tpu_torch: types, devices, communication, the DNDarray and its operations."""

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
    types,
)
