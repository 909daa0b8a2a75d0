"""Spatial algorithms (counterpart of heat_tpu/spatial/)."""

from .distance import *
from . import distance
