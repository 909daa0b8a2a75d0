"""Classification algorithms (counterpart of heat_tpu/classification/)."""

from .kneighborsclassifier import *
from . import kneighborsclassifier
