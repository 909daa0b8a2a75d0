"""Preprocessing transformers (counterpart of heat_tpu/preprocessing/)."""

from .preprocessing import *
from . import preprocessing
