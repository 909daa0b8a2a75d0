"""Utilities (counterpart of heat_tpu/utils/: the data fixtures and test matrices)."""

from . import data
