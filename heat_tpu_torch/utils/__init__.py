"""Utilities (counterpart of heat_tpu/utils/: the data fixtures so far)."""

from . import data
