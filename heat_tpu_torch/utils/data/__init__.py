"""Data utilities (counterpart of heat_tpu/utils/data/: ``spherical`` so far)."""

from . import spherical
