"""Data utilities (counterpart of heat_tpu/utils/data/: ``spherical`` and
``matrixgallery``)."""

from . import matrixgallery, spherical
