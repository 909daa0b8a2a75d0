"""Utilities (counterpart of heat_tpu/utils/): the input pipeline and data fixtures, and
the image transforms."""

from . import data, vision_transforms
