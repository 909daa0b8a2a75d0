"""Distributed FFTs (counterpart of heat_tpu/fft/)."""

from .fft import *
from . import fft
