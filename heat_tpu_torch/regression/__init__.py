"""Regression estimators (counterpart of heat_tpu/regression/)."""

from .lasso import *
from . import lasso
