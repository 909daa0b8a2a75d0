"""Naive Bayes estimators (counterpart of heat_tpu/naive_bayes/)."""

from .gaussianNB import *
from . import gaussianNB
