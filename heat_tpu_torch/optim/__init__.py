"""Optimizers (counterpart of heat_tpu.optim): ``DataParallelOptimizer``, the learning-rate
schedulers and ``DetectMetricPlateau``. Any other name falls through to ``torch.optim``,
as the reference Heat falls through to it (heat_tpu falls through to optax)."""

import torch

from .dp_optimizer import *
from .utils import *
from . import dp_optimizer, lr_scheduler, utils


def __getattr__(name):
    try:
        return getattr(torch.optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute {name!r}") from None
