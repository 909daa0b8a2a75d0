"""Learning-rate schedulers (counterpart of heat_tpu/optim/lr_scheduler.py).

torch.optim.lr_scheduler's API over the mutable ``lr`` of
:class:`~heat_tpu_torch.optim.DataParallelOptimizer`, which writes every parameter
group's rate: the same nine classes as heat_tpu's, pure Python, so that a schedule gives
the same sequence of rates in both packages.
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Callable, List, Optional, Sequence

__all__ = [
    "LRScheduler",
    "LambdaLR",
    "StepLR",
    "MultiStepLR",
    "ConstantLR",
    "LinearLR",
    "ExponentialLR",
    "CosineAnnealingLR",
    "ReduceLROnPlateau",
]


class LRScheduler:
    """Base class (torch.optim.lr_scheduler.LRScheduler semantics): ``step()`` advances
    ``last_epoch`` and writes ``get_lr()`` into the optimizer."""

    def __init__(self, optimizer, last_epoch: int = -1):
        if not hasattr(optimizer, "lr"):
            raise TypeError(
                f"optimizer must expose a mutable 'lr' (got {type(optimizer)})"
            )
        self.optimizer = optimizer
        self.base_lr = float(optimizer.lr)
        self.last_epoch = last_epoch
        self.step()  # torch initializes by stepping to epoch 0

    def get_lr(self) -> float:
        raise NotImplementedError()

    def get_last_lr(self) -> List[float]:
        return [float(self.optimizer.lr)]

    def step(self, epoch: Optional[int] = None) -> None:
        self.last_epoch = self.last_epoch + 1 if epoch is None else epoch
        self.optimizer.lr = self.get_lr()


class LambdaLR(LRScheduler):
    """lr = base_lr * lr_lambda(epoch)."""

    def __init__(self, optimizer, lr_lambda: Callable[[int], float], last_epoch: int = -1):
        self.lr_lambda = lr_lambda
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.base_lr * self.lr_lambda(self.last_epoch)


class StepLR(LRScheduler):
    """Decay by gamma every step_size epochs."""

    def __init__(self, optimizer, step_size: int, gamma: float = 0.1, last_epoch: int = -1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class MultiStepLR(LRScheduler):
    """Decay by gamma at each milestone epoch."""

    def __init__(self, optimizer, milestones: Sequence[int], gamma: float = 0.1, last_epoch: int = -1):
        self.milestones = sorted(milestones)
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.base_lr * self.gamma ** bisect_right(self.milestones, self.last_epoch)


class ConstantLR(LRScheduler):
    """lr = base_lr * factor until total_iters, then base_lr."""

    def __init__(self, optimizer, factor: float = 1.0 / 3, total_iters: int = 5, last_epoch: int = -1):
        self.factor = factor
        self.total_iters = total_iters
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.base_lr * (self.factor if self.last_epoch < self.total_iters else 1.0)


class LinearLR(LRScheduler):
    """Linearly ramp the factor from start_factor to end_factor over total_iters."""

    def __init__(self, optimizer, start_factor: float = 1.0 / 3, end_factor: float = 1.0,
                 total_iters: int = 5, last_epoch: int = -1):
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        t = min(self.last_epoch, self.total_iters) / self.total_iters
        return self.base_lr * (self.start_factor + (self.end_factor - self.start_factor) * t)


class ExponentialLR(LRScheduler):
    """lr = base_lr * gamma ** epoch."""

    def __init__(self, optimizer, gamma: float, last_epoch: int = -1):
        self.gamma = gamma
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        return self.base_lr * self.gamma**self.last_epoch


class CosineAnnealingLR(LRScheduler):
    """Cosine anneal from base_lr to eta_min over T_max epochs."""

    def __init__(self, optimizer, T_max: int, eta_min: float = 0.0, last_epoch: int = -1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(optimizer, last_epoch)

    def get_lr(self) -> float:
        # torch does NOT clamp at T_max: the cosine keeps evolving, so the lr
        # climbs back up after the trough (periodic annealing)
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)
        ) / 2


class ReduceLROnPlateau:
    """Multiply lr by ``factor`` after ``patience`` epochs without improvement
    (torch.optim.lr_scheduler.ReduceLROnPlateau semantics; ``step`` takes the metric)."""

    def __init__(self, optimizer, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, min_lr: float = 0.0,
                 cooldown: int = 0):
        if factor >= 1.0:
            raise ValueError("factor should be < 1.0")
        self.optimizer = optimizer
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.last_epoch = -1

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1 - self.threshold)
        return metric > self.best * (1 + self.threshold)

    def step(self, metric) -> None:
        metric = float(metric)
        self.last_epoch += 1
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        elif self.num_bad_epochs > self.patience:
            self.optimizer.lr = max(float(self.optimizer.lr) * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def get_last_lr(self) -> List[float]:
        return [float(self.optimizer.lr)]
