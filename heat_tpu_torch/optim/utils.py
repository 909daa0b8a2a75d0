"""Optimizer utilities (counterpart of heat_tpu/optim/utils.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["DetectMetricPlateau"]


class DetectMetricPlateau:
    """Detect when a metric has stopped improving (reference ``utils.py:14``, itself
    adapted from torch's ReduceLROnPlateau trigger logic).

    ``mode='min'``: plateaued when the metric stops decreasing; ``'max'``: when it
    stops increasing. ``patience`` epochs with no significant improvement (per
    ``threshold``/``threshold_mode``) flag a plateau; ``cooldown`` epochs are ignored
    after each detection. State is a plain dict for checkpointing
    (:meth:`get_state`/:meth:`set_state`).
    """

    def __init__(
        self,
        mode: str = "min",
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r} is unknown (expected 'min' or 'max')")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(
                f"threshold mode {threshold_mode!r} is unknown (expected 'rel' or 'abs')"
            )
        self.mode = mode
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown

        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.mode_worse = np.inf if mode == "min" else -np.inf
        self.best = self.mode_worse
        self.last_epoch = 0

    def get_state(self) -> Dict:
        """Class parameters as a dict, for checkpointing (reference ``:72``)."""
        return {
            "mode": self.mode,
            "patience": self.patience,
            "threshold": self.threshold,
            "threshold_mode": self.threshold_mode,
            "cooldown": self.cooldown,
            "cooldown_counter": self.cooldown_counter,
            "num_bad_epochs": self.num_bad_epochs,
            "mode_worse": self.mode_worse,
            "best": self.best,
            "last_epoch": self.last_epoch,
        }

    def set_state(self, dic: Dict) -> None:
        """Load a state dict produced by :meth:`get_state` (reference ``:89``)."""
        self.__dict__.update(dic)

    def reset(self) -> None:
        """Reset the bad-epoch counter and the best value (reference ``:109``)."""
        self.best = self.mode_worse
        self.cooldown_counter = 0
        self.num_bad_epochs = 0

    def test_if_improving(self, metrics) -> bool:
        """Feed one metric value; True when a plateau is detected (reference ``:117``)."""
        current = float(np.asarray(metrics).reshape(()))
        self.last_epoch += 1

        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.in_cooldown:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
            return True
        return False

    @property
    def in_cooldown(self) -> bool:
        return self.cooldown_counter > 0

    def is_better(self, a: float, best: float) -> bool:
        if self.mode == "min":
            dyn = best * (1.0 - self.threshold) if self.threshold_mode == "rel" else best - self.threshold
            return a < dyn
        dyn = best * (1.0 + self.threshold) if self.threshold_mode == "rel" else best + self.threshold
        return a > dyn
