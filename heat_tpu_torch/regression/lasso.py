"""Lasso regression (counterpart of heat_tpu/regression/lasso.py): coordinate descent with
soft thresholding, in float64.

Each coordinate update computes the full residual ``y - X·θ + X[:, j]·θ[j]`` (heat_tpu's
arithmetic, which its ``Precision.HIGHEST`` keeps in float64) and its dot with column j;
across ranks (samples split) that dot is one all-reduce. The sweeps run on the device:
θ is updated in place by index, and the host reads the convergence value once a sweep,
never once a coordinate.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import core as ht
from ..core import factories
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray

__all__ = ["Lasso"]


def _soft_threshold(rho: torch.Tensor, lam: float) -> torch.Tensor:
    return torch.where(rho < -lam, rho + lam, torch.where(rho > lam, rho - lam, torch.zeros_like(rho)))


class Lasso(RegressionMixin, BaseEstimator):
    """L1-regularised linear regression by coordinate descent. ``x`` carries a leading
    all-ones column for the intercept, which is not penalised."""

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def lam(self) -> float:
        return self.__lam

    @lam.setter
    def lam(self, arg: float) -> None:
        self.__lam = arg

    @property
    def theta(self):
        return self.__theta

    def soft_threshold(self, rho: Union[DNDarray, float]) -> Union[DNDarray, float]:
        """The soft-thresholding operator at ``lam``."""
        if isinstance(rho, DNDarray):
            value = _soft_threshold(rho.larray, self.__lam)
            return DNDarray(value, rho.gshape, rho.dtype, rho.split, rho.device, rho.comm, True)
        return float(_soft_threshold(torch.as_tensor(rho, dtype=torch.float64), self.__lam))

    def rmse(self, gt: DNDarray, yest: DNDarray) -> DNDarray:
        """Root mean squared error."""
        return ht.sqrt(ht.mean((gt - yest) ** 2))

    def fit(self, x: DNDarray, y: DNDarray) -> None:
        """Coordinate descent until the relative change of θ in a sweep falls below
        ``tol`` or ``max_iter`` sweeps have run."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise ValueError("x and y need to be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2-D, got {x.ndim}-D")
        rows = 0 if x.split is not None else None
        xv = x._relayout(rows).to(torch.float64)
        yv = (y.reshape(-1) if y.ndim != 1 else y)._relayout(rows).to(torch.float64)
        distributed = x.is_distributed() and rows is not None
        cols = xv.T.contiguous()  # column j as one contiguous read
        colnorm2 = torch.sum(xv * xv, dim=0)
        if distributed:
            x.comm.all_reduce(colnorm2, "sum")
        lam, n = self.__lam, xv.shape[1]
        theta = xv.new_zeros(n)
        it, diff = 0, float("inf")
        while it < self.max_iter and diff >= self.tol:
            theta_old = theta.clone()
            for j in range(n):
                resid = yv - torch.mv(xv, theta) + cols[j] * theta[j]
                rho = torch.dot(cols[j], resid)
                if distributed:
                    x.comm.all_reduce(rho, "sum")
                rho = rho / torch.clamp(colnorm2[j], min=1e-300)
                theta[j] = rho if j == 0 else _soft_threshold(rho, lam)  # the intercept is not penalised
            change = torch.sum(torch.abs(theta - theta_old)) / torch.clamp(torch.sum(torch.abs(theta_old)), min=1e-300)
            diff = float(change.item())  # the one host read of a sweep
            it += 1
        self.n_iter = it
        self.__theta = factories.array(theta.reshape(-1, 1), device=x.device, comm=x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """The linear prediction ``x·θ``."""
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        return ht.matmul(x, self.__theta.astype(x.dtype))
