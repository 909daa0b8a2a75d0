"""Feature scalers (counterpart of heat_tpu/preprocessing/preprocessing.py): the five
sklearn-style transformers. Every statistic is a reduction over the sample axis, which
across ranks is a local reduction and one all-reduce (``median`` and ``percentile``: the
distributed sort)."""

from __future__ import annotations

from typing import Tuple

from .. import core as ht
from ..core.base import BaseEstimator, TransformMixin
from ..core.dndarray import DNDarray

__all__ = ["StandardScaler", "MinMaxScaler", "Normalizer", "MaxAbsScaler", "RobustScaler"]


def _check_2d_float(x: DNDarray, name: str) -> None:
    if not isinstance(x, DNDarray):
        raise TypeError(f"{name} requires a DNDarray, got {type(x)}")
    if x.dtype not in (ht.float32, ht.float64):
        raise TypeError(f"{name} requires float32/float64 data, got {x.dtype}")


def _nonzero(v: DNDarray) -> DNDarray:
    """``v`` with its zeros replaced by 1, the safe divisor of a constant feature."""
    return ht.where(v == 0.0, 1.0, v)


class StandardScaler(TransformMixin, BaseEstimator):
    """Standardize each feature to zero mean and unit variance."""

    def __init__(self, *, copy: bool = True, with_mean: bool = True, with_std: bool = True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std
        self.mean_ = None
        self.var_ = None

    def fit(self, X: DNDarray, sample_weight=None) -> "StandardScaler":
        _check_2d_float(X, "StandardScaler")
        self.mean_ = ht.mean(X, axis=0) if self.with_mean or self.with_std else None
        if self.with_std:
            self.var_ = ht.var(X, axis=0)
        return self

    def transform(self, X: DNDarray) -> DNDarray:
        _check_2d_float(X, "StandardScaler")
        out = X
        if self.with_mean:
            out = out - self.mean_
        if self.with_std:
            out = out / _nonzero(ht.sqrt(self.var_)).astype(out.dtype)
        return out

    def inverse_transform(self, Y: DNDarray) -> DNDarray:
        out = Y
        if self.with_std:
            out = out * ht.sqrt(self.var_).astype(out.dtype)
        if self.with_mean:
            out = out + self.mean_
        return out


class MinMaxScaler(TransformMixin, BaseEstimator):
    """Scale each feature to ``feature_range``."""

    def __init__(self, feature_range: Tuple[float, float] = (0.0, 1.0), *, copy: bool = True, clip: bool = False):
        if feature_range[0] >= feature_range[1]:
            raise ValueError("feature_range minimum must be smaller than maximum")
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def fit(self, X: DNDarray) -> "MinMaxScaler":
        _check_2d_float(X, "MinMaxScaler")
        self.data_min_ = ht.min(X, axis=0)
        self.data_max_ = ht.max(X, axis=0)
        lo, hi = self.feature_range
        self.scale_ = (hi - lo) / _nonzero(self.data_max_ - self.data_min_)
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def transform(self, X: DNDarray) -> DNDarray:
        _check_2d_float(X, "MinMaxScaler")
        out = X * self.scale_.astype(X.dtype) + self.min_.astype(X.dtype)
        if self.clip:
            out = ht.clip(out, self.feature_range[0], self.feature_range[1])
        return out

    def inverse_transform(self, Y: DNDarray) -> DNDarray:
        return (Y - self.min_.astype(Y.dtype)) / self.scale_.astype(Y.dtype)


class Normalizer(TransformMixin, BaseEstimator):
    """Scale each sample to unit norm (``l1``, ``l2`` or ``max``)."""

    def __init__(self, norm: str = "l2", *, copy: bool = True):
        if norm not in ("l1", "l2", "max"):
            raise NotImplementedError(f"unsupported norm {norm!r}")
        self.norm = norm
        self.copy = copy

    def fit(self, X: DNDarray) -> "Normalizer":
        return self  # stateless

    def transform(self, X: DNDarray) -> DNDarray:
        _check_2d_float(X, "Normalizer")
        if self.norm == "l1":
            n = ht.sum(ht.abs(X), axis=1, keepdims=True)
        elif self.norm == "l2":
            n = ht.sqrt(ht.sum(X * X, axis=1, keepdims=True))
        else:
            n = ht.max(ht.abs(X), axis=1, keepdims=True)
        return X / _nonzero(n)


class MaxAbsScaler(TransformMixin, BaseEstimator):
    """Scale each feature by its largest absolute value."""

    def __init__(self, *, copy: bool = True):
        self.copy = copy
        self.max_abs_ = None
        self.scale_ = None

    def fit(self, X: DNDarray) -> "MaxAbsScaler":
        _check_2d_float(X, "MaxAbsScaler")
        self.max_abs_ = ht.max(ht.abs(X), axis=0)
        self.scale_ = _nonzero(self.max_abs_)
        return self

    def transform(self, X: DNDarray) -> DNDarray:
        _check_2d_float(X, "MaxAbsScaler")
        return X / self.scale_.astype(X.dtype)

    def inverse_transform(self, Y: DNDarray) -> DNDarray:
        return Y * self.scale_.astype(Y.dtype)


class RobustScaler(TransformMixin, BaseEstimator):
    """Center each feature on its median and scale it by its interquantile range."""

    def __init__(
        self,
        *,
        with_centering: bool = True,
        with_scaling: bool = True,
        quantile_range: Tuple[float, float] = (25.0, 75.0),
        copy: bool = True,
        unit_variance: bool = False,
    ):
        lo, hi = quantile_range
        if not 0 <= lo <= hi <= 100:
            raise ValueError(f"invalid quantile range {quantile_range}")
        if unit_variance:
            raise NotImplementedError("unit_variance rescaling is not supported")
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy
        self.unit_variance = unit_variance
        self.center_ = None
        self.iqr_ = None

    def fit(self, X: DNDarray) -> "RobustScaler":
        _check_2d_float(X, "RobustScaler")
        if self.with_centering:
            self.center_ = ht.median(X, axis=0)
        if self.with_scaling:
            lo, hi = self.quantile_range
            self.iqr_ = _nonzero(ht.percentile(X, hi, axis=0) - ht.percentile(X, lo, axis=0))
        return self

    def transform(self, X: DNDarray) -> DNDarray:
        _check_2d_float(X, "RobustScaler")
        out = X
        if self.with_centering:
            out = out - self.center_.astype(out.dtype)
        if self.with_scaling:
            out = out / self.iqr_.astype(out.dtype)
        return out

    def inverse_transform(self, Y: DNDarray) -> DNDarray:
        out = Y
        if self.with_scaling:
            out = out * self.iqr_.astype(out.dtype)
        if self.with_centering:
            out = out + self.center_.astype(out.dtype)
        return out
