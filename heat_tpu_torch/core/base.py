"""Estimator base classes (counterpart of heat_tpu/core/base.py): ``BaseEstimator`` with
the sklearn-style get_params/set_params protocol, the classifier, transformer, clusterer
and regressor mixins, and the ``is_*`` checks."""

from __future__ import annotations

import inspect
from typing import Dict, List

from .dndarray import DNDarray

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "TransformMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "is_classifier",
    "is_transformer",
    "is_estimator",
    "is_clusterer",
    "is_regressor",
]


class BaseEstimator:
    """Base for all estimators."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        """Constructor parameter names, the sklearn introspection contract."""
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return sorted(
            p.name
            for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        )

    def get_params(self, deep: bool = True) -> Dict[str, object]:
        """Parameters of this estimator."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set parameters; supports nested ``component__parameter`` keys."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"invalid parameter {key} for estimator {self}")
            if delim:
                nested.setdefault(key, {})[sub_key] = value
            else:
                setattr(self, key, value)
        for key, sub_params in nested.items():
            getattr(self, key).set_params(**sub_params)
        return self

    def __repr__(self, indent: int = 1) -> str:
        params = ", ".join(f"{k}={v!r}" for k, v in sorted(self.get_params(deep=False).items()))
        return f"{self.__class__.__name__}({params})"


class ClassificationMixin:
    """Mixin for classifiers."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class TransformMixin:
    """Mixin for transformers."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_transform(self, x: DNDarray) -> DNDarray:
        self.fit(x)
        return self.transform(x)

    def transform(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


class ClusteringMixin:
    """Mixin for clusterers."""

    def fit(self, x: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray) -> DNDarray:
        self.fit(x)
        return self.labels_


class RegressionMixin:
    """Mixin for regressors."""

    def fit(self, x: DNDarray, y: DNDarray):
        raise NotImplementedError()

    def fit_predict(self, x: DNDarray, y: DNDarray) -> DNDarray:
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x: DNDarray) -> DNDarray:
        raise NotImplementedError()


def is_classifier(estimator: object) -> bool:
    """True for classifiers."""
    return isinstance(estimator, ClassificationMixin)


def is_transformer(estimator: object) -> bool:
    """True for transformers."""
    return isinstance(estimator, TransformMixin)


def is_estimator(estimator: object) -> bool:
    """True for estimators."""
    return isinstance(estimator, BaseEstimator)


def is_clusterer(estimator: object) -> bool:
    """True for clusterers."""
    return isinstance(estimator, ClusteringMixin)


def is_regressor(estimator: object) -> bool:
    """True for regressors."""
    return isinstance(estimator, RegressionMixin)
