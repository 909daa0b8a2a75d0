"""Gaussian Naive Bayes (counterpart of heat_tpu/naive_bayes/gaussianNB.py).

Moments are float64 throughout, one masked reduction a class as heat_tpu's: each rank
takes its rows' weighted counts and sums per class, one all-reduce of them all gives the
class means, and a second pass and all-reduce the sums of squared deviations from them
(the two-pass variance heat_tpu computes). ``partial_fit`` merges a batch into the
running moments by the pairwise update. ``classes_`` is the unique of the labels over
every rank. The fitted moments are float64 tensors on the data's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import core as ht
from ..core import factories, types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.devices import get_device
from ..core.dndarray import DNDarray

__all__ = ["GaussianNB"]


def _rows(x: DNDarray) -> torch.Tensor:
    """This rank's rows of ``x`` (split along the samples, or whole) in float64."""
    return x._relayout(0 if x.split is not None else None).to(torch.float64)


def _vector_like(v, x: DNDarray, dtype=None) -> torch.Tensor:
    """The entries of a per-sample vector (``y``, sample weights) that go with this
    rank's rows of ``x``."""
    if not isinstance(v, DNDarray):
        v = factories.array(v, device=x.device, comm=x.comm)
    v = v.reshape(-1) if v.ndim != 1 else v
    local = v._relayout(0 if x.split is not None else None)
    return local if dtype is None else local.to(dtype)


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian Naive Bayes classifier; ``var_smoothing`` times the largest feature
    variance is added to every class variance."""

    def __init__(self, priors: Optional[DNDarray] = None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None

    def fit(self, x: DNDarray, y: DNDarray, sample_weight: Optional[DNDarray] = None) -> "GaussianNB":
        """Fit from scratch."""
        self.classes_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(
        self,
        x: DNDarray,
        y: DNDarray,
        classes: Optional[DNDarray] = None,
        sample_weight: Optional[DNDarray] = None,
    ) -> "GaussianNB":
        """Merge a batch into the running per-class moments."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"x needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2-D, got {x.ndim}-D")
        xv = _rows(x)
        yv = _vector_like(y, x)
        w = None if sample_weight is None else _vector_like(sample_weight, x, torch.float64)
        comm = x.comm

        if self.classes_ is None:
            if classes is not None:
                cls = classes if isinstance(classes, DNDarray) else factories.array(classes, device=x.device, comm=comm)
                self.classes_ = cls.resplit(None)
            else:
                labels = y if isinstance(y, DNDarray) else factories.array(y, device=x.device, comm=comm)
                self.classes_ = ht.unique(labels)
            shape = (self.classes_.gshape[0], x.gshape[1])
            self.theta_ = xv.new_zeros(shape)
            self.var_ = xv.new_zeros(shape)
            self.class_count_ = xv.new_zeros(shape[:1])
        cls_vals = self.classes_.larray.to(xv.device)

        # the smoothing from the pooled batch's largest feature variance
        self.epsilon_ = self.var_smoothing * float(ht.var(x.astype(ht.float64), axis=0).max().item())

        masks = []
        for c in cls_vals:  # one masked reduction a class
            mask = (yv == c).to(torch.float64)
            masks.append(mask if w is None else mask * w)
        n_new = torch.stack([m.sum() for m in masks])
        sums = torch.stack([m @ xv for m in masks]) if masks else self.theta_.clone()
        if x.split is not None:
            n_new, sums = comm.all_reduce_packed([n_new, sums])
        mu_new = torch.where(n_new[:, None] > 0, sums / torch.clamp(n_new, min=1.0)[:, None], 0.0)
        ssd_new = torch.stack([(((xv - mu) ** 2) * m[:, None]).sum(0) for mu, m in zip(mu_new, masks)]) if masks \
            else self.var_.clone()
        if x.split is not None:
            comm.all_reduce(ssd_new, "sum")
        var_new = torch.where(n_new[:, None] > 0, ssd_new / torch.clamp(n_new, min=1.0)[:, None], 0.0)

        # the pairwise merge with the running moments
        n_old, mu_old, var_old = self.class_count_[:, None], self.theta_, self.var_
        n_b = n_new[:, None]
        n_tot = n_old + n_b
        den = torch.clamp(n_tot, min=1.0)
        mu_tot = torch.where(n_tot > 0, (n_old * mu_old + n_b * mu_new) / den, 0.0)
        ssd = n_old * var_old + n_b * var_new + torch.where(n_tot > 0, (n_old * n_b / den) * (mu_old - mu_new) ** 2, 0.0)
        self.var_ = torch.where(n_tot > 0, ssd / den, 0.0)
        self.theta_ = mu_tot
        self.class_count_ = n_tot[:, 0]

        if self.priors is not None:
            pv = (self.priors._relayout(None) if isinstance(self.priors, DNDarray)
                  else torch.as_tensor(self.priors)).to(device=xv.device, dtype=torch.float64)
            if pv.shape[0] != cls_vals.shape[0]:
                raise ValueError("Number of priors must match number of classes.")
            if not bool(torch.isclose(pv.sum(), pv.new_tensor(1.0))):
                raise ValueError("The sum of the priors should be 1.")
            if bool((pv < 0).any()):
                raise ValueError("Priors must be non-negative.")
            self.class_prior_ = pv
        else:
            self.class_prior_ = self.class_count_ / torch.clamp(self.class_count_.sum(), min=1.0)
        return self

    def _joint_log_likelihood(self, x: DNDarray) -> torch.Tensor:
        """The per-class joint log likelihood of this rank's rows, (rows, classes)."""
        xv = _rows(x)
        var = self.var_ + self.epsilon_
        jll = []
        for i in range(self.theta_.shape[0]):
            prior = torch.log(torch.clamp(self.class_prior_[i], min=1e-300))
            n_ij = -0.5 * torch.sum(torch.log(2.0 * math.pi * var[i]))
            n_ij = n_ij - 0.5 * torch.sum(((xv - self.theta_[i]) ** 2) / var[i], dim=1)
            jll.append(prior + n_ij)
        return torch.stack(jll, dim=1)

    def _wrap(self, value: torch.Tensor, x: DNDarray) -> DNDarray:
        split = 0 if x.split is not None else None
        gshape = (x.gshape[0],) + tuple(value.shape[1:])
        return DNDarray(value, gshape, types.canonical_heat_type(value.dtype), split, x.device, x.comm, True)

    def predict(self, x: DNDarray) -> DNDarray:
        """The most probable class of each sample."""
        if self.classes_ is None:
            raise RuntimeError("fit needs to be called before predict")
        jll = self._joint_log_likelihood(x)
        return self._wrap(self.classes_.larray.to(jll.device)[torch.argmax(jll, dim=1)], x)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """The log probability of each class for each sample."""
        jll = self._joint_log_likelihood(x)
        return self._wrap(jll - self.logsumexp(jll, axis=1, keepdims=True), x)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """The probability of each class for each sample."""
        return self._wrap(torch.exp(self.predict_log_proba(x).larray), x)

    @staticmethod
    def logsumexp(a, axis=None, b=None, keepdims: bool = False, return_sign: bool = False):
        """log(Σ b·exp(a)) over ``axis``, stable (the largest value taken out first), as
        jax.scipy.special.logsumexp: with ``b`` a negative sum gives NaN, unless
        ``return_sign`` asks for (log|sum|, sign)."""
        def tensor(v) -> torch.Tensor:  # host data goes to the default device
            if isinstance(v, DNDarray):
                return v._relayout(None)
            return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=get_device().torch_device)

        av = tensor(a)
        if not (av.is_floating_point() or av.is_complex()):
            av = av.to(torch.float32 if av.dtype != torch.int64 else torch.float64)
        if b is not None:
            bv = tensor(b).to(av.device)
            ct = torch.promote_types(av.dtype, bv.dtype)
            av, bv = torch.broadcast_tensors(av.to(ct), bv.to(ct))
            av = torch.where(bv != 0, av, float("-inf"))
        dims = tuple(range(av.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else tuple(axis))
        real = av.real if av.is_complex() else av
        amax = torch.amax(real, dim=dims, keepdim=True) if av.numel() else real.new_full((1,) * av.ndim, float("-inf"))
        amax = torch.where(torch.isfinite(amax), amax, 0.0)
        exp_a = torch.exp(av - amax.to(av.dtype))
        if b is not None:
            exp_a = exp_a * bv
        sumexp = exp_a.sum(dim=dims, keepdim=keepdims)
        sign = torch.sgn(sumexp) if sumexp.is_complex() else torch.sign(sumexp)
        if return_sign or not sumexp.is_complex():
            sumexp = sumexp.abs()
        out = torch.log(sumexp) + (amax if keepdims else amax.reshape(sumexp.shape)).to(sumexp.dtype)
        if return_sign:
            return out, sign
        if b is not None and not out.is_complex():
            out = torch.where(sign < 0, float("nan"), out)
        return out
