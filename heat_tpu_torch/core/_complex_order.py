"""The order of complex numbers that heat_tpu's sort, unique, min and max follow, which
torch's do not have.

jnp (heat_tpu at one device; see ROADMAP Queue 3 for its split layouts) orders complex
values lexicographically, by the real part and then the imaginary one, each part with
NaN after every number: the order of two stable sorts, by the imaginary part and then by
the real one. (numpy's sort places values with a NaN otherwise, in four classes; jnp's
does not, and the port follows heat_tpu.) ``unique`` counts every value with a NaN as one,
``nan+0j`` (jnp's). torch sorts no complex tensor, so the order is built here from the
real keys.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["argsort", "extreme", "keys", "lexsort_with_index", "maximum", "minimum", "unique"]


def keys(v: torch.Tensor) -> List[torch.Tensor]:
    """The real sort keys of complex ``v``, least significant first: the imaginary part,
    then the real part (torch.sort puts NaN after every number, as jnp's does)."""
    return [v.imag, v.real]


def _by_keys(ks: List[torch.Tensor], order: torch.Tensor, dim: int, descending: bool) -> torch.Tensor:
    """``order`` (positions along ``dim``) re-sorted by each key in turn, stably."""
    for key in ks:
        idx = torch.sort(key.take_along_dim(order, dim), dim=dim, descending=descending, stable=True).indices
        order = order.take_along_dim(idx, dim)
    return order


def argsort(v: torch.Tensor, dim: int = -1, descending: bool = False) -> torch.Tensor:
    """The stable argsort of complex ``v`` along ``dim`` in jnp's order (descending: its
    reverse, ties kept in order, as jnp's ``argsort(descending=True, stable=True)``)."""
    dim = dim % v.ndim
    shape = [1] * v.ndim
    shape[dim] = v.shape[dim]
    order = torch.arange(v.shape[dim], device=v.device).view(shape).expand(v.shape)
    return _by_keys(keys(v), order, dim, descending)


def lexsort_with_index(values: torch.Tensor, index: torch.Tensor, dim: int, descending: bool) -> torch.Tensor:
    """The positions that sort complex ``values`` along ``dim`` by (value, index): the
    value in jnp's order (or its reverse), the index ascending."""
    order = torch.argsort(index, dim=dim, stable=True)
    return _by_keys(keys(values), order, dim, descending)


def extreme(v: torch.Tensor, dim: int, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, index) of the first ``kind`` ("max" or "min") along ``dim`` (kept as a size-1
    axis): the first element with a NaN where there is one, as numpy's ``maximum.reduce``
    propagates it, else the (real, imaginary) extreme, first of its ties."""
    re, im = v.real, v.imag
    nan = torch.isnan(re) | torch.isnan(im)
    red = torch.amax if kind == "max" else torch.amin
    worst = float("-inf") if kind == "max" else float("inf")
    re_m = torch.where(nan, worst, re)
    cand = (re_m == red(re_m, dim, keepdim=True)) & ~nan
    im_m = torch.where(cand, im, worst)
    hit = cand & (im_m == red(im_m, dim, keepdim=True))
    pick = torch.where(nan.any(dim, keepdim=True), nan, hit)
    index = torch.argmax(pick.to(torch.uint8), dim=dim, keepdim=True)  # the first
    return v.gather(dim, index), index


def maximum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp's elementwise maximum of complex values: ``x`` where it is greater than ``y``
    in (real, imaginary) order, else ``y`` (``lax.max``'s complex rule, NaN included)."""
    pick_x = torch.where(x.real == y.real, x.imag > y.imag, x.real > y.real)
    return torch.where(pick_x, x, y)


def minimum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """jnp's elementwise minimum of complex values (``lax.min``'s complex rule)."""
    pick_x = torch.where(x.real == y.real, x.imag < y.imag, x.real < y.real)
    return torch.where(pick_x, x, y)


def unique(flat: torch.Tensor) -> torch.Tensor:
    """The distinct values of a 1-D complex tensor in jnp's order, every value with a NaN
    counted as one ``nan+0j`` after the numbers (jnp.unique's ``equal_nan``)."""
    nan = torch.isnan(flat.real) | torch.isnan(flat.imag)
    flat = torch.where(nan, complex(float("nan"), 0.0), flat)
    ranked = flat[argsort(flat)]
    nan = torch.isnan(ranked.real)
    new = (ranked[1:] != ranked[:-1]) & ~(nan[1:] & nan[:-1])
    first = torch.cat([torch.ones(min(1, ranked.numel()), dtype=torch.bool, device=flat.device), new])
    return ranked[first]
