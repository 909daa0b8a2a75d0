"""The plain reference of the KMeans configuration: Lloyd's algorithm in float64, in blocks
of rows, from the inputs the benchmark made (X and the initial centers) and nothing the
program made.

Semantics of heat's fit: while fewer than ``max_iter`` updates are applied and the last
squared shift of the centers exceeds ``tol``, assign every row to its nearest center (squared
Euclidean distance), and move each center to the mean of its rows (an empty cluster keeps its
center); then one final assignment gives the labels and the inertia, the sum of each row's
squared distance to its center.

The keyword arguments make the controls and planted faults of the comparison: ``x_dtype``
reads X rounded to a lower type; ``update_rows`` takes the means over the first rows only;
``frozen`` returns the old centers from every update.

:func:`judge` reads a fit's centers and labels only to judge them: the objective that the
centers give on X, and how far each row's label lies from its nearest center, in float64.
"""

from __future__ import annotations

from typing import Optional

import torch


def _pass(x, c, block: int, x_dtype, update_rows: int):
    """Labels, sums, counts and the sum of squared distances of one assignment (float64)."""
    k, d = c.shape
    sums = torch.zeros(k, d, dtype=torch.float64, device=x.device)
    counts = torch.zeros(k, dtype=torch.float64, device=x.device)
    sse = torch.zeros((), dtype=torch.float64, device=x.device)
    labels = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    cc = (c * c).sum(1)
    for a in range(0, x.shape[0], block):
        xb = x[a:a + block]
        if x_dtype is not None:
            xb = xb.to(x_dtype)
        xb = xb.double()
        dist = (xb * xb).sum(1, keepdim=True) - 2.0 * (xb @ c.T) + cc
        lab = dist.argmin(1)
        labels[a:a + block] = lab
        sse += dist.gather(1, lab[:, None]).clamp_min(0.0).sum()
        m = max(0, min(xb.shape[0], update_rows - a))
        if m:
            onehot = torch.nn.functional.one_hot(lab[:m], k).double()
            sums += onehot.T @ xb[:m]
            counts += onehot.sum(0)
    return labels, sums, counts, float(sse)


def fit(x: torch.Tensor, init: torch.Tensor, cfg: dict, x_dtype: Optional[torch.dtype] = None,
        update_rows: Optional[int] = None, frozen: bool = False, block: int = 1 << 20) -> dict:
    """``{"centers", "labels", "inertia", "n_iter"}`` of the fit of ``x`` (n, d) from
    ``init`` (k, d) under ``cfg``'s ``max_iter`` and ``tol``."""
    rows = x.shape[0] if update_rows is None else update_rows
    c = init.double()
    shift, n_iter = float("inf"), 0
    while n_iter < cfg["max_iter"] and shift > cfg["tol"]:
        _, sums, counts, _ = _pass(x, c, block, x_dtype, rows)
        new = c if frozen else torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c)
        shift = float(((c - new) ** 2).sum())
        c, n_iter = new, n_iter + 1
    labels, _, _, sse = _pass(x, c, block, x_dtype, 0)
    return {"centers": c, "labels": labels, "inertia": sse, "n_iter": n_iter}


def judge(x: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor, block: int = 1 << 18) -> dict:
    """``{"objective", "assign_excess"}`` of a fit's ``centers`` (k, d) and ``labels`` (n,) on
    ``x``, in float64: the sum over rows of the squared distance to the nearest center, and
    the largest excess of a row's squared distance to its labelled center over its distance to
    the nearest, as a share of the mean nearest distance."""
    c = centers.to(x.device, torch.float64)
    labels = labels.to(x.device)
    objective = torch.zeros((), dtype=torch.float64, device=x.device)
    excess = torch.zeros((), dtype=torch.float64, device=x.device)
    for a in range(0, x.shape[0], block):
        xb = x[a:a + block].double()
        dist = ((xb[:, None, :] - c[None]) ** 2).sum(-1)
        nearest = dist.min(1).values
        objective += nearest.sum()
        excess = torch.maximum(excess, (dist.gather(1, labels[a:a + block, None])[:, 0] - nearest).max())
    objective = float(objective)
    return {"objective": objective, "assign_excess": float(excess) * x.shape[0] / objective}
