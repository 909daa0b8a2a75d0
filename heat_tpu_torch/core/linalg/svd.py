"""Full SVD (counterpart of heat_tpu/core/linalg/svd.py).

A tall-skinny split=0 array rides the TSQR (``A = QR``, the small ``R = U_r Σ Vᴴ`` on every
rank, ``U = Q U_r`` local); a short-fat one factors its transpose; any other layout calls
``torch.linalg.svd`` on the gathered matrix, through :func:`.svdtools.guarded_svd` (on the
card: cuSOLVER's ``gesvd``, for accurate singular vectors).
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from .. import _operations, types
from ..dndarray import DNDarray
from . import comm_plan
from .basics import _wrap_local
from .svdtools import guarded_svd

__all__ = ["svd", "pinv", "matrix_rank", "cond"]

SVD_t = collections.namedtuple("SVD", "U, S, Vh")


def svd(A: DNDarray, full_matrices: bool = False, compute_uv: bool = True):
    """Reduced SVD ``A = U @ diag(S) @ Vh`` of a 2-D DNDarray (heat_tpu svd.py:40).

    Returns ``SVD(U, S, Vh)``, U split as A's rows (split 0) and S, Vh whole; with
    ``compute_uv=False`` only S. ``full_matrices=True`` is not supported. A row-split A goes
    through TSQR; another layout gathers A (a dense factorisation)."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"'A' must be a DNDarray, got {type(A)}")
    if A.ndim != 2:
        raise ValueError(f"svd requires a 2-D array, got {A.ndim}-D")
    if full_matrices:
        raise NotImplementedError("full_matrices=True is not supported; the reduced SVD is")
    if not issubclass(A.dtype, types.floating):
        A = A.astype(types.promote_types(A.dtype, types.float32))

    m, n = A.gshape
    if m < n:
        # A = U Σ Vᴴ  ⇔  Aᵀ = V Σ Uᴴ: factor the tall transpose and swap the roles
        res = svd(A.T, compute_uv=compute_uv)
        if not compute_uv:
            return res
        u_t, s, vh_t = res
        return SVD_t(vh_t.T, s, u_t.T)

    from .qr import qr as _qr

    if A.split == 0 and A.is_distributed() and m >= n * A.comm.size:
        if not compute_uv:
            _, r = _qr(A, calc_q=False)
            return _operations.wrap_global(guarded_svd(r.larray, compute_uv=False), A, None)
        q, r = _qr(A, calc_q=True)
        u_r, s_val, vh_val = guarded_svd(r.larray)
        u = _wrap_local(comm_plan._mm(q.larray, u_r), A, 0, (m, u_r.shape[1]))
    else:
        full = A._relayout(None)
        if not compute_uv:
            return _operations.wrap_global(guarded_svd(full, compute_uv=False), A, None)
        u_val, s_val, vh_val = guarded_svd(full)
        u = _operations.wrap_global(u_val, A, 0 if A.split == 0 else None)
    return SVD_t(u, _operations.wrap_global(s_val, A, None), _operations.wrap_global(vh_val, A, None))


def pinv(A: DNDarray, rtol: float = 1e-15) -> DNDarray:
    """Moore–Penrose pseudo-inverse from the reduced SVD (heat_tpu svd.py:91): singular
    values below ``rtol·max(s)`` count as zero. A split-0 tall input gives a column-split
    result, a split-1 input a row-split one."""
    u, s, vh = svd(A)
    sv = s.larray
    cutoff = rtol * torch.max(sv)
    inv_s = torch.where(sv > cutoff, 1.0 / torch.where(sv > cutoff, sv, torch.ones_like(sv)), torch.zeros_like(sv))
    value = comm_plan._mm(vh.larray.conj().T * inv_s, u._relayout(None).conj().T)
    split = 1 if (A.split == 0 and A.gshape[0] >= A.gshape[1]) else (0 if A.split == 1 else None)
    return _operations.wrap_global(value, A, split)


def matrix_rank(A: DNDarray, tol: Optional[float] = None) -> DNDarray:
    """Rank from the singular values (numpy's rule: tol = max(s)·max(m, n)·eps)."""
    sv = svd(A, compute_uv=False).larray
    tol_val = torch.max(sv) * max(A.gshape) * torch.finfo(sv.dtype).eps if tol is None else tol
    return _operations.wrap_global(torch.sum(sv > tol_val).to(torch.int64), A, None)


def cond(A: DNDarray) -> DNDarray:
    """2-norm condition number σ_max / σ_min."""
    sv = svd(A, compute_uv=False).larray
    return _operations.wrap_global(torch.max(sv) / torch.min(sv), A, None)
