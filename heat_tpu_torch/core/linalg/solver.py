"""Iterative solvers (counterpart of heat_tpu/core/linalg/solver.py): conjugate gradients
and Lanczos.

Both run heat_tpu's iteration on the gathered operands, the same on every rank (heat_tpu
runs each as one jitted program on the global arrays). Matrix-vector products run in full
fp32 for f32 (TF32 off). Where heat_tpu keys its Lanczos restart vector with
``jax.random``, the port draws it from a ``torch.Generator`` the caller may pass (seeded
17 by default), so a restart gives other values than heat_tpu's: a recorded deviation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import factories, types
from ..devices import full_fp32_matmul
from ..dndarray import DNDarray

__all__ = ["cg", "lanczos"]


def _into(out: DNDarray, value: torch.Tensor) -> DNDarray:
    """Write the global ``value`` into ``out``'s chunk, in ``out``'s dtype."""
    if out.split is not None:
        _, _, sl = out.comm.chunk(out.gshape, out.split)
        value = value[sl]
    out.larray = value.to(out.dtype.torch_type()).contiguous()
    return out


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for the SPD system ``A x = b`` (heat_tpu solver.py:25): at most
    ``n`` iterations, until the residual's norm falls below 1e-10. The result is split as
    ``b``. A, b and x0 are gathered: a dense solve on the whole system."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError(f"A, b, x0 need to be DNDarrays, but were {type(A)}, {type(b)}, {type(x0)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("x0 needs to be a 1D vector")
    dt = types.promote_types(types.promote_types(A.dtype, b.dtype), types.promote_types(x0.dtype, types.float32))
    tt = dt.torch_type()
    a, bv, x = A._relayout(None).to(tt), b._relayout(None).to(tt), x0._relayout(None).to(tt)
    with full_fp32_matmul():
        r = bv - a @ x
        p = r
        rsold = torch.dot(r, r)
        for _ in range(bv.shape[0]):
            if float(torch.sqrt(rsold)) < 1e-10:
                break
            Ap = a @ p
            alpha = rsold / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rsnew = torch.dot(r, r)
            p = r + (rsnew / rsold) * p
            rsold = rsnew
    res = factories.array(x, split=b.split, device=b.device, comm=b.comm)
    if out is not None:
        return _into(out, x)
    return res


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[DNDarray, DNDarray]:
    """Lanczos tridiagonalisation of a symmetric matrix (heat_tpu solver.py:150): ``(V,
    T)`` with ``V`` n × m orthonormal and ``T`` m × m tridiagonal, with full
    reorthogonalisation each step. ``v0`` defaults to ones; a vanishing β restarts from a
    normal vector drawn from ``generator`` (a CPU ``torch.Generator``; seeded 17 when
    None). A row-split matrix multiplies by its rows; another layout gathers the matrix."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be a DNDarray, got {type(A)}")
    if not isinstance(m, (int, float)):
        raise TypeError(f"m must be int, got {type(m)}")
    n, column = A.gshape
    if n != column:
        raise TypeError("A needs to be a square matrix")
    m = int(m)
    out_dtype = A.dtype if A.dtype is types.float64 else types.float32
    tt = out_dtype.torch_type()
    if A.split == 0 and A.is_distributed():
        # each rank multiplies its rows; the product vector (n values) is gathered
        rows, counts = A.larray.to(tt), A.counts_displs()[0]

        def matvec(v):
            return A.comm.all_gather_v(rows @ v, counts)

    else:
        a = A._relayout(None).to(tt)

        def matvec(v):
            return a @ v

    device = A.larray.device
    v = torch.ones(n, dtype=tt, device=device) if v0 is None else v0._relayout(None).to(tt)
    gen = generator if generator is not None else torch.Generator().manual_seed(17)
    V_rows, T_val = _lanczos(matvec, v, m, gen)
    T = factories.array(T_val, dtype=out_dtype, split=None, device=A.device, comm=A.comm)
    V = factories.array(V_rows.T, dtype=out_dtype, split=None, device=A.device, comm=A.comm)
    if V_out is not None:
        V = _into(V_out, V_rows.T)
    if T_out is not None:
        return V, _into(T_out, T_val)
    return V, T


def _lanczos(matvec, v0: torch.Tensor, m: int, gen: torch.Generator):
    """heat_tpu's ``_lanczos_run_impl`` (solver.py:83) with ``matvec(v) = A·v``: returns
    ``(V_rows, T)``, row i of ``V_rows`` the i-th Lanczos vector."""
    n = v0.shape[0]
    eps = 1e-10
    V = v0.new_zeros((m, n))
    T = v0.new_zeros((m, m))
    with full_fp32_matmul():
        v = v0 / torch.linalg.vector_norm(v0)
        w = matvec(v)
        alpha = torch.dot(w, v)
        V[0], T[0, 0] = v, alpha
        w = w - alpha * v
        for i in range(1, m):
            beta = torch.linalg.vector_norm(w)
            good = bool(beta > eps)
            if good:
                vr = w / beta
            else:
                vr = torch.randn(n, generator=gen, dtype=v0.dtype).to(v0.device)
            # project out the rows < i
            coef = V[:i] @ vr
            vr = vr - coef @ V[:i]
            nrm = torch.linalg.vector_norm(vr)
            if bool(nrm > 0):
                vr = vr / nrm
            wn = matvec(vr)
            alpha = torch.dot(wn, vr)
            beta_eff = beta if good else torch.zeros_like(beta)
            w = wn - alpha * vr - beta_eff * V[i - 1]
            V[i] = vr
            T[i, i], T[i - 1, i], T[i, i - 1] = alpha, beta_eff, beta_eff
    return V, T
