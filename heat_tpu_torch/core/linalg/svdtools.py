"""Hierarchical SVD (counterpart of heat_tpu/core/linalg/svdtools.py).

The tree is heat_tpu's: a truncated SVD of each column block, then merges of the nodes'
``U·diag(σ)`` (``maxmergedim`` and ``no_of_merges`` set the groups), each merge re-truncated,
with the squared errors summed, ``err² = Σ err_i² + err_merge²``.

Distribution. Level 0 is strictly local: each rank already holds its column block of a
split=1 array (heat_tpu's ``_stack_column_blocks`` is that relabelling) and factors it
alone, padded with zero columns to the common block width ``ceil(n/P)`` as heat_tpu pads
(zero columns add zero singular values, which the truncation drops, and keep every
truncation decision equal to heat_tpu's). The merge levels work on small nodes (m ×
≤ maxmergedim): the level-0 nodes are gathered, rank 0 runs the merge tree, and U, σ and
the error estimate are broadcast, so every rank holds the same bits and the same
decisions.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import factories, types
from ..dndarray import DNDarray
from .basics import matmul, vector_norm

__all__ = ["hsvd", "hsvd_rank", "hsvd_rtol"]


def hsvd_rank(
    A: DNDarray,
    maxrank: int,
    compute_sv: bool = False,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    silent: bool = True,
):
    """Hierarchical SVD truncated to ``maxrank`` (heat_tpu svdtools.py:44)."""
    if A.ndim != 2:
        raise RuntimeError(f"hsvd_rank requires a 2-D array, got {A.ndim}-D")
    A_local_size = max(int(np.ceil(s / max(A.comm.size, 1))) for s in A.gshape)
    if maxmergedim is None:
        maxmergedim = max(A_local_size + 1, 2 * (maxrank + safetyshift) + 1)
    return hsvd(
        A, maxrank=maxrank, maxmergedim=maxmergedim, safetyshift=safetyshift, compute_sv=compute_sv,
        silent=silent, warnings_off=True,
    )


def hsvd_rtol(
    A: DNDarray,
    rtol: float,
    compute_sv: bool = False,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    safetyshift: int = 5,
    no_of_merges: Optional[int] = None,
    silent: bool = True,
):
    """Hierarchical SVD truncated to a relative reconstruction-error bound (heat_tpu
    svdtools.py:69)."""
    if A.ndim != 2:
        raise RuntimeError(f"hsvd_rtol requires a 2-D array, got {A.ndim}-D")
    return hsvd(
        A, rtol=rtol, maxrank=maxrank, maxmergedim=maxmergedim, safetyshift=safetyshift,
        no_of_merges=no_of_merges or 2, compute_sv=compute_sv, silent=silent, warnings_off=True,
    )


def hsvd(
    A: DNDarray,
    maxrank: Optional[int] = None,
    maxmergedim: Optional[int] = None,
    rtol: Optional[float] = None,
    safetyshift: int = 0,
    no_of_merges: Optional[int] = 2,
    compute_sv: bool = False,
    silent: bool = True,
    warnings_off: bool = False,
):
    """Low-level hierarchical SVD (heat_tpu svdtools.py:96).

    Returns ``(U, sigma, V, rel_error_estimate)`` if ``compute_sv`` else
    ``(U, rel_error_estimate)``."""
    if A.ndim != 2:
        raise RuntimeError(f"hsvd requires a 2-D array, got {A.ndim}-D")
    if A.dtype not in (types.float32, types.float64):
        raise TypeError(f"hsvd requires float32/float64, got {A.dtype}")
    if maxrank is None and rtol is None:
        raise ValueError("at least one of maxrank and rtol must be given")

    # split=0: work on A.T, so the distributed axis is the column axis
    transposeflag = A.split == 0
    work = A.T if transposeflag else A
    comm = work.comm

    Anorm = float(vector_norm(work).item())
    m, n = work.gshape
    distributed = work.split == 1 and work.is_distributed()
    nblocks = comm.size if distributed else 1
    if maxrank is None:
        maxrank = min(m, n)
    loc_atol = None if rtol is None else rtol * Anorm / np.sqrt(2 * nblocks - 1)

    # level 0: this rank's column block alone, at heat_tpu's common block width
    x = work.larray
    if distributed:
        w = -(-n // nblocks)
        if x.shape[1] < w:
            x = torch.cat([x, x.new_zeros((m, w - x.shape[1]))], dim=1)
    u, s, err = _truncate_stacked(0, x.unsqueeze(0), maxrank, loc_atol, safetyshift, silent)[0]
    node = u * s
    if distributed:
        nodes, errs = _gather_nodes(comm, node, err)
        if comm.rank == 0:
            final = _merge_tree(nodes, errs, no_of_merges, maxmergedim, maxrank, loc_atol, safetyshift, silent)
        else:
            final = None
        final_u, total_err_squared = _bcast_result(comm, final, m, x.dtype, x.device)
    else:
        final_u, total_err_squared = _merge_tree([node], [err], no_of_merges, maxmergedim, maxrank, loc_atol, safetyshift, silent)
    rel_err = float(np.sqrt(total_err_squared)) / Anorm if Anorm > 0 else 0.0

    U = factories.array(final_u, split=None, device=A.device, comm=A.comm)
    rel_error_estimate = factories.array(
        np.asarray(rel_err, dtype=np.float64 if final_u.dtype == torch.float64 else np.float32),
        device=A.device, comm=A.comm,
    )

    # postprocessing (heat_tpu svdtools.py:205-216)
    if transposeflag or compute_sv:
        V = matmul(work.T, U)
        sigma = vector_norm(V, axis=0)
        if float(vector_norm(sigma).item()) > 0:
            from ..manipulations import diag

            V = matmul(V, diag(1.0 / sigma))
        if transposeflag:
            if compute_sv:
                return V, sigma, U, rel_error_estimate
            return V, rel_error_estimate
        return U, sigma, V, rel_error_estimate
    return U, rel_error_estimate


def guarded_svd(x: torch.Tensor, full_matrices: bool = False, compute_uv: bool = True):
    """``torch.linalg.svd`` (or ``svdvals``) as hsvd and :func:`..svd.svd` need it (the
    role of heat_tpu's ``guarded_svd``, svdtools.py:33, whose TPU x64 guard does not apply).
    On a CUDA tensor it asks cuSOLVER for ``gesvd`` (QR iteration): the default driver,
    ``gesvdj`` (Jacobi), stops at a tolerance that leaves the leading singular subspace of
    config #4's rank-10 2048 × 32768 f32 matrix off by about 1e-3 (‖A − UUᵀA‖/‖A‖), where
    ``gesvd``'s is within 1e-6, and ``gesvd`` is also the faster of the two there
    (chip_smoke.py's ``[linalg_hsvd]`` on an H100; PERF.md §5)."""
    driver = "gesvd" if x.is_cuda else None
    if not compute_uv:
        return torch.linalg.svdvals(x, driver=driver)
    return torch.linalg.svd(x, full_matrices=full_matrices, driver=driver)


def _merge_tree(nodes, err_squared, no_of_merges, maxmergedim, maxrank, loc_atol, safetyshift, silent):
    """The merge levels on one rank (heat_tpu svdtools.py:150-196): group neighbouring
    nodes under the merge budget, re-truncate each group, until one node is left; then the
    final truncation without the safety shift. Returns ``(U, total err²)``."""
    arity = no_of_merges or 2
    level = 0
    while len(nodes) > 1:
        level += 1
        groups, keep = [], []
        i = 0
        while i < len(nodes):
            group_idx = [i]
            width = nodes[i].shape[1]
            j = i + 1
            while j < len(nodes) and len(group_idx) < arity and (
                maxmergedim is None or width + nodes[j].shape[1] <= maxmergedim
            ):
                group_idx.append(j)
                width += nodes[j].shape[1]
                j += 1
            (groups if len(group_idx) > 1 else keep).append(group_idx)
            i = j
        cats = [torch.cat([nodes[k] for k in g], dim=1) for g in groups]
        outs = _batched_truncated_svd(level, cats, maxrank, loc_atol, safetyshift, silent) if cats else []
        merged = {}
        for g, (u, s, e) in zip(groups, outs):
            merged[g[0]] = (u * s, sum(err_squared[k] for k in g) + e)
        for g in keep:
            merged[g[0]] = (nodes[g[0]], err_squared[g[0]])
        order = sorted(merged)
        nodes = [merged[k][0] for k in order]
        err_squared = [merged[k][1] for k in order]
    # the final truncation drops the safety shift (heat_tpu svdtools.py:198-200)
    final_u, _, final_err = _local_truncated_svd(level + 1, 0, nodes[0], maxrank, loc_atol, 0, silent)
    return final_u, sum(err_squared) + final_err


def _gather_nodes(comm, node: torch.Tensor, err: float):
    """Every rank's level-0 node (its width is data-dependent) and error, on every rank,
    in rank order: widths and errors in one gather, the nodes padded to the widest in
    another, then trimmed."""
    m = node.shape[0]
    meta = torch.tensor([float(node.shape[1]), err], dtype=torch.float64, device=node.device)
    metas = comm.all_gather_stacked(meta).cpu()
    widths = [int(v) for v in metas[:, 0].tolist()]
    errs = [float(v) for v in metas[:, 1].tolist()]
    wmax = max(widths)
    padded = node if node.shape[1] == wmax else torch.cat([node, node.new_zeros((m, wmax - node.shape[1]))], dim=1)
    stacked = comm.all_gather_stacked(padded.contiguous())
    return [stacked[r, :, : widths[r]] for r in range(comm.size)], errs


def _bcast_result(comm, final, m: int, dtype, device):
    """Rank 0's ``(U, err²)`` on every rank: its rank and error first, then U."""
    meta = torch.zeros(2, dtype=torch.float64, device=device)
    if comm.rank == 0:
        meta[0], meta[1] = final[0].shape[1], final[1]
    comm.bcast(meta, root=0)
    r = int(meta[0].item())
    u = final[0].contiguous() if comm.rank == 0 else torch.empty((m, r), dtype=dtype, device=device)
    comm.bcast(u, root=0)
    return u, float(meta[1].item())


def _batched_truncated_svd(
    level: int,
    blocks: List[torch.Tensor],
    maxrank: int,
    loc_atol: Optional[float],
    safetyshift: int,
    silent: bool = True,
) -> List[Tuple[torch.Tensor, torch.Tensor, float]]:
    """Truncated SVDs of a list of node blocks (heat_tpu svdtools.py:256): zero-padded to
    a common width, stacked, and cut by :func:`_truncate_stacked`."""
    wmax = max(b.shape[1] for b in blocks)
    stacked = torch.stack(
        [torch.cat([b, b.new_zeros((b.shape[0], wmax - b.shape[1]))], dim=1) if b.shape[1] < wmax else b for b in blocks]
    )
    return _truncate_stacked(level, stacked, maxrank, loc_atol, safetyshift, silent)


def _truncate_stacked(
    level: int,
    stacked: torch.Tensor,
    maxrank: int,
    loc_atol: Optional[float],
    safetyshift: int,
    silent: bool = True,
) -> List[Tuple[torch.Tensor, torch.Tensor, float]]:
    """Truncated SVDs of a ``(B, m, w)`` stack (heat_tpu svdtools.py:279): one batched
    ``torch.linalg.svd``, the singular values read on the host once for the noise-floor,
    rank and atol decisions. Per node ``(U_trunc, σ_trunc, err² dropped)``."""
    u, s, _ = guarded_svd(stacked)
    noiselevel = 1e-14 if stacked.dtype == torch.float64 else 1e-7
    s_all = s.detach().cpu().double().numpy()
    results = []
    for node_id in range(stacked.shape[0]):
        s_np = s_all[node_id]
        above = np.nonzero(s_np >= noiselevel)[0]
        if len(above) == 0:
            err = float(np.linalg.norm(s_np) ** 2)
            results.append((stacked.new_zeros((stacked.shape[1], 1)), stacked.new_zeros((1,)), err))
            continue
        cut_noise_rank = int(above.max()) + 1
        if loc_atol is None:
            trunc = min(maxrank, cut_noise_rank)
        else:
            tails = np.array([np.linalg.norm(s_np[k:]) ** 2 for k in range(len(s_np) + 1)])
            ideal = int(np.nonzero(tails < loc_atol**2)[0].min())
            trunc = min(maxrank, ideal, cut_noise_rank)
            if trunc != ideal and not silent:
                print(
                    f"in hSVD (level {level}, node {node_id}): atol requires rank {ideal}, but "
                    f"maxrank={maxrank}. Loss of desired precision likely!"
                )
        trunc = min(len(s_np), trunc + safetyshift)
        # the squared energy dropped here (heat_tpu's rule: the kept safety columns are
        # not charged)
        err = float(np.linalg.norm(s_np[trunc:]) ** 2)
        results.append((u[node_id, :, :trunc], s[node_id, :trunc], err))
    return results


def _local_truncated_svd(
    level: int,
    node_id: int,
    x: torch.Tensor,
    maxrank: int,
    loc_atol: Optional[float],
    safetyshift: int,
    silent: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """One node's truncated SVD (heat_tpu svdtools.py:344)."""
    return _batched_truncated_svd(level, [x], maxrank, loc_atol, safetyshift, silent)[0]
