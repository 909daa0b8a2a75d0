"""K1: fused KMeans assignment + centroid accumulation, a CUDA C++ kernel for Hopper.

Replaces the Pallas TPU kernel ``heat_tpu/core/kernels/kmeans.py:44`` (``_kernel``,
launched by ``_fused_pallas``; entry ``fused_assign_update``). One streaming pass over
x (n, d) f32 against centers (k, d) f32 gives the labels, the per-cluster sums and counts
and the sum of squared distances, without the (n, k) distance matrix ever reaching
device memory. The source, ``csrc/kmeans_assign.cu``, says what bounds it on the card
(one read of x: 4 operations a byte at k = 8, so the bytes of x) and how its design answers.

The wrapper takes the plain PyTorch version, :func:`fused_assign_update_reference`, only
for tensors that lie on the CPU. A CUDA tensor launches the kernel or raises: there is no
fallback. ``launches`` counts the kernel's launches, one a call, and ``launches_tma`` those
whose tiles reached shared memory by TMA bulk copies (:func:`route`).

The kernel's summation order, which this module writes out for the checks (see
:func:`rounding_depths` and :func:`ordered_sums`): rows come in tiles of
``plan.rows_per_tile`` consecutive rows, and block ``b`` of a grid of ``G`` takes tiles
``b, b + G, b + 2G, ...`` (one CTA an SM hosts ``plan.per_cta`` of these blocks, which
changes nothing of the order). Within a tile, the rows of cluster ``j`` are summed in row order
into a partial that starts at 0; the block adds each tile's partial to its record in tile
order. The blocks' records are folded in groups of 16 consecutive blocks, each group's in
block order, then the groups' sums in group order (with one group, its sum is the output).
Row ``i`` of a tile has slot ``i`` of the block, which sums the minimum d² of its rows in
tile order; the block adds its slots in runs of ``ceil(rows_per_tile / 32)`` consecutive
slots, then the runs in order; the blocks' sse is folded with the records. Counts are
integers until the records are folded.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..devices import full_fp32_matmul
from . import _nvcc

__all__ = [
    "Plan",
    "fits_smem",
    "grid_blocks",
    "fused_assign_update",
    "fused_assign_update_packed",
    "fused_assign_update_reference",
    "ordered_sums",
    "plan",
    "rounding_depths",
    "route",
    "unpack",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "kmeans_assign.cu"

launches = 0
"""Launches of the CUDA kernel since import (or since a caller reset it to 0)."""
launches_tma = 0
"""Of those, the launches whose tiles came by TMA bulk copies (the route ``"bulk"``)."""
# the counts move under this lock: request threads launch the kernel concurrently
_count_lock = threading.Lock()

_MAX_D = 256
# dynamic shared memory a block may opt into on sm_90 (227 KB)
_SMEM_BUDGET = 232_448
# the most clusters whose centers a thread keeps in registers (the source's kRegK)
_REG_K = 8
# the launch the planner starts from, shrunk until it fits: assigning threads a block (as
# many accumulate, and copy the tiles in) and the ring's stages (depths of 3 to 8 moved
# nothing at d = 28 and 64 on an H100)
_THREADS, _STAGES = 256, 4
# how the producer fills a stage: the source's kRouteBulk, kRouteChunks, kRouteWords
ROUTES = ("bulk", "chunks", "words")
# the source's kFoldGroup and kMaxGroups: blocks whose records one block folds, and groups
# the ticket counters cover
_FOLD_GROUP, _MAX_GROUPS = 16, 512

_LIB = None
_MAX_BLOCKS: Dict[Tuple[int, "Plan"], int] = {}
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


class Plan(NamedTuple):
    """One launch's shape (the source's ``dmax_of``, ``reg_of``, ``tpr_of``): ``dmax`` the
    kernel's bound on d (32, 64, 128 or 256); ``reg`` whether each thread keeps its columns
    of every center in registers (d <= 64 and k <= 8), ``tpr`` the threads that share a
    row's columns (4 then; else 1 up to d = 64 and 64 columns a thread above); ``threads``
    the assigning threads a block (as many accumulate) and ``stages`` of the ring."""

    d: int
    k: int
    dmax: int
    reg: bool
    tpr: int
    threads: int
    stages: int

    @property
    def rows_per_tile(self) -> int:
        """Rows in a tile, each with its own slot of the block's sse: one an assigning thread
        with the centers in registers (a quad computes four rows together), else one a group
        of ``tpr`` threads."""
        return self.threads if self.reg else self.threads // self.tpr

    @property
    def chunks(self) -> int:
        """16-byte chunks of a row, ceil(d / 4)."""
        return -(-self.d // 4)

    @property
    def row_stride4(self) -> int:
        """A tile row's stride in 16-byte chunks (the source's ``row_stride4``): unpadded
        with the centers in registers, so that a tile is one span for one bulk copy; else
        padded to ``tpr`` modulo ``2 * tpr`` chunks, so that 16-byte reads of neighbouring
        rows fall on distinct banks."""
        p = self.chunks
        while not self.reg and p % (2 * self.tpr) != self.tpr:
            p += 1
        return p

    @property
    def per_cta(self) -> int:
        """Blocks of the order one CTA hosts (the source's ``per_cta_of``): 2 where the launch
        before the TMA ring kept two blocks resident on an SM (the centers in registers, rows
        of at most 7 chunks), so that its order and bits stay; else 1. A launch whose blocks
        hold at most one tile each has a CTA a block (the same order)."""
        return 2 if self.reg and self.row_stride4 <= 7 else 1

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block (the source's ``smem_bytes``): the ring of ``stages``
        tiles of padded rows and the centers, in 16-byte chunks; a list of a tile's rows for
        each accumulating warp in 4-byte words; two mbarriers a stage (full, assigned); then a
        ticket a stage, |c|², the (k, d) record and the counts of each hosted block, a label
        slot per tile row and stage, a sum per row slot and hosted block, and one flag in
        4-byte words."""
        d, k, bn, warps, v = self.d, self.k, self.rows_per_tile, self.threads // 32, self.per_cta
        chunks = self.stages * bn * self.row_stride4 + k * self.chunks
        words = warps * bn + self.stages + k + v * k * d + v * k + self.stages * bn + v * bn + 1
        return 16 * chunks + 8 * 2 * self.stages + 4 * words


def _shape(d: int, k: int, threads: int, stages: int) -> Plan:
    dmax = 32 if d <= 32 else 64 if d <= 64 else 128 if d <= 128 else 256
    reg = d <= 64 and k <= _REG_K
    tpr = 4 if reg else max(1, dmax // 64)
    return Plan(d, k, dmax, reg, tpr, threads, stages)


def smem_bytes(d: int, k: int, threads: int = _THREADS, stages: int = _STAGES) -> int:
    """Shared memory of one block of ``threads`` assigning threads and a ring of ``stages``
    tiles."""
    return _shape(d, k, threads, stages).smem_bytes


@functools.lru_cache(maxsize=1024)
def plan(d: int, k: int, threads: int = _THREADS, stages: int = _STAGES) -> Optional[Plan]:
    """The launch for (d, k), or None beyond the kernel's gate: from the given shape, fewer
    stages (down to 2), then fewer assigning threads (down to one warp; whole warpgroups with
    the centers in registers, whose roles trade registers), until the block's shared memory
    fits."""
    if not (1 <= d <= _MAX_D and k >= 1):
        return None
    p = _shape(d, k, threads, stages)
    while p.smem_bytes > _SMEM_BUDGET:
        if p.stages > 2:
            p = p._replace(stages=p.stages - 1)
        elif p.threads > (128 if p.reg else 32):
            p = p._replace(threads=p.threads // 2)
        else:
            return None
    return p


def route(p: Plan, x: torch.Tensor) -> str:
    """How the kernel fills a stage for ``x`` under the plan ``p``: ``"bulk"``
    (one TMA bulk copy a tile) where x is 16-byte aligned, d % 4 == 0 and a tile row's padded
    stride is its natural one, so that a tile is one contiguous span in both places;
    ``"chunks"`` (16-byte cp.async into the padded rows) where only the first two hold;
    ``"words"`` (4-byte cp.async) for any other x."""
    if x.data_ptr() % 16 or p.d % 4:
        return "words"
    return "bulk" if p.row_stride4 == p.chunks else "chunks"


def fits_smem(d: int, k: int) -> bool:
    """The kernel's gate (the counterpart of heat_tpu's ``_fits_vmem``): d <= 256 and some
    launch of :func:`plan` fits shared memory. Larger shapes take the generic Lloyd path."""
    return plan(d, k) is not None


def grid_blocks(n: int, d: int, k: int, device: torch.device) -> Tuple[int, int]:
    """(blocks, assigning warps per block) of the launch for ``n`` rows on a CUDA
    ``device``: the blocks of the order, ``per_cta`` of them on each SM's one CTA, fewer
    when there are fewer tiles."""
    p = plan(d, k)
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return _grid(n, p, dev), p.threads // 32


def _grid(n: int, p: Plan, dev: int) -> int:
    max_blocks = _MAX_BLOCKS.get((dev, p))
    if max_blocks is None:
        lib = _lib()
        out = ctypes.c_int(0)
        rc = lib.kmeans_assign_max_blocks(dev, p.d, p.k, p.threads, p.stages, ctypes.byref(out))
        _raise_on(lib, rc, "occupancy query")
        max_blocks = _MAX_BLOCKS[(dev, p)] = out.value
    return max(1, min(max_blocks, -(-n // p.rows_per_tile)))


def _fold_depth(blocks: int) -> int:
    """Additions a block's record passes through in the fold: the group's, then the groups'."""
    groups = -(-blocks // _FOLD_GROUP)
    return blocks if groups == 1 else _FOLD_GROUP + groups


def _folded(records: np.ndarray) -> np.ndarray:
    """The fold of the blocks' records (axis 0) in the kernel's order, in float32."""
    sums = []
    for g0 in range(0, records.shape[0], _FOLD_GROUP):
        s = np.zeros(records.shape[1:], dtype=np.float32)
        for r in records[g0:g0 + _FOLD_GROUP]:
            s = s + r
        sums.append(s)
    if len(sums) == 1:
        return sums[0]
    out = np.zeros(records.shape[1:], dtype=np.float32)
    for s in sums:
        out = out + s
    return out


def rounding_depths(n: int, d: int, k: int, labels: torch.Tensor, grid, launch: Optional[Plan] = None) -> Dict[str, int]:
    """The most fp32 roundings any term passes through in the kernel's order, for ``n``
    rows with the kernel's ``labels`` on a grid of ``grid`` blocks (an int, or
    :func:`grid_blocks`'s pair) and the plan ``launch`` (:func:`plan`'s by default):

    - ``h_sums``: a row's coordinate is added into its tile's partial of its cluster (at
      most the tile's rows of that cluster), the partial into the block's record (at most
      the block's tiles) and the record into the output (the blocks, or 16 and the groups
      of 16 blocks);
    - ``h_sse``: a row's minimum d² into its slot's sum (at most the block's tiles), that
      into its run of slots (ceil(rows_per_tile / 32)), the run into the block's (32), that
      into the output as the records;
    - ``h_row``: one d² = max(|x|² + |c|² − 2 x·c, 0). With the centers in registers each
      product and |c|² is one running sum over the thread's columns, and the ``tpr``
      threads of a row add theirs by shuffles; else each product is 4 running sums over the
      thread's chunks, added in pairs, then the shuffles, and |c|² 4 running sums over all
      chunks, added in pairs; then two additions.

    So a sum is within γ(h_sums)·Σ|x| of the exact one, and a row's d² within
    γ(h_row)·(|x| + |c|)²."""
    p = launch or plan(d, k)
    blocks = grid[0] if isinstance(grid, tuple) else int(grid)
    bn = p.rows_per_tile
    tiles = -(-n // bn)
    tiles_per_block = -(-tiles // blocks) if tiles else 0
    lab = labels.reshape(-1).long()
    tile_of = torch.arange(n, device=lab.device) // bn
    most = int(torch.bincount(tile_of * k + lab, minlength=max(1, tiles * k)).max()) if n else 0
    own = -(-p.chunks // p.tpr)  # a thread's chunks of a row
    shuffles = int(math.log2(p.tpr))
    product = 4 * own + shuffles if p.reg else own + 2 + shuffles
    norm = product if p.reg else p.chunks + 2  # |c|²
    fold = _fold_depth(blocks)
    return {
        "h_sums": most + tiles_per_block + fold,
        "h_sse": tiles_per_block + -(-bn // 32) + 32 + fold,
        "h_row": max(product, norm) + 2,
    }


def ordered_sums(x: np.ndarray, labels: np.ndarray, k: int, blocks: int, launch: Optional[Plan] = None) -> np.ndarray:
    """The kernel's (k, d) sums of ``x`` (n, d) f32 grouped by ``labels``, replayed in its
    fp32 order on the host for a grid of ``blocks`` blocks and the plan ``launch``
    (:func:`plan`'s by default): equal to the kernel's bit for bit. Sequential in Python
    over tiles: for checks at small n."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    labels = np.asarray(labels).reshape(-1)
    n, d = x.shape
    bn = (launch or plan(d, k)).rows_per_tile
    tiles = -(-n // bn)
    records = np.zeros((blocks, k, d), dtype=np.float32)
    for t in range(tiles):
        rows, lab = x[t * bn:(t + 1) * bn], labels[t * bn:(t + 1) * bn]
        for j in np.unique(lab):
            # add.accumulate is sequential in the array's type
            part = np.add.accumulate(rows[lab == j], axis=0, dtype=np.float32)[-1]
            records[t % blocks, j] = records[t % blocks, j] + part
    return _folded(records)


def fused_assign_update_reference(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (mirrors heat_tpu/core/kernels/kmeans.py:28-41):
    (labels int32, sums, counts, sse) of nearest-centroid assignment, with the cross
    term in full fp32."""
    xx = torch.sum(x * x, dim=1, keepdim=True)
    cc = torch.sum(centers * centers, dim=1)[None, :]
    with full_fp32_matmul():
        xc = torch.matmul(x, centers.T)
    d2 = torch.clamp_min(xx + cc - 2.0 * xc, 0.0)
    labels = torch.argmin(d2, dim=1).to(torch.int32)  # first index of the row minimum
    k = centers.shape[0]
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add_(
        0, labels, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    )
    sse = torch.sum(torch.amin(d2, dim=1)) if x.shape[0] else x.new_zeros(())
    return labels, sums, counts, sse


def unpack(packed: torch.Tensor, k: int, d: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums (k, d), counts (k,), sse ()) views of a packed k*d + k + 1 record."""
    return packed[: k * d].view(k, d), packed[k * d : k * d + k], packed[k * d + k]


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    for t, name in ((x, "x"), (centers, "centers")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape[1] != centers.shape[1]:
        raise ValueError(f"x has {x.shape[1]} features, centers {centers.shape[1]}")
    if x.device != centers.device:
        raise ValueError(f"x is on {x.device}, centers on {centers.device}")


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_assign_max_blocks.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.kmeans_assign_max_blocks.restype = i
        lib.kmeans_assign_launch.argtypes = [i, p, p, ll, i, i, p, p, i, p, p, i, i, i, p]
        lib.kmeans_assign_launch.restype = i
        lib.kmeans_assign_smem_bytes.argtypes = [i, i, i, i]
        lib.kmeans_assign_smem_bytes.restype = ll
        lib.kmeans_error_string.argtypes = [i]
        lib.kmeans_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kmeans_assign: {what} failed: {lib.kmeans_error_string(rc).decode()} ({rc})")


def _counter(dev: int, stream: int, device: torch.device) -> torch.Tensor:
    """The fold's tickets of ``stream`` on ``dev`` (one for the groups, one a group): zeroed
    once, and returned to zero by the blocks that draw the last ticket of every launch, so
    calls on one stream share them and calls on two streams never do."""
    c = _COUNTERS.get((dev, stream))
    if c is None:
        c = _COUNTERS[(dev, stream)] = torch.zeros(1 + _MAX_GROUPS, dtype=torch.int32, device=device)
    return c


def fused_assign_update_packed(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) int32, packed (k*d + k + 1,) f32: sums, counts, sse) in one pass.

    CPU tensors take the plain version; CUDA tensors launch K1 (one kernel) on the current
    stream without synchronising, and count one launch. Raises on a dtype other than f32,
    on non-contiguous input and, on the card, on shapes beyond :func:`fits_smem`."""
    global launches, launches_tma
    _check(x, centers)
    n, d = x.shape
    k = centers.shape[0]
    if x.device.type == "cpu":
        labels, sums, counts, sse = fused_assign_update_reference(x, centers)
        return labels, torch.cat([sums.reshape(-1), counts, sse.reshape(1)])
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on CUDA or CPU tensors, got {x.device}")
    p = plan(d, k)
    if p is None:
        raise ValueError(f"(d={d}, k={k}) is beyond the kernel's gate (d <= {_MAX_D}, shared memory)")
    if n >= 2**31:
        raise ValueError(f"n={n} rows overflow the int32 labels")
    lib = _lib()
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    blocks = _grid(n, p, dev)
    m = k * d + k + 1
    m4 = -(-m // 4) * 4  # the scratch's rows start 16-byte aligned
    groups = -(-blocks // _FOLD_GROUP)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    how = route(p, x)
    # allocated on the stream the kernel runs on: when `scratch` is freed on return, the
    # caching allocator hands its memory only to work queued after it on that stream
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    scratch = torch.empty((blocks + groups, m4), dtype=torch.float32, device=x.device)
    packed = torch.empty(m, dtype=torch.float32, device=x.device)
    rc = lib.kmeans_assign_launch(
        dev, x.data_ptr(), centers.data_ptr(), n, d, k, labels.data_ptr(), scratch.data_ptr(), blocks,
        packed.data_ptr(), _counter(dev, stream, x.device).data_ptr(), p.threads, p.stages, ROUTES.index(how), stream,
    )
    _raise_on(lib, rc, "launch")
    with _count_lock:
        launches += 1
        launches_tma += how == "bulk"
    return labels, packed


def fused_assign_update(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labels, sums, counts, sse) in one streaming pass over ``x``: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    labels, packed = fused_assign_update_packed(x, centers)
    return (labels, *unpack(packed, centers.shape[0], x.shape[1]))
