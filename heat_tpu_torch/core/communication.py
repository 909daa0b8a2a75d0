"""Communication layer over ``torch.distributed`` (counterpart of heat_tpu/core/communication.py).

A DNDarray holds its rank's local ``torch.Tensor``; ranks talk over ``torch.distributed``
(NCCL on the card, gloo on the CPU). When no process group is initialised the world is a
single rank and every collective is the identity. Every collective of the package lives
in this file.

Every collective of :class:`TorchCommunication` runs through the one guarded chokepoint
(:func:`_guarded`, heat_tpu/core/communication.py:42-100): the supervision plane's
sentinel poll and watchdog, the fault plan and site policies of ``ht.resilience``, the
telemetry plane's collective window, the forensics plane's collective timer and the
profiler's ``collective`` slice, each one module-attribute read when its plane is off (the
profiler's slice records while it is enabled or a ``torch.profiler`` session runs: two).
The site of a collective is ``comm.<method>``.

Chunking follows heat_tpu's ceil-division rule (heat_tpu/core/communication.py:311-337):
rank ``r`` owns ``[r*c, min((r+1)*c, n))`` with ``c = ceil(n / size)``, so lshape maps
agree between the two packages. Trailing ranks may own empty chunks.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import _complex_order, diagnostics, forensics, profiler, resilience, supervision, telemetry

__all__ = [
    "Communication",
    "TorchCommunication",
    "COMM_WORLD",
    "COMM_SELF",
    "get_comm",
    "use_comm",
    "sanitize_comm",
    "initialize",
]

_REDUCE_OPS = {"sum": "SUM", "prod": "PRODUCT", "min": "MIN", "max": "MAX"}

# the types neither gloo nor NCCL moves, and the carrier each travels as (cast back after)
_CARRIERS = {torch.bool: torch.uint8, torch.int16: torch.int32}


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a type the backends move (bool as uint8, int16 as int32)."""
    carrier = _CARRIERS.get(t.dtype)
    return t.to(carrier) if carrier is not None else t


def _from_wire(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A tensor received as :func:`_to_wire`'s carrier, back in ``dtype``."""
    return t if t.dtype == dtype else t.to(dtype)


def _collective(fn):
    """Route one collective method through :func:`_guarded` at site ``comm.<name>``;
    while diagnostics or forensics collect, first report its logical bytes
    (:func:`_record_collective`)."""
    site = f"comm.{fn.__name__}"
    op = fn.__name__

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if diagnostics._enabled or forensics._enabled:
            _record_collective(self, op, args)
        return _guarded(site, fn, self, *args, **kwargs)

    return wrapped


def _record_collective(comm, op: str, args) -> None:
    """One collective's logical bytes (this rank's tensor payload × participants) to
    ht.diagnostics and the forensics cost meters, each gated on its own switch
    (heat_tpu's ``MeshCommunication._record_collective``)."""
    participants = comm.size
    nbytes = participants * sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    if diagnostics._enabled:
        diagnostics.record_collective(op, "d", participants, nbytes)
    if forensics._enabled:
        forensics.note_collective(op, 0.0, nbytes=nbytes)


def _guarded(site, fn, *args, **kwargs):
    """Run one collective invocation under ht.supervision, ht.telemetry,
    ht.forensics, ht.profiler and ht.resilience (heat_tpu's chokepoint).

    Idle fast path: one module-attribute read per plane. When the supervision
    plane is armed the abort sentinel is polled before and after the invocation
    (a peer failure raises typed ``PeerFailed`` instead of entering a collective
    its dead peer will never join) and, with ``HEAT_TPU_COLLECTIVE_TIMEOUT_S`` set,
    the invocation window is armed on the collective watchdog
    (``supervision.watch``). When telemetry collection is on, the invocation is
    timed into a :func:`telemetry.collective_window`; when the forensics plane is
    armed, onto the ambient request's record. When the profiler is active the
    invocation is a ``collective`` slice of the ambient request scope. When a fault
    plan is armed or a site policy is registered, the call goes through
    ``resilience.guard``: injected faults fire per attempt and the policy retries.
    All of it is host-side timing: nothing is added to what the card runs."""
    if supervision._armed:
        with supervision.watch(site):
            return _guarded_telemetry(site, fn, *args, **kwargs)
    return _guarded_telemetry(site, fn, *args, **kwargs)


def _guarded_telemetry(site, fn, *args, **kwargs):
    if telemetry._collecting:
        with telemetry.collective_window(site):
            return _guarded_forensics(site, fn, *args, **kwargs)
    return _guarded_forensics(site, fn, *args, **kwargs)


def _guarded_forensics(site, fn, *args, **kwargs):
    if forensics._enabled:
        with forensics.collective_timer(site):
            return _guarded_run(site, fn, *args, **kwargs)
    return _guarded_run(site, fn, *args, **kwargs)


def _guarded_run(site, fn, *args, **kwargs):
    if profiler.recording():  # enabled, or inside a torch.profiler session
        with profiler.scope("collective", site):
            if resilience._active:
                return resilience.guard(site, fn, *args, **kwargs)
            return fn(*args, **kwargs)
    if resilience._active:
        return resilience.guard(site, fn, *args, **kwargs)
    return fn(*args, **kwargs)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class TorchCommunication:
    """A communicator over a ``torch.distributed`` process group (None: the default
    group). ``size``/``rank`` are read when asked, so a communicator made before
    ``init_process_group`` sees the group made after it."""

    def __init__(self, group=None):
        self.group = group
        self._n_nodes = None  # set by :meth:`hierarchical`
        self._node_comm = self._cross_comm = None

    @classmethod
    def hierarchical(cls, n_nodes: int) -> "TorchCommunication":
        """A two-tier communicator over the world: ``n_nodes`` node groups of ``L = size /
        n_nodes`` ranks each (heat_tpu's ``MeshCommunication.hierarchical``, its mesh
        ``(n_nodes, L)``): node ``j`` is ranks ``j·L … (j+1)·L − 1``, and local index
        ``l`` of every node forms the cross-node group ``{l, L + l, …}``. DASO reduces
        gradients over :attr:`node_comm` and syncs the replicas over :attr:`cross_comm`.

        ``torch.distributed.new_group`` is collective over the whole world, so every rank
        creates every group, in the same order, also the groups it is not in. A group of
        one rank or of the whole world needs none."""
        world = cls()
        size, rank = world.size, world.rank
        if n_nodes <= 0 or size % n_nodes != 0:
            raise ValueError(f"cannot split {size} devices into {n_nodes} equal node groups")
        per_node = size // n_nodes
        out = cls()
        out._n_nodes = int(n_nodes)

        def tier(groups_of_ranks, mine):
            if len(mine) == 1:
                return _SelfCommunication()
            if len(mine) == size:
                return cls()
            made = [dist.new_group(ranks=r) for r in groups_of_ranks]  # every rank, every group
            return cls(made[groups_of_ranks.index(mine)])

        nodes = [list(range(j * per_node, (j + 1) * per_node)) for j in range(n_nodes)]
        cross = [list(range(l, size, per_node)) for l in range(per_node)]
        out._node_comm = tier(nodes, nodes[rank // per_node])
        out._cross_comm = tier(cross, cross[rank % per_node])
        return out

    # ------------------------------------------------------------------ topology
    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if _initialized() else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if _initialized() else 0

    def is_distributed(self) -> bool:
        return self.size > 1

    @property
    def is_hierarchical(self) -> bool:
        """Whether this communicator was made by :meth:`hierarchical`."""
        return self._n_nodes is not None

    @property
    def n_nodes(self) -> int:
        """The number of node groups: 1 on a flat communicator."""
        return self._n_nodes or 1

    @property
    def node_size(self) -> int:
        """Ranks per node group."""
        return self.size // self.n_nodes

    @property
    def node(self) -> int:
        """The node group of this rank."""
        return self.rank // self.node_size

    @property
    def local_rank(self) -> int:
        """This rank's index within its node group."""
        return self.rank % self.node_size

    @property
    def node_comm(self) -> "TorchCommunication":
        """This rank's node group (the whole communicator when flat)."""
        return self._node_comm if self._node_comm is not None else self

    @property
    def cross_comm(self) -> "TorchCommunication":
        """The ranks of every node at this rank's local index, in node order (this rank
        alone when flat)."""
        return self._cross_comm if self._cross_comm is not None else _SelfCommunication()

    def __repr__(self) -> str:
        return f"TorchCommunication(size={self.size}, rank={self.rank})"

    # ------------------------------------------------------------------ chunking
    def chunk(
        self, shape: Sequence[int], split: Optional[int], rank: Optional[int] = None
    ) -> Tuple[int, Tuple[int, ...], Tuple[slice, ...]]:
        """The chunk of the global ``shape`` owned by ``rank`` along ``split``, by the
        ceil-division rule. Returns ``(offset, local_shape, slices)``."""
        if rank is None:
            rank = self.rank
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        split = int(split)
        n = shape[split]
        c = -(-n // self.size) if n else 0  # ceil division; 0-size stays 0
        start = min(rank * c, n)
        end = min((rank + 1) * c, n)
        lshape = shape[:split] + (end - start,) + shape[split + 1 :]
        slices = tuple(
            slice(start, end) if i == split else slice(0, s) for i, s in enumerate(shape)
        )
        return start, lshape, slices

    def counts_displs_shape(
        self, shape: Sequence[int], split: int
    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
        """Per-rank counts/displacements along ``split``, and this rank's lshape."""
        counts, displs = [], []
        for r in range(self.size):
            offset, lshape, _ = self.chunk(shape, split, rank=r)
            counts.append(lshape[split])
            displs.append(offset)
        _, lshape, _ = self.chunk(shape, split)
        return tuple(counts), tuple(displs), tuple(lshape)

    def lshape_map(self, shape: Sequence[int], split: Optional[int]) -> np.ndarray:
        """(size, ndim) array of every rank's local shape."""
        out = np.empty((self.size, len(shape)), dtype=np.int64)
        for r in range(self.size):
            _, lshape, _ = self.chunk(shape, split, rank=r)
            out[r] = lshape
        return out

    # ------------------------------------------------------------------ collectives
    @_collective
    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``tensor`` across ranks in place (``op``: sum, prod, min, max) and
        return it."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unsupported reduction {op!r}, expected one of {sorted(_REDUCE_OPS)}")
        if self.size == 1:
            return tensor
        red = getattr(dist.ReduceOp, _REDUCE_OPS[op])
        if tensor.dtype in _CARRIERS:
            # neither NCCL nor gloo reduces bool or int16; sum over bool means "any", and an
            # int16 sum in int32 wraps to the same bits when cut back
            buf = _to_wire(tensor)
            dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "sum" and tensor.dtype == torch.bool else red,
                            group=self.group)
            tensor.copy_(_from_wire(buf, tensor.dtype))
            return tensor
        dist.all_reduce(tensor, op=red, group=self.group)
        return tensor

    @_collective
    def all_reduce_lexicographic(self, tensor: torch.Tensor, kind: str) -> torch.Tensor:
        """The ``kind`` ("min" or "max") across ranks of complex ``tensor`` in (real,
        imaginary) order, which no backend's MIN or MAX has: every rank's candidates
        in one all-gather, then the first extreme in rank order (the first NaN where a
        rank holds one). Returns a new tensor."""
        if self.size == 1:
            return tensor
        return _complex_order.extreme(self.all_gather_stacked(tensor), 0, kind)[0].squeeze(0)

    @_collective
    def all_reduce_packed(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sums across ranks of ``tensors`` (one dtype and device, any shapes), by one
        collective over a flat buffer that packs them all; at world 1 the tensors as given.
        A data-parallel step reduces every gradient and its loss this way, in one call
        instead of one per parameter."""
        tensors = list(tensors)
        if self.size == 1 or not tensors:
            return tensors
        if len({(t.dtype, t.device) for t in tensors}) != 1:
            raise ValueError("all_reduce_packed takes tensors of one dtype and device")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return [part.view(t.shape) for part, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    @_collective
    def all_gather(self, local: torch.Tensor, gshape: Sequence[int], split: Optional[int]) -> torch.Tensor:
        """The global tensor of shape ``gshape`` from every rank's chunk along
        ``split``; chunks may be uneven or empty (each is padded to the ceil-division
        extent for the collective and trimmed after)."""
        gshape = tuple(int(s) for s in gshape)
        if split is None or self.size == 1:
            return local
        n = gshape[split]
        if n == 0:
            return local
        c = -(-n // self.size)
        moved = local.movedim(split, 0)
        dtype = moved.dtype
        moved = _to_wire(moved)
        if moved.shape[0] < c:
            pad = moved.new_zeros((c - moved.shape[0],) + tuple(moved.shape[1:]))
            moved = torch.cat([moved, pad], dim=0)
        moved = moved.contiguous()
        parts = [torch.empty_like(moved) for _ in range(self.size)]
        dist.all_gather(parts, moved, group=self.group)
        full = _from_wire(torch.cat(parts, dim=0)[:n], dtype)
        return full.movedim(0, split).contiguous()

    @_collective
    def all_gather_stacked(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's equally shaped ``tensor``, stacked along a new leading axis: a few
        values a rank (counts, candidates, halos, totals) or, under :meth:`all_gather_v`,
        what the ranks selected; a split array's chunks go through :meth:`all_gather`."""
        if self.size == 1:
            return tensor.unsqueeze(0)
        dtype = tensor.dtype
        send = _to_wire(tensor).reshape(-1).contiguous()
        out = send.new_empty(self.size * send.numel())
        dist.all_gather_into_tensor(out, send, group=self.group)
        return _from_wire(out.view((self.size,) + tuple(tensor.shape)), dtype)

    def all_gather_counts(self, n: int, device=None) -> List[int]:
        """Every rank's integer ``n``, in rank order (one small all-gather)."""
        if self.size == 1:
            return [int(n)]
        return self.all_gather_stacked(torch.tensor(int(n), dtype=torch.int64, device=device)).tolist()

    @_collective
    def all_gather_v(self, tensor: torch.Tensor, counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Every rank's ``tensor``, whose leading extents may differ (``counts``, when
        known), joined along axis 0 in rank order: each is padded to the largest for one
        all-gather and trimmed after. For pieces a rank selected (partial uniques, masked
        elements, nonzero indices along an axis other than 0), whose bytes are the
        selection's, not a split array's chunks (:meth:`all_gather`)."""
        if self.size == 1:
            return tensor
        if counts is None:
            counts = self.all_gather_counts(tensor.shape[0], tensor.device)
        top = max(counts)
        if top == 0:
            return tensor[:0]
        if tensor.shape[0] < top:
            pad = tensor.new_zeros((top - tensor.shape[0],) + tuple(tensor.shape[1:]))
            tensor = torch.cat([tensor, pad])
        parts = self.all_gather_stacked(tensor)
        return torch.cat([parts[r, : counts[r]] for r in range(self.size)])

    @_collective
    def redistribute(
        self,
        local: torch.Tensor,
        gshape: Sequence[int],
        axis: int,
        src_counts: Sequence[int],
        dst_counts: Sequence[int],
        src_displs: Optional[Sequence[int]] = None,
        dst_displs: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Move a distribution along ``axis`` with arbitrary per-rank extents to another
        one: rank ``r`` holds ``src_counts[r]`` slices of the global ``gshape`` (from
        ``src_displs[r]``, by default the running sum of the counts, so rank order) and
        receives ``dst_counts[r]`` slices (from ``dst_displs[r]``, by default the running
        sum; given, the ranges may overlap, as halos do). One
        ``all_to_all_single`` with per-peer split sizes; an empty message is neither sent
        nor received, and nothing beyond the overlaps moves."""
        gshape = tuple(int(s) for s in gshape)
        src_counts = [int(c) for c in src_counts]
        dst_counts = [int(c) for c in dst_counts]
        if sum(src_counts) != gshape[axis] or (dst_displs is None and sum(dst_counts) != gshape[axis]):
            raise ValueError(f"redistribute: counts {src_counts} -> {dst_counts} do not cover extent {gshape[axis]}")
        rank = self.rank
        if local.shape[axis] != src_counts[rank]:  # ht: ignore[spmd-divergent-collective] -- argument check, not a branch of a correct call: a rank whose chunk disagrees with the counts every rank was given is the caller's error and raises at once; its peers' collective then ends at the group's timeout (typed by the supervision watchdog when armed)
            raise ValueError(f"redistribute: this rank holds {local.shape[axis]} along {axis}, not {src_counts[rank]}")
        if src_displs is None:
            src_displs = _displs(src_counts)
        if dst_displs is None:
            dst_displs = _displs(dst_counts)
        if self.size == 1:
            return local.narrow(axis, dst_displs[0] - src_displs[0], dst_counts[0])

        def overlap(s0, n0, s1, n1):
            return max(0, min(s0 + n0, s1 + n1) - max(s0, s1)), max(s0, s1)

        dtype = local.dtype
        moved = _to_wire(local).movedim(axis, 0)
        row = int(np.prod(moved.shape[1:]))
        send_parts, in_sizes, out_sizes = [], [], []
        for peer in range(self.size):
            n, start = overlap(src_displs[rank], src_counts[rank], dst_displs[peer], dst_counts[peer])
            lo = start - src_displs[rank]
            send_parts.append(moved[lo : lo + n])
            in_sizes.append(n * row)
            n_in, _ = overlap(src_displs[peer], src_counts[peer], dst_displs[rank], dst_counts[rank])
            out_sizes.append(n_in * row)
        send = torch.cat([p.reshape(-1) for p in send_parts]) if sum(in_sizes) else moved.new_empty(0)
        out = moved.new_empty(sum(out_sizes))
        dist.all_to_all_single(out, send.contiguous(), out_sizes, in_sizes, group=self.group)
        # the pieces arrive in peer order; each peer's source range starts where the
        # previous one's ends only in rank order, so order them by where they start
        starts = [max(src_displs[p], dst_displs[rank]) for p in range(self.size)]
        pieces = [piece for _, piece in sorted(zip(starts, out.split(out_sizes)), key=lambda t: t[0])]
        joined = torch.cat(pieces).view((dst_counts[rank],) + tuple(moved.shape[1:]))
        return _from_wire(joined.movedim(0, axis).contiguous(), dtype)

    @_collective
    def take(
        self, local: torch.Tensor, axis: int, counts: Sequence[int], index: torch.Tensor, replicate: bool = False,
        ranges: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> torch.Tensor:
        """The slices along ``axis`` at the global positions ``index`` (int64, the same on
        every rank) of an array whose rank ``r`` holds ``counts[r]`` consecutive slices:
        this rank's canonical chunk of the result, or with ``replicate`` all of it, or
        ``index[lo:hi]`` for this rank's ``ranges[rank] = (lo, hi)`` (every rank's range
        given, the same on every rank), in ``index`` order. One ``all_to_all_single``; each
        rank sends only the slices asked of it, never its whole chunk."""
        counts = [int(c) for c in counts]
        index = index.to(torch.int64).reshape(-1)
        if self.size == 1:
            lo, hi = (0, index.numel()) if ranges is None or replicate else ranges[0]
            return local.index_select(axis, index[lo:hi].to(local.device))
        index = index.to(local.device)
        m, rank = index.numel(), self.rank
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=local.device)
        owner = torch.searchsorted(ends, index, right=True)
        start = int(sum(counts[:rank]))
        if replicate:
            ranges = [(0, m)] * self.size
        elif ranges is not None:
            ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        else:
            c = -(-m // self.size) if m else 0
            ranges = [(min(r * c, m), min((r + 1) * c, m)) for r in range(self.size)]
        dtype = local.dtype
        moved = _to_wire(local).movedim(axis, 0)
        row = int(np.prod(moved.shape[1:]))
        # what this rank sends each peer, and the positions each peer's reply fills here
        send_parts, in_sizes = [], []
        for lo, hi in ranges:
            sel = index[lo:hi][owner[lo:hi] == rank] - start
            send_parts.append(moved.index_select(0, sel))
            in_sizes.append(sel.numel() * row)
        lo, hi = ranges[rank]
        mine = owner[lo:hi]
        positions = [torch.nonzero(mine == r).reshape(-1) for r in range(self.size)]
        out_sizes = [int(p.numel()) * row for p in positions]
        send = torch.cat([p.reshape(-1) for p in send_parts])
        out = moved.new_empty(sum(out_sizes))
        dist.all_to_all_single(out, send.contiguous(), out_sizes, in_sizes, group=self.group)
        result = moved.new_empty((hi - lo,) + tuple(moved.shape[1:]))
        result[torch.cat(positions)] = out.view((-1,) + tuple(moved.shape[1:]))
        return _from_wire(result.movedim(0, axis).contiguous(), dtype)

    @_collective
    def fetch(self, local: torch.Tensor, counts: Sequence[int], index: torch.Tensor) -> torch.Tensor:
        """The elements at this rank's own global positions ``index`` (int64, each rank its
        own list) of a 1-D array whose rank ``r`` holds ``counts[r]`` consecutive elements,
        in ``index`` order: each rank sends its positions to their owners and the owners
        answer with those elements (two ``all_to_all_single``, after one small gather of
        the P·P request counts), so no rank receives an element it did not ask for."""
        counts = [int(c) for c in counts]
        index = index.to(torch.int64).reshape(-1).to(local.device)
        if self.size == 1:
            return local[index]
        dtype = local.dtype
        moved = _to_wire(local)
        ends = torch.tensor(np.cumsum(counts), dtype=torch.int64, device=local.device)
        owner = torch.searchsorted(ends, index, right=True)
        order = torch.argsort(owner, stable=True)
        asked = torch.bincount(owner, minlength=self.size)
        table = self.all_gather_stacked(asked).tolist()  # table[r][q]: r asks q for so many
        send_sizes = [int(c) for c in asked.tolist()]
        recv_sizes = [int(table[r][self.rank]) for r in range(self.size)]
        wanted = index.new_empty(sum(recv_sizes))
        dist.all_to_all_single(wanted, index[order].contiguous(), recv_sizes, send_sizes, group=self.group)
        row = int(np.prod(moved.shape[1:]))
        reply = moved[wanted - sum(counts[: self.rank])].contiguous()
        got = moved.new_empty((index.numel(),) + tuple(moved.shape[1:]))
        dist.all_to_all_single(got.view(-1), reply.view(-1), [n * row for n in send_sizes],
                               [n * row for n in recv_sizes], group=self.group)
        result = torch.empty_like(got)
        result[order] = got
        return _from_wire(result, dtype)

    @_collective
    def exchange(self, tensor: torch.Tensor, peer: int, recv_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Send ``tensor`` to ``peer`` and receive what ``peer`` sends this rank (of
        ``recv_shape``, by default this tensor's): one send/recv pair, the block
        compare-exchange of the distributed sort."""
        recv_shape = tuple(tensor.shape) if recv_shape is None else tuple(int(s) for s in recv_shape)
        if peer == self.rank:  # ht: ignore[spmd-divergent-collective] -- pairwise exchange: a rank paired with itself has no partner waiting on it, and every other pair meets in its own send/recv
            return tensor
        dtype = tensor.dtype
        send = _to_wire(tensor).contiguous()
        recv = torch.empty(recv_shape, dtype=send.dtype, device=send.device)
        ops = []
        if send.numel():
            ops.append(dist.P2POp(dist.isend, send, self._global_rank(peer), self.group))
        if recv.numel():
            ops.append(dist.P2POp(dist.irecv, recv, self._global_rank(peer), self.group))
        for w in dist.batch_isend_irecv(ops) if ops else []:
            w.wait()
        return _from_wire(recv, dtype)

    @_collective
    def bcast(self, tensor: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Broadcast ``tensor`` from ``root`` (a rank of this communicator) in place and
        return it."""
        if self.size > 1:
            buf = _to_wire(tensor)
            dist.broadcast(buf, src=self._global_rank(root), group=self.group)
            if buf is not tensor:
                tensor.copy_(_from_wire(buf, tensor.dtype))
        return tensor

    @_collective
    def barrier(self) -> None:
        """Block until every rank of this communicator has reached it."""
        if self.size > 1:
            if dist.get_backend(self.group) == "nccl":
                dist.barrier(group=self.group, device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier(group=self.group)

    @_collective
    def agree_min(self, flag: int) -> int:
        """The least of every rank's integer ``flag``, the same on every rank: a branch
        taken on it cannot split the ranks' sequences of collectives (the checkpoint's
        agreement that turns one rank's failure into every rank's error)."""
        if self.size == 1:
            return int(flag)
        on_card = dist.get_backend(self.group) == "nccl"
        t = torch.tensor([int(flag)], dtype=torch.int64, device="cuda" if on_card else "cpu")
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return int(t.item())

    @_collective
    def allgather_object(self, obj) -> list:
        """Every rank's small picklable ``obj`` (metadata, not arrays), in rank order."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    @_collective
    def ring_shift(
        self, tensor: torch.Tensor, shift: int = 1, recv_shape: Optional[Sequence[int]] = None, async_op: bool = False
    ):
        """Rotate one tensor a rank around the ring (heat_tpu/core/communication.py:570): send
        ``tensor`` to rank ``(rank + shift) % size`` and receive from ``(rank - shift) %
        size`` a tensor of ``recv_shape`` (default: this tensor's shape; chunks may be
        ragged, so a caller whose peers hold other extents says what arrives). An empty
        message is neither sent nor received: both ends know its size. With ``async_op``
        the exchange is only started, and the returned handle's ``wait()`` gives the
        received tensor, so work on ``tensor`` can overlap its transfer."""
        recv_shape = tuple(tensor.shape) if recv_shape is None else tuple(int(s) for s in recv_shape)
        size = self.size
        if size == 1 or shift % size == 0:
            if recv_shape != tuple(tensor.shape):
                raise ValueError(f"ring_shift onto itself: recv_shape {recv_shape} is not {tuple(tensor.shape)}")
            return _Pending([], tensor, tensor.dtype) if async_op else tensor
        rank = self.rank
        dtype = tensor.dtype
        send = _to_wire(tensor).contiguous()
        recv = torch.empty(recv_shape, dtype=send.dtype, device=send.device)
        ops = []
        if send.numel():
            ops.append(dist.P2POp(dist.isend, send, self._global_rank((rank + shift) % size), self.group))
        if recv.numel():
            ops.append(dist.P2POp(dist.irecv, recv, self._global_rank((rank - shift) % size), self.group))
        works = dist.batch_isend_irecv(ops) if ops else []
        handle = _Pending(works, recv, dtype, keep=send)
        return handle if async_op else handle.wait()

    def ring_blocks(self, block: torch.Tensor, shape_of):
        """The ring schedule of heat_tpu's ring algorithms (``_ring_body``,
        ``_ring_pairwise``): yield ``(src, blk)`` ``size`` times, ``blk`` being the block of
        rank ``src = (rank - i) % size`` at step ``i``, starting from this rank's
        ``block``. Each block's hop to the next rank starts before it is yielded, so the
        caller's work on it overlaps the transfer, and the last one makes no hop.
        ``shape_of(r)`` is the shape of rank ``r``'s block (blocks may be ragged)."""
        size, rank = self.size, self.rank
        blk = block.contiguous()
        for i in range(size):
            src = (rank - i) % size
            pending = self.ring_shift(blk, 1, shape_of((src - 1) % size), async_op=True) if i < size - 1 else None
            yield src, blk
            if pending is not None:
                blk = pending.wait()

    @_collective
    def all_to_all(
        self, tensor: torch.Tensor, split_axis: int, concat_axis: int, concat_extent: Optional[int] = None
    ) -> torch.Tensor:
        """All-to-all (heat_tpu/core/communication.py:549): cut ``tensor`` along
        ``split_axis`` into every rank's chunk (the ceil-division rule over its extent
        here, the global one) and send chunk ``r`` to rank ``r``; the chunks received are
        joined along ``concat_axis`` in rank order. ``concat_extent`` is the global
        extent along ``concat_axis``, whose chunks by the same rule are what each rank
        sends (None: every rank holds this rank's extent there). Chunks may be ragged or
        empty: every count comes from :meth:`counts_displs_shape`, none from the local
        tensor alone. One ``all_to_all_single`` over flat buffers."""
        nd = tensor.ndim
        split_axis, concat_axis = split_axis % nd, concat_axis % nd
        if split_axis == concat_axis:
            raise ValueError(f"all_to_all: split and concat axis are both {split_axis}")
        if self.size == 1:
            return tensor
        local = list(tensor.shape)
        if concat_extent is None:
            concat_extent = local[concat_axis] * self.size
        send_counts, _, _ = self.counts_displs_shape(local, split_axis)
        recv_counts, _, _ = self.counts_displs_shape(local[:concat_axis] + [concat_extent] + local[concat_axis + 1 :], concat_axis)
        if recv_counts[self.rank] != local[concat_axis]:  # ht: ignore[spmd-divergent-collective] -- argument check, not a branch of a correct call: a rank whose extent disagrees with the chunk rule is the caller's error and raises at once; its peers' collective then ends at the group's timeout (typed by the supervision watchdog when armed)
            raise ValueError(
                f"all_to_all: this rank holds {local[concat_axis]} along axis {concat_axis}, the chunk rule "
                f"over {concat_extent} gives it {recv_counts[self.rank]}"
            )
        dtype = tensor.dtype
        moved = _to_wire(tensor).movedim(split_axis, 0).contiguous()
        rest = list(moved.shape[1:])
        c = concat_axis - 1 if concat_axis > split_axis else concat_axis  # concat_axis in ``rest``
        mine = send_counts[self.rank]
        others = int(np.prod(rest[:c] + rest[c + 1 :]))  # the elements beside both axes
        in_sizes = [n * int(np.prod(rest)) for n in send_counts]
        out_sizes = [mine * others * n for n in recv_counts]
        out = moved.new_empty(sum(out_sizes))
        dist.all_to_all_single(out, moved.reshape(-1), out_sizes, in_sizes, group=self.group)
        blocks = [
            part.view([mine] + rest[:c] + [n] + rest[c + 1 :]) for part, n in zip(out.split(out_sizes), recv_counts)
        ]
        return _from_wire(torch.cat(blocks, dim=c + 1).movedim(0, split_axis), dtype).contiguous()

    @_collective
    def reduce_scatter(self, tensor: torch.Tensor, scatter_axis: int = 0) -> torch.Tensor:
        """Sum ``tensor`` over the ranks and keep this rank's chunk of the sum along
        ``scatter_axis`` by the ceil-division rule (heat_tpu's ``psum_scatter``,
        heat_tpu/core/communication.py:531): the (P−1)/P half of an all-reduce, for a
        result that stays split. Even chunks take one ``reduce_scatter_tensor``; ragged
        or empty ones an all-to-all of the chunks and a sum in rank order."""
        if self.size == 1:
            return tensor
        scatter_axis = scatter_axis % tensor.ndim
        shape = list(tensor.shape)
        counts, _, _ = self.counts_displs_shape(shape, scatter_axis)
        moved = tensor.movedim(scatter_axis, 0).contiguous()
        if tensor.dtype not in _CARRIERS and len(set(counts)) == 1:  # ht: ignore[spmd-divergent-collective] -- counts is the chunk rule over every rank (counts_displs_shape's first element), the same tuple on every rank; only its third element, this rank's lshape, depends on the rank, and the checker's return taint is per function, not per element
            out = moved.new_empty((counts[0],) + tuple(moved.shape[1:]))
            _reduce_scatter(out, moved, group=self.group)
            return out.movedim(0, scatter_axis).contiguous()
        # ragged: every rank's copy of this rank's chunk, stacked on a new leading axis
        stacked = self.all_to_all(moved.unsqueeze(0), split_axis=1, concat_axis=0, concat_extent=self.size)
        summed = stacked.sum(dim=0) if tensor.dtype != torch.bool else stacked.any(dim=0)
        return summed.to(tensor.dtype).movedim(0, scatter_axis).contiguous()

    def _global_rank(self, group_rank: int) -> int:
        """The default group's rank of ``group_rank`` in this communicator's group (the
        point-to-point calls take global ranks)."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)


class _Pending:
    """An exchange in flight: ``wait()`` finishes it and gives the received tensor. The
    send buffer is kept until then, as the transfer reads it."""

    def __init__(self, works, recv: torch.Tensor, dtype: torch.dtype, keep: Optional[torch.Tensor] = None):
        self._works, self._recv, self._dtype, self._keep = works, recv, dtype, keep

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._works, self._keep = [], None
        return _from_wire(self._recv, self._dtype)


def _displs(counts: Sequence[int]) -> List[int]:
    """Displacements of consecutive ``counts``: their exclusive running sum."""
    return np.concatenate([[0], np.cumsum(counts, dtype=np.int64)[:-1]]).astype(np.int64).tolist() if len(counts) else []


# reduce_scatter_single is reduce_scatter_tensor's newer name in torch.distributed
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


# the default communicator: the default process group, or a single rank
Communication = TorchCommunication  # heat_tpu's name of the communicator class


class _SelfCommunication(TorchCommunication):
    """This rank alone: size 1 and rank 0 whatever the process group, so every
    collective returns before it reaches ``torch.distributed``."""

    @property
    def size(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    def __repr__(self) -> str:
        return "TorchCommunication(self)"


COMM_WORLD = TorchCommunication()
COMM_SELF = _SelfCommunication()
__default_comm = COMM_WORLD


def get_comm() -> TorchCommunication:
    """The current default communicator."""
    return __default_comm


def use_comm(comm: Optional[TorchCommunication] = None) -> None:
    """Set the default communicator (None: the world)."""
    global __default_comm
    __default_comm = COMM_WORLD if comm is None else sanitize_comm(comm)


def sanitize_comm(comm: Optional[TorchCommunication]) -> TorchCommunication:
    """Validate ``comm`` or return the default."""
    if comm is None:
        return get_comm()
    if isinstance(comm, TorchCommunication):
        return comm
    raise TypeError(f"Unknown communication, must be a TorchCommunication, got {type(comm)}")


def initialize(init_method: str = "env://") -> None:
    """Join the process group of a multi-process launch (``torchrun``): rank and world
    size from ``RANK`` and ``WORLD_SIZE``, the rendezvous from ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``init_method="env://"``; another method, such as a file, may be
    given). The backend follows the default device: NCCL with one card a process, the
    card of ``LOCAL_RANK``, when the device is the card, and gloo when the CPU was asked
    for (``use_device("cpu")``). Without CUDA on the card's path it raises; it never
    falls back to gloo. Then the telemetry clock handshake runs over the group's store
    and the supervision plane is armed on it (:func:`_telemetry_bootstrap`); an elastic
    restart re-joins through :func:`supervision.bootstrap_distributed`."""
    from .devices import get_device

    on_card = get_device().device_type != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: the device is the card, but CUDA is not available")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    rank = int(os.environ["RANK"])
    dist.init_process_group("nccl" if on_card else "gloo", init_method=init_method, rank=rank,
                            world_size=int(os.environ["WORLD_SIZE"]))
    _telemetry_bootstrap()


# Every bootstrap (each initialize() and each elastic restart) gets its own barrier
# namespace: the store's keys are scoped per use, and every process counts its
# bootstraps in the same order, so a re-init re-anchors instead of failing the
# handshake.
_handshake_generation = 0


def _telemetry_bootstrap() -> None:
    """Stamp this process's rank into ht.telemetry (and for rank-targeted fault
    plans) and, on multi-process jobs, run the boot-time clock-offset handshake
    (heat_tpu/core/communication.py:786-844): a supervised barrier over the job's
    store, then every process samples ``time.monotonic_ns()`` and publishes it
    through the store — the zero point that lets ``telemetry.merge`` align trace
    timestamps across ranks. No collective and nothing on the card. A failed
    handshake degrades to unaligned anchors, recorded on the resilience stream.
    Afterwards the supervision plane is armed for the job."""
    global _handshake_generation
    rank = dist.get_rank() if _initialized() else 0
    world = dist.get_world_size() if _initialized() else 1
    try:
        telemetry.set_process_info(rank, world)
        resilience.set_fault_rank(rank)  # rank-targeted fault-plan entries fire on this process
        if world > 1 and os.environ.get("HEAT_TPU_TELEMETRY_HANDSHAKE") != "0":
            co = supervision.default_coordinator()
            if co is None:
                raise RuntimeError("the process group has no store")
            gen = _handshake_generation
            _handshake_generation += 1  # ht: ignore[lock-racing-increment] -- bootstrap-only: runs inside initialize() and an elastic restart's re-join, both single-threaded launch paths; SPMD symmetry (not thread-safety) is what keeps the counter aligned
            # boot-time liveness wait, capped at 60 s: the plane is not armed yet,
            # so a peer that died before the handshake cannot abort it mid-wait
            boot_ms = min(supervision.coord_timeout_ms(), 60_000)
            supervision.kv_barrier(
                f"heat_tpu/telemetry/clock/{gen}", nprocs=world, rank=rank, timeout_ms=boot_ms,
                site="telemetry.handshake", coordinator=co,
            )
            anchor = time.monotonic_ns()
            co.set(f"heat_tpu/telemetry/anchor/{gen}/{rank}", str(anchor))
            anchors = [
                int(supervision.kv_wait(f"heat_tpu/telemetry/anchor/{gen}/{i}", boot_ms,
                                        site="telemetry.handshake", coordinator=co))
                for i in range(world)
            ]
            telemetry.record_clock_anchor(anchor, anchors)
    except Exception as exc:
        diagnostics.record_resilience_event("telemetry.handshake", "degraded", f"{type(exc).__name__}: {exc}")
    supervision.auto_arm()
