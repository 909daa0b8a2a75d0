"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

:class:`DataParallelOptimizer` wraps a ``torch.optim.Optimizer`` and runs one training
step over a batch split across ranks: this rank's forward and backward on its rows, one
packed all-reduce of every gradient and the loss through the communicator (the only
collective of the step), and the local optimizer's update, equal on every rank. heat_tpu's
step is one jitted ``value_and_grad`` plus an optax update over the global sharded batch,
whose gradient reduction XLA inserts; the two give the same step.

:class:`DASO` (the reference's hierarchical asynchronous optimizer) trains one replica a
node group: the ranks of a node reduce their gradients over the node's process group, and
a phase machine decides when the replicas are re-averaged across the nodes, with the
deltas rounded to bfloat16 for the wire.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import profiler
from ..core.communication import TorchCommunication, sanitize_comm
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray
from ..nn.functional import batch_rows
from .utils import DetectMetricPlateau

__all__ = ["DataParallelOptimizer", "DASO"]

# heat_tpu's string specs and their counterparts, at their defaults (optax.sgd, optax.adam)
_BY_NAME = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}


def _local_batch(batch) -> Tuple[tuple, float, Optional[tuple]]:
    """This rank's tensors of ``batch``, their weight in the global mean and their rows: a
    DNDarray becomes its local tensor, anything else passes as it is; the weight is this
    rank's share n_local / n of the rows along the split axis of the split DNDarrays (1
    when none is split), which must agree in their split axis and length along it; the rows
    are (split axis, first row, n_local, n) for :func:`~heat_tpu_torch.nn.functional.batch_rows`,
    None when none is split."""
    local = tuple(b.larray if isinstance(b, DNDarray) else b for b in batch)
    extents = {
        (b.split, b.comm.chunk(b.gshape, b.split)[0], b.lshape[b.split], b.gshape[b.split])
        for b in batch if isinstance(b, DNDarray) and b.split is not None
    }
    if len(extents) > 1:
        raise ValueError(f"the split batch arrays disagree in their split extent: {sorted(extents)}")
    if not extents:
        return local, 1.0, None
    rows = extents.pop()
    return local, (rows[2] / rows[3] if rows[3] else 0.0), rows


class DataParallelOptimizer:
    """Wrap a local optimizer for data-parallel training (heat_tpu's
    ``DataParallelOptimizer``, the reference's ``:851``).

    Parameters
    ----------
    torch_optimizer : torch.optim.Optimizer or str
        The local optimizer: "sgd" or "adam" (``torch.optim.SGD`` / ``torch.optim.Adam`` at
        their defaults with learning rate ``lr``, made over the model's parameters when a
        :class:`~heat_tpu_torch.nn.DataParallel` attaches this optimizer), or an optimizer
        already made over them.
    blocking : bool
        Kept for API parity: the gradients are reduced in one blocking collective.
    lr : float
        The learning rate of a string spec; an optimizer instance keeps its own.
    """

    def __init__(self, torch_optimizer=None, blocking: bool = False, lr: float = 0.01):
        if not isinstance(blocking, bool):
            raise TypeError(f"blocking parameter must be a boolean, currently {type(blocking)}")
        if torch_optimizer is None:
            torch_optimizer = "sgd"
        if isinstance(torch_optimizer, str):
            if torch_optimizer not in _BY_NAME:
                raise ValueError(f"unknown optimizer {torch_optimizer!r}, expected one of {sorted(_BY_NAME)}")
            self._lr = float(lr)
            self.local_optimizer: Optional[torch.optim.Optimizer] = None
        elif isinstance(torch_optimizer, torch.optim.Optimizer):
            self._lr = float(torch_optimizer.param_groups[0]["lr"])
            self.local_optimizer = torch_optimizer
        else:
            raise TypeError(f"torch_optimizer must be 'sgd', 'adam' or a torch.optim.Optimizer, got {type(torch_optimizer)}")
        self._spec = torch_optimizer
        self.blocking_parameter_updates = blocking
        self._model = None

    @property
    def torch_optimizer(self) -> Optional[torch.optim.Optimizer]:
        """The local optimizer (made at attach time for a string spec)."""
        return self.local_optimizer

    @property
    def lr(self) -> float:
        """Current learning rate (mutable; consumed by heat_tpu_torch.optim.lr_scheduler):
        setting it writes every parameter group's ``lr``."""
        return self._lr

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr = float(value)
        if self.local_optimizer is not None:
            for group in self.local_optimizer.param_groups:
                group["lr"] = self._lr

    def _attach(self, model) -> None:
        self._model = model
        if isinstance(self._spec, str):
            params = [p for p in model.parameters() if p.requires_grad]
            self.local_optimizer = _BY_NAME[self._spec](params, lr=self._lr)

    def zero_grad(self) -> None:
        """Clear the local optimizer's gradients (``step`` starts from none either way)."""
        if self.local_optimizer is not None:
            self.local_optimizer.zero_grad(set_to_none=True)

    def step(self, loss_fn: Optional[Callable] = None, *batch) -> torch.Tensor:
        """One training step; returns the global loss as a 0-d tensor on the device.

        ``loss_fn(model, *local_batch)`` is called with the attached
        :class:`~heat_tpu_torch.nn.DataParallel` in place of heat_tpu's parameter tree
        and this rank's tensors of ``batch``; it must return the mean loss over the rows of
        the split axis (as ``CrossEntropyLoss`` over sequences of one length does). The
        step:

        1. takes this rank's rows of each split DNDarray (a DNDarray that is not split
           whole, tensors as they are);
        2. runs ``loss_fn`` and ``backward()``, both with TF32 off (heat_tpu computes in
           f32), unless this rank holds no rows: it then contributes zeros;
        3. weights the gradients and the loss by this rank's share n_local / n of the rows,
           so that their sum over ranks is the gradient of the global mean even when the
           chunks differ in size;
        4. sums them over ranks in one packed all-reduce (none at world 1);
        5. applies the local optimizer. A parameter without a gradient gets zeros, as
           ``jax.grad`` gives heat_tpu's optax update.
        """
        if self._model is None:
            raise RuntimeError("optimizer is not attached to a DataParallel model")
        if loss_fn is None:
            raise TypeError("step() requires loss_fn(model, *batch)")
        local, weight, rows = _local_batch(batch)
        return self._reduced_step(loss_fn, local, weight, self._model.comm, rows)

    def _reduced_step(self, loss_fn: Callable, local: tuple, weight: float, comm: TorchCommunication,
                      rows: Optional[tuple] = None) -> torch.Tensor:
        """Steps 2-5 of :meth:`step` over ``comm``: this rank's rows ``local`` carry the
        share ``weight`` of the rows that ``comm``'s ranks train on together. ``rows``
        (axis, first row, rows here, rows in all) places them in the batch that heat_tpu's
        program holds whole, so that keyed masks drawn in ``loss_fn`` are that batch's
        (:func:`~heat_tpu_torch.nn.functional.batch_rows`). Returns the loss over those
        rows.

        Phases (``ht.profiler``, each also timed on a CUDA device): ``step.forward``
        (``loss_fn``), ``step.backward``, ``step.reduce`` (the all-reduce, at world > 1)
        and ``step.update`` (the gradients set and the local optimizer's step)."""
        params = [p for group in self.local_optimizer.param_groups for p in group["params"]]
        device = params[0].device
        self.local_optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=device)
        if weight > 0:
            with full_fp32_matmul(), batch_rows(*rows) if rows is not None else contextlib.nullcontext():
                with profiler.phase("step.forward", device):
                    value = loss_fn(self._model, *local)
                with profiler.phase("step.backward", device):
                    value.backward()
            loss = value.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if comm.is_distributed():
            with profiler.phase("step.reduce", device):
                reduced = comm.all_reduce_packed([g * weight for g in grads] + [(loss * weight).reshape(1)])
                grads, loss = reduced[:-1], reduced[-1][0]
        with profiler.phase("step.update", device):
            for p, g in zip(params, grads):
                p.grad = g
            self.local_optimizer.step()
        return loss


def wire_deltas(params: List[torch.Tensor], refs: List[torch.Tensor], wire: Optional[torch.dtype]) -> torch.Tensor:
    """One replica's side of DASO's global sync: its floating parameters' deltas from the
    reference replica, ``p − ref``, each rounded once to ``wire`` (None: kept) and packed
    into one flat buffer for the gather. A delta keeps bfloat16's full relative precision,
    so an update far below the weight's own bfloat16 ulp survives the sync."""
    deltas = [(p.detach() - r).reshape(-1) for p, r in zip(params, refs)]
    flat = torch.cat(deltas) if deltas else torch.empty(0)
    return flat if wire is None else flat.to(wire)


def synced_params(refs: List[torch.Tensor], gathered: torch.Tensor) -> List[torch.Tensor]:
    """The synced parameters from the reference replica's ``refs`` and every node's
    :func:`wire_deltas` stacked in node order (``gathered``, (n_nodes, numel)): ``ref +
    mean``, the deltas summed in float32 in node order and divided by the node count, as
    heat_tpu's ``ref + mean(delta.astype(f32))`` (``dp_optimizer.py:512-519``). A bfloat16
    all-reduce would round its partial sums in bfloat16 instead. Rank-local: the same on
    every rank, and on virtual replicas with ``torch.stack`` in place of the gather."""
    acc = gathered[0].to(torch.float32)
    for j in range(1, gathered.shape[0]):
        acc = acc + gathered[j].to(torch.float32)
    mean = acc / gathered.shape[0]
    out, at = [], 0
    for r in refs:
        out.append(r + mean[at : at + r.numel()].view(r.shape).to(r.dtype))
        at += r.numel()
    return out


class DASO:
    """Distributed Asynchronous and Selective Optimization (heat_tpu's ``DASO``, the
    reference's ``:64``).

    The phase machine is heat_tpu's: warmup (a global sync every step), cycling (a sync
    every ``global_skip`` batches, the skips divided on a loss plateau and cycled back up
    at 1), cooldown (every step again).

    Mechanism: ``comm`` is a :meth:`TorchCommunication.hierarchical` communicator of
    ``n_nodes`` node groups. Each node's ranks train one replica of the model on the
    node's rows of the global batch (node ``j`` takes rows ``[j·B/n, (j+1)·B/n)``, as
    heat_tpu's reshape ``(n, B/n)``): their gradients are weighted by their share of the
    node's rows and all-reduced over the node's group, so the replicas diverge between
    global syncs as heat_tpu's per-node replicas do. ``_global_sync`` broadcasts node 0's
    parameters over each cross-node group as the reference, rounds every replica's delta
    to ``downcast_type`` for the wire, gathers the deltas over the cross-node group, sums
    them in float32 in node order and writes ``ref + mean`` into every replica
    (:func:`wire_deltas`, :func:`synced_params`). A rank's module is its node's replica.
    At ``n_nodes == 1`` a step is the local optimizer's data-parallel step, as heat_tpu's.
    ``sending_chunk_size`` and ``use_mpi_groups`` are kept for API parity.
    """

    def __init__(
        self,
        local_optimizer: DataParallelOptimizer,
        total_epochs: int,
        comm: Optional[TorchCommunication] = None,
        warmup_epochs: int = 4,
        cooldown_epochs: int = 4,
        scheduler=None,
        stability_level: float = 0.05,
        max_global_skips: int = 8,
        sending_chunk_size: int = 10_000_000,
        downcast_type=torch.bfloat16,
        use_mpi_groups: bool = True,
        skip_reduction_factor: int = 2,
        local_skip_factor: int = 4,
        verbose: bool = False,
    ):
        if not isinstance(total_epochs, int) or total_epochs <= 0:
            raise TypeError(f"total_epochs must be a positive int, got {total_epochs}")
        if warmup_epochs < 0 or cooldown_epochs < 0:
            raise ValueError("warmup/cooldown epochs must be non-negative")
        if warmup_epochs + cooldown_epochs > total_epochs:
            raise ValueError("warmup + cooldown epochs exceed total_epochs")
        self.local_optimizer = local_optimizer
        self.total_epochs = total_epochs
        self.comm = sanitize_comm(comm)
        self.warmup_epochs = warmup_epochs
        self.cooldown_epochs = cooldown_epochs
        self.scheduler = scheduler
        # the reference's plateau detector drives the skip schedule (DetectMetricPlateau(
        # patience=2, threshold=level), dp_optimizer.py:244)
        self.stability = DetectMetricPlateau(patience=2, threshold=stability_level)
        self.stability_level = stability_level
        self.max_global_skips = max_global_skips
        self.sending_chunk_size = sending_chunk_size
        self.downcast_type = downcast_type
        self.use_mpi_groups = use_mpi_groups
        self.skip_reduction_factor = skip_reduction_factor
        self.local_skip_factor = local_skip_factor
        self.verbose = verbose
        self.global_skip = 0
        self.local_skip = 0
        self.batches_to_wait = 0
        self.epoch = 0
        self._batch_in_epoch = 0
        self._phase = "warmup"
        if warmup_epochs == 0:
            self._start_cycling()

    def add_scaler(self, scaler) -> None:
        """Kept for API parity (the reference attaches a torch AMP GradScaler); stored."""
        self.scaler = scaler

    def set_model(self, model) -> None:
        """Attach the :class:`~heat_tpu_torch.nn.DataParallel` model whose parameters DASO
        trains, through the local optimizer (which makes its optimizer over them)."""
        self.local_optimizer._attach(model)

    _attach = set_model  # DataParallel attaches its optimizers by this name

    def reset(self) -> None:
        """Reset the phase machine to its base state (reference ``:711``)."""
        self.stability.reset()
        self.global_skip = 0
        self.local_skip = 0
        self.batches_to_wait = 0
        self.epoch = 0
        self._batch_in_epoch = 0
        self._phase = "warmup"
        if self.warmup_epochs == 0:
            self._start_cycling()

    # ------------------------------------------------------------------ phase machine
    def _start_cycling(self) -> None:
        # the reference's post-warmup schedule (dp_optimizer.py:392-396: gs=4, ls=1,
        # btw=1), capped by the user's max
        self._phase = "cycling"
        self.global_skip = min(4, self.max_global_skips)
        self.local_skip = 1
        self.batches_to_wait = 1

    def epoch_loss_logic(self, loss, loss_globally_averaged: bool = False) -> None:
        """Drive the skip schedule from the epoch's training loss (reference ``:354``): the
        loss is averaged over the ranks unless ``loss_globally_averaged``; on a plateau
        (patience 2) with ``global_skip > 1`` the skips are divided by
        ``skip_reduction_factor``, at ``global_skip == 1`` they cycle back up to
        ``max_global_skips``."""
        loss_value = float(loss.detach() if isinstance(loss, torch.Tensor) else loss)
        if not loss_globally_averaged and self.comm.is_distributed():
            # heat_tpu gathers every process's loss and takes their mean (:372-377)
            loss_value = float(np.mean(self.comm.allgather_object(loss_value)))
        if self._phase != "cycling":
            return
        stable = self.stability.test_if_improving(loss_value)
        if stable and self.global_skip > 1:
            # floor at 1 so the schedule always reaches the cycle-up branch below
            self.global_skip = max(self.global_skip // self.skip_reduction_factor, 1)
            self.local_skip = max(self.local_skip // self.skip_reduction_factor, 1)
            self.batches_to_wait = max(self.batches_to_wait - 1, 1)
            if self.verbose:
                self.print0(f"DASO: plateau, dropping skips -> {self.global_skip}")
        elif stable and self.global_skip == 1:
            self.global_skip = self.max_global_skips
            self.local_skip = max(self.max_global_skips // self.local_skip_factor, 1)
            self.batches_to_wait = max(self.max_global_skips // self.local_skip_factor, 1)
            if self.verbose:
                self.print0(f"DASO: plateau at skip 1, cycling up -> {self.global_skip}")

    def epoch_end(self) -> None:
        """Advance the phase machine at the end of an epoch (reference ``:747-832``)."""
        self.epoch += 1
        self._batch_in_epoch = 0
        if self.epoch >= self.total_epochs - self.cooldown_epochs:
            self._phase = "cooldown"
            self.global_skip = 0
            self.local_skip = 0
        elif self.epoch >= self.warmup_epochs and self._phase == "warmup":
            self._start_cycling()
        self.sync_model_params()

    def last_batch(self) -> None:
        """Force a final full sync (reference ``:735``)."""
        self.global_skip = 0

    def sync_model_params(self) -> None:
        """Kept for API parity: heat_tpu copies replica 0 into the user-visible
        parameters here; a rank's module already is its node's replica."""

    # ------------------------------------------------------------------ replicas
    @property
    def n_nodes(self) -> int:
        return self.comm.n_nodes

    @property
    def lr(self) -> float:
        """Learning rate of the local optimizer (scheduler-mutable)."""
        return self.local_optimizer.lr

    @lr.setter
    def lr(self, value: float) -> None:
        self.local_optimizer.lr = value

    def _named_params(self) -> List[Tuple[str, torch.Tensor]]:
        model = self.local_optimizer._model
        if model is None:
            raise RuntimeError("DASO's local optimizer is not attached to a model")
        return [(n, p) for n, p in model.module.named_parameters()]

    @property
    def stacked_params(self) -> Dict[str, torch.Tensor]:
        """Every node's replica of each parameter, (n_nodes, ...) in node order: a gather
        over this rank's cross-node group (for tests and inspection)."""
        return {n: self.comm.cross_comm.all_gather_stacked(p.detach()) for n, p in self._named_params()}

    @stacked_params.setter
    def stacked_params(self, value: Dict[str, torch.Tensor]) -> None:
        node = self.comm.node if self.n_nodes > 1 else 0
        with torch.no_grad():
            for n, p in self._named_params():
                p.copy_(value[n][node])

    def consolidated_params(self) -> Dict[str, torch.Tensor]:
        """One synced copy of the parameters: the mean over the node replicas."""
        return {n: s.mean(dim=0) for n, s in self.stacked_params.items()}

    # ------------------------------------------------------------------ stepping
    def _should_global_sync(self) -> bool:
        if self._phase in ("warmup", "cooldown") or self.global_skip <= 1:
            return True
        return self._batch_in_epoch % self.global_skip == 0

    def _node_rows(self, batch) -> Tuple[tuple, float, tuple]:
        """This rank's rows of its node's share of ``batch``, and their weight in the
        node's mean: node ``j`` takes rows ``[j·B/n, (j+1)·B/n)`` of every array, chunked
        over the node's ranks by the ceil-division rule. A split DNDarray moves there by
        one ``redistribute`` (none when its chunks are already those); an unsplit one or
        a tensor, whole on every rank, is sliced. Also returns this rank's rows of the
        node's batch (0, first, count, rows of the node): heat_tpu maps one program over
        the node batches, with one key, so each node draws its mask over its own rows."""
        comm, n = self.comm, self.n_nodes
        per_node, node, local_rank = comm.node_size, comm.node, comm.local_rank
        out, rows = [], None
        for b in batch:
            whole = b.larray if isinstance(b, DNDarray) and b.split is None else b
            total = b.gshape[0] if isinstance(b, DNDarray) else whole.shape[0]
            if total % n:
                raise ValueError(f"batch size {total} not divisible by n_nodes={n}")
            m = total // n
            c = -(-m // per_node) if m else 0
            lo, hi = min(local_rank * c, m), min((local_rank + 1) * c, m)
            rows = (lo, hi - lo, m)
            if isinstance(b, DNDarray) and b.split is not None:
                if b.split != 0:
                    raise ValueError(f"DASO splits the batch along axis 0, got an array split along {b.split}")
                src, _, _ = b.comm.counts_displs_shape(b.gshape, 0)
                counts, displs = [], []
                for r in range(comm.size):
                    rl = r % per_node
                    counts.append(min((rl + 1) * c, m) - min(rl * c, m))
                    displs.append((r // per_node) * m + min(rl * c, m))
                if list(src) == counts and displs == [sum(counts[:r]) for r in range(comm.size)]:
                    out.append(b.larray)
                else:
                    out.append(b.comm.redistribute(b.larray, b.gshape, 0, src, counts, dst_displs=displs))
            else:
                out.append(whole[node * m + lo : node * m + hi])
        first, n_local, m = rows if rows is not None else (0, 0, 0)
        return tuple(out), (n_local / m if m else 0.0), (0, first, n_local, m)

    def step(self, loss_fn: Optional[Callable] = None, *batch) -> torch.Tensor:
        """A node-local optimizer step on each node's replica and, on the phase machine's
        cadence, the global sync (reference step machine ``:747-832``). Returns the mean
        over the nodes of their losses."""
        if loss_fn is None:
            raise TypeError("step() requires loss_fn(model, *batch)")
        if self.n_nodes == 1:
            # one node group has nothing to diverge from or sync with: DASO is the plain
            # data-parallel step (heat_tpu's dp_optimizer.py:433-441)
            loss = self.local_optimizer.step(loss_fn, *batch)
            self._batch_in_epoch += 1
            return loss
        if self.local_optimizer._model is None:
            raise RuntimeError("DASO's local optimizer is not attached to a model")
        local, weight, rows = self._node_rows(batch)
        loss = self.local_optimizer._reduced_step(loss_fn, local, weight, self.comm.node_comm, rows)
        loss = self.comm.cross_comm.all_reduce(loss.reshape(1).clone(), "sum")[0] / self.n_nodes
        if self._should_global_sync():
            self._global_sync()
        self._batch_in_epoch += 1
        return loss

    def _global_sync(self) -> None:
        """Re-average the node replicas (reference ``_global_sync :450``): node 0's
        parameters broadcast over each cross-node group as the reference, every replica's
        delta rounded to ``downcast_type``, the deltas gathered over the cross-node group
        and ``ref + mean`` written back (:func:`synced_params`). Integer parameters are
        left as they are, as heat_tpu's."""
        cross = self.comm.cross_comm
        params = [p for _, p in self._named_params() if p.is_floating_point()]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        with torch.no_grad():
            for group in by_dtype.values():
                flat_ref = cross.bcast(torch.cat([p.detach().reshape(-1) for p in group]), root=0)
                refs, at = [], 0
                for p in group:
                    refs.append(flat_ref[at : at + p.numel()].view(p.shape))
                    at += p.numel()
                gathered = cross.all_gather_stacked(wire_deltas(group, refs, self.downcast_type))
                for p, new in zip(group, synced_params(refs, gathered)):
                    p.copy_(new)

    def print0(self, *args, **kwargs) -> None:
        """Print from rank 0 only (reference ``:704``)."""
        if self.comm.rank == 0:
            print(*args, **kwargs)

    def zero_grad(self) -> None:
        self.local_optimizer.zero_grad()
