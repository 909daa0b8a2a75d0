"""Data-parallel optimizers (counterpart of heat_tpu/optim/dp_optimizer.py).

:class:`DataParallelOptimizer` wraps a ``torch.optim.Optimizer`` and runs one training
step over a batch split across ranks: this rank's forward and backward on its rows, one
packed all-reduce of every gradient and the loss through the communicator (the only
collective of the step), and the local optimizer's update, equal on every rank. heat_tpu's
step is one jitted ``value_and_grad`` plus an optax update over the global sharded batch,
whose gradient reduction XLA inserts; the two give the same step.

``DASO`` (the reference's hierarchical asynchronous optimizer) needs node-local and global
process groups and is not ported yet (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray

__all__ = ["DataParallelOptimizer", "DASO"]

# heat_tpu's string specs and their counterparts, at their defaults (optax.sgd, optax.adam)
_BY_NAME = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}


def _local_batch(batch) -> Tuple[tuple, float]:
    """This rank's tensors of ``batch`` and their weight in the global mean: a DNDarray
    becomes its local tensor, anything else passes as it is; the weight is this rank's
    share n_local / n of the rows along the split axis of the split DNDarrays (1 when
    none is split), which must agree in their length along it."""
    local = tuple(b.larray if isinstance(b, DNDarray) else b for b in batch)
    extents = {(b.lshape[b.split], b.gshape[b.split]) for b in batch if isinstance(b, DNDarray) and b.split is not None}
    if len(extents) > 1:
        raise ValueError(f"the split batch arrays disagree in their split extent: {sorted(extents)}")
    if not extents:
        return local, 1.0
    n_local, n = extents.pop()
    return local, (n_local / n if n else 0.0)


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
        local, weight = _local_batch(batch)
        params = [p for group in self.local_optimizer.param_groups for p in group["params"]]
        self.local_optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
        if weight > 0:
            with full_fp32_matmul():
                value = loss_fn(self._model, *local)
                value.backward()
            loss = value.detach()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        comm = self._model.comm
        if comm.is_distributed():
            reduced = comm.all_reduce_packed([g * weight for g in grads] + [(loss * weight).reshape(1)])
            grads, loss = reduced[:-1], reduced[-1][0]
        for p, g in zip(params, grads):
            p.grad = g
        self.local_optimizer.step()
        return loss


class DASO:
    """Distributed Asynchronous and Selective Optimization (heat_tpu's ``DASO``): not
    ported yet. It trains node-local replicas that a phase machine re-averages over the
    slow axis, and needs node-local and global process groups (ROADMAP.md Queue 1 item 8)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DASO is not ported yet: it needs node-local and global process groups (ROADMAP.md Queue 1 item 8)"
        )
