"""Data-parallel model wrappers (counterpart of heat_tpu/nn/data_parallel.py).

Every rank holds a whole copy of the model and trains it on its own rows of a batch split
along axis 0. :class:`DataParallel` makes the copies equal at the start, as the reference
Heat does: rank 0's parameters and buffers are broadcast to the others (heat_tpu derives
them from one seed instead, ``data_parallel.py:48-52``). The gradients are reduced by the
attached :class:`~heat_tpu_torch.optim.DataParallelOptimizer`, one packed all-reduce per
step through the communicator, so the copies stay equal.
"""

from __future__ import annotations

import itertools
from typing import Optional

import torch

from ..core.communication import TorchCommunication, sanitize_comm

__all__ = ["DataParallel", "DataParallelMultiGPU"]


class DataParallel(torch.nn.Module):
    """Run the same ``torch.nn.Module`` on every rank's shard of a split batch (heat_tpu's
    ``DataParallel``, the reference's ``:22``).

    ``optimizer`` (one :class:`~heat_tpu_torch.optim.DataParallelOptimizer` or a list of
    them) is attached to this wrapper, whose ``step`` then trains the module.
    ``blocking_parameter_updates`` is kept for API parity: the optimizer reduces the
    gradients in one blocking collective after the backward either way."""

    def __init__(
        self,
        module: torch.nn.Module,
        comm: Optional[TorchCommunication] = None,
        optimizer=None,
        blocking_parameter_updates: bool = False,
    ):
        if not isinstance(module, torch.nn.Module):
            raise TypeError(f"module must be a torch.nn.Module, got {type(module)}")
        super().__init__()
        self.module = module
        self.comm = sanitize_comm(comm)
        self.blocking_parameter_updates = blocking_parameter_updates
        with torch.no_grad():
            for t in itertools.chain(module.parameters(), module.buffers()):
                self.comm.bcast(t.detach(), root=0)
        if optimizer is not None:
            for opt in optimizer if isinstance(optimizer, (list, tuple)) else [optimizer]:
                opt._attach(self)

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)


class DataParallelMultiGPU(DataParallel):
    """The node-local tier of the reference's hierarchical data parallelism (``:313``),
    paired with :class:`~heat_tpu_torch.optim.DASO` as heat_tpu's is: ``comm`` is
    expected to be a :meth:`TorchCommunication.hierarchical` communicator, and
    ``optimizer`` a ``DataParallelOptimizer`` (or a ``DASO``, which attaches through its
    local optimizer). The copies start equal (rank 0's parameters, broadcast); DASO then
    reduces gradients within each node and syncs the node replicas on its cadence."""

    def __init__(self, module: torch.nn.Module, optimizer=None, comm: Optional[TorchCommunication] = None):
        super().__init__(module, comm=comm, optimizer=optimizer)
