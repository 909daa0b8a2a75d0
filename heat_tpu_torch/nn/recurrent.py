"""Recurrent layers (counterpart of heat_tpu/nn/recurrent.py).

heat_tpu's ``RNN``, ``LSTM``, ``GRU`` and their cells keep torch's parameter names
(``weight_ih_l{k}``, ...) and gate orders (i, f, g, o for the LSTM; r, z, n for the GRU),
so the port's are torch's own modules, subclassed: eval mode at start, parameters on the
port's default device, heat_tpu's ``initial_state`` argument, and torch's recurrence in
full fp32 (on the card cuDNN's, with TF32 off, as heat_tpu's f32 ``lax.scan`` is). They
raise at construction for ``bidirectional`` and inter-layer ``dropout``, as heat_tpu's do
(:36-39). A DNDarray input is computed whole, as heat_tpu computes it; the output keeps a
split along the time or batch axis, the states come back as tensors (heat_tpu's arrays).
"""

from __future__ import annotations

import torch

from ..core._operations import wrap_global
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray
from .modules import Module

__all__ = ["RNN", "LSTM", "GRU", "RNNCell", "LSTMCell", "GRUCell"]


def _whole(t):
    return t._relayout(None) if isinstance(t, DNDarray) else t


def _states(state):
    """A state, or an LSTM's (h, c), whole on this rank."""
    if isinstance(state, (tuple, list)):
        return tuple(_whole(s) for s in state)
    return _whole(state)


class _RNNBase(Module):
    """torch's recurrent layer with heat_tpu's refusals and call: ``forward(x,
    initial_state=None)`` gives ``(output, h_n)`` (``(output, (h_n, c_n))`` for the LSTM)."""

    _keeps_split = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bidirectional:
            raise NotImplementedError("bidirectional recurrent layers are not supported")
        if self.dropout != 0.0:
            raise NotImplementedError("inter-layer dropout is not supported")

    def forward(self, x, initial_state=None):
        value = _whole(x)
        with full_fp32_matmul():
            out, h_n = super().forward(value, None if initial_state is None else _states(initial_state))
        if isinstance(x, DNDarray):
            # the output keeps the input's (T, B) / (B, T) layout; only the feature axis changes
            keep = x.split if x.split is not None and x.split < x.ndim - 1 else None
            out = wrap_global(out, x, keep)
        return out, h_n


class RNN(_RNNBase, torch.nn.RNN):
    """torch's RNN, tanh or relu."""


class LSTM(_RNNBase, torch.nn.LSTM):
    """torch's LSTM, gates i, f, g, o; returns (output, (h_n, c_n))."""


class GRU(_RNNBase, torch.nn.GRU):
    """torch's GRU, gates r, z, n, with n = tanh(W_in x + b_in + r·(W_hn h + b_hn))."""


class _CellBase(Module):
    """torch's cell: one step, ``forward(x, state=None)`` gives the new state (``(h, c)``
    for the LSTM cell), batched (B, I) or unbatched (I,). On a DNDarray the state keeps a
    batch split of a (B, I) input (heat_tpu's rule)."""

    _keeps_split = False

    def forward(self, x, state=None):
        value = _whole(x)
        with full_fp32_matmul():
            out = super().forward(value, None if state is None else _states(state))
        if isinstance(x, DNDarray):
            keep = x.split if x.split == 0 and x.ndim == 2 else None
            out = tuple(wrap_global(s, x, keep) for s in out) if isinstance(out, tuple) else wrap_global(out, x, keep)
        return out


class RNNCell(_CellBase, torch.nn.RNNCell):
    """h' = tanh or relu(W_ih x + b_ih + W_hh h + b_hh)."""


class LSTMCell(_CellBase, torch.nn.LSTMCell):
    """(h', c') from (x, (h, c)); gates i, f, g, o."""


class GRUCell(_CellBase, torch.nn.GRUCell):
    """torch's r, z, n gate formulation."""
