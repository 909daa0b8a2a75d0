"""The module zoo (counterpart of heat_tpu/nn/modules.py).

Every module is a thin subclass of torch's own, under heat_tpu's name, signature and
parameter names, so a parameter tree of heat_tpu maps onto a ``state_dict`` mechanically
(``interop.load_jax_params``; heat_tpu's ``Linear`` weight is (in, out), torch's (out, in)).
What the subclasses add to torch's:

- **Eval mode at start.** torch's modules start in training mode, heat_tpu's in eval mode
  (its ``_resolve_ctx`` defaults to eval, modules.py:160-172). Each module here calls
  ``.eval()`` once built, so a fresh ``Dropout`` passes its input through, as heat_tpu's
  does; ``.train()`` switches dropout and batch statistics on.
- **heat_tpu's PRNG keys.** Randomness takes an explicit key, the two uint32 words of
  ``jax.random.key_data``: ``module(x, key=k)``. A module whose ``forward`` takes no key
  splits it over its children in registration order (``_split(key, max(n, 1))``, heat_tpu's
  ``_bind``, modules.py:118-131), each child using its share when called without one, so
  masks equal heat_tpu's bit for bit. ``Dropout``/``Dropout2d`` in training mode raise
  without a key, as heat_tpu's do (:556-581).
- **DNDarrays.** Each module takes a DNDarray and computes it as one global array through
  :mod:`heat_tpu_torch.nn.functional`; the result keeps the input's split where that axis
  keeps its extent, else comes back whole (heat_tpu's ``Module.__call__``, :174-193).
- **The card.** Parameters are made on the port's default device unless ``device`` is
  given; matrix products and convolutions run in full fp32 (TF32 off for cuBLAS and cuDNN).

``BatchNorm1d``/``BatchNorm2d`` keep torch's running buffers, updated in training mode
with heat_tpu's rule (:421-426), and take global moments on a batch split. The losses
follow heat_tpu's signatures (``CrossEntropyLoss(weight, ignore_index, reduction,
label_smoothing)``) and are global means on DNDarrays. ``Remat`` recomputes the wrapped
module's forward in the backward (``torch.utils.checkpoint`` without reentrancy, heat_tpu's
``jax.checkpoint``, :584-608).
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
import torch.utils.checkpoint

from ..core import devices
from ..core.devices import full_fp32_matmul
from ..core.dndarray import DNDarray
from . import functional as F

__all__ = [
    "Module",
    "Linear",
    "Embedding",
    "Conv2d",
    "ConvTranspose2d",
    "MaxPool2d",
    "AvgPool2d",
    "AdaptiveAvgPool2d",
    "AdaptiveMaxPool2d",
    "Conv1d",
    "MaxPool1d",
    "AvgPool1d",
    "BatchNorm1d",
    "BatchNorm2d",
    "GroupNorm",
    "InstanceNorm2d",
    "LayerNorm",
    "ReLU",
    "ReLU6",
    "LeakyReLU",
    "PReLU",
    "GELU",
    "ELU",
    "SiLU",
    "Mish",
    "Softplus",
    "Hardtanh",
    "Tanh",
    "Sigmoid",
    "Softmax",
    "LogSoftmax",
    "Identity",
    "Flatten",
    "Unflatten",
    "Dropout",
    "Dropout2d",
    "Remat",
    "remat",
    "Sequential",
    "ModuleList",
    "MSELoss",
    "L1Loss",
    "NLLLoss",
    "CrossEntropyLoss",
    "BCELoss",
    "BCEWithLogitsLoss",
    "SmoothL1Loss",
    "HuberLoss",
]

_TAKES_DEVICE = {}


def _takes_device(cls) -> bool:
    """Whether the torch class below ``cls`` takes a ``device`` argument (the first torch
    class in its order that names its arguments: ``torch.nn.RNN``'s are ``*args, **kwargs``)."""
    if cls not in _TAKES_DEVICE:
        takes = False
        for base in cls.__mro__[1:]:
            if not base.__module__.startswith("torch.") or "__init__" not in vars(base):
                continue
            params = inspect.signature(base.__init__).parameters.values()
            if all(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or p.name == "self" for p in params):
                continue
            takes = any(p.name == "device" for p in params)
            break
        _TAKES_DEVICE[cls] = takes
    return _TAKES_DEVICE[cls]


def _bind(module: torch.nn.Module, key) -> None:
    """heat_tpu's ``_bind``: ``key`` split over the children in registration order, each
    child's share kept for its next call; a ``ModuleList`` binds its own children at once
    (it is indexed, never called)."""
    kids = [m for m in module._modules.values() if m is not None]
    keys = F._subkeys(key, max(len(kids), 1)) if key is not None else [None] * len(kids)
    for m, k in zip(kids, keys):
        m._bound_key = k
        if isinstance(m, torch.nn.ModuleList):
            _bind(m, k)


def _keep_split(x: DNDarray, out):
    """heat_tpu's ``Module.__call__`` rule: the input's split where that axis still has its
    extent, else whole."""
    if not isinstance(out, DNDarray):
        return out
    s = x.split
    target = s if s is not None and s < out.ndim and out.gshape[s] == x.gshape[s] else None
    return out if out.split == target else out.resplit(target)


class Module(torch.nn.Module):
    """``torch.nn.Module`` in heat_tpu's manner: eval mode at start, heat_tpu's PRNG keys
    (``module(x, key=k)``) and DNDarray inputs (the module docstring says how).

    ``_rng_arg`` names a ``forward`` argument that takes the key itself (None: the key is
    split over the children); ``_keeps_split`` applies heat_tpu's split rule to a DNDarray
    result."""

    _rng_arg: Optional[str] = None
    _keeps_split = True

    def __init__(self, *args, device=None, **kwargs):
        if _takes_device(type(self)):
            kwargs["device"] = devices.sanitize_device(device).torch_device
        super().__init__(*args, **kwargs)
        self.train(False)

    def __call__(self, *args, **kwargs):
        bound = self.__dict__.get("_bound_key")
        if self._rng_arg is not None:
            if kwargs.get(self._rng_arg) is None:
                kwargs[self._rng_arg] = bound
        else:
            key = kwargs.pop("key", None)
            _bind(self, bound if key is None else key)
        out = super().__call__(*args, **kwargs)
        if self._keeps_split and args and isinstance(args[0], DNDarray):
            return _keep_split(args[0], out)
        return out


# ---------------------------------------------------------------------- layers with parameters
class Linear(Module, torch.nn.Linear):
    """``y = x Wᵀ + b`` (torch's layout; heat_tpu's weight is the transpose)."""

    def forward(self, x):
        if isinstance(x, DNDarray):
            return F.linear(x, self.weight, self.bias)
        with full_fp32_matmul():
            return torch.nn.functional.linear(x, self.weight, self.bias)


class Embedding(Module, torch.nn.Embedding):
    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Conv1d(Module, torch.nn.Conv1d):
    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups)


class Conv2d(Module, torch.nn.Conv2d):
    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups)


class ConvTranspose2d(Module, torch.nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class LayerNorm(Module, torch.nn.LayerNorm):
    def forward(self, x):
        if isinstance(x, DNDarray):
            return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        return torch.nn.functional.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(Module, torch.nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


class InstanceNorm2d(Module, torch.nn.InstanceNorm2d):
    """Per sample and channel: a GroupNorm with a group per channel, as heat_tpu's."""

    def forward(self, x):
        return F.group_norm(x, self.num_features, self.weight, self.bias, self.eps)


class _BatchNorm(Module):
    """Batch statistics in training mode, the running ones in eval mode; the running
    buffers are updated in training mode with heat_tpu's rule (unbiased by n / (n − 1))."""

    def forward(self, x):
        train = self.training
        running = self.track_running_stats and not train
        out, mean, var = F.batch_norm(
            x, self.running_mean if running else None, self.running_var if running else None,
            self.weight, self.bias, training=train or not self.track_running_stats, eps=self.eps,
        )
        if train and self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                n = x.shape[0] * (_numel(x) // max(x.shape[0] * self.num_features, 1))
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(m * var.detach() * (n / max(n - 1, 1)))
        return out


def _numel(x) -> int:
    return x.size if isinstance(x, DNDarray) else x.numel()


class BatchNorm1d(_BatchNorm, torch.nn.BatchNorm1d):
    """torch's BatchNorm1d over (N, C) or (N, C, L)."""


class BatchNorm2d(_BatchNorm, torch.nn.BatchNorm2d):
    """torch's BatchNorm2d over (N, C, H, W)."""


class PReLU(Module, torch.nn.PReLU):
    """Leaky ReLU with a learnable slope, one or one per channel (axis 1)."""

    def forward(self, x):
        a = self.weight
        if self.num_parameters > 1 and x.ndim > 1:
            a = a.reshape((1, -1) + (1,) * (x.ndim - 2))
        return F._run(x, lambda v: torch.where(v >= 0, v, a * v))


# ---------------------------------------------------------------------- parameter-free layers
class MaxPool1d(Module, torch.nn.MaxPool1d):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class MaxPool2d(Module, torch.nn.MaxPool2d):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1d(Module, torch.nn.AvgPool1d):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2d(Module, torch.nn.AvgPool2d):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool2d(Module, torch.nn.AdaptiveAvgPool2d):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2d(Module, torch.nn.AdaptiveMaxPool2d):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class ReLU(Module, torch.nn.ReLU):
    def forward(self, x):
        return F.relu(x)


class ReLU6(Module, torch.nn.ReLU6):
    def forward(self, x):
        return F.hardtanh(x, 0.0, 6.0)


class LeakyReLU(Module, torch.nn.LeakyReLU):
    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class GELU(Module, torch.nn.GELU):
    """The exact erf form by default, ``approximate='tanh'`` the fast one."""

    def __init__(self, approximate: str = "none", device=None):
        if approximate not in ("none", "tanh"):
            raise ValueError(f"approximate must be 'none' or 'tanh', got {approximate!r}")
        super().__init__(approximate=approximate, device=device)

    def forward(self, x):
        return F.gelu(x, self.approximate)


class ELU(Module, torch.nn.ELU):
    def forward(self, x):
        return F.elu(x, self.alpha)


class SiLU(Module, torch.nn.SiLU):
    def forward(self, x):
        return F.silu(x)


class Mish(Module, torch.nn.Mish):
    def forward(self, x):
        return F.mish(x)


class Softplus(Module, torch.nn.Softplus):
    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Hardtanh(Module, torch.nn.Hardtanh):
    def forward(self, x):
        return F.hardtanh(x, self.min_val, self.max_val)


class Tanh(Module, torch.nn.Tanh):
    def forward(self, x):
        return F.tanh(x)


class Sigmoid(Module, torch.nn.Sigmoid):
    def forward(self, x):
        return F.sigmoid(x)


class Softmax(Module, torch.nn.Softmax):
    """Along ``dim``, -1 by default (heat_tpu's default; torch's is None)."""

    def __init__(self, dim: int = -1, device=None):
        super().__init__(dim=dim, device=device)

    def forward(self, x):
        return F.softmax(x, dim=self.dim)


class LogSoftmax(Module, torch.nn.LogSoftmax):
    """Along ``dim``, -1 by default (heat_tpu's default; torch's is None)."""

    def __init__(self, dim: int = -1, device=None):
        super().__init__(dim=dim, device=device)

    def forward(self, x):
        return F.log_softmax(x, dim=self.dim)


class Identity(Module, torch.nn.Identity):
    def forward(self, x):
        return x


class Flatten(Module, torch.nn.Flatten):
    """Flattens axes ``start_dim`` to ``end_dim`` (the batch axis kept by default)."""

    def forward(self, x):
        return F.flatten(x, self.start_dim, self.end_dim)


class Unflatten(Module, torch.nn.Unflatten):
    """Expands axis ``dim`` into ``unflattened_size``; a split before it survives."""

    def forward(self, x):
        d = self.dim if self.dim >= 0 else x.ndim + self.dim
        return F._run(x, lambda v: v.reshape(*v.shape[:d], *self.unflattened_size, *v.shape[d + 1 :]),
                      local=lambda s: s < d, rule=lambda s: s if s is not None and s < d else None)


class Dropout(Module, torch.nn.Dropout):
    """Inverted dropout in training mode with heat_tpu's key (``module(x, key=k)``),
    raising without one; the identity in eval mode, where every module starts."""

    _rng_arg = "key"

    def forward(self, x, key=None):
        if not self.training or self.p == 0.0:
            return x
        if key is None:
            raise ValueError("Dropout in train mode needs an explicit PRNG key")
        return F.dropout(x, self.p, training=True, key=key)


class Dropout2d(Module, torch.nn.Dropout2d):
    """Channel dropout (whole feature maps) in training mode with heat_tpu's key."""

    _rng_arg = "key"

    def forward(self, x, key=None):
        if not self.training or self.p == 0.0:
            return x
        return F.dropout2d(x, self.p, training=True, key=key)


class Remat(Module):
    """Gradient checkpointing: the wrapped module's forward runs again in the backward in
    place of stored activations (``torch.utils.checkpoint``, non-reentrant), with the same
    key. heat_tpu's parameter tree of a ``Remat`` is the wrapped module's own; the port's
    ``state_dict`` holds it under ``module.`` (``load_jax_params`` maps one to the other)."""

    _rng_arg = "key"

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, x, key=None):
        def run(v):
            return self.module(v, key=key) if isinstance(self.module, Module) else self.module(v)

        if torch.is_grad_enabled() and isinstance(x, torch.Tensor):
            return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
        return run(x)


def remat(module: torch.nn.Module) -> Remat:
    """Functional alias of :class:`Remat`."""
    return Remat(module)


class Sequential(Module, torch.nn.Sequential):
    """Chained modules; a key is split over them in order, as heat_tpu's ``Sequential``."""

    def forward(self, x):
        for m in self:
            x = m(x)
        return x


class ModuleList(Module, torch.nn.ModuleList):
    """An indexable container; a parent binds its children's keys through it."""


# ---------------------------------------------------------------------- losses
class _Loss(Module):
    """A loss under heat_tpu's signature, computed by :mod:`.functional` (global on
    DNDarrays)."""

    _keeps_split = False


class MSELoss(_Loss, torch.nn.MSELoss):
    def __init__(self, reduction: str = "mean"):
        super().__init__(reduction=reduction)

    def forward(self, pred, target):
        return F.mse_loss(pred, target, reduction=self.reduction)


class L1Loss(_Loss, torch.nn.L1Loss):
    def __init__(self, reduction: str = "mean"):
        super().__init__(reduction=reduction)

    def forward(self, pred, target):
        return F.l1_loss(pred, target, reduction=self.reduction)


class NLLLoss(_Loss, torch.nn.NLLLoss):
    """Over log-probabilities, with class ``weight``, ``ignore_index`` and ``reduction``."""

    def __init__(self, weight=None, ignore_index: int = -100, reduction: str = "mean"):
        super().__init__(weight=F._p(weight), ignore_index=ignore_index, reduction=reduction)

    def forward(self, log_probs, target):
        return F.nll_loss(log_probs, target, self.weight, self.ignore_index, self.reduction)


class CrossEntropyLoss(_Loss, torch.nn.CrossEntropyLoss):
    """Softmax cross-entropy on logits, with ``weight``, ``ignore_index``, ``reduction`` and
    ``label_smoothing``."""

    def __init__(self, weight=None, ignore_index: int = -100, reduction: str = "mean", label_smoothing: float = 0.0):
        super().__init__(weight=F._p(weight), ignore_index=ignore_index, reduction=reduction,
                         label_smoothing=label_smoothing)

    def forward(self, logits, target):
        return F.cross_entropy(logits, target, self.weight, self.ignore_index, self.reduction, self.label_smoothing)


class BCELoss(_Loss, torch.nn.BCELoss):
    """On probabilities, with an elementwise ``weight``."""

    def __init__(self, weight=None, reduction: str = "mean"):
        super().__init__(weight=F._p(weight), reduction=reduction)

    def forward(self, pred, target):
        return F.binary_cross_entropy(pred, target, weight=self.weight, reduction=self.reduction)


class BCEWithLogitsLoss(_Loss, torch.nn.BCEWithLogitsLoss):
    """Sigmoid and BCE in one stable op, with ``weight`` and ``pos_weight``."""

    def __init__(self, weight=None, reduction: str = "mean", pos_weight=None):
        super().__init__(weight=F._p(weight), reduction=reduction, pos_weight=F._p(pos_weight))

    def forward(self, pred, target):
        return F.binary_cross_entropy_with_logits(pred, target, weight=self.weight, reduction=self.reduction,
                                                  pos_weight=self.pos_weight)


class SmoothL1Loss(_Loss, torch.nn.SmoothL1Loss):
    def __init__(self, reduction: str = "mean", beta: float = 1.0):
        super().__init__(reduction=reduction, beta=beta)

    def forward(self, pred, target):
        return F.smooth_l1_loss(pred, target, reduction=self.reduction, beta=self.beta)


class HuberLoss(_Loss, torch.nn.HuberLoss):
    def __init__(self, reduction: str = "mean", delta: float = 1.0):
        super().__init__(reduction=reduction, delta=delta)

    def forward(self, pred, target):
        return F.huber_loss(pred, target, reduction=self.reduction, delta=self.delta)
