"""The module zoo: ``torch.nn``'s own modules, re-exported.

heat_tpu's ``nn/modules.py`` rebuilds torch's module zoo on JAX (explicit parameter trees,
``init``/``apply``) and is tested against torch. The port runs on torch, so it takes the
originals instead of a copy: ``GELU`` is the exact erf form by default, as heat_tpu's
(``modules.py:479``). Two layout differences matter when parameters cross from heat_tpu
(``interop.load_jax_params`` handles both): heat_tpu's ``Linear`` weight is (in, out) and
torch's (out, in); and torch modules start in training mode where heat_tpu's start in
eval mode (the attention modules of :mod:`heat_tpu_torch.nn.attention` start in eval
mode, as heat_tpu's do). The losses are torch's too: heat_tpu's ``CrossEntropyLoss``,
``MSELoss``, ``L1Loss`` and ``NLLLoss`` (``modules.py:636-694``) have torch's semantics
and defaults, and a loss over this rank's rows of a split batch is a local mean, which
:class:`~heat_tpu_torch.optim.DataParallelOptimizer` weights into the global one.
"""

from torch.nn import (
    GELU,
    CrossEntropyLoss,
    Dropout,
    Embedding,
    L1Loss,
    LayerNorm,
    Linear,
    Module,
    ModuleList,
    MSELoss,
    NLLLoss,
    ReLU,
    Sequential,
)

__all__ = [
    "CrossEntropyLoss",
    "Dropout",
    "Embedding",
    "GELU",
    "L1Loss",
    "LayerNorm",
    "Linear",
    "MSELoss",
    "Module",
    "ModuleList",
    "NLLLoss",
    "ReLU",
    "Sequential",
]
