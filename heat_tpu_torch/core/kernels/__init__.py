"""Hand-written CUDA kernels for Hopper (counterparts of heat_tpu/core/kernels/).

Each kernel module keeps its plain PyTorch version beside the wrapper, used for CPU
tensors and by the tests, and a ``launches`` counter for each kernel. Importing a kernel
module needs neither CUDA nor nvcc: a kernel is built at its first launch.
"""

from . import flash_attention, kmeans
from .flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_pipelined_reference,
    flash_attention_reference,
)
from .kmeans import fused_assign_update, fused_assign_update_reference

__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_pipelined_reference",
    "flash_attention_reference",
    "fused_assign_update",
    "fused_assign_update_reference",
    "kmeans",
    "launch_counts",
    "reset_launch_counts",
]

# every ported kernel by name: an object with its ``SOURCE`` and its ``launches`` count
# (the kernel's module where it is the module's one kernel)
KERNELS = {
    "kmeans_assign": kmeans,
    "flash_attention_fwd": flash_attention,
    "flash_attention_bwd_d": flash_attention.bwd_d,
    "flash_attention_bwd_dq": flash_attention.bwd_dq,
    "flash_attention_bwd_dkv": flash_attention.bwd_dkv,
    "flash_attention_fwd_pipelined": flash_attention.fwd_pipelined,
}


def launch_counts() -> dict:
    """Launches of each ported kernel, by name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
