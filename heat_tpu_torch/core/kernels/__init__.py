"""Hand-written CUDA kernels for Hopper (counterparts of heat_tpu/core/kernels/, and the
integer and bool products that heat_tpu leaves to XLA and cuBLAS cannot run).

Each kernel module keeps its plain PyTorch version beside the wrapper, used for CPU
tensors and by the tests, and a ``launches`` counter for each kernel, counted under the
module's ``_count_lock`` so that concurrent request threads lose no launch. Importing a
kernel module needs neither CUDA nor nvcc: a kernel is built at its first launch.
"""

from . import flash_attention, int_matmul, kmeans
from .flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_pipelined_reference,
    flash_attention_reference,
)
from .int_matmul import int_matmul_reference
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
    "int_matmul",
    "int_matmul_reference",
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
    "int_matmul": int_matmul,
    "int_matmul_tc": int_matmul.tc,
    "int_transpose_pad": int_matmul.transpose,
    "int_matmul_planes": int_matmul.byte_planes,
    "int_planes": int_matmul.split_planes,
    "int_planes_t": int_matmul.split_planes_t,
}


def launch_counts() -> dict:
    """Launches of each ported kernel, by name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    with flash_attention._count_lock, int_matmul._count_lock, kmeans._count_lock:
        for mod in KERNELS.values():
            mod.launches = 0
        kmeans.launches_tma = 0
