"""Device registry (counterpart of heat_tpu/core/devices.py).

A :class:`Device` names where a DNDarray's local tensor lives: ``"gpu"`` (the CUDA card
of this rank) or ``"cpu"``. The default device is the GPU. The CPU is used only when the
caller asks for it — ``use_device("cpu")`` or ``device="cpu"`` — and resolving the GPU
on a machine without one raises instead of carrying on silently on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "use_device", "sanitize_device"]


class Device:
    """A compute device: ``device_type`` is ``"gpu"`` or ``"cpu"``; ``device_id``
    selects the CUDA card (None: the current CUDA device of this process)."""

    def __init__(self, device_type: str, device_id: Optional[int] = None):
        kind = device_type.strip().lower()
        if kind == "cuda":
            kind = "gpu"
        if kind not in ("gpu", "cpu"):
            raise ValueError(f"Unknown device type {device_type!r}, must be 'gpu' or 'cpu'")
        self.__device_type = kind
        self.__device_id = None if device_id is None else int(device_id)

    @property
    def device_type(self) -> str:
        return self.__device_type

    @property
    def device_id(self) -> int:
        if self.__device_id is not None:
            return self.__device_id
        if self.__device_type == "gpu" and torch.cuda.is_available():
            return torch.cuda.current_device()
        return 0

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` local tensors live on. Raises ``RuntimeError`` for the
        GPU when CUDA is not available."""
        if self.__device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "heat_tpu_torch: no CUDA device is available; ask for the CPU explicitly "
                "with heat_tpu_torch.use_device('cpu') or device='cpu'"
            )
        return torch.device("cuda", self.device_id)

    def __repr__(self) -> str:
        return f"device({str(self)!r})"

    def __str__(self) -> str:
        if self.__device_id is None:
            return self.__device_type
        return f"{self.__device_type}:{self.__device_id}"

    def __eq__(self, other) -> bool:
        if isinstance(other, Device):
            return self.device_type == other.device_type and self.device_id == other.device_id
        if isinstance(other, str):
            return str(self) == other or self.device_type == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.device_type)


cpu = Device("cpu")
"""The host CPU."""
gpu = Device("gpu")
"""This rank's CUDA card."""

__default_device = gpu


def get_device() -> Device:
    """Return the current default device."""
    return __default_device


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the default device (``"gpu"`` or ``"cpu"``)."""
    global __default_device
    __default_device = gpu if device is None else sanitize_device(device)


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Validate ``device`` or return the default."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        return Device("cpu") if device.type == "cpu" else Device("gpu", device.index)
    if isinstance(device, str):
        kind, _, idx = device.strip().lower().partition(":")
        if kind in ("cpu", "gpu", "cuda"):
            return Device(kind, int(idx) if idx else None)
    raise ValueError(f"Unknown device, must be 'gpu' or 'cpu', got {device!r}")


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 matrix products in full fp32 inside the block: TF32 off for cuBLAS and
    cuDNN, whatever the process set (TF32 keeps ~3 decimal digits, too few for the
    cancelling quadratic expansion of a distance)."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
