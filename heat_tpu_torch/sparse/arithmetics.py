"""Elementwise sparse arithmetic (counterpart of heat_tpu/sparse/arithmetics.py)."""

from __future__ import annotations

from typing import Union

import torch

from ._operations import binary_op_csr
from .dcsr_matrix import DCSR_matrix

__all__ = ["add", "mul"]


def add(t1: DCSR_matrix, t2: Union[DCSR_matrix, float, int]) -> DCSR_matrix:
    """Elementwise sum."""
    return binary_op_csr(torch.add, t1, t2)


def mul(t1: DCSR_matrix, t2: Union[DCSR_matrix, float, int]) -> DCSR_matrix:
    """Elementwise product."""
    return binary_op_csr(torch.mul, t1, t2)
