"""3xTF32 arithmetic of the port's tensor-core kernels (``csrc/mma_tf32x3.cuh``), emulated
in PyTorch on the CPU for the tests that hold the kernels' arithmetic to heat_tpu.

An f32 operand splits into a TF32 big part (rounded to nearest, ties away from zero, as
``cvt.rna.tf32.f32``) and a TF32 small part (the residual, rounded the same way), and a·b
is accumulated in f32 as small·big, then big·small, then big·big, one m16n8k8 product
(k = 8) at a time.
"""

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest with ties away
    from zero: half of the 13 dropped bits' range added to the magnitude, then those bits
    cleared (what ``cvt.rna.tf32.f32`` gives, masked as the kernels mask it)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = round_tf32(x)
    return big, round_tf32(x - big)


def mma3(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c + a·b over one k chunk in 3xTF32: small·big, big·small, big·big, f32 sums."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    c = c + a_small @ b_big
    c = c + a_big @ b_small
    return c + a_big @ b_big


def mma1(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c + a·b over one k chunk in a single TF32 product (the route the kernels do not take
    for f32: it keeps about three decimal digits)."""
    return c + round_tf32(a) @ round_tf32(b)


def chunked(c, a, b, product=mma3):
    """c + a·b with the k dimension walked 8 at a time, each chunk one ``product``."""
    for k0 in range(0, a.shape[-1], 8):
        c = product(c, a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
    return c
