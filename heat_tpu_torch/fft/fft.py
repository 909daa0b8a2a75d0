"""numpy.fft-compatible distributed FFTs (counterpart of heat_tpu/fft/fft.py).

A transform along axes that are not split is one local ``torch.fft`` call on each rank's
chunk (cuFFT on the card). A transform along the split axis is a pencil decomposition,
as heat_tpu's and Heat's: the array is resplit to the first axis that is not
transformed (one all-to-all), transformed locally, and resplit back; when every axis is
transformed it is gathered whole first. A CUDA tensor is transformed on the card or the
call raises: nothing moves to the host.

Result types are heat_tpu's (jnp.fft with x64 on): float64 and int64 give complex128,
every other real type complex64 (as jnp promotes int32 and bool to float32), and the
real outputs of the inverse real transforms are the matching float types.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core import types
from ..core.dndarray import DNDarray
from ..core.sanitation import sanitize_in
from ..core.stride_tricks import sanitize_axis

__all__ = [
    "fft",
    "fft2",
    "fftfreq",
    "fftn",
    "fftshift",
    "hfft",
    "hfft2",
    "hfftn",
    "ifft",
    "ifft2",
    "ifftn",
    "ifftshift",
    "ihfft",
    "ihfft2",
    "ihfftn",
    "irfft",
    "irfft2",
    "irfftn",
    "rfft",
    "rfft2",
    "rfftfreq",
    "rfftn",
]

# the norm an inverse-real transform takes to give the Hermitian transform's scaling
_SWAPPED_NORM = {None: "forward", "backward": "forward", "forward": "backward", "ortho": "ortho"}


def _work_type(x: DNDarray, to_complex: bool) -> torch.dtype:
    """The float (or, with ``to_complex``, complex) type a transform of ``x`` computes
    in: jnp's promotion with x64 on."""
    if types.heat_type_is_complexfloating(x.dtype):
        ct = x.dtype.torch_type()
    elif x.dtype in (types.float64, types.int64):
        ct = torch.complex128
    else:
        ct = torch.complex64
    if to_complex:
        return ct
    return torch.float32 if ct == torch.complex64 else torch.float64


def _pencil_split(x: DNDarray, transformed: Sequence[int]) -> Optional[int]:
    """The first axis that is not transformed, or None when every axis is."""
    return next((ax for ax in range(x.ndim) if ax not in transformed), None)


def _apply(local: Callable[[torch.Tensor], torch.Tensor], v: torch.Tensor, transformed: Sequence[int]) -> torch.Tensor:
    """``local(v)``; a chunk that is empty along an axis not transformed (a rank without
    rows of a pencil) gets its result's shape and type from a transform of one slice,
    cut back to none (the FFT libraries refuse empty input)."""
    empty = [d for d in range(v.ndim) if v.shape[d] == 0 and d not in transformed]
    if not empty:
        return local(v).resolve_conj()
    out = local(v.new_zeros([1 if d in empty else n for d, n in enumerate(v.shape)]))
    return out[tuple(slice(0, 0) if d in empty else slice(None) for d in range(out.ndim))].resolve_conj()


def _transform(x: DNDarray, local: Callable[[torch.Tensor], torch.Tensor], transformed: Sequence[int]) -> DNDarray:
    """``local`` applied to the array laid out so that no transformed axis is split (the
    pencil), the result laid out along ``x``'s split again."""
    sanitize_in(x)
    if x.split is None or x.split not in transformed or not x.is_distributed():
        value = _apply(local, x.larray, transformed)
        gshape = list(value.shape)
        if x.is_distributed():
            gshape[x.split] = x.gshape[x.split]  # not transformed: its global extent stays
        return DNDarray(value, tuple(gshape), types.canonical_heat_type(value.dtype), x.split, x.device, x.comm, True)
    tmp = _pencil_split(x, transformed)
    value = _apply(local, x._relayout(tmp), transformed)
    gshape = list(value.shape)
    if tmp is not None:
        gshape[tmp] = x.gshape[tmp]
    res = DNDarray(value, tuple(gshape), types.canonical_heat_type(value.dtype), tmp, x.device, x.comm, True)
    return res.resplit_(x.split)


def _fft_op(x: DNDarray, op: Callable, n: Optional[int], axis: int, norm: Optional[str], to_complex: bool) -> DNDarray:
    """A one-axis transform ``op`` (a ``torch.fft`` function) of ``x`` cast to its work
    type."""
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    wt = _work_type(x, to_complex)
    return _transform(x, lambda v: op(v.to(wt), n=n, dim=axis, norm=norm), (axis,))


def _axes_of(x: DNDarray, s, axes) -> Tuple[Optional[Tuple[int, ...]], Tuple[int, ...]]:
    """The sanitised ``axes`` and the axes an n-D transform acts on (numpy's rule: ``s``
    without ``axes`` transforms the last ``len(s)`` axes; neither, every axis)."""
    if axes is not None:
        axes = tuple(sanitize_axis(x.gshape, ax) for ax in axes)
        return axes, axes
    if s is not None:
        return None, tuple(range(x.ndim - len(tuple(s)), x.ndim))
    return None, tuple(range(x.ndim))


def _fftn_op(x: DNDarray, op: Callable, s, axes, norm: Optional[str], to_complex: bool) -> DNDarray:
    """An n-D transform ``op`` (a ``torch.fft`` function or a composition of them)."""
    sanitize_in(x)
    axes, transformed = _axes_of(x, s, axes)
    wt = _work_type(x, to_complex)
    s = None if s is None else tuple(s)
    return _transform(x, lambda v: op(v.to(wt), s=s, dim=axes, norm=norm), transformed)


def _real_input(x: DNDarray, name: str) -> None:
    """A real transform takes real input, and (as jnp's) not a 2-byte float."""
    if types.heat_type_is_complexfloating(x.dtype):
        raise TypeError(f"{name} requires a real input")
    if x.dtype in (types.float16, types.bfloat16):
        raise ValueError(f"{name} input must be float32 or float64, got {x.dtype.__name__}")


def _two_axes(axes, name: str):
    """The axes of a 2-D transform: two of them, or None (every axis, as numpy's)."""
    if axes is not None and len(tuple(axes)) != 2:
        raise ValueError(f"{name} takes 2 axes, got axes = {tuple(axes)}")
    return axes


def fft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """1-D discrete Fourier transform."""
    return _fft_op(x, torch.fft.fft, n, axis, norm, True)


def ifft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Inverse 1-D discrete Fourier transform."""
    return _fft_op(x, torch.fft.ifft, n, axis, norm, True)


def fft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """2-D discrete Fourier transform (``axes=None``: every axis, as numpy's)."""
    return _fftn_op(x, torch.fft.fftn, s, _two_axes(axes, "fft2"), norm, True)


def ifft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """Inverse 2-D discrete Fourier transform."""
    return _fftn_op(x, torch.fft.ifftn, s, _two_axes(axes, "ifft2"), norm, True)


def fftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """n-D discrete Fourier transform."""
    return _fftn_op(x, torch.fft.fftn, s, axes, norm, True)


def ifftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """Inverse n-D discrete Fourier transform."""
    return _fftn_op(x, torch.fft.ifftn, s, axes, norm, True)


def rfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """1-D discrete Fourier transform of a real input (the non-negative frequencies)."""
    _real_input(x, "rfft")
    return _fft_op(x, torch.fft.rfft, n, axis, norm, False)


def irfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Inverse of :func:`rfft`."""
    return _fft_op(x, torch.fft.irfft, n, axis, norm, True)


def rfft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """2-D discrete Fourier transform of a real input."""
    _real_input(x, "rfft2")
    return _fftn_op(x, torch.fft.rfftn, s, _two_axes(axes, "rfft2"), norm, False)


def irfft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """Inverse of :func:`rfft2`."""
    return _fftn_op(x, torch.fft.irfftn, s, _two_axes(axes, "irfft2"), norm, True)


def rfftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """n-D discrete Fourier transform of a real input."""
    _real_input(x, "rfftn")
    return _fftn_op(x, torch.fft.rfftn, s, axes, norm, False)


def irfftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """Inverse of :func:`rfftn`."""
    return _fftn_op(x, torch.fft.irfftn, s, axes, norm, True)


def hfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """1-D discrete Fourier transform of a Hermitian-symmetric signal (a real result)."""
    return _fft_op(x, torch.fft.hfft, n, axis, norm, True)


def ihfft(x: DNDarray, n: Optional[int] = None, axis: int = -1, norm: Optional[str] = None) -> DNDarray:
    """Inverse of :func:`hfft`."""
    _real_input(x, "ihfft")
    return _fft_op(x, torch.fft.ihfft, n, axis, norm, False)


def _hfftn(v: torch.Tensor, s=None, dim=None, norm=None) -> torch.Tensor:
    return torch.fft.irfftn(torch.conj(v), s=s, dim=dim, norm=norm)


def _ihfftn(v: torch.Tensor, s=None, dim=None, norm=None) -> torch.Tensor:
    return torch.conj(torch.fft.rfftn(v, s=s, dim=dim, norm=norm))


def hfft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """2-D Hermitian discrete Fourier transform."""
    return hfftn(x, s=s, axes=axes, norm=norm)


def hfftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """n-D Hermitian discrete Fourier transform: ``irfftn`` of the conjugate with the
    inverse normalisation (torch.fft.hfftn's definition, as heat_tpu's)."""
    return _fftn_op(x, _hfftn, s, axes, _SWAPPED_NORM[norm], True)


def ihfft2(x: DNDarray, s=None, axes=(-2, -1), norm: Optional[str] = None) -> DNDarray:
    """Inverse 2-D Hermitian discrete Fourier transform."""
    return ihfftn(x, s=s, axes=axes, norm=norm)


def ihfftn(x: DNDarray, s=None, axes=None, norm: Optional[str] = None) -> DNDarray:
    """Inverse n-D Hermitian discrete Fourier transform: the conjugate of ``rfftn`` with
    the inverse normalisation."""
    _real_input(x, "ihfftn")
    return _fftn_op(x, _ihfftn, s, axes, _SWAPPED_NORM[norm], False)


def _freq(k: torch.Tensor, n: int, d: float, dtype, split, device, comm) -> DNDarray:
    """``k / (d * n)`` in float64 (jnp's arithmetic), cast to ``dtype`` if given."""
    from ..core import factories

    result = k / torch.tensor(d * n, dtype=torch.float64)
    return factories.array(result, dtype=types.float64 if dtype is None else dtype, split=split, device=device,
                           comm=comm)


def fftfreq(n: int, d: float = 1.0, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Sample frequencies of a discrete Fourier transform of length ``n`` (float64 unless
    ``dtype`` is given)."""
    i = torch.arange(n, dtype=torch.float64)
    return _freq((i + n // 2) % n - n // 2, n, d, dtype, split, device, comm)


def rfftfreq(n: int, d: float = 1.0, dtype=None, split: Optional[int] = None, device=None, comm=None) -> DNDarray:
    """Sample frequencies of :func:`rfft` of length ``n`` (float64 unless ``dtype``)."""
    return _freq(torch.arange(0, n // 2 + 1, dtype=torch.float64), n, d, dtype, split, device, comm)


def _shift(x: DNDarray, axes, sign: int) -> DNDarray:
    """Roll ``axes`` (every axis by default) by half their extent, ``sign`` setting the
    direction; along the split axis this is the distributed ``roll`` of the global
    array."""
    from ..core.manipulations import roll

    sanitize_in(x)
    if axes is None:
        axes = tuple(range(x.ndim))
    elif not isinstance(axes, (tuple, list)):
        axes = (axes,)
    axes = tuple(sanitize_axis(x.gshape, ax) for ax in axes)
    return roll(x, tuple(sign * (x.gshape[ax] // 2) for ax in axes), axes)


def fftshift(x: DNDarray, axes=None) -> DNDarray:
    """Shift the zero-frequency component to the centre."""
    return _shift(x, axes, 1)


def ifftshift(x: DNDarray, axes=None) -> DNDarray:
    """Inverse of :func:`fftshift`."""
    return _shift(x, axes, -1)
