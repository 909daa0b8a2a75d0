"""heat_tpu_torch.fft against heat_tpu.fft: the same numpy inputs through both, the port as
one rank (tests/test_torch_distributed.py runs the pencil transforms at three ranks).

Values agree within 1e-5 of the result's largest magnitude in complex64/float32 and
1e-12 in complex128/float64 (torch's pocketfft and XLA's FFT sum in other orders); the
dtype, gshape and split are equal."""

import numpy as np
import pytest

import heat_tpu as ht

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


_rng = np.random.default_rng(7)
DATA = {
    "f32": _rng.standard_normal((6, 10)).astype(np.float32),
    "f64": _rng.standard_normal((5, 7)),
    "c64": (_rng.standard_normal((6, 8)) + 1j * _rng.standard_normal((6, 8))).astype(np.complex64),
    "c128": _rng.standard_normal((4, 6)) + 1j * _rng.standard_normal((4, 6)),
    "i32": _rng.integers(-5, 9, (6, 5)).astype(np.int32),
    "i64": _rng.integers(-5, 9, (5, 4)),
    "bool": _rng.standard_normal((4, 6)) > 0,
    "f16": _rng.standard_normal((4, 8)).astype(np.float16),
    "cube": _rng.standard_normal((3, 4, 6)).astype(np.float32),
}
REAL = ("f32", "f64", "i32", "i64", "bool", "f16", "cube")


def tolerance(want: np.ndarray) -> float:
    single = want.dtype in (np.complex64, np.float32)
    return (1e-5 if single else 1e-12) * max(1.0, float(np.abs(want).max()))


def pair(fn, data, split, kw):
    """heat_tpu's result and the port's on the same input; where heat_tpu raises, the
    port raises too and the pair is None."""
    try:
        want = getattr(ht.fft, fn)(ht.array(data, split=split), **kw)
    except (TypeError, ValueError) as exc:
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            getattr(htt.fft, fn)(htt.array(data, split=split), **kw)
        return None, exc
    return getattr(htt.fft, fn)(htt.array(data, split=split), **kw), want


def same(got, want):
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.gshape == want.gshape and got.split == want.split
    w = np.asarray(want.numpy())
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=tolerance(w))


ONE_AXIS = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_AXES = ["fft2", "ifft2", "fftn", "ifftn", "rfft2", "irfft2", "rfftn", "irfftn", "hfft2", "hfftn", "ihfft2", "ihfftn"]
REAL_ONLY = ("rfft", "ihfft", "rfft2", "rfftn", "ihfft2", "ihfftn")
KW_ONE = [{"n": 12}, {"axis": 0}, {"n": 3, "axis": 0, "norm": "ortho"}, {"norm": "forward"}]
KW_N = [{}, {"s": (4, 6)}, {"axes": (0,)}, {"axes": None}, {"axes": (1, 0), "norm": "ortho"},
        {"s": (5,), "norm": "forward"}]


def _cases():
    """Every function on every input type at its defaults; the size, axis and norm
    arguments on float32 and complex128 input; every split."""
    out = []
    for fn in ONE_AXIS:
        for name in DATA if fn in ("fft", "rfft") else ("f32", "f64", "c64", "c128", "i64", "cube"):
            if not (fn in REAL_ONLY and name not in REAL):
                out.append((fn, name, 0, {}))
        for i, kw in enumerate(KW_ONE):
            for name in ("f32", "c128")[: 1 if fn in REAL_ONLY else 2]:
                out.append((fn, name, (None, 1)[i % 2], kw))
    for fn in N_AXES:
        for i, kw in enumerate(KW_N):
            if kw != {"axes": None} or fn.endswith("2"):  # the n-D functions' default already
                out.append((fn, "cube", (None, 0, 1)[i % 3], kw))
        for name in ("f32", "i64") if fn in REAL_ONLY else ("c128", "i64"):
            out.append((fn, name, (None, 0, 1)[len(out) % 3], {}))
    return out


CASES = _cases()


@pytest.mark.parametrize("fn,name,split,kw", CASES, ids=[f"{f}-{n}-{s}-{k}" for f, n, s, k in CASES])
def test_transforms(fn, name, split, kw):
    """The port's transform equals heat_tpu's in value (within the module's tolerance),
    dtype, gshape and split; where heat_tpu refuses the arguments, the port does too."""
    got, want = pair(fn, DATA[name], split, kw)
    if got is not None:
        same(got, want)


@pytest.mark.parametrize("split", [None, 0])
def test_frequencies(split):
    """fftfreq and rfftfreq: heat_tpu's float64 values (k / (d·n)) bit for bit, or cast to
    the dtype asked for."""
    for n in (8, 7):
        for d in (1.0, 0.25):
            for dtype in (None, "float32"):
                for fn in ("fftfreq", "rfftfreq"):
                    got = getattr(htt.fft, fn)(n, d, dtype=dtype and getattr(htt, dtype), split=split)
                    want = getattr(ht.fft, fn)(n, d, dtype=dtype and getattr(ht, dtype), split=split)
                    assert got.dtype.__name__ == want.dtype.__name__ and got.split == want.split
                    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_shifts(split):
    """fftshift and ifftshift of every axis, one axis and a pair, the split axis among
    them: the global array rolled by half of each extent, exactly as heat_tpu's."""
    data = DATA["cube"]
    for axes in (None, 0, (1,), (0, 2), -1):
        for fn in ("fftshift", "ifftshift"):
            got = getattr(htt.fft, fn)(htt.array(data, split=split), axes=axes)
            want = getattr(ht.fft, fn)(ht.array(data, split=split), axes=axes)
            assert got.split == want.split and got.gshape == want.gshape
            np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("fn", REAL_ONLY)
def test_real_transforms_refuse_complex(fn):
    """A real transform of complex input raises in both packages."""
    with pytest.raises((TypeError, ValueError)):
        getattr(ht.fft, fn)(ht.array(DATA["c64"]))
    with pytest.raises(TypeError):
        getattr(htt.fft, fn)(htt.array(DATA["c64"]))


def test_no_host_round_trip(monkeypatch):
    """The transforms, the pencil and the shifts never bring the tensor to the host:
    with ``Tensor.cpu`` and ``Tensor.numpy`` made to raise they still run, and the result
    lies where the input did."""
    import torch

    x = htt.array(DATA["cube"], split=0)

    def refuse(*args, **kwargs):
        raise AssertionError("the transform moved a tensor to the host")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    for res in (htt.fft.fft(x, axis=0), htt.fft.rfftn(x), htt.fft.ihfftn(x, axes=(0, 2)), htt.fft.fftshift(x),
                htt.fft.hfft(htt.fft.fft(x), axis=1)):
        assert res.larray.device == x.larray.device
