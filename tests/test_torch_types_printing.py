"""heat_tpu_torch's type queries, the rest of its input sanitation, printing and the halo
convolution against heat_tpu's, the port as one rank (the convolution's three- and
four-rank runs are among the cases of tests/test_torch_distributed.py)."""

import numpy as np
import pytest
import torch

import heat_tpu as ht

import heat_tpu_torch as htt
from _torch_parity import cases, check

TYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64",
         "complex64", "complex128"]
CONVOLVE = cases(["convolve"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("casting", ["no", "safe", "same_kind", "unsafe", "intuitive"])
@pytest.mark.parametrize("src", TYPES)
def test_can_cast(src, casting):
    for dst in TYPES:
        assert htt.can_cast(getattr(htt, src), getattr(htt, dst), casting) == ht.can_cast(
            getattr(ht, src), getattr(ht, dst), casting), (src, dst)


@pytest.mark.parametrize("value", [3, -3, 300, 2.5, True])
def test_can_cast_scalars(value):
    """A Python scalar casts by numpy's value-based rule. (heat_tpu hands the scalar to
    ``np.can_cast``, which numpy 2 refuses with a TypeError: a difference of the
    reference, ROADMAP Queue 3.)"""
    for dst in ("uint8", "int8", "int32", "float32"):
        want = np.can_cast(np.min_scalar_type(value), np.dtype(dst))
        assert htt.can_cast(value, getattr(htt, dst)) == want, (value, dst)
        with pytest.raises(TypeError):
            ht.can_cast(value, getattr(ht, dst))


@pytest.mark.parametrize("name", TYPES)
def test_info_and_subdtype(name):
    t, w = getattr(htt, name), getattr(ht, name)
    if name.startswith(("float", "bfloat", "complex")):
        a, b = htt.finfo(t), ht.finfo(w)
        assert (a.bits, a.eps, a.max, a.min, a.tiny) == (b.bits, b.eps, b.max, b.min, b.tiny)
        with pytest.raises(TypeError):
            htt.iinfo(t)
    else:
        a, b = htt.iinfo(t), ht.iinfo(w)
        assert (a.bits, a.max, a.min) == (b.bits, b.max, b.min)
        with pytest.raises(TypeError):
            htt.finfo(t)
    for abstract in ("number", "integer", "signedinteger", "unsignedinteger", "floating", "complexfloating"):
        assert htt.issubdtype(t, getattr(htt, abstract)) == ht.issubdtype(w, getattr(ht, abstract))


@pytest.mark.parametrize("split", [None, 0])
def test_iscomplex_isreal(split):
    data = np.array([1 + 0j, 2 + 1j, 3 - 2j, 0j], dtype=np.complex64)
    for fn in ("iscomplex", "isreal"):
        for x in (data, data.real.copy()):
            got, want = getattr(htt, fn)(htt.array(x, split=split)), getattr(ht, fn)(ht.array(x, split=split))
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_sanitation():
    x = htt.array(np.arange(12).reshape(4, 3), split=0)
    assert htt.sanitize_infinity(x) == ht.sanitize_infinity(ht.array(np.arange(3))) == np.iinfo(np.int64).max
    assert htt.sanitize_infinity(torch.zeros(1)) == float(np.finfo(np.float32).max)
    htt.sanitize_lshape(x, torch.zeros(4, 3))
    with pytest.raises(ValueError):
        htt.sanitize_lshape(x, torch.zeros(2, 2))
    y = htt.sanitize_distribution(htt.array(np.ones((4, 3)), split=1), target=x)
    assert y.split == 0 and y.numpy().sum() == 12
    s = htt.scalar_to_1d(htt.array(5.0))
    assert s.gshape == (1,) and s.numpy().tolist() == [5.0]
    with pytest.raises(TypeError):
        htt.sanitize_in_tensor(x)


def _body(x) -> str:
    text = str(x)
    return text[len("DNDarray("): text.rindex(", dtype=")]


PRINTED = [(shape, split) for shape in [(5,), (3, 4), (40, 50), (5000,), (3, 4, 500)]
           for split in (None, 0, 1) if split is None or split < len(shape)]


@pytest.mark.parametrize("shape,split", PRINTED, ids=str)
def test_printing_matches_heat_tpu(shape, split):
    """Small arrays whole, large ones from their edge items: the same text as heat_tpu's."""
    data = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) / 7
    assert _body(htt.array(data, split=split)) == _body(ht.array(data, split=split))


def test_print_options_and_print0(capsys):
    before = htt.get_printoptions()
    try:
        htt.set_printoptions(profile="short")
        assert htt.get_printoptions()["precision"] == 2
        htt.set_printoptions(precision=6)
        assert htt.get_printoptions()["precision"] == 6
    finally:
        htt.set_printoptions(**{k: v for k, v in before.items() if k != "sci_mode"})
    htt.print0("hello")
    assert capsys.readouterr().out == "hello\n"


@pytest.mark.parametrize("name,split", CONVOLVE, ids=[f"{n}-{s}" for n, s in CONVOLVE])
def test_convolve_matches_heat_tpu(name, split):
    check(name, split)
