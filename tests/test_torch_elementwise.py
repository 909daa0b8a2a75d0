"""heat_tpu_torch's elementwise functions (rounding, exponential, trigonometric, logical,
complex, the rest of the arithmetic) against heat_tpu's, over its dtypes, the port as one
rank: the result dtype, gshape and split equal; exact results (integer, bool, rounding,
comparisons) equal, float results within 4 ulp of heat_tpu's (torch's transcendental
functions and XLA's round differently in the last bits), 64 for arctanh (XLA's formula
loses up to 36 ulp in float64 near |x| = 0.95, where arctanh is ill-conditioned)."""

import numpy as np
import pytest

import heat_tpu as ht

import heat_tpu_torch as htt
from _torch_parity import cases, check

DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16", "float32", "float64"]
UNARY = ["exp", "expm1", "exp2", "log", "log2", "log10", "log1p", "sqrt", "square", "sin", "cos", "tan", "arcsin",
         "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arctanh", "deg2rad", "rad2deg", "floor", "ceil",
         "trunc", "abs", "fabs", "round", "sign", "sgn", "isnan", "isinf", "isfinite", "isposinf", "isneginf",
         "logical_not", "signbit", "nan_to_num", "pos", "neg", "conj", "imag", "real", "angle"]
BINARY = ["floordiv", "mod", "fmod", "hypot", "copysign", "logaddexp", "logaddexp2", "arctan2", "maximum", "minimum",
          "logical_and", "logical_or", "logical_xor", "isclose", "eq", "greater_equal", "less"]
INT_BINARY = ["bitwise_and", "bitwise_or", "bitwise_xor", "gcd", "lcm", "left_shift", "right_shift"]


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _data(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, (6, 5)) if dtype.startswith("float") else rng.integers(1, 6, (6, 5))
    return x.astype(dtype)


ULPS = {"arctanh": 64}


def _same(got, want, ulps=4):
    assert got.dtype.__name__ == want.dtype.__name__, (got.dtype, want.dtype)
    assert got.gshape == want.gshape and got.split == want.split
    g, w = got.numpy(), want.numpy()
    if np.issubdtype(w.dtype, np.floating):
        tol = ulps * np.spacing(np.abs(w).astype(w.dtype)).astype(np.float64) + ulps * np.finfo(w.dtype).tiny
        assert np.all((np.abs(g.astype(np.float64) - w) <= tol) | (np.isnan(g) & np.isnan(w))), (g, w)
    else:
        np.testing.assert_array_equal(g, w)


def _pair(fn, *args):
    """heat_tpu's result and the port's, or the exception types when heat_tpu raises."""
    try:
        want = getattr(ht, fn)(*[ht.array(a, split=s) for a, s in args])
    except (TypeError, ValueError) as exc:
        with pytest.raises((TypeError, ValueError, RuntimeError, NotImplementedError)):
            getattr(htt, fn)(*[htt.array(a, split=s) for a, s in args])
        return None, exc
    return getattr(htt, fn)(*[htt.array(a, split=s) for a, s in args]), want


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fn", UNARY)
def test_unary(fn, dtype, split):
    data = _data(dtype)
    if fn in ("arccos", "arcsin", "arctanh") and not dtype.startswith("float"):
        data = (data % 1).astype(dtype)
    got, want = _pair(fn, (data, split))
    if got is not None:
        _same(got, want, ULPS.get(fn, 4))


@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("fn", BINARY)
def test_binary(fn, dtype, split):
    got, want = _pair(fn, (_data(dtype, 1), split), (_data(dtype, 2), 0))
    if got is not None:
        _same(got, want)


@pytest.mark.parametrize("dtype", ["bool", "uint8", "int32", "int64"])
@pytest.mark.parametrize("fn", INT_BINARY)
def test_integer_binary(fn, dtype):
    a, b = _data(dtype, 3), _data(dtype, 4)
    if fn in ("left_shift", "right_shift"):
        b = (b % 3).astype(dtype)
    got, want = _pair(fn, (a, 0), (b, None))
    if got is not None:
        _same(got, want)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_dunders_and_in_place(split):
    x = _data("int32")
    got, want = htt.array(x, split=split), ht.array(x, split=split)
    for g, w in ((got // 2, want // 2), (got % 3, want % 3), (~got, ~want), (got << 1, want << 1),
                 (got >> 1, want >> 1), (got & 6, want & 6), (got | 1, want | 1), (got ^ 5, want ^ 5),
                 (+got, +want), (abs(-got), abs(-want)), (7 % got, 7 % want), (2 ** got, 2 ** want)):
        _same(g, w)
    for g, w in zip(divmod(got, 4), divmod(want, 4)):
        _same(g, w)
    got += 3
    want += 3
    got *= 2
    want *= 2
    _same(got, want)


@pytest.mark.parametrize("fn", ["clip", "modf", "round_decimals"])
@pytest.mark.parametrize("dtype", ["int32", "float32", "float64"])
def test_rounding_extras(fn, dtype):
    data = _data(dtype) * 3
    got_x, want_x = htt.array(data, split=0), ht.array(data, split=0)
    if fn == "clip":
        pairs = [(htt.clip(got_x, 1, 2), ht.clip(want_x, 1, 2))]
    elif fn == "modf":
        pairs = list(zip(htt.modf(got_x), ht.modf(want_x)))
    else:
        pairs = [(htt.round(got_x, 1), ht.round(want_x, 1))]
    for g, w in pairs:
        _same(g, w)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_logical_verdicts(split):
    a = _data("float32")
    got, want = htt.array(a, split=split), ht.array(a, split=split)
    assert htt.allclose(got, got + 1e-9) == ht.allclose(want, want + 1e-9) is True
    assert htt.allclose(got, got + 1) == ht.allclose(want, want + 1) is False
    assert htt.equal(got, got) == ht.equal(want, want) is True
    assert htt.equal(got, got[:2]) == ht.equal(want, want[:2]) is False
    for fn in ("all", "any"):
        for axis in (None, 0, 1):
            _same(getattr(htt, fn)(got > 0.5, axis=axis), getattr(ht, fn)(want > 0.5, axis=axis))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("fn", ["var", "std", "nanprod", "skew", "kurtosis"])
def test_moments(fn, split, axis):
    data = _data("float64", 5)
    got = getattr(htt, fn)(htt.array(data, split=split), axis=axis)
    want = getattr(ht, fn)(ht.array(data, split=split), axis=axis)
    assert got.dtype.__name__ == want.dtype.__name__ and got.gshape == want.gshape and got.split == want.split
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_var_ddof_and_histograms(split):
    data = _data("float32", 6)
    got, want = htt.array(data, split=split), ht.array(data, split=split)
    np.testing.assert_allclose(htt.var(got, 0, ddof=1).numpy(), ht.var(want, 0, ddof=1).numpy(), rtol=1e-6)
    (gh, ge), (wh, we) = htt.histogram(got, 6), ht.histogram(want, 6)
    np.testing.assert_array_equal(gh.numpy(), wh.numpy())
    np.testing.assert_allclose(ge.numpy(), we.numpy(), rtol=0, atol=4 * np.spacing(np.abs(we.numpy()).max()))
    np.testing.assert_array_equal(htt.histc(got, 5).numpy(), ht.histc(want, 5).numpy())
    np.testing.assert_allclose(htt.average(got).numpy(), ht.average(want).numpy(), rtol=1e-6)
    np.testing.assert_allclose(htt.cov(got).numpy(), ht.cov(want).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,split", cases(["edge_"]))
def test_edge_cases(name, split):
    """Where torch's function answers otherwise than jnp's, the port answers as heat_tpu:
    sign and sgn of NaN, histogram counts of bool and int input in float, unique slices
    with NaN in numpy's order, vector_norm of int and bool in float64, trace of bool
    as an int, outer of 2-D operands, argmax/argmin, bincount and vdot of bool, and
    integer division and remainders by zero (tests/_torch_array_cases.py)."""
    check(name, split)


@pytest.mark.parametrize("split", [None, 0])
def test_bfloat16_numpy(split):
    """``numpy()`` of a bfloat16 array is an ``ml_dtypes.bfloat16`` array, as heat_tpu's."""
    data = np.array([1.5, -2.25, 3.0e5, 0.0], np.float32)
    got = htt.array(data, split=split).astype(htt.bfloat16).numpy()
    want = ht.array(data, split=split).astype(ht.bfloat16).numpy()
    assert got.dtype == want.dtype and got.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.astype(np.float32), np.asarray(want).astype(np.float32))
