"""Every dtype heat_tpu computes on, the port as one rank against heat_tpu: the dtype
sweep of tests/_torch_array_cases.py (bool, uint8, int8, int16, float16, bfloat16,
complex64 and complex128 through reshapes, slices, masks, sorts, reductions, sums and
elementwise arithmetic), and the places where heat_tpu's own answers depend on the
layout or on its reduction order, each pinned here (ROADMAP Queue 3, "The reference's
own differences"): the port gives heat_tpu's one-device answer on every layout."""

import numpy as np
import pytest

import heat_tpu as ht

import heat_tpu_torch as htt
from _torch_array_cases import INPUTS
from _torch_parity import cases, check


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", cases(["dtype_"]), ids=[f"{n}-{s}" for n, s in cases(["dtype_"])])
def test_dtype_sweep(name, split):
    check(name, split)


@pytest.mark.parametrize("fn", ["max", "min"])
def test_reference_split_complex_max_raises(fn):
    """heat_tpu's max and min of a split complex array raise in XLA (no complex reduction
    across devices); at split=None they give the (real, imaginary) extreme. The port gives
    that answer on every layout."""
    c = INPUTS["cplx"]
    with pytest.raises(Exception, match="Unsupported reduction"):
        getattr(ht, fn)(ht.array(c, split=0)).numpy()
    want = getattr(ht, fn)(ht.array(c)).numpy()
    flat = c.ravel()
    order = np.lexsort((flat.imag, flat.real))
    assert want == flat[order[-1] if fn == "max" else order[0]]
    for split in (None, 0, 1):
        assert getattr(htt, fn)(htt.array(c, split=split)).numpy() == want


def test_reference_split_complex_var_is_wrong():
    """heat_tpu's var of a split complex64 array is not numpy's mean(|x - mean|²) (nor
    real); at split=None it is. The port gives numpy's on every layout."""
    c = INPUTS["cplx"]
    exact = np.mean(np.abs(c.astype(np.complex128) - c.astype(np.complex128).mean()) ** 2)
    split_var = np.asarray(ht.var(ht.array(c, split=0)).numpy())
    assert not np.allclose(split_var, exact, rtol=1e-3)
    np.testing.assert_allclose(ht.var(ht.array(c)).numpy(), exact, rtol=1e-6)
    for split in (None, 0, 1):
        got = htt.var(htt.array(c, split=split))
        assert got.dtype is htt.float32
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6)


def test_reference_split_unique_inverse_of_complex_nan():
    """heat_tpu's unique(return_inverse=True) of a split complex array with NaN gives its
    NaN elements other indices than its split=None answer (which maps each to the one
    ``nan+0j``); the port gives the split=None inverse on every layout."""
    c = INPUTS["cplx_nan"]
    values, inverse = ht.unique(ht.array(c), return_inverse=True)
    _, split_inverse = ht.unique(ht.array(c, split=0), return_inverse=True)
    nan = np.isnan(c)
    assert np.all(np.asarray(inverse.numpy())[nan] == values.shape[0] - 1)
    assert not np.array_equal(np.asarray(split_inverse.numpy()), np.asarray(inverse.numpy()))
    for split in (None, 0):
        got_values, got_inverse = htt.unique(htt.array(c, split=split), return_inverse=True)
        np.testing.assert_array_equal(got_inverse.numpy(), inverse.numpy())
        np.testing.assert_array_equal(got_values.numpy(), values.numpy())


def test_reference_complex_max_with_nan():
    """heat_tpu's max of a complex array holding a NaN follows XLA's pairwise select,
    which drops a NaN followed by a number, so its answer depends on the reduction order;
    the port returns the first value with a NaN, as numpy's maximum.reduce does, on every
    layout."""
    c = INPUTS["cplx_b"]
    nan = np.isnan(c)
    first_nan = c.ravel()[np.flatnonzero(nan.ravel())[0]]
    assert not np.isnan(complex(ht.max(ht.array(c)).numpy()))
    for split in (None, 0, 1):
        got = complex(htt.max(htt.array(c, split=split)).numpy())
        assert np.isnan(got) and (got.real == first_nan.real or np.isnan(first_nan.real))
    np.testing.assert_equal(np.max(c), first_nan)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_cumsum_accumulates_in_float32(dtype):
    """torch's cumsum of float16 and bfloat16 accumulates in float32 and rounds each output
    once; jnp's accumulates in the type itself, rounding at every step. The port's result
    is the exact cumsum rounded once to the type; heat_tpu's differs from it, within one
    rounding of the type a step."""
    x = INPUTS["f16"].astype(np.float32)
    half = htt.array(x).astype(getattr(htt, dtype))
    exact = np.cumsum(half.astype(htt.float32).numpy().astype(np.float64), 0)
    got = htt.cumsum(half, 0)
    once = htt.array(exact.astype(np.float32)).astype(getattr(htt, dtype))
    assert got.dtype is getattr(htt, dtype)
    np.testing.assert_array_equal(got.astype(htt.float32).numpy(), once.astype(htt.float32).numpy())
    want = np.asarray(ht.cumsum(ht.array(x).astype(getattr(ht, dtype)), 0).astype(ht.float32).numpy(), np.float64)
    unit = 2.0 ** (-11 if dtype == "float16" else -8)
    assert np.all(np.abs(want - exact) <= 2 * unit * np.cumsum(np.abs(exact), 0))
    assert not np.array_equal(want, got.astype(htt.float32).numpy())
