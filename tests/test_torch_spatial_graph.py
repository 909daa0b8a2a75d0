"""manhattan, rbf and the graph Laplacian in the PyTorch port against heat_tpu, on the CPU.

manhattan within 1e-5 relative, rbf within 1e-4 relative and 1e-6 absolute (heat_tpu's
own rule, tests/test_domain.py:31-35), at every split pair; the Laplacian in both
definitions and the fully connected and ε-neighbour graphs, split None and 0.
"""

import numpy as np
import pytest

import heat_tpu as ht

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _xy(seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((40, 5)).astype(np.float32), rng.standard_normal((9, 5)).astype(np.float32)


def _same_layout(got, want):
    assert got.gshape == want.gshape
    assert got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__


@pytest.mark.parametrize("y_split", [None, 0, "self"])
@pytest.mark.parametrize("x_split", [None, 0, 1])
def test_manhattan_parity(x_split, y_split):
    x, y = _xy()
    if y_split == "self":
        got, want = htt.spatial.manhattan(htt.array(x, split=x_split)), ht.spatial.manhattan(ht.array(x, split=x_split))
    else:
        got = htt.spatial.manhattan(htt.array(x, split=x_split), htt.array(y, split=y_split))
        want = ht.spatial.manhattan(ht.array(x, split=x_split), ht.array(y, split=y_split))
    _same_layout(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_manhattan_f64_and_ints():
    x = np.random.default_rng(3).integers(-5, 5, (12, 3))
    got, want = htt.spatial.manhattan(htt.array(x, split=0)), ht.spatial.manhattan(ht.array(x, split=0))
    _same_layout(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    f = x.astype(np.float64) / 3
    got, want = htt.spatial.manhattan(htt.array(f)), ht.spatial.manhattan(ht.array(f))
    _same_layout(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


@pytest.mark.parametrize("sigma", [1.0, 0.5, np.sqrt(0.5)], ids=["1.0", "0.5", "np_f64"])
@pytest.mark.parametrize("y_split", [None, 0, "self"])
@pytest.mark.parametrize("x_split", [None, 0, 1])
def test_rbf_parity(x_split, y_split, sigma):
    """A NumPy float64 sigma (as Spectral passes) makes the result float64, as in heat_tpu."""
    x, y = _xy(8)
    if y_split == "self":
        got = htt.spatial.rbf(htt.array(x, split=x_split), sigma=sigma)
        want = ht.spatial.rbf(ht.array(x, split=x_split), sigma=sigma)
    else:
        got = htt.spatial.rbf(htt.array(x, split=x_split), htt.array(y, split=y_split), sigma=sigma)
        want = ht.spatial.rbf(ht.array(x, split=x_split), ht.array(y, split=y_split), sigma=sigma)
    _same_layout(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-6)


def _similarity(m, name):
    if name == "rbf":
        return lambda x: m.spatial.rbf(x, sigma=1.5)
    return lambda x: m.spatial.cdist(x)


LAPLACIANS = [
    ("simple", "fully_connected", "upper"),
    ("norm_sym", "fully_connected", "upper"),
    ("simple", "eNeighbour", "upper"),
    ("simple", "eNeighbour", "lower"),
    ("norm_sym", "eNeighbour", "upper"),
    ("norm_sym", "eNeighbour", "lower"),
]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("sim", ["rbf", "cdist"])
@pytest.mark.parametrize("definition,mode,key", LAPLACIANS)
def test_laplacian_parity(definition, mode, key, sim, split, weighted):
    x = np.random.default_rng(4).standard_normal((23, 3)).astype(np.float32)
    value = 0.5 if sim == "rbf" else 2.0
    kw = dict(weighted=weighted, definition=definition, mode=mode, threshold_key=key, threshold_value=value)
    got = htt.graph.Laplacian(_similarity(htt, sim), **kw).construct(htt.array(x, split=split))
    want = ht.graph.Laplacian(_similarity(ht, sim), **kw).construct(ht.array(x, split=split))
    _same_layout(got, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_laplacian_argument_errors():
    for m in (ht, htt):
        with pytest.raises(NotImplementedError):
            m.graph.Laplacian(lambda x: x, definition="random_walk")
        with pytest.raises(NotImplementedError):
            m.graph.Laplacian(lambda x: x, mode="kNN")
        with pytest.raises(ValueError):
            m.graph.Laplacian(lambda x: x, threshold_key="middle")
