"""heat_tpu_torch's indexing against heat_tpu's: ``__getitem__`` with slices (negative
steps), ``Ellipsis`` and ``None``, integers, boolean masks (one that selects nothing on
the first rank's rows) and integer arrays; ``__setitem__``; ``nonzero`` and ``where``. The
port as one rank, values exact, dtype, gshape and split equal at splits None, 0 and 1."""

import numpy as np
import pytest

import heat_tpu as ht

import heat_tpu_torch as htt
from _torch_parity import cases, check

INDEXING = cases(["get_", "set_", "nonzero", "where"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", INDEXING, ids=[f"{n}-{s}" for n, s in INDEXING])
def test_indexing_matches_heat_tpu(name, split):
    check(name, split)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_index_split_rule_is_heat_tpus(split):
    """_index_split is heat_tpu's rule, key for key."""
    keys = [0, slice(1, 4), (slice(None), 2), (Ellipsis, None), (None, 1), ([0, 2],), (slice(None), [1, 2]),
            (np.zeros((4, 3), bool),), (1, slice(None), None)]
    data = np.arange(12.0).reshape(4, 3)
    got, want = htt.array(data, split=split), ht.array(data, split=split)
    for key in keys:
        assert got._index_split(key) == want._index_split(key), key


def test_iteration_and_scalars():
    data = np.arange(6).reshape(3, 2)
    rows = [r.numpy().tolist() for r in htt.array(data, split=0)]
    assert rows == data.tolist()
    x = htt.array([[7]])
    assert int(x) == 7 and float(x) == 7.0 and complex(x) == 7 and [0, 1, 2][htt.array(1)] == 1


@pytest.mark.parametrize("split", [None, 0, 1])
def test_fill_diagonal(split):
    got = htt.zeros((5, 3), split=split).fill_diagonal(2.5)
    want = ht.zeros((5, 3), split=split).fill_diagonal(2.5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
