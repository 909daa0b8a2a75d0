"""heat_tpu_torch's sort, topk, unique, percentile and median against heat_tpu's, the port
as one rank: ties, NaNs, -0.0, descending order, ragged shapes and an empty rank; values
and int64 indices exact (percentiles within 1e-6), dtype, gshape and split equal. The
network tables are heat_tpu's; the three- and four-rank runs (odd-even transposition and
the bitonic network) are in tests/test_torch_distributed.py."""

import numpy as np
import pytest
import torch

from heat_tpu.core import dist_sort as jsort

import heat_tpu_torch as htt
from heat_tpu_torch.core import dist_sort
from _torch_parity import cases, check

SORTING = cases(["sort", "topk", "unique", "percentile", "median"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", SORTING, ids=[f"{n}-{s}" for n, s in SORTING])
def test_sorting_matches_heat_tpu(name, split):
    check(name, split)


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 5, 6, 8, 16])
def test_network_rounds_are_heat_tpus(nproc):
    assert dist_sort._network_rounds(nproc) == jsort._network_rounds(nproc)


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int64, torch.bool])
def test_pad_sentinel_sorts_last(dtype, descending):
    """A pad (whose index is past every element's) sorts after every element in the
    requested direction, NaNs included."""
    values = torch.tensor([0, 1, 1, 0], dtype=dtype)
    if dtype.is_floating_point:
        values = torch.tensor([float("nan"), -float("inf"), float("inf"), 0.0])
    pad = torch.tensor([dist_sort._pad_sentinel(dtype, descending)], dtype=dtype)
    index = torch.tensor([99, 0, 1, 2, 3])
    v, i = dist_sort._lexsort(torch.cat([pad, values]), index, 0, descending)
    assert i[-1] == 99


def test_lexsort_is_a_stable_sort():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 4, (6, 50)).astype(np.float32))
    x[0, 5] = float("nan")
    for descending in (False, True):
        want = torch.sort(x, dim=1, descending=descending, stable=True)
        v, i = dist_sort._lexsort(x, torch.arange(50).expand(6, 50).contiguous(), 1, descending)
        assert torch.equal(i, want.indices) and torch.equal(v.nan_to_num(9), want.values.nan_to_num(9))
