"""heat_tpu_torch's manipulations against heat_tpu's on the same seeded inputs, the port
as one rank: values exact, dtype, gshape and split equal, at splits None, 0 and 1, on
ragged shapes and one with an empty rank (the cases of tests/_torch_array_cases.py; the
three- and four-rank runs are in tests/test_torch_distributed.py)."""

import numpy as np
import pytest
import torch

import heat_tpu as ht

import heat_tpu_torch as htt
from _torch_parity import cases, check

MANIPULATIONS = cases(["reshape", "flatten", "concatenate", "hstack", "vstack", "column_stack", "stack", "resplit",
                       "squeeze", "expand_dims", "swapaxes", "moveaxis", "flip", "rot90", "roll", "pad", "repeat",
                       "tile", "diag", "split", "hsplit", "broadcast_to", "cumsum", "cumprod", "diff", "where_kw",
                       "maximum", "all0", "any", "nansum", "bincount", "digitize", "bucketize"])


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name,split", MANIPULATIONS, ids=[f"{n}-{s}" for n, s in MANIPULATIONS])
def test_manipulation_matches_heat_tpu(name, split):
    check(name, split)


@pytest.mark.parametrize("mode", ["edge", "wrap", "reflect", "symmetric", "mean"])
def test_pad_off_the_cpu_never_reaches_numpy(monkeypatch, mode):
    """On a tensor off the CPU (meta here, CUDA on the card) the modes that copy
    elements index the tensor on its device, and the computed modes (mean here) compute
    by torch ops on it; numpy's pad is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("numpy.pad called")

    monkeypatch.setattr(np, "pad", refuse)
    x = htt.array(np.arange(12.0, dtype=np.float32).reshape(4, 3))
    meta = htt.DNDarray(torch.empty((4, 3), device="meta"), (4, 3), x.dtype, None, x.device, x.comm, True)
    res = htt.pad(meta, ((1, 5), (4, 0)), mode=mode)
    assert res.larray.device.type == "meta" and res.gshape == (10, 7)
    monkeypatch.undo()
    np.testing.assert_array_equal(htt.pad(x, ((1, 5), (4, 0)), mode=mode).numpy(),
                                  np.pad(x.numpy(), ((1, 5), (4, 0)), mode=mode))


@pytest.mark.parametrize("split", [None, 0, 1])
def test_copy_is_independent(split):
    x = htt.array(np.arange(12.0).reshape(4, 3), split=split)
    y = htt.copy(x)
    y[0, 0] = 99.0
    assert x.numpy()[0, 0] == 0.0 and y.numpy()[0, 0] == 99.0
    assert (y.split, y.gshape, y.dtype) == (x.split, x.gshape, x.dtype)


def test_balance_and_redistribute_keep_the_canonical_chunks():
    x = htt.array(np.arange(10), split=0)
    assert htt.balance(x) is x and x.is_balanced()
    np.testing.assert_array_equal(htt.redistribute(x, target_map=x.lshape_map()).numpy(), np.arange(10))
    with pytest.raises(NotImplementedError):
        x.redistribute_(target_map=np.array([[3]]))
    w = ht.array(np.arange(10), split=0)
    with pytest.raises(NotImplementedError):
        w.redistribute_(target_map=np.array([[3]] * w.comm.size))


@pytest.mark.parametrize("split", [None, 0])
def test_linspace_logspace_eye_meshgrid(split):
    for got, want in (
        (htt.linspace(-1.5, 2.0, 9, split=split), ht.linspace(-1.5, 2.0, 9, split=split)),
        (htt.linspace(0, 1, 5, dtype=htt.float64, split=split), ht.linspace(0, 1, 5, dtype=ht.float64, split=split)),
        (htt.eye((5, 3), split=split), ht.eye((5, 3), split=split)),
        (htt.eye(4, dtype=htt.int32, split=split), ht.eye(4, dtype=ht.int32, split=split)),
    ):
        assert (got.dtype.__name__, got.gshape, got.split) == (want.dtype.__name__, want.gshape, want.split)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    got, want = htt.logspace(0, 2, 7, split=split), ht.logspace(0, 2, 7, split=split)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    gx, gy = htt.meshgrid(htt.arange(3, split=split), htt.arange(4))
    wx, wy = ht.meshgrid(ht.arange(3, split=split), ht.arange(4))
    for g, w in ((gx, wx), (gy, wy)):
        assert (g.gshape, g.split) == (w.gshape, w.split)
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_asarray_keeps_a_dndarray():
    x = htt.arange(4)
    assert htt.asarray(x) is x
    assert htt.asarray(x, dtype=htt.float32).dtype is htt.float32
