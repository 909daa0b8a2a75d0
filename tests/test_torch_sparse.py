"""heat_tpu_torch.sparse against heat_tpu.sparse: the DCSR matrix built from the same
inputs in both packages, the port as one rank against heat_tpu on one device (so the
per-rank views and counts are comparable; tests/test_torch_distributed.py runs three
ranks, one of them without rows). Values are exact: nothing is summed in another order
(sums of two stored values at most)."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import heat_tpu as ht
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.fixture(scope="module")
def one():
    """heat_tpu's communicator over one device: the port's world of one rank."""
    return MeshCommunication(jax.devices()[:1])


def _matrix(rows, cols, density, dtype, seed):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((rows, cols)) * (rng.random((rows, cols)) < density)).astype(dtype)
    if np.issubdtype(dtype, np.integer):
        a = (a * 4).astype(dtype)
    return a


MATS = {
    "f32": _matrix(7, 5, 0.4, np.float32, 1),
    "f32_b": _matrix(7, 5, 0.4, np.float32, 2),
    "f64": _matrix(6, 9, 0.3, np.float64, 3),
    "i32": _matrix(5, 4, 0.5, np.int32, 4),
    "empty_rows": np.array([[0, 0, 0], [1.5, 0, 0], [0, 0, 0], [0, 0, -2.0]], np.float32),
}
SOURCES = ["numpy", "scipy", "torch_csr", "torch_coo", "dndarray"]


def _source(kind, a, m, split, one):
    """``a`` in the form ``kind`` for package ``m``."""
    if kind == "scipy":
        return sp.csr_matrix(a)
    if kind == "torch_csr":
        return torch.tensor(a).to_sparse_csr()
    if kind == "torch_coo":
        return torch.tensor(a).to_sparse_coo()
    if kind == "dndarray":
        return m.array(a, split=split, **({"comm": one} if m is ht else {}))
    return a


def same(got, want):
    """Every view and count of a port DCSR_matrix equals heat_tpu's."""
    assert (got.shape, got.gshape, got.lshape, got.split, got.ndim) == (want.shape, want.gshape, want.lshape,
                                                                          want.split, want.ndim)
    assert got.dtype.__name__ == want.dtype.__name__
    assert (got.nnz, got.gnnz, got.lnnz, got.is_distributed()) == (want.nnz, want.gnnz, want.lnnz,
                                                                     want.is_distributed())
    for view in ("indptr", "gindptr", "global_indptr", "lindptr", "indices", "gindices", "lindices", "data", "gdata",
                 "ldata"):
        np.testing.assert_array_equal(getattr(got, view).numpy(), np.asarray(getattr(want, view)), err_msg=view)
    if want.split is not None:
        assert got.counts_displs_nnz() == want.counts_displs_nnz()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    dense_g, dense_w = got.todense(), want.todense()
    assert (dense_g.split, dense_g.dtype.__name__, dense_g.gshape) == (dense_w.split, dense_w.dtype.__name__,
                                                                       dense_w.gshape)
    np.testing.assert_array_equal(dense_g.numpy(), dense_w.numpy())


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("name", list(MATS))
def test_factory(name, kind, split, one):
    a = MATS[name]
    got = htt.sparse.sparse_csr_matrix(_source(kind, a, htt, split, one), split=split)
    want = ht.sparse.sparse_csr_matrix(_source(kind, a, ht, split, one), split=split, comm=one)
    same(got, want)


@pytest.mark.parametrize("dtype", ["float64", "int64"])
def test_factory_dtype_and_is_split(dtype, one):
    a = MATS["f32"]
    got = htt.sparse.sparse_csr_matrix(a, dtype=getattr(htt, dtype), is_split=0)
    same(got, ht.sparse.sparse_csr_matrix(a, dtype=getattr(ht, dtype), is_split=0, comm=one))
    same(htt.sparse.sparse_csr_matrix(got), ht.sparse.sparse_csr_matrix(
        ht.sparse.sparse_csr_matrix(a, dtype=getattr(ht, dtype), is_split=0, comm=one), comm=one))


@pytest.mark.parametrize("splits", [(0, 0), (None, None), (0, None), (None, 0)])
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("pair", [("f32", "f32_b"), ("f32", "f32"), ("i32", "i32"), ("empty_rows", "empty_rows")])
def test_sparse_times_sparse(pair, op, splits, one):
    """The union of both patterns, explicit zeros (a product of disjoint entries, x + -x)
    included, as heat_tpu's."""
    a, b = MATS[pair[0]], MATS[pair[1]]
    if pair[0] == pair[1]:
        b = -b if op == "add" else np.where(a != 0, 0, 1).astype(a.dtype)  # cancelling sums, products with no overlap
    mk = lambda m, x, s, **kw: m.sparse.sparse_csr_matrix(x, split=s, **kw)  # noqa: E731
    got = getattr(htt.sparse, op)(mk(htt, a, splits[0]), mk(htt, b, splits[1]))
    want = getattr(ht.sparse, op)(mk(ht, a, splits[0], comm=one), mk(ht, b, splits[1], comm=one))
    same(got, want)
    dunder = {"add": "__add__", "mul": "__mul__"}[op]
    same(getattr(mk(htt, a, splits[0]), dunder)(mk(htt, b, splits[1])), want)


@pytest.mark.parametrize("scalar", [2, 2.5, 0, -1.0])
@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("name", ["f32", "i32", "f64"])
def test_scalar_operand(name, op, scalar, one):
    """A scalar acts on the stored values only, with heat_tpu's result type."""
    got = getattr(htt.sparse, op)(htt.sparse.sparse_csr_matrix(MATS[name], split=0), scalar)
    want = getattr(ht.sparse, op)(ht.sparse.sparse_csr_matrix(MATS[name], split=0, comm=one), scalar)
    same(got, want)


@pytest.mark.parametrize("split", [None, 0])
def test_conversions(split, one):
    a = MATS["f64"]
    got = htt.sparse.to_sparse(htt.array(a, split=split))
    # heat_tpu's to_sparse takes the default communicator, not the array's: its matrix
    # on the one-device communicator is sparse_csr_matrix's
    want = ht.sparse.sparse_csr_matrix(ht.array(a, split=split, comm=one), split=split, comm=one)
    np.testing.assert_array_equal(ht.sparse.to_sparse(ht.array(a, split=split, comm=one)).numpy(), want.numpy())
    same(got, want)
    same(got.astype(htt.float32), want.astype(ht.float32))
    assert got.astype(htt.float64, copy=False) is got
    out = htt.zeros(a.shape, dtype=htt.float32, split=split)
    assert htt.sparse.to_dense(got, out=out) is out
    np.testing.assert_array_equal(out.numpy(), a.astype(np.float32))
    assert repr(got) == repr(want)


def test_errors():
    a = htt.sparse.sparse_csr_matrix(MATS["f32"])
    with pytest.raises(ValueError):
        htt.sparse.sparse_csr_matrix(MATS["f32"], split=1)
    with pytest.raises(ValueError):
        htt.sparse.sparse_csr_matrix(np.ones((2, 3, 4)))
    with pytest.raises(ValueError):
        htt.sparse.add(a, htt.sparse.sparse_csr_matrix(MATS["f64"]))
    with pytest.raises(TypeError):
        htt.sparse.mul(a, [1, 2])
    with pytest.raises(TypeError):
        htt.sparse.add(MATS["f32"], a)
    with pytest.raises(ValueError):
        a.counts_displs_nnz()


def test_no_host_round_trip(monkeypatch):
    """Building, merging and densifying never bring a tensor to the host: with
    ``Tensor.cpu`` and ``Tensor.numpy`` made to raise they still run (only counts come
    back, as Python ints)."""
    a = htt.array(MATS["f32"], split=0)
    b = htt.array(MATS["f32_b"], split=0)

    def refuse(*args, **kwargs):
        raise AssertionError("a sparse operation moved a tensor to the host")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    sa, sb = htt.sparse.to_sparse(a), htt.sparse.sparse_csr_matrix(b.larray, split=0)
    for res in (sa + sb, sa * sb, sa * 3.0, htt.sparse.sparse_csr_matrix(sa.larray.to_sparse_coo())):
        assert res.larray.device == a.larray.device
    assert res.todense().larray.device == a.larray.device
