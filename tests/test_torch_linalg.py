"""The port's linear algebra against heat_tpu's on the same numpy inputs, the port on one
rank: products of every split pair, the small dense operations, QR, the tile maps,
hierarchical SVD, the full SVD and its users, and the iterative solvers.

Tolerances: f32 products within 1e-5 × max|ref|, f64 within 1e-12 × max|ref|;
decompositions up to signs (R's rows, the subspaces U Uᵀ), σ within 1e-5 relative in f32;
cg and lanczos in f64 within 1e-10. tests/test_torch_distributed.py runs the same
functions on three gloo ranks against heat_tpu's three-device mesh.
"""

from functools import partial

import numpy as np
import pytest

import jax

import heat_tpu as ht
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.interop import dndarray_from_numpy
from heat_tpu_torch.testing import assert_port_equal, port_record, assert_record_equal

check = partial(assert_port_equal, tpu_array=ht.array)
SPLITS = (None, 0, 1)
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _rand(shape, dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _scaled(dtype, *arrays):
    """``atol`` of ``TOL[dtype]`` × the largest magnitude of the float64 reference."""
    ref = np.asarray(arrays[0], np.float64)
    for x in arrays[1:]:
        ref = ref @ np.asarray(x, np.float64)
    return TOL[dtype] * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sb", SPLITS)
@pytest.mark.parametrize("sa", SPLITS)
def test_matmul_2d(sa, sb, dtype):
    a, b = _rand((9, 7), dtype), _rand((7, 5), dtype, 1)
    check(ht.matmul, htt.matmul, [a, b], [sa, sb], rtol=0, atol=_scaled(dtype, a, b))


@pytest.mark.parametrize("case", [
    ("batch_a0", (3, 6, 4), 0, (4, 5), None),
    ("batch_a1", (3, 6, 4), 1, (4, 5), None),
    ("batch_a2", (3, 6, 4), 2, (4, 5), 0),
    ("batch_both0", (3, 6, 4), 0, (3, 4, 5), 0),
    ("batch_b2", (3, 6, 4), None, (3, 4, 5), 2),
    ("vec_mat", (6,), 0, (6, 4), 1),
    ("mat_vec", (5, 6), 0, (6,), 0),
    ("vec_vec", (6,), 0, (6,), None),
])
def test_matmul_nd(case):
    """≥ 3-D batches and 1-D operands, with heat_tpu's output-split rule."""
    _, sha, sa, shb, sb = case
    a, b = _rand(sha), _rand(shb, seed=1)
    check(ht.matmul, htt.matmul, [a, b], [sa, sb], rtol=0, atol=1e-5 * max(np.abs(np.matmul(a, b)).max(), 1))


def test_matmul_mixed_dtypes():
    a, b = _rand((5, 4)), np.arange(12, dtype=np.int32).reshape(4, 3)
    check(ht.matmul, htt.matmul, [a, b], [0, 1], rtol=0, atol=1e-5 * np.abs(a @ b).max())
    ia, ib = np.arange(12, dtype=np.int64).reshape(3, 4), np.arange(8, dtype=np.int64).reshape(4, 2)
    check(ht.matmul, htt.matmul, [ia, ib], [0, None])


@pytest.mark.parametrize("split", SPLITS[:2])
def test_dot(split):
    x, y = _rand((8,)), _rand((8,), seed=1)
    check(ht.dot, htt.dot, [x, y], [split, split], rtol=1e-6)
    a, b = _rand((4, 3)), _rand((3, 5), seed=1)
    check(ht.dot, htt.dot, [a, b], [split, None], rtol=1e-6)
    out_p = htt.zeros((4, 5), split=split)
    got = htt.dot(htt.array(a, split=split), htt.array(b), out=out_p)
    assert got is out_p
    np.testing.assert_allclose(out_p.numpy(), a @ b, rtol=1e-5, atol=1e-6)
    assert htt.dot(htt.array(x), 2.0).numpy().tolist() == ht.dot(ht.array(x), 2.0).numpy().tolist()


@pytest.mark.parametrize("split", SPLITS)
def test_small_dense_ops(split):
    a = _rand((4, 4), np.float64) + 4 * np.eye(4)
    b = _rand((4, 4), np.float64, seed=1)
    for fn in ("det", "inv"):
        check(getattr(ht.linalg, fn), getattr(htt.linalg, fn), [a], [split], rtol=1e-12)
    check(ht.linalg.transpose, htt.linalg.transpose, [a], [split])
    check(lambda x: x.T, lambda x: x.T, [b], [split])
    for k in (-1, 0, 2):
        check(partial(ht.linalg.tril, k=k), partial(htt.linalg.tril, k=k), [a], [split])
        check(partial(ht.linalg.triu, k=k), partial(htt.linalg.triu, k=k), [a], [split])
    if split != 1:
        check(ht.linalg.tril, htt.linalg.tril, [a[0]], [split])  # a vector: the square of its rows
        check(ht.linalg.vdot, htt.linalg.vdot, [a[0], b[0]], [split, split], rtol=1e-12)
        check(ht.linalg.outer, htt.linalg.outer, [a[0], b[1]], [split, None])
        check(ht.linalg.outer, htt.linalg.outer, [a[0], b[1]], [None, split])
        check(ht.linalg.projection, htt.linalg.projection, [a[0], b[1]], [split, split], rtol=1e-12)
    check(ht.linalg.vecdot, htt.linalg.vecdot, [a, b], [split, split], rtol=1e-12)
    check(partial(ht.linalg.vecdot, axis=0), partial(htt.linalg.vecdot, axis=0), [a, b], [split, split], rtol=1e-12)
    v3, w3 = _rand((5, 3), np.float64), _rand((5, 3), np.float64, seed=2)
    check(ht.linalg.cross, htt.linalg.cross, [v3, w3], [0 if split is not None else None] * 2, rtol=1e-12)
    t3 = _rand((2, 3, 4), np.float64)
    check(partial(ht.linalg.transpose, axes=(2, 0, 1)), partial(htt.linalg.transpose, axes=(2, 0, 1)), [t3], [split])
    assert htt.linalg.trace(htt.array(a, split=split)) == pytest.approx(ht.linalg.trace(ht.array(a, split=split)), rel=1e-12)
    check(partial(ht.linalg.trace, axis1=1, axis2=2), partial(htt.linalg.trace, axis1=1, axis2=2), [t3], [split], rtol=1e-12)


@pytest.mark.parametrize("split", SPLITS)
def test_norms(split):
    x = _rand((5, 6))
    for axis in (None, 0, 1):
        for keepdims in (False, True):
            check(partial(ht.linalg.vector_norm, axis=axis, keepdims=keepdims),
                  partial(htt.linalg.vector_norm, axis=axis, keepdims=keepdims), [x], [split], rtol=1e-6)
    for ord_ in (1, np.inf):
        check(partial(ht.linalg.vector_norm, axis=1, ord=ord_), partial(htt.linalg.vector_norm, axis=1, ord=ord_),
              [x], [split], rtol=1e-6)
    for ord_ in (None, 1, "fro", np.inf):
        check(partial(ht.linalg.matrix_norm, ord=ord_), partial(htt.linalg.matrix_norm, ord=ord_), [x], [split], rtol=1e-6)
    check(ht.linalg.norm, htt.linalg.norm, [x], [split], rtol=1e-6)
    check(partial(ht.linalg.norm, axis=0), partial(htt.linalg.norm, axis=0), [x], [split], rtol=1e-6)
    check(partial(ht.linalg.norm, axis=(0, 1), ord=1), partial(htt.linalg.norm, axis=(0, 1), ord=1), [x], [split], rtol=1e-6)
    check(ht.norm, htt.norm, [np.arange(7, dtype=np.int32)], [split if split != 1 else None], rtol=1e-6)


def _up_to_signs(q_got, q_want, axis):
    """Flip ``q_got``'s rows (axis 0) or columns (axis 1) to ``q_want``'s signs."""
    s = np.sign(np.sum(q_got * q_want, axis=1 - axis, keepdims=True))
    s[s == 0] = 1
    return q_got * (s if axis == 0 else s.reshape(1, -1))


@pytest.mark.parametrize("case", [
    ("tall_split0", (96, 5), 0, 2),
    ("tall_split0_one_tile", (48, 5), 0, 3),
    ("split1", (12, 9), 1, 2),
    ("none", (12, 9), None, 2),
    ("short_fat_split0", (5, 9), 0, 2),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qr(case, dtype):
    _, shape, split, tiles = case
    a = _rand(shape, dtype)
    got = htt.linalg.qr(htt.array(a, split=split), tiles_per_proc=tiles)
    want = ht.linalg.qr(ht.array(a, split=split), tiles_per_proc=tiles)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    scale = np.abs(a).max()
    for g, w in zip(got, want):
        assert (g.split, g.gshape, g.dtype.__name__) == (w.split, w.gshape, w.dtype.__name__)
    r_g, r_w = got.R.numpy(), want.R.numpy()
    np.testing.assert_allclose(_up_to_signs(r_g, r_w, 0), r_w, atol=tol * 10 * scale)
    np.testing.assert_allclose(_up_to_signs(got.Q.numpy(), want.Q.numpy(), 1), want.Q.numpy(), atol=tol * 10)
    np.testing.assert_allclose(got.Q.numpy() @ r_g, a, atol=tol * 10 * scale)
    r_only = htt.linalg.qr(htt.array(a, split=split), tiles_per_proc=tiles, calc_q=False)
    assert r_only.Q is None
    np.testing.assert_allclose(np.abs(r_only.R.numpy()), np.abs(r_g), atol=tol * 10 * scale)


def test_qr_overwrite_and_ints():
    a = np.arange(20, dtype=np.int64).reshape(5, 4) % 7
    q, _ = htt.linalg.qr(htt.array(a))
    assert q.dtype is htt.float32 and ht.linalg.qr(ht.array(a)).Q.dtype is ht.float32
    x = htt.array(a.astype(np.float64))
    _, r = htt.linalg.qr(x, overwrite_a=True)
    assert x.gshape == r.gshape == (4, 4) and np.array_equal(x.numpy(), r.numpy())


class _Sized(TorchCommunication):
    def __init__(self, size: int):
        super().__init__()
        self._size = size

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return 0


@pytest.mark.parametrize("size", [1, 3, 8])
@pytest.mark.parametrize("shape", [(13, 7), (4, 9), (30, 30)])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_tile_maps(size, shape, split):
    """SplitTiles and SquareDiagTiles give heat_tpu's grids, maps and indices at 1, 3 and
    8 ranks (the port's metadata needs no process group)."""
    from heat_tpu.core import tiling as jtiling

    from heat_tpu_torch.core import tiling

    mesh = MeshCommunication(jax.devices()[:size])
    x = htt.array(np.zeros(shape, np.float32), split=split, comm=_Sized(size))
    y = ht.array(np.zeros(shape, np.float32), split=split, comm=mesh)
    st, jst = tiling.SplitTiles(x), jtiling.SplitTiles(y)
    for attr in ("tile_dimensions", "tile_ends_g", "tile_locations", "lshape_map"):
        np.testing.assert_array_equal(getattr(st, attr), np.asarray(getattr(jst, attr)), err_msg=attr)
    assert st.get_tile_size((0, 0)) == jst.get_tile_size((0, 0))
    if split is not None:
        dims = st.tile_dimensions
        np.testing.assert_array_equal(st.set_tile_locations(split, dims, x), jst.set_tile_locations(split, dims, y))
    for tpp in (1, 2, 3):
        sq, jsq = tiling.SquareDiagTiles(x, tpp), jtiling.SquareDiagTiles(y, tpp)
        np.testing.assert_array_equal(sq.tile_map, jsq.tile_map)
        for attr in ("tile_rows", "tile_columns", "row_indices", "col_indices", "tile_rows_per_process",
                     "tile_columns_per_process", "last_diagonal_process"):
            assert getattr(sq, attr) == getattr(jsq, attr), attr
        assert sq.get_start_stop((0, 0)) == jsq.get_start_stop((0, 0))
        assert sq.local_to_global((0, 0), size - 1) == jsq.local_to_global((0, 0), size - 1)


def test_tiles_read_and_write():
    from heat_tpu_torch.core import tiling

    a = np.arange(42, dtype=np.float32).reshape(7, 6)
    x = htt.array(a, split=0)
    sq = tiling.SquareDiagTiles(x, 2)
    np.testing.assert_array_equal(sq[0, 0].numpy(), a[: sq.get_tile_size((0, 0))[0], : sq.get_tile_size((0, 0))[1]])
    sq[1, 1] = 0.0
    r0, r1, c0, c1 = sq.get_start_stop((1, 1))
    a[r0:r1, c0:c1] = 0.0
    np.testing.assert_array_equal(x.numpy(), a)
    st = tiling.SplitTiles(x)
    st[0] = 5.0
    np.testing.assert_array_equal(x.numpy(), np.full_like(a, 5.0))


def _low_rank(m, n, r, dtype=np.float32, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, r)) @ rng.standard_normal((r, n))).astype(dtype)


def _subspace(u):
    u = np.asarray(u, np.float64)
    return u @ u.T


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hsvd_rank(split, dtype):
    """hsvd_rank on one rank against heat_tpu on one device (the same tree): the same U
    subspace, σ and V within 1e-5 relative in f32, the error estimate near zero for an
    exact rank-4 matrix."""
    a = _low_rank(24, 40, 4, dtype)
    mesh1 = MeshCommunication(jax.devices()[:1])
    tol = 1e-5 if dtype == np.float32 else 1e-12
    U, err = htt.linalg.hsvd_rank(htt.array(a, split=split), 4)
    jU, jerr = ht.linalg.hsvd_rank(ht.array(a, split=split, comm=mesh1), 4)
    assert (U.gshape, U.split, U.dtype.__name__) == (jU.gshape, jU.split, jU.dtype.__name__)
    np.testing.assert_allclose(_subspace(U.numpy()), _subspace(jU.numpy()), atol=tol * 10)
    assert float(err.item()) < 10 * tol and float(jerr.item()) < 10 * tol
    assert err.dtype.__name__ == jerr.dtype.__name__
    U, s, V, _ = htt.linalg.hsvd_rank(htt.array(a, split=split), 4, compute_sv=True)
    jU, js, jV, _ = ht.linalg.hsvd_rank(ht.array(a, split=split, comm=mesh1), 4, compute_sv=True)
    np.testing.assert_allclose(s.numpy(), js.numpy(), rtol=tol)
    np.testing.assert_allclose(_subspace(V.numpy()), _subspace(jV.numpy()), atol=tol * 10)
    for got, want in ((U, jU), (s, js), (V, jV)):
        assert (got.gshape, got.split) == (want.gshape, want.split)


@pytest.mark.parametrize("split", [None, 1])
def test_hsvd_rtol_and_truncation(split):
    """A noisy matrix, truncated by a relative tolerance and by a rank below its own: the
    same rank, subspace and error estimate as heat_tpu's."""
    rng = np.random.default_rng(4)
    a = (_low_rank(20, 30, 6, np.float64) + 1e-3 * rng.standard_normal((20, 30)))
    mesh1 = MeshCommunication(jax.devices()[:1])
    for kwargs in ({"rtol": 1e-2}, {"rtol": 1e-5, "maxrank": 3}):
        U, err = htt.linalg.hsvd_rtol(htt.array(a, split=split), **kwargs)
        jU, jerr = ht.linalg.hsvd_rtol(ht.array(a, split=split, comm=mesh1), **kwargs)
        assert U.gshape == jU.gshape
        np.testing.assert_allclose(_subspace(U.numpy()), _subspace(jU.numpy()), atol=1e-10)
        np.testing.assert_allclose(float(err.item()), float(jerr.item()), rtol=1e-10)
    U, err = htt.linalg.hsvd(htt.array(a, split=split), maxrank=2)
    jU, jerr = ht.linalg.hsvd(ht.array(a, split=split, comm=mesh1), maxrank=2)
    np.testing.assert_allclose(_subspace(U.numpy()), _subspace(jU.numpy()), atol=1e-10)
    np.testing.assert_allclose(float(err.item()), float(jerr.item()), rtol=1e-10)


@pytest.mark.parametrize("case", [("tall0", (40, 4), 0), ("fat1", (5, 12), 1), ("none", (9, 6), None), ("fat0", (4, 9), 0)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_svd_and_users(case, dtype):
    _, shape, split = case
    a = _rand(shape, dtype, seed=5)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    got = htt.linalg.svd(htt.array(a, split=split))
    want = ht.linalg.svd(ht.array(a, split=split))
    for g, w in zip(got, want):
        assert (g.gshape, g.split, g.dtype.__name__) == (w.gshape, w.split, w.dtype.__name__)
    np.testing.assert_allclose(got.S.numpy(), want.S.numpy(), rtol=tol * 10)
    np.testing.assert_allclose(_up_to_signs(got.U.numpy(), want.U.numpy(), 1), want.U.numpy(), atol=tol * 100)
    np.testing.assert_allclose((got.U.numpy() * got.S.numpy()) @ got.Vh.numpy(), a, atol=tol * 10 * np.abs(a).max())
    s_only = htt.linalg.svd(htt.array(a, split=split), compute_uv=False)
    np.testing.assert_allclose(s_only.numpy(), want.S.numpy(), rtol=tol * 10)
    check(ht.linalg.pinv, htt.linalg.pinv, [a], [split], rtol=0, atol=tol * 100 * np.abs(np.linalg.pinv(a)).max())
    check(ht.linalg.matrix_rank, htt.linalg.matrix_rank, [a], [split])
    check(ht.linalg.cond, htt.linalg.cond, [a], [split], rtol=tol * 100)


@pytest.mark.parametrize("split", SPLITS[:2])
def test_cg(split):
    rng = np.random.default_rng(6)
    m = rng.standard_normal((12, 12))
    A = m @ m.T + 12 * np.eye(12)
    b = rng.standard_normal(12)
    x0 = np.zeros(12)
    check(ht.linalg.cg, htt.linalg.cg, [A, b, x0], [split, split, None], rtol=0, atol=1e-10)
    out = htt.zeros((12,), dtype=htt.float64, split=split)
    got = htt.linalg.cg(htt.array(A, split=split), htt.array(b, split=split), htt.array(x0), out=out)
    assert got is out
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(A, b), atol=1e-10)


def test_lanczos():
    """Lanczos with ``v0`` given, in f64 (heat_tpu draws its restarts otherwise), and with
    the default start, whose vanishing β at m = n draws from the port's generator."""
    rng = np.random.default_rng(7)
    m = rng.standard_normal((10, 10))
    A = m + m.T
    v0 = rng.standard_normal(10)
    for split in (None, 0):
        V, T = htt.linalg.lanczos(htt.array(A, split=split), 8, v0=htt.array(v0, split=split))
        jV, jT = ht.linalg.lanczos(ht.array(A, split=split), 8, v0=ht.array(v0, split=split))
        assert_record_equal(port_record(T), jT, rtol=0, atol=1e-10)
        assert_record_equal(port_record(V), jV, rtol=0, atol=1e-10)
    V_out, T_out = htt.zeros((10, 10), dtype=htt.float64), htt.zeros((10, 10), dtype=htt.float64)
    V, T = htt.linalg.lanczos(htt.array(A), 10, V_out=V_out, T_out=T_out)
    assert V is V_out and T is T_out
    np.testing.assert_allclose(V.numpy().T @ A @ V.numpy(), T.numpy(), atol=1e-10)
    np.testing.assert_allclose(V.numpy().T @ V.numpy(), np.eye(10), atol=1e-10)


def test_port_equal_helper_catches_differences():
    a = _rand((4, 3))
    check(ht.linalg.transpose, htt.linalg.transpose, [a], [0])
    with pytest.raises(AssertionError, match="split"):
        check(ht.linalg.transpose, lambda x: htt.linalg.transpose(x).resplit(None), [a], [0])
    with pytest.raises(AssertionError, match="values"):
        check(ht.linalg.transpose, lambda x: htt.linalg.transpose(x) * 2, [a], [0])
    rec = port_record(dndarray_from_numpy(a, split=1))
    assert rec["gshape"].tolist() == [4, 3] and int(rec["split"]) == 1 and rec["lshape_map"].tolist() == [[4, 3]]
