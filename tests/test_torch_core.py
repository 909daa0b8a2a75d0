"""The PyTorch port's core layers against heat_tpu: factories, binary operations across
splits, reductions, chunking and type promotion. The same numpy inputs go through both
packages; results are compared through ``numpy()`` together with dtype, gshape and split.
The port runs as a single rank here; tests/test_torch_distributed.py runs it on three."""

import numpy as np
import pytest

import heat_tpu as ht
from heat_tpu.core.communication import get_comm as heat_comm

import heat_tpu_torch as htt
from heat_tpu_torch.core.communication import TorchCommunication


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


def _same(got, want, rtol=1e-6, atol=0.0):
    """Global value, dtype, gshape and split of a port DNDarray equal heat_tpu's."""
    assert got.dtype.__name__ == want.dtype.__name__
    assert got.gshape == want.gshape
    assert got.split == want.split
    g, w = got.numpy(), want.numpy()
    assert g.dtype == w.dtype
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        np.testing.assert_array_equal(g, w)


def test_north_star_arange_sum():
    got, want = htt.arange(10, split=0).sum(), ht.arange(10, split=0).sum()
    assert got.item() == want.item() == 45
    assert got.dtype is htt.int64 and want.dtype is ht.int64
    _same(got, want)


FACTORIES = {
    "zeros": lambda m, s: m.zeros((7, 3), split=s),
    "zeros_i32": lambda m, s: m.zeros((7, 3), dtype=m.int32, split=s),
    "ones": lambda m, s: m.ones((7, 3), split=s),
    "empty": lambda m, s: m.empty((7, 3), dtype=m.int64, split=s),
    "full_int": lambda m, s: m.full((7, 3), 4, split=s),
    "full_float": lambda m, s: m.full((7, 3), 2.5, split=s),
    "full_bool": lambda m, s: m.full((7, 3), True, split=s),
    "array_ints": lambda m, s: m.array([[1, 2, 3]] * 7, split=s),
    "array_floats": lambda m, s: m.array([[1.5, 2.0, 3.25]] * 7, split=s),
    "array_f64": lambda m, s: m.array(np.arange(21, dtype=np.float64).reshape(7, 3), split=s),
    "array_i32": lambda m, s: m.array(np.arange(21, dtype=np.int32).reshape(7, 3), split=s),
}
LIKES = {
    "zeros_like": lambda m, a: m.zeros_like(a),
    "ones_like": lambda m, a: m.ones_like(a),
    "empty_like": lambda m, a: m.empty_like(a),
    "full_like": lambda m, a: m.full_like(a, 7),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factories(name, split):
    _same(FACTORIES[name](htt, split), FACTORIES[name](ht, split))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", sorted(LIKES))
def test_like_factories(name, split):
    src = np.arange(21, dtype=np.int32).reshape(7, 3)
    got = LIKES[name](htt, htt.array(src, split=split))
    want = LIKES[name](ht, ht.array(src, split=split))
    _same(got, want)


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("args", [(10,), (2, 11, 3), (0.0, 2.0, 0.25)], ids=str)
def test_arange(args, split):
    _same(htt.arange(*args, split=split), ht.arange(*args, split=split))


def test_is_split_single_rank():
    data = np.arange(12, dtype=np.float32).reshape(4, 3)
    _same(htt.array(data, is_split=0), ht.array(data, is_split=0))


OPERANDS = {
    "f32_s0": (lambda r: r.standard_normal((7, 3)).astype(np.float32), 0),
    "f32_s1": (lambda r: r.standard_normal((7, 3)).astype(np.float32), 1),
    "f64_none": (lambda r: r.standard_normal((7, 3)), None),
    "i32_s1": (lambda r: r.integers(1, 5, (7, 3)).astype(np.int32), 1),
    "i64_s0": (lambda r: r.integers(1, 5, (7, 3)), 0),
    "row_s0": (lambda r: r.standard_normal((1, 3)).astype(np.float32), 0),
    "vec_s0": (lambda r: r.standard_normal(3).astype(np.float32), 0),
}
PAIRS = [
    ("f32_s0", "f32_s1"),
    ("f32_s1", "f32_s0"),
    ("f32_s1", "f64_none"),
    ("i32_s1", "i64_s0"),
    ("i32_s1", "f32_s0"),
    ("f64_none", "row_s0"),
    ("row_s0", "f32_s1"),
    ("vec_s0", "f32_s1"),
    ("i64_s0", 2),
    ("i32_s1", 2.5),
    (3, "f32_s1"),
]
OPS = ["add", "sub", "mul", "div", "pow"]


def _operand(m, spec, seed):
    if not isinstance(spec, str):
        return spec
    make, split = OPERANDS[spec]
    return m.array(make(np.random.default_rng(seed)), split=split)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_binary_ops_across_splits(pair, op):
    a, b = pair
    got = getattr(htt, op)(_operand(htt, a, 1), _operand(htt, b, 2))
    want = getattr(ht, op)(_operand(ht, a, 1), _operand(ht, b, 2))
    _same(got, want, rtol=1e-5)


@pytest.mark.parametrize(
    "pair", [(2, 2.5), (3, 4), (True, 2), ([1, 2, 3], 2), (1.5, [[1.0], [2.0]]), ([1, 2], [3.5, 4])], ids=str
)
def test_binary_ops_without_dndarrays(pair):
    for op in OPS:
        _same(getattr(htt, op)(*pair), getattr(ht, op)(*pair), rtol=1e-6)


def test_dunders():
    x = np.random.default_rng(4).standard_normal((5, 4)).astype(np.float32)
    a, b = htt.array(x, split=0), ht.array(x, split=0)
    _same(-a + 2 * a - a / 3 + a**2, -b + 2 * b - b / 3 + b**2, rtol=1e-5)
    _same(1 - a, 1 - b)
    for cmp in ("__lt__", "__le__", "__gt__", "__ge__", "__eq__", "__ne__"):
        _same(getattr(a, cmp)(0.5), getattr(b, cmp)(0.5))


REDUCE_INPUTS = {
    "f32": lambda r: r.standard_normal((7, 5)).astype(np.float32),
    "i32": lambda r: r.integers(-9, 9, (7, 5)).astype(np.int32),
    "i64": lambda r: r.integers(-9, 9, (7, 5)),
    "f64": lambda r: r.standard_normal((7, 5)),
}


@pytest.mark.parametrize("keepdims", [False, True])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", sorted(REDUCE_INPUTS))
@pytest.mark.parametrize("fn", ["sum", "prod", "mean", "min", "max", "argmin", "argmax"])
def test_reductions(fn, dtype, split, axis, keepdims):
    data = REDUCE_INPUTS[dtype](np.random.default_rng(5))
    if fn == "prod":
        data = (data / 4 + 1).astype(data.dtype) if data.dtype.kind == "f" else np.clip(data, -2, 2)
    kw = {} if (fn == "mean" and keepdims is False) else {"keepdims": keepdims}
    got = getattr(htt, fn)(htt.array(data, split=split), axis=axis, **kw)
    want = getattr(ht, fn)(ht.array(data, split=split), axis=axis, **kw)
    if fn == "mean" and dtype == "i32":
        # jnp.mean's rule gives float32 for int32, as heat_tpu does on unpadded layouts;
        # heat_tpu's padded-layout path (a ragged split) gives float64 instead. The port
        # keeps jnp.mean's rule on every layout.
        assert got.dtype is htt.float32
        want = want.astype(ht.float32)
    _same(got, want, rtol=1e-5, atol=1e-6)


def test_argmin_ties_lowest_index_wins():
    data = np.array([[3, 1, 1], [1, 0, 2], [0, 0, 5], [2, 0, 0]], dtype=np.float32)
    for split in (None, 0, 1):
        for axis in (None, 0, 1):
            _same(htt.argmin(htt.array(data, split=split), axis=axis), ht.argmin(ht.array(data, split=split), axis=axis))
            _same(htt.argmax(htt.array(-data, split=split), axis=axis), ht.argmax(ht.array(-data, split=split), axis=axis))


class _SizedComm(TorchCommunication):
    """The port's communicator with a fixed world size, to compare the chunk rule."""

    def __init__(self, size):
        super().__init__()
        self._size = size

    @property
    def size(self):
        return self._size


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape", [(7, 3), (8, 8), (2, 5), (0, 4), (17, 1), (3, 19)], ids=str)
def test_chunk_and_lshape_map_match_heat_tpu(shape, split):
    hc = heat_comm()
    assert hc.size == 8
    pc = _SizedComm(hc.size)
    for r in range(hc.size):
        assert pc.chunk(shape, split, rank=r) == hc.chunk(shape, split, rank=r)
    np.testing.assert_array_equal(pc.lshape_map(shape, split), hc.lshape_map(shape, split))
    if split is not None:
        assert pc.counts_displs_shape(shape, split)[:2] == hc.counts_displs_shape(shape, split)[:2]


def test_lshape_map_single_rank():
    a = htt.zeros((7, 3), split=0)
    assert a.lshape == (7, 3)
    np.testing.assert_array_equal(a.lshape_map().numpy(), [[7, 3]])
    assert a.counts_displs() == ((7,), (0,))
    assert not a.is_distributed()


TYPE_NAMES = [
    "bool", "uint8", "int8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64", "complex64", "complex128",
]


@pytest.mark.parametrize("a", TYPE_NAMES)
def test_promote_types_match_heat_tpu(a):
    for b in TYPE_NAMES:
        got = htt.promote_types(getattr(htt, a), getattr(htt, b))
        want = ht.promote_types(getattr(ht, a), getattr(ht, b))
        assert got.__name__ == want.__name__, (a, b)


@pytest.mark.parametrize(
    "args",
    [("int32", 2), ("int32", 2.5), ("bool", 3), ("float16", 2.5), ("float32", 1j), ("int8", "int16"), (2.5,), (3,)],
    ids=str,
)
def test_result_type_matches_heat_tpu(args):
    def conv(m, a):
        return getattr(m, a) if isinstance(a, str) else a

    got = htt.result_type(*(conv(htt, a) for a in args))
    want = ht.result_type(*(conv(ht, a) for a in args))
    assert got.__name__ == want.__name__


def test_resplit_roundtrip():
    data = np.random.default_rng(6).standard_normal((7, 3)).astype(np.float32)
    a = htt.array(data, split=0)
    for target in (None, 1, 0):
        a.resplit_(target)
        assert a.split == target
        np.testing.assert_array_equal(a.numpy(), data)


def _one_device():
    """heat_tpu's communicator over one device: the port's world of one rank."""
    import jax
    from heat_tpu.core.communication import MeshCommunication

    return MeshCommunication(jax.devices()[:1])


SURFACE_ARRAYS = {
    "f32": np.arange(35, dtype=np.float32).reshape(7, 5) / 3,
    "c64": (np.arange(12) + 1j * np.arange(12)[::-1]).astype(np.complex64).reshape(3, 4),
    "i16": np.arange(24, dtype=np.int16).reshape(2, 3, 4),
    "bools": np.arange(6).reshape(3, 2) % 2 == 0,
    "empty_rows": np.ones((0, 3), np.float64),
}


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("name", list(SURFACE_ARRAYS))
def test_dndarray_surface(name, split):
    """nbytes, gnbytes, lnbytes, stride, strides, real and imag equal heat_tpu's, layout by
    layout (both count the logical chunk; the port has no padded layout)."""
    data = SURFACE_ARRAYS[name]
    got, want = htt.array(data, split=split), ht.array(data, split=split, comm=_one_device())
    for attr in ("nbytes", "gnbytes", "lnbytes", "strides", "lnumel"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert tuple(got.stride) == tuple(want.stride) == got.stride() and got.stride(0) == want.stride(0)
    _same(got.real, want.real)
    _same(got.imag, want.imag)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_partition_interface_round_trip(split):
    """``__partitioned__`` holds heat_tpu's grid, positions, starts, shapes, locations and
    dtype, this rank's chunk as its data; ``from_partitioned`` of it (and of heat_tpu's
    dict, whose data are numpy arrays) gives the array back."""
    data = SURFACE_ARRAYS["f32"]
    got, want = htt.array(data, split=split), ht.array(data, split=split, comm=_one_device())
    pg, pw = got.__partitioned__, want.__partitioned__
    assert pg["shape"] == pw["shape"] and pg["partition_tiling"] == pw["partition_tiling"]
    assert pg["locals"] == pw["locals"] and set(pg["partitions"]) == set(pw["partitions"])
    for pos, part in pw["partitions"].items():
        mine = pg["partitions"][pos]
        assert (mine["start"], mine["shape"], mine["location"], mine["dtype"]) == (
            part["start"], part["shape"], part["location"], part["dtype"])
        np.testing.assert_array_equal(pg["get"](mine["data"]).numpy(), np.asarray(pw["get"](part["data"])))
    assert got.create_partition_interface(no_data=True)["partitions"][pg["locals"][0]]["data"] is None
    for source in (got, pg, pw):
        _same(htt.from_partitioned(source), ht.from_partitioned(want, comm=want.comm))
    with pytest.raises(ValueError):
        htt.from_partition_dict(dict(pg, shape=(8, 5)))


def test_lloc_reads_and_writes_the_local_tensor():
    """``lloc`` indexes this rank's tensor (at one rank, the whole array): heat_tpu's
    marker carries the same array and key."""
    data = SURFACE_ARRAYS["f32"]
    got, want = htt.array(data, split=0), ht.array(data, split=0)
    marker = want.lloc[2:4, 1]
    array, key = marker.obj
    np.testing.assert_array_equal(got.lloc[2:4, 1].numpy(), np.asarray(array)[key])
    got.lloc[0, 0] = 7.0
    assert got.numpy()[0, 0] == 7.0 and isinstance(got.lloc, htt.LocalIndex)


def test_estimator_mixins_and_checks():
    """The mixins and ``is_*`` checks answer as heat_tpu's for each kind of estimator."""
    kinds = {
        "classifier": ("ClassificationMixin", "is_classifier"),
        "transformer": ("TransformMixin", "is_transformer"),
        "clusterer": ("ClusteringMixin", "is_clusterer"),
        "regressor": ("RegressionMixin", "is_regressor"),
    }
    for mixin, _ in kinds.values():
        for m in (ht, htt):
            est = type("Est", (getattr(m.core.base, mixin), m.BaseEstimator), {})()
            assert [getattr(m, check)(est) for _, check in kinds.values()] == [
                k == mixin for k, _ in kinds.values()]
            assert m.is_estimator(est) and not m.is_estimator(object())
            with pytest.raises(NotImplementedError):
                est.fit(None) if mixin in ("TransformMixin", "ClusteringMixin") else est.fit(None, None)


def test_top_level_names():
    """The names heat_tpu exports from its core are exported by the port too."""
    names = ["broadcast_shape", "broadcast_shapes", "sanitize_axis", "sanitize_shape", "sanitize_slice", "SplitTiles",
             "SquareDiagTiles", "LocalIndex", "COMM_SELF", "COMM_WORLD", "Communication", "initialize",
             "from_partitioned", "from_partition_dict", "ClassificationMixin", "TransformMixin", "RegressionMixin",
             "is_classifier", "is_transformer", "is_estimator", "is_clusterer", "is_regressor"]
    assert [n for n in names if not hasattr(ht, n)] == []
    assert [n for n in names if not hasattr(htt, n)] == []
    assert htt.broadcast_shape((3, 1), (1, 4)) == ht.broadcast_shape((3, 1), (1, 4))
    assert htt.sanitize_axis((2, 3), -1) == ht.sanitize_axis((2, 3), -1)
    assert htt.COMM_SELF.size == 1 and htt.COMM_SELF.rank == 0
    assert isinstance(htt.COMM_WORLD, htt.Communication)
    x = htt.arange(6, split=0, comm=htt.COMM_SELF)
    assert x.sum().item() == 15 and x.lshape == (6,)


def test_initialize_reads_torchrun_env(monkeypatch):
    """``initialize`` takes rank and world size from torchrun's environment and picks gloo
    when the CPU was asked for; on the card's path without CUDA it raises and never
    falls back to gloo."""
    seen = {}
    monkeypatch.setattr(htt.core.communication.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    htt.initialize()
    assert seen == {"backend": "gloo", "init_method": "env://", "rank": 2, "world_size": 3}
    seen.clear()
    htt.use_device("gpu")
    try:
        if not htt.core.communication.torch.cuda.is_available():
            with pytest.raises(RuntimeError):
                htt.initialize()
            assert seen == {}
    finally:
        htt.use_device("cpu")
