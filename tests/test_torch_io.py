"""The port's I/O (heat_tpu_torch/core/io.py) against heat_tpu's on the same files: a file
written by one package loads in the other, for CSV (the byte-offset parse, headers, ragged
split 0), HDF5 (round trips, the save modes, fraction loads, ragged extents), NPY, zarr,
the errors and the packaged datasets; heat_tpu runs on its 8-device CPU test mesh, the
port at one rank, and per-rank slabs are checked with communicators that report a size
without a process group. The multi-rank slab writes run in tests/test_torch_train_state.py.
"""

import numpy as np
import pytest
import torch

import heat_tpu as jht

import heat_tpu_torch as ht
from heat_tpu_torch.core import io as tio
from heat_tpu_torch.core.communication import TorchCommunication


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


@pytest.fixture
def data():
    return np.random.default_rng(0).random((12, 5)).astype(np.float32)


class _Sized(TorchCommunication):
    """A communicator of ``size`` ranks seen from ``rank``, without a process group."""

    def __init__(self, size: int, rank: int = 0):
        super().__init__()
        self._size, self._rank = size, rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return self._rank


PACKAGES = {"port_writes": (ht, jht), "heat_tpu_writes": (jht, ht)}


@pytest.mark.parametrize("direction", sorted(PACKAGES))
@pytest.mark.parametrize("split", [None, 0])
def test_csv_roundtrip_across_packages(tmp_path, data, direction, split):
    writer, reader = PACKAGES[direction]
    p = str(tmp_path / "x.csv")
    writer.save(writer.array(data, split=split), p, decimals=7)
    back = reader.load(p, split=split)
    np.testing.assert_allclose(back.numpy(), data, rtol=1e-5)
    assert back.split == split
    # the file each package writes is the same text
    q = str(tmp_path / "y.csv")
    reader.save(reader.array(data, split=split), q, decimals=7)
    assert open(p).read() == open(q).read()


@pytest.mark.parametrize("nrows", [7, 16, 3])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_csv_byte_offset_parse(tmp_path, nrows, split):
    data = np.random.default_rng(3 + nrows).random((nrows, 4)).astype(np.float32)
    p = str(tmp_path / "b.csv")
    np.savetxt(p, data, delimiter=",")
    got = ht.load_csv(p, split=split)
    want = jht.load_csv(p, split=split)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert got.split == split and got.gshape == want.gshape and got.larray.dtype == torch.float32


@pytest.mark.parametrize("case", ["column", "no_trailing_newline", "blank_lines", "empty", "header"])
def test_csv_edge_files(tmp_path, case):
    p = str(tmp_path / f"{case}.csv")
    kw = {}
    if case == "column":
        np.savetxt(p, np.arange(9.0))
    elif case == "empty":
        open(p, "w").close()
    else:
        text = {"no_trailing_newline": "1,2\n3,4\n5,6", "blank_lines": "1,2\n\n3,4\n   \n5,6\n",
                "header": "a,b\nc,d\n1,2\n3,4\n"}[case]
        with open(p, "w") as fh:
            fh.write(text)
        kw = {"header_lines": 2} if case == "header" else {}
    for split in (None, 0):
        got, want = ht.load_csv(p, split=split, **kw), jht.load_csv(p, split=split, **kw)
        assert got.gshape == want.gshape
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_csv_header_and_decimals(tmp_path, data):
    p, q = str(tmp_path / "h.csv"), str(tmp_path / "j.csv")
    ht.save_csv(ht.array(data), p, header_lines=["a,b,c,d,e"], decimals=5)
    jht.save_csv(jht.array(data), q, header_lines=["a,b,c,d,e"], decimals=5)
    assert open(p).read() == open(q).read()
    np.testing.assert_array_equal(ht.load_csv(p, header_lines=1).numpy(), jht.load_csv(p, header_lines=1).numpy())


@pytest.mark.parametrize("n", [3, 8 * 4 + 3])
def test_csv_ragged_split0_per_rank_rows(tmp_path, n):
    """At split 0 each rank parses only its own rows: every rank of a 4-rank communicator
    holds its chunk of heat_tpu's result."""
    ref = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    p = str(tmp_path / "ragged.csv")
    np.savetxt(p, ref, delimiter=",", fmt="%.1f")
    want = jht.load_csv(p, split=0).numpy()
    parts = []
    for r in range(4):
        comm = _Sized(4, r)
        x = ht.load_csv(p, split=0, comm=comm)
        _, lshape, sl = comm.chunk((n, 2), 0)
        assert tuple(x.larray.shape) == lshape and x.gshape == (n, 2)
        parts.append(x.larray.numpy())
    np.testing.assert_array_equal(np.concatenate(parts), want)


@pytest.mark.parametrize("direction", sorted(PACKAGES))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_hdf5_roundtrip_across_packages(tmp_path, data, direction, split):
    writer, reader = PACKAGES[direction]
    p = str(tmp_path / "x.h5")
    writer.save(writer.array(data, split=split), p, "data")
    back = reader.load(p, dataset="data", split=split)
    np.testing.assert_array_equal(back.numpy(), data)
    assert back.split == split


@pytest.mark.parametrize("n", [4 * 8, 4 * 8 + 5])
def test_hdf5_ragged_read_touches_only_local_slabs(tmp_path, n):
    """Every rank of a 4-rank communicator reads one request, its own chunk, and holds
    its rows of heat_tpu's load."""
    import h5py

    ref = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    path = str(tmp_path / "ragged.h5")
    with h5py.File(path, "w") as fh:
        fh.create_dataset("data", data=ref)
    want = jht.load_hdf5(path, dataset="data", split=0).numpy()
    c = -(-n // 4)
    requests = []
    original = h5py.Dataset.__getitem__

    def spy(self, key):
        requests.append(key)
        return original(self, key)

    parts = []
    h5py.Dataset.__getitem__ = spy
    try:
        for r in range(4):
            requests.clear()
            x = ht.load_hdf5(path, "data", split=0, comm=_Sized(4, r))
            assert len(requests) <= 1
            for key in requests:
                assert key[0].stop - key[0].start <= c
            parts.append(x.larray.numpy())
    finally:
        h5py.Dataset.__getitem__ = original
    np.testing.assert_array_equal(np.concatenate(parts), want)


def test_hdf5_save_modes_match_heat_tpu(tmp_path):
    import h5py

    for pkg, name in ((ht, "port.h5"), (jht, "jax.h5")):
        path = str(tmp_path / name)
        pkg.save_hdf5(pkg.arange(12, split=0), path, dataset="a", mode="w")
        pkg.save_hdf5(pkg.arange(6, split=0) * 2, path, dataset="b", mode="a")
        with pytest.raises(ValueError):
            pkg.save_hdf5(pkg.arange(3), path, dataset="c", mode="x")
    with h5py.File(str(tmp_path / "port.h5"), "r") as fp, h5py.File(str(tmp_path / "jax.h5"), "r") as fj:
        for key in ("a", "b"):
            assert fp[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(np.asarray(fp[key]), np.asarray(fj[key]))


def test_hdf5_save_writes_slabs_without_a_gather(tmp_path, monkeypatch):
    """A split save writes its chunk without gathering the global array."""
    import h5py

    from heat_tpu_torch.core.dndarray import DNDarray

    monkeypatch.setattr(DNDarray, "numpy", lambda self: (_ for _ in ()).throw(AssertionError("a global gather")))
    for n in (8, 13):
        ref = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        path = str(tmp_path / f"slab_{n}.h5")
        ht.save_hdf5(ht.array(ref, split=0), path, dataset="data")
        with h5py.File(path, "r") as fh:
            np.testing.assert_array_equal(np.asarray(fh["data"]), ref)


@pytest.mark.parametrize("split", [0, None])
def test_hdf5_load_fraction(tmp_path, data, split):
    p = str(tmp_path / "f.h5")
    jht.save_hdf5(jht.array(data), p, "data")
    got = ht.load_hdf5(p, "data", load_fraction=0.5, split=split)
    want = jht.load_hdf5(p, "data", load_fraction=0.5, split=split)
    assert got.gshape == want.gshape
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("direction", sorted(PACKAGES))
@pytest.mark.parametrize("splits", [(0, 1), (None, 0), (1, None)])
def test_npy_roundtrip_across_packages(tmp_path, data, direction, splits):
    writer, reader = PACKAGES[direction]
    p = str(tmp_path / "x.npy")
    writer.save(writer.array(data, split=splits[0]), p)
    back = reader.load(p, split=splits[1])
    np.testing.assert_array_equal(back.numpy(), data)
    assert back.split == splits[1]


def test_npy_load_copies_its_slab(tmp_path, data):
    """A CPU load through the memory map owns its tensor: writing to it leaves the file."""
    p = str(tmp_path / "x.npy")
    np.save(p, data)
    x = ht.load_npy(p, split=0)
    x.larray += 1
    np.testing.assert_array_equal(np.load(p), data)


@pytest.mark.parametrize("direction", sorted(PACKAGES))
@pytest.mark.parametrize("split", [None, 0, 1])
def test_zarr_roundtrip_across_packages(tmp_path, data, direction, split):
    writer, reader = PACKAGES[direction]
    p = str(tmp_path / f"z{split}.zarr")
    writer.save(writer.array(data, split=split), p)
    back = reader.load(p, split=split)
    np.testing.assert_array_equal(back.numpy(), data)
    assert back.split == split
    back64 = reader.load_zarr(p, dtype=reader.float64, split=split)
    assert back64.dtype is reader.float64


def test_zarr_chunks_on_the_split_grid(tmp_path):
    even = np.arange(8 * 4 * 3, dtype=np.float32).reshape(-1, 3)
    p = str(tmp_path / "ze.zarr")
    ht.save_zarr(ht.array(even, split=0), p)
    np.testing.assert_array_equal(jht.load_zarr(p, split=0).numpy(), even)
    np.testing.assert_array_equal(ht.load_zarr(p, split=0).numpy(), even)


def test_errors(tmp_path):
    for pkg in (ht, jht):
        with pytest.raises(ValueError):
            pkg.load(str(tmp_path / "x.bogus"))
        with pytest.raises(TypeError):
            pkg.load(42)
        with pytest.raises(TypeError):
            pkg.save(np.zeros(3), str(tmp_path / "x.csv"))
        with pytest.raises(ValueError):
            pkg.save_csv(pkg.ones((2, 2, 2)), str(tmp_path / "x.csv"))
        with pytest.raises(ValueError):
            pkg.load_hdf5(str(tmp_path / "x.h5"), "data", load_fraction=0.0)
        with pytest.raises(TypeError):
            pkg.load_hdf5(str(tmp_path / "x.h5"), "data", load_fraction=1)
    assert ht.io.supports_netcdf() == jht.io.supports_netcdf() is False
    assert ht.io.supports_hdf5() and ht.io.supports_zarr()
    with pytest.raises(RuntimeError, match="netcdf"):
        ht.load(str(tmp_path / "x.nc"), "v")


def test_netcdf_slice_composition_matches_heat_tpu():
    from heat_tpu.core.io import _compose_netcdf_slices as jcomp
    from heat_tpu.core.io import _netcdf_has_fancy_keys as jfancy

    cases = [
        (slice(None), (10, 4), (10, 4), [False] * 2),
        (slice(10, 20), (10,), (10,), [True]),
        (slice(4, None), (6,), (4,), [True]),
        (slice(0, 20, 2), (10,), (20,), [False]),
        (slice(-5, None), (5,), (10,), [False]),
        ((Ellipsis, slice(1, 3)), (10, 2), (10, 4), [False] * 2),
        (slice(0, 5), (10,), (10,), [False]),
        ((slice(None), [1, 2]), (10, 2), (10, 4), [False] * 2),
        (slice(None, None, -1), (10,), (10,), [False]),
        (slice(10, 20), (10,), (10,), [False]),
        (slice(None), (10,), (10, 4), [False] * 2),
    ]
    for args in cases:
        assert tio._compose_netcdf_slices(*args) == jcomp(*args), args
    for keys in ([1, 2], (slice(None), 3), slice(None, None, -1), (Ellipsis, slice(1, 3)), slice(None)):
        assert tio._netcdf_has_fancy_keys(keys) == jfancy(keys)


def test_packaged_datasets_match_heat_tpu():
    from heat_tpu import datasets as jds

    from heat_tpu_torch import datasets as tds

    for name, kw in (("flowers.csv", {"sep": ";"}), ("flowers_X_train.csv", {"sep": ";"}),
                     ("flowers_y_test.csv", {"dtype": "int64"}), ("flowers_labels.csv", {"dtype": "int64"})):
        tkw = {k: (getattr(ht, v) if k == "dtype" else v) for k, v in kw.items()}
        jkw = {k: (getattr(jht, v) if k == "dtype" else v) for k, v in kw.items()}
        got = ht.load_csv(tds.path(name), split=0, **tkw)
        want = jht.load_csv(jds.path(name), split=0, **jkw)
        assert got.gshape == want.gshape
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    for dset in ("x", "y"):
        got = ht.load(tds.path("sugar.h5"), dataset=dset, split=0)
        want = jht.load(jds.path("sugar.h5"), dataset=dset, split=0)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    h = ht.load(tds.path("flowers.h5"), dataset="data", split=0)
    np.testing.assert_array_equal(h.numpy(), jht.load(jds.path("flowers.h5"), dataset="data", split=0).numpy())


def test_iter_shards_and_lshards():
    """A rank's shard is its chunk with its global index; an empty chunk yields none."""
    x = ht.array(np.arange(21.0).reshape(7, 3), split=0)
    (index, value), = list(x.iter_shards())
    assert index == (slice(0, 7), slice(0, 3)) and torch.equal(value, x.larray)
    assert len(x.lshards) == 1
    for r, rows in enumerate([(0, 2), (2, 4), (4, 6), (6, 7)]):
        comm = _Sized(4, r)
        _, lshape, sl = comm.chunk((7, 3), 0)
        y = ht.core.dndarray.DNDarray(torch.zeros(lshape), (7, 3), ht.float32, 0, ht.cpu, comm, True)
        assert [i for i, _ in y.iter_shards()] == [(slice(*rows), slice(0, 3))]
    empty = ht.core.dndarray.DNDarray(torch.zeros((0, 3)), (2, 3), ht.float32, 0, ht.cpu, _Sized(4, 3), True)
    assert list(empty.iter_shards()) == [] and empty.lshards == []
    jx = jht.array(np.arange(21.0).reshape(7, 3), split=0)
    assert sorted(i for i, _ in jx.iter_shards())[0][1] == slice(0, 3)
