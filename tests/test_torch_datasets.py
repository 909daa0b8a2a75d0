"""heat_tpu_torch.datasets and heat_tpu_torch.utils.data.matrixgallery against heat_tpu's.

The port ships its own copies of heat_tpu's data files, byte for byte, and reads nothing
under heat_tpu/. The gallery's matrices come from the random streams, whose normal
draws are within 4 ulp (float32) and 32 ulp (float64) of heat_tpu's: so the matrices
are compared within 1e-5 (single) and 1e-12 (double) of their largest magnitude, not
bit for bit; QR-built ones at split None, where both packages take one Householder QR
(heat_tpu's split QR is its TSQR on the test mesh, whose column signs may differ)."""

import os

import h5py
import numpy as np
import pytest

import heat_tpu as ht
import heat_tpu.datasets as ht_datasets
from heat_tpu.utils.data import matrixgallery as ht_gallery

import heat_tpu_torch as htt
import heat_tpu_torch.datasets as htt_datasets
from heat_tpu_torch.utils.data import matrixgallery as htt_gallery

FILES = ["flowers.csv", "flowers.h5", "flowers_X_test.csv", "flowers_X_train.csv", "flowers_labels.csv",
         "flowers_y_test.csv", "flowers_y_train.csv", "sugar.h5"]


@pytest.fixture(autouse=True)
def _on_cpu():
    htt.use_device("cpu")


@pytest.mark.parametrize("name", FILES)
def test_files_are_heat_tpus_byte_for_byte(name):
    """Each packaged file equals heat_tpu's byte for byte and lies in the port's own
    package directory."""
    mine = htt_datasets.path(name)
    assert os.path.dirname(mine) == os.path.dirname(os.path.abspath(htt_datasets.__file__))
    assert "heat_tpu_torch" in mine.split(os.sep)
    with open(mine, "rb") as a, open(ht_datasets.path(name), "rb") as b:
        assert a.read() == b.read()


def test_tables_are_the_files():
    """``tables()`` draws the files' contents from their seed: the CSVs as written
    (4 decimals) and the HDF5 tables exactly."""
    t = htt_datasets.tables()
    for name in ("flowers", "flowers_X_train", "flowers_X_test"):
        np.testing.assert_array_equal(np.loadtxt(htt_datasets.path(f"{name}.csv"), delimiter=";"),
                                      np.round(t[name].astype(np.float64), 4))
    for name in ("flowers_labels", "flowers_y_train", "flowers_y_test"):
        np.testing.assert_array_equal(np.loadtxt(htt_datasets.path(f"{name}.csv")), t[name])
    with h5py.File(htt_datasets.path("sugar.h5"), "r") as f:
        np.testing.assert_array_equal(f["x"][...], t["sugar_x"])
        np.testing.assert_array_equal(f["y"][...], t["sugar_y"])
    with h5py.File(htt_datasets.path("flowers.h5"), "r") as f:
        np.testing.assert_array_equal(f["data"][...], t["flowers"])


def test_generate_writes_the_same_files(tmp_path, monkeypatch):
    """``generate()`` writes heat_tpu's CSV files byte for byte and HDF5 files of the same
    tables; ``flowers.nc`` only where netCDF4 is installed, as heat_tpu's."""
    monkeypatch.setattr(htt_datasets, "_DIR", str(tmp_path))
    htt_datasets.generate()
    for name in FILES:
        assert (tmp_path / name).exists()
        if name.endswith(".csv"):
            with open(ht_datasets.path(name), "rb") as b:
                assert (tmp_path / name).read_bytes() == b.read()
    for name, keys in (("sugar.h5", ("x", "y")), ("flowers.h5", ("data",))):
        with h5py.File(tmp_path / name, "r") as a, h5py.File(ht_datasets.path(name), "r") as b:
            for key in keys:
                np.testing.assert_array_equal(a[key][...], b[key][...])
    try:
        import netCDF4  # noqa: F401
    except ImportError:
        assert not (tmp_path / "flowers.nc").exists()


def _close(got, want, single):
    assert got.dtype.__name__ == want.dtype.__name__ and got.gshape == want.gshape and got.split == want.split
    w = np.asarray(want.numpy())
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=(1e-5 if single else 1e-12) * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype,positive_definite", [("complex64", False), ("complex128", True), ("float32", True),
                                                     ("float64", False)])
def test_hermitian(dtype, positive_definite, split):
    for m in (ht, htt):
        m.random.seed(17)
    got = htt_gallery.hermitian(6, dtype=getattr(htt, dtype), split=split, positive_definite=positive_definite)
    want = ht_gallery.hermitian(6, dtype=getattr(ht, dtype), split=split, positive_definite=positive_definite)
    _close(got, want, dtype in ("complex64", "float32"))
    np.testing.assert_array_equal(got.numpy(), got.numpy().conj().T)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_parter(split):
    """The Parter matrix exactly; split 1 (of the 1-D ramp inside) raises in both."""
    if split == 1:
        for gallery in (ht_gallery, htt_gallery):
            with pytest.raises(ValueError):
                gallery.parter(9, split=split)
        return
    got, want = htt_gallery.parter(9, split=split), ht_gallery.parter(9, split=split)
    assert got.split == want.split and got.dtype.__name__ == want.dtype.__name__
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("shape,r", [((12, 7), 3), ((6, 9), 6)])
def test_random_known_rank(shape, r):
    """At split None: A, U, s and V as heat_tpu's; A's singular values are s."""
    for m in (ht, htt):
        m.random.seed(23)
    got, (gu, gs, gv) = htt_gallery.random_known_rank(*shape, r)
    want, (wu, ws, wv) = ht_gallery.random_known_rank(*shape, r)
    for g, w in ((got, want), (gu, wu), (gs, ws), (gv, wv)):
        _close(g, w, True)
    np.testing.assert_allclose(np.linalg.svd(got.numpy(), compute_uv=False)[:r], gs.numpy(), rtol=1e-5)


@pytest.mark.parametrize("split", [0, 1])
def test_random_known_singularvalues_split(split):
    """Split: the layout and dtype as heat_tpu's, the singular values as asked, U and V of
    orthonormal columns (their signs may differ from heat_tpu's TSQR)."""
    s = np.array([5.0, 2.0, 0.5], np.float64)
    for m in (ht, htt):
        m.random.seed(29)
    got, (gu, _, gv) = htt_gallery.random_known_singularvalues(10, 8, s, split=split)
    want, (wu, _, wv) = ht_gallery.random_known_singularvalues(10, 8, s, split=split)
    for g, w in ((got, want), (gu, wu), (gv, wv)):
        assert (g.gshape, g.split, g.dtype.__name__) == (w.gshape, w.split, w.dtype.__name__)
    np.testing.assert_allclose(np.linalg.svd(got.numpy(), compute_uv=False)[:3], s, rtol=1e-12)
    for q in (gu, gv):
        np.testing.assert_allclose(q.numpy().T @ q.numpy(), np.eye(3), atol=1e-12)
    with pytest.raises(ValueError):
        htt_gallery.random_known_singularvalues(2, 2, s)
