"""The port's input pipeline against heat_tpu's on the same inputs and seeds: the vision
transforms (tests/test_vision.py's cases, the random ones equal under the same keys and
seeds), ``Dataset``, ``DataLoader`` and the shuffles (heat_tpu's permutation), the
``PartialH5Dataset`` windows, the TFRecord index, parse and ImageNet merge on files the
test writes, and the MNIST gate.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch

import jax

import heat_tpu as jht
from heat_tpu.utils import vision_transforms as J
from heat_tpu.utils.data import _utils as jutils

import heat_tpu_torch as ht
from heat_tpu_torch.utils import vision_transforms as T
from heat_tpu_torch.utils.data import _utils as tutils


@pytest.fixture(autouse=True)
def _on_cpu():
    ht.use_device("cpu")


@pytest.fixture
def batch():
    return np.random.default_rng(0).integers(0, 256, (8, 3, 16, 16)).astype(np.uint8)


def _kd(key):
    """heat_tpu's key as the two uint32 words the port takes."""
    return np.asarray(jax.random.key_data(key))


# ------------------------------------------------------------------ vision transforms
def test_to_tensor_and_normalize(batch):
    got, want = T.ToTensor()(batch), J.ToTensor()(batch)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = batch.astype(np.float32)
    mean, std = [1.0, 2.0, 3.0], [2.0, 2.0, 2.0]
    np.testing.assert_array_equal(T.Normalize(mean, std)(x).numpy(), np.asarray(J.Normalize(mean, std)(x)))
    g = x[0, 0]
    np.testing.assert_array_equal(T.Normalize(5.0, 2.0)(g).numpy(), np.asarray(J.Normalize(5.0, 2.0)(g)))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_random_flips_match_heat_tpu(batch, seed, ndim):
    x = batch.astype(np.float32)[(0,) * (4 - ndim)]
    for tcls, jcls in ((T.RandomHorizontalFlip, J.RandomHorizontalFlip), (T.RandomVerticalFlip, J.RandomVerticalFlip)):
        for p in (0.0, 0.5, 1.0):
            key = jax.random.key(seed)
            np.testing.assert_array_equal(tcls(p)(x, key=_kd(key)).numpy(), np.asarray(jcls(p)(x, key=key)))
        # the module's stream: seed() and then keyless calls draw heat_tpu's keys
        T.seed(seed)
        J.seed(seed)
        for _ in range(3):
            np.testing.assert_array_equal(tcls(0.5)(x).numpy(), np.asarray(jcls(0.5)(x)))


@pytest.mark.parametrize("size,padding", [(8, 0), (16, 2), ((5, 9), 1)])
def test_random_crop_matches_heat_tpu(batch, size, padding):
    x = batch.astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        got = T.RandomCrop(size, padding=padding)(x, key=_kd(key)).numpy()
        np.testing.assert_array_equal(got, np.asarray(J.RandomCrop(size, padding=padding)(x, key=key)))
    np.testing.assert_array_equal(T.CenterCrop(8)(x).numpy(), x[:, :, 4:12, 4:12])


@pytest.mark.parametrize("size", [(8, 8), 4, (20, 24), (16, 5)])
def test_resize_matches_heat_tpu(batch, size):
    x = batch.astype(np.float32)
    got, want = T.Resize(size)(x).numpy(), np.asarray(J.Resize(size)(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    const = np.full((3, 16, 16), 7.0, np.float32)
    np.testing.assert_allclose(T.Resize(4)(const).numpy(), 7.0, rtol=1e-5)


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_compose_on_dndarrays_matches_heat_tpu(batch, split):
    """A DNDarray comes back a DNDarray with its split: a batch split along its samples is
    transformed rank by rank (each rank its chunk of the per-sample draws); any other split
    on the gathered value."""
    pipe_t = T.Compose([T.ToTensor(), T.Normalize([0.5] * 3, [0.5] * 3), T.RandomHorizontalFlip(), T.CenterCrop(8)])
    pipe_j = J.Compose([J.ToTensor(), J.Normalize([0.5] * 3, [0.5] * 3), J.RandomHorizontalFlip(), J.CenterCrop(8)])
    key = jax.random.key(9)
    want = np.asarray(pipe_j(batch, key=key))
    got = pipe_t(ht.array(batch, split=split), key=_kd(key))
    assert isinstance(got, ht.DNDarray) and got.split == split and got.gshape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    jgot = pipe_j(jht.array(batch, split=split), key=key)
    np.testing.assert_array_equal(jgot.numpy(), want)
    assert "Compose" in repr(pipe_t) and "Lambda" in repr(T.Lambda(abs)) and T.Lambda(abs)(-2) == 2


def test_transform_errors():
    for mod in (T, J):
        with pytest.raises(ValueError):
            mod.CenterCrop(4)(np.zeros((2, 2, 2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="two uint32"):
        T.RandomHorizontalFlip()(np.zeros((4, 4), np.float32), key=[1, 2, 3])


# ------------------------------------------------------------------ Dataset, DataLoader, the shuffles
def test_dataset_shuffle_is_heat_tpus_permutation():
    for pkg in (ht, jht):
        pkg.random.seed(5)
    xs, ys = [], []
    for pkg in (ht, jht):
        ds = pkg.utils.data.Dataset(pkg.arange(40, split=0).reshape((20, 2)), pkg.arange(20, split=0))
        ds.shuffle()
        x, y = ds.arrays
        assert x.split == 0 and y.split == 0
        xs.append(x.numpy())
        ys.append(y.numpy())
        np.testing.assert_array_equal(x.numpy()[:, 0] // 2, y.numpy())
    np.testing.assert_array_equal(xs[0], xs[1])
    np.testing.assert_array_equal(ys[0], ys[1])
    assert not np.array_equal(ys[0], np.arange(20))
    for pkg in (ht, jht):  # the counter advanced alike
        assert pkg.random.get_state()[2] == 20


@pytest.mark.parametrize("n,batch_size,drop_last", [(12, 5, False), (12, 5, True), (10, 4, False), (40, 8, False)])
def test_dataloader_matches_heat_tpu(n, batch_size, drop_last):
    """Epoch 1 in order, later epochs reshuffled by heat_tpu's permutation; the ragged tail
    batch kept unless drop_last."""
    epochs = []
    for pkg in (ht, jht):
        pkg.random.seed(7)
        x = pkg.arange(n, split=0).astype(pkg.float32).reshape((n, 1))
        dl = pkg.utils.data.DataLoader(x, batch_size=batch_size, drop_last=drop_last)
        assert len(dl) == (n // batch_size if drop_last else -(-n // batch_size))
        runs = []
        for _ in range(3):
            batches = list(dl)
            assert all(b.split == 0 for b in batches)
            runs.append([b.numpy().ravel().tolist() for b in batches])
        epochs.append(runs)
    assert epochs[0] == epochs[1]
    assert epochs[0][0][0] == list(range(min(batch_size, n)))


def test_dataset_ishuffle_test_set_and_errors():
    for pkg in (ht, jht):
        ds = pkg.utils.data.Dataset(pkg.arange(6, split=0), test_set=True)
        ds.Shuffle()
        ds.Ishuffle()
        np.testing.assert_array_equal(ds.arrays[0].numpy(), np.arange(6))
        assert len(ds) == 6 and ds[2].item() == 2
        with pytest.raises(ValueError):
            pkg.utils.data.Dataset(pkg.arange(6), pkg.arange(5))
        with pytest.raises(TypeError):
            pkg.utils.data.DataLoader(42)
    ht.random.seed(1)
    jht.random.seed(1)
    a, b = ht.utils.data.Dataset(ht.arange(9, split=0)), jht.utils.data.Dataset(jht.arange(9, split=0))
    ht.utils.data.dataset_ishuffle(a)
    jht.utils.data.dataset_ishuffle(b)
    np.testing.assert_array_equal(a.arrays[0].numpy(), b.arrays[0].numpy())


# ------------------------------------------------------------------ PartialH5Dataset
@pytest.mark.parametrize("kw,sizes", [
    ({"initial_load": 10, "load_length": 10}, [10, 10, 5]),
    ({"initial_load": 15, "load_length": 5}, [15, 5, 5]),
    ({"initial_load": 100, "load_length": 100, "available_memory": 80}, [5, 5, 5, 5, 5]),
    ({"initial_load": 5, "load_length": 5, "validate_set": True}, [25]),
])
def test_partial_h5_windows_match_heat_tpu(tmp_path, kw, sizes):
    p = str(tmp_path / "stream.h5")
    data = np.arange(100.0, dtype=np.float32).reshape(25, 4)
    ht.save_hdf5(ht.array(data), p, "data")
    port = [c for c in ht.utils.data.partial_dataset.PartialH5Dataset(p, **kw)]
    ref = [np.asarray(c) for c in jht.utils.data.partial_dataset.PartialH5Dataset(p, **kw)]
    assert [len(c) for c in port] == [len(c) for c in ref] == sizes
    assert all(isinstance(c, torch.Tensor) for c in port)
    np.testing.assert_array_equal(np.vstack([c.numpy() for c in port]), data)


def test_partial_h5_names_transforms_and_refill(tmp_path):
    import h5py

    p = str(tmp_path / "two.h5")
    with h5py.File(p, "w") as fh:
        fh.create_dataset("x", data=np.arange(40.0, dtype=np.float32).reshape(10, 4))
        fh.create_dataset("y", data=np.arange(10, dtype=np.int64))
    kw = dict(dataset_names=["x", "y"], initial_load=4, load_length=3)
    port = list(ht.utils.data.PartialH5Dataset(p, transforms=[lambda t: t * 2], **kw))
    ref = list(jht.utils.data.PartialH5Dataset(p, transforms=[lambda t: t * 2], **kw))
    assert len(port) == len(ref) == 3
    for (px, py), (jx, jy) in zip(port, ref):
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    for pkg in (ht, jht):
        ds = pkg.utils.data.PartialH5Dataset(p, **kw)
        window = {"x": np.zeros((4, 4), np.float32), "y": np.zeros(4, np.int64)}
        nxt = ds.thread_replace_converted_batches(window, [1, 3], 9)
        assert nxt == 1 and window["y"].tolist() == [0, 9, 0, 0] and len(ds) == 10
        assert ds.Shuffle() is NotImplementedError and ds.Ishuffle() is NotImplementedError
    assert ht.utils.data.PartialH5Dataset(p, dataset_names="x", use_gpu=False).device == ht.cpu


# ------------------------------------------------------------------ TFRecord, the ImageNet merge
def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _example(features: dict) -> bytes:
    body = b""
    for name, feat in features.items():
        body += _ld(1, _ld(1, name.encode()) + _ld(2, feat))
    return _ld(1, body)


def _write_tfrecord(path, payloads):
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)) + b"\x00" * 4 + p + b"\x00" * 4)


def _jpeg(h, w, seed):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def _imagenet_example(h, w, label, seed, with_bbox=True):
    ints = lambda vals: _ld(3, _ld(1, b"".join(_varint(v & (1 << 64) - 1) for v in vals)))  # noqa: E731
    byts = lambda vals: _ld(1, b"".join(_ld(1, v) for v in vals))  # noqa: E731
    floats = lambda vals: _ld(2, _ld(1, struct.pack(f"<{len(vals)}f", *vals)))  # noqa: E731
    feats = {
        "image/encoded": byts([_jpeg(h, w, seed)]), "image/height": ints([h]), "image/width": ints([w]),
        "image/channels": ints([3]), "image/class/label": ints([label]), "image/format": byts([b"JPEG"]),
        "image/filename": byts([f"img_{seed}.JPEG".encode()]), "image/class/synset": byts([b"n0144"]),
        "image/class/text": byts([b"red fox"]),
    }
    if with_bbox:
        feats.update({"image/object/bbox/xmin": floats([0.1]), "image/object/bbox/xmax": floats([0.9]),
                      "image/object/bbox/ymin": floats([0.2]), "image/object/bbox/ymax": floats([0.8]),
                      "image/object/bbox/label": ints([label])})
    return _example(feats)


def test_tfrecord_index_and_parse_match_heat_tpu(tmp_path):
    path = str(tmp_path / "recs.tfrecord")
    _write_tfrecord(path, [b"a" * 10, b"b" * 33, b"c" * 7])
    assert tutils.tfrecord_index(path) == jutils.tfrecord_index(path) == [(0, 26), (26, 49), (75, 23)]
    for sub in ("train", "val"):
        (tmp_path / sub).mkdir()
        _write_tfrecord(str(tmp_path / sub / "s0"), [b"x" * 5])
    for mod, tag in ((tutils, "t"), (jutils, "j")):
        mod.dali_tfrecord2idx(str(tmp_path / "train"), str(tmp_path / f"{tag}ti"), str(tmp_path / "val"),
                              str(tmp_path / f"{tag}vi"))
    assert open(tmp_path / "tti" / "s0").read() == open(tmp_path / "jti" / "s0").read() == "0 21\n"
    ex = str(tmp_path / "ex.tfrecord")
    _write_tfrecord(ex, [_imagenet_example(8, 6, label=42, seed=0), _imagenet_example(5, 7, 3, 1, with_bbox=False)])
    got, want = list(tutils.read_tfrecord_file(ex)), list(jutils.read_tfrecord_file(ex))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert (g[k].bytes_list, g[k].int64_list, list(g[k].float_list)) == (
                w[k].bytes_list, w[k].int64_list, list(w[k].float_list)), k
    img = tutils._decode_jpeg_rgb(got[0]["image/encoded"].bytes_list[0])
    np.testing.assert_array_equal(img, jutils._decode_jpeg_rgb(want[0]["image/encoded"].bytes_list[0]))
    assert img.shape == (8, 6, 3)


def test_merge_files_imagenet_tfrecord_matches_heat_tpu(tmp_path):
    import h5py

    src = tmp_path / "shards"
    src.mkdir()
    _write_tfrecord(str(src / "train-00000"), [_imagenet_example(10, 12, 5, 1), _imagenet_example(9, 9, 7, 2)])
    _write_tfrecord(str(src / "train-00001"), [_imagenet_example(11, 8, 3, 3, with_bbox=False)])
    _write_tfrecord(str(src / "val-00000"), [_imagenet_example(7, 7, 2, 4)])
    tt, tv = tutils.merge_files_imagenet_tfrecord(str(src), str(tmp_path / "port"))
    jt, jv = jutils.merge_files_imagenet_tfrecord(str(src), str(tmp_path / "jax"))
    for a, b in ((tt, jt), (tv, jv)):
        with h5py.File(a) as fa, h5py.File(b) as fb:
            assert sorted(fa) == sorted(fb) == ["file_info", "images", "metadata"]
            for key in fa:
                np.testing.assert_array_equal(np.asarray(fa[key]), np.asarray(fb[key]))
    # the merged file streams through PartialH5Dataset
    meta = list(ht.utils.data.PartialH5Dataset(tt, dataset_names="metadata", initial_load=2, load_length=2))
    np.testing.assert_allclose(torch.cat(meta).numpy()[:, :4], [[10, 12, 3, 4], [9, 9, 3, 6], [11, 8, 3, 2]])


def test_mnist_gate_matches_heat_tpu(tmp_path):
    """Without torchvision both packages refuse with the same error, before touching the
    root directory."""
    try:
        import torchvision  # noqa: F401

        pytest.skip("torchvision is installed: the gate is open")
    except ImportError:
        pass
    for pkg in (ht, jht):
        with pytest.raises(RuntimeError, match="requires torchvision"):
            pkg.utils.data.MNISTDataset(str(tmp_path))
    assert os.listdir(str(tmp_path)) == []
