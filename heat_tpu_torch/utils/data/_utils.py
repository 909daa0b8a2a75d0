"""ImageNet/TFRecord ingest helpers (the port's own copy of
heat_tpu/utils/data/_utils.py; numpy and the stdlib, no tensorflow).

- TFRecord framing (u64 length, u32 masked crc, payload, u32 masked crc) is parsed with
  ``struct``, as the reference's ``dali_tfrecord2idx`` does;
- ``tf.train.Example`` payloads are decoded by a minimal protobuf wire-format parser;
- JPEG decode goes through PIL, imported inside the function that decodes.

:func:`merge_files_imagenet_tfrecord` writes heat_tpu's schema
(``imagenet_merged.h5`` / ``imagenet_merged_validation.h5`` with ``images`` as
base64-ascii strings, ``metadata`` (N, 9) floats, ``file_info`` (N, 4) strings), which
``PartialH5Dataset`` reads.
"""

from __future__ import annotations

import binascii
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = [
    "dali_tfrecord2idx",
    "merge_files_imagenet_tfrecord",
    "read_tfrecord_file",
    "tfrecord_index",
]


# ----------------------------------------------------------------- record framing
def tfrecord_index(path: str) -> List[Tuple[int, int]]:
    """(offset, total_length) of every record in a TFRecord file (the framing walk of
    reference ``_utils.py:13``). CRCs are not verified — same stance as the reference.
    """
    out: List[Tuple[int, int]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while True:
            start = f.tell()
            head = f.read(8)
            if len(head) < 8:
                break
            (length,) = struct.unpack("<Q", head)
            end = start + 8 + 4 + length + 4  # header, length-crc, payload, payload-crc
            if end > size:
                break  # truncated final record: not indexable
            f.seek(end)
            out.append((start, end - start))
    return out


def dali_tfrecord2idx(train_dir, train_idx_dir, val_dir, val_idx_dir) -> None:
    """Produce DALI-style ``"offset length"`` index files for every TFRecord under
    ``train_dir`` and ``val_dir`` (reference ``_utils.py:13``)."""
    for src_dir, idx_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        os.makedirs(idx_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            try:
                entries = tfrecord_index(src)
            except OSError:
                entries = []
            if not entries:
                # unreadable, empty, or not TFRecord framing (a stray README /
                # checksum file parses zero valid records) — skip, don't write a
                # bogus index the downstream consumer fails on far from the cause
                print(f"Not a valid TFRecord file: {src}")
                continue
            with open(os.path.join(idx_dir, name), "w") as idx:
                for off, length in entries:
                    idx.write(f"{off} {length}\n")


def _iter_records(path: str) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            f.read(4)
            payload = f.read(length)
            f.read(4)
            if len(payload) < length:
                return
            yield payload


# ------------------------------------------------------- minimal protobuf decoding
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, raw_value) over a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # fixed64
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


class Feature:
    """One ``tf.train.Feature``: exactly one of the three value lists is populated."""

    __slots__ = ("bytes_list", "float_list", "int64_list")

    def __init__(self):
        self.bytes_list: List[bytes] = []
        self.float_list: List[float] = []
        self.int64_list: List[int] = []


def parse_example(payload: bytes) -> Dict[str, Feature]:
    """Decode a serialized ``tf.train.Example`` into ``{name: Feature}``.

    Schema (fixed since TF 1.0): Example.features(1) → Features.feature(1) =
    map<string, Feature>; Feature.bytes_list(1)/float_list(2)/int64_list(3), each with
    repeated value(1) (floats packed fixed32, ints packed or unpacked varint).
    """
    features: Dict[str, Feature] = {}
    for field, wire, val in _iter_fields(payload):
        if field != 1 or wire != 2:
            continue
        for f2, w2, entry in _iter_fields(val):
            if f2 != 1 or w2 != 2:
                continue
            name, feat = "", Feature()
            for f3, w3, v3 in _iter_fields(entry):
                if f3 == 1 and w3 == 2:
                    name = v3.decode("utf-8")
                elif f3 == 2 and w3 == 2:
                    # v3 is the Feature message: bytes_list(1) / float_list(2) /
                    # int64_list(3), each a nested *List message with repeated value(1)
                    for f4, w4, v4 in _iter_fields(v3):
                        if w4 != 2:
                            continue
                        for f5, w5, v5 in _iter_fields(v4):
                            if f5 != 1:
                                continue
                            if f4 == 1 and w5 == 2:  # BytesList.value
                                feat.bytes_list.append(v5)
                            elif f4 == 2 and w5 == 2:  # FloatList.value packed
                                feat.float_list.extend(
                                    struct.unpack(f"<{len(v5) // 4}f", v5)
                                )
                            elif f4 == 2 and w5 == 5:
                                feat.float_list.append(struct.unpack("<f", v5)[0])
                            elif f4 == 3 and w5 == 2:  # Int64List.value packed
                                pos = 0
                                while pos < len(v5):
                                    iv, pos = _read_varint(v5, pos)
                                    feat.int64_list.append(_to_signed(iv))
                            elif f4 == 3 and w5 == 0:
                                feat.int64_list.append(_to_signed(v5))
            features[name] = feat
    return features


def _to_signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


# --------------------------------------------------------------- imagenet merging
def read_tfrecord_file(path: str) -> Iterator[Dict[str, Feature]]:
    """Iterate the decoded ``tf.train.Example`` feature maps of one TFRecord file."""
    for payload in _iter_records(path):
        yield parse_example(payload)


def _decode_jpeg_rgb(data: bytes) -> np.ndarray:
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def _single_file_load(src: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Decoded contents of one preprocessed-imagenet TFRecord file (reference
    ``__single_file_load``): base64-ascii image strings, (N, 9) float metadata,
    (N, 4) byte-string file info."""
    imgs: List[str] = []
    img_meta: List[List[float]] = [[] for _ in range(9)]
    file_arr: List[List[bytes]] = [[] for _ in range(4)]
    for feats in read_tfrecord_file(src):
        img_str = feats["image/encoded"].bytes_list[0]
        img = _decode_jpeg_rgb(img_str)
        imgs.append(binascii.b2a_base64(img.tobytes()).decode("ascii"))
        h = float(feats["image/height"].int64_list[0]) if "image/height" in feats else float(img.shape[0])
        w = float(feats["image/width"].int64_list[0]) if "image/width" in feats else float(img.shape[1])
        c = float(feats["image/channels"].int64_list[0]) if "image/channels" in feats else 3.0
        img_meta[0].append(h)
        img_meta[1].append(w)
        img_meta[2].append(c)
        img_meta[3].append(float(feats["image/class/label"].int64_list[0] - 1))
        try:
            bbxmin = feats["image/object/bbox/xmin"].float_list[0]
            bbxmax = feats["image/object/bbox/xmax"].float_list[0]
            bbymin = feats["image/object/bbox/ymin"].float_list[0]
            bbymax = feats["image/object/bbox/ymax"].float_list[0]
            bblabel = feats["image/object/bbox/label"].int64_list[0] - 1
        except (KeyError, IndexError):
            bbxmin, bbxmax, bbymin, bbymax, bblabel = 0.0, w, 0.0, h, -2
        img_meta[4].append(float(bbxmin))
        img_meta[5].append(float(bbxmax))
        img_meta[6].append(float(bbymin))
        img_meta[7].append(float(bbymax))
        img_meta[8].append(float(bblabel))

        def _bytes_of(key: str, default: bytes = b"") -> bytes:
            feat = feats.get(key)
            return feat.bytes_list[0] if feat and feat.bytes_list else default

        file_arr[0].append(_bytes_of("image/format", b"JPEG"))
        file_arr[1].append(_bytes_of("image/filename"))
        file_arr[2].append(_bytes_of("image/class/synset"))
        file_arr[3].append(_bytes_of("image/class/text"))
    meta = np.array(img_meta, dtype=np.float64).T if imgs else np.empty((0, 9))
    finfo = np.array(file_arr, dtype="S10").T if imgs else np.empty((0, 4), "S10")
    return imgs, meta, finfo


def merge_files_imagenet_tfrecord(folder_name: str, output_folder: Optional[str] = None) -> Tuple[str, str]:
    """Merge preprocessed imagenet TFRecord shards into the two HDF5 files the DASO
    imagenet example streams from (reference ``_utils.py:47``): files starting with
    ``train`` → ``imagenet_merged.h5``, ``val`` → ``imagenet_merged_validation.h5``,
    each with resizable ``images`` / ``metadata`` / ``file_info`` datasets.

    Returns the two output paths.
    """
    import h5py

    output_folder = output_folder or "."
    os.makedirs(output_folder, exist_ok=True)
    names = sorted(os.listdir(folder_name))
    train_names = [os.path.join(folder_name, f) for f in names if f.startswith("train")]
    val_names = [os.path.join(folder_name, f) for f in names if f.startswith("val")]
    out_train = os.path.join(output_folder, "imagenet_merged.h5")
    out_val = os.path.join(output_folder, "imagenet_merged_validation.h5")

    str_dt = None
    for srcs, out_path in ((train_names, out_train), (val_names, out_val)):
        with h5py.File(out_path, "w") as fh:
            if str_dt is None:
                str_dt = h5py.string_dtype(encoding="ascii")
            fh.create_dataset("images", (0,), maxshape=(None,), dtype=str_dt)
            fh.create_dataset("metadata", (0, 9), maxshape=(None, 9))
            fh.create_dataset("file_info", (0, 4), maxshape=(None, 4), dtype="S10")
            size = 0
            for src in srcs:
                imgs, meta, finfo = _single_file_load(src)
                if not imgs:
                    continue
                new = size + len(imgs)
                fh["images"].resize((new,))
                fh["images"][size:new] = imgs
                fh["metadata"].resize((new, 9))
                fh["metadata"][size:new] = meta
                fh["file_info"].resize((new, 4))
                fh["file_info"][size:new] = finfo
                size = new
    return out_train, out_val
