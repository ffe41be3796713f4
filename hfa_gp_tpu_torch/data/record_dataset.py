"""The arcface training pack (port of hfa_gp_tpu/data/record_dataset.py):
the reference's MXNet RecordIO face dataset (arcface_torch/dataset.py:
.rec/.idx packs of (jpeg bytes, label)) as one ArrayRecord file.

A record is a 4-byte little-endian int32 label followed by the encoded
image. `RecordFaceDataset` decodes it with PIL, resizes it bilinearly to
size² and maps it to [-1, 1], as the JAX package does, so both packages
read a pack to the same arrays. `array_record` is imported when a file is
opened or written, never at import; without it they raise ImportError.
"""

from __future__ import annotations

import io
import struct

import numpy as np
from PIL import Image


def _array_record():
    try:
        from array_record.python import array_record_module
    except ImportError as e:
        raise ImportError("ArrayRecord packs need the `array_record` "
                          "package (pip install array_record)") from e
    return array_record_module


def encode_record(image: bytes, label: int) -> bytes:
    return struct.pack("<i", int(label)) + image


def write_record_dataset(path: str, images: list[bytes],
                         labels: list[int]) -> None:
    """Encoded images and their labels → one .array_record file."""
    w = _array_record().ArrayRecordWriter(path, "group_size:1")
    try:
        for img, lab in zip(images, labels):
            w.write(encode_record(img, lab))
    finally:
        w.close()


def decode_image(data: bytes, size: int) -> np.ndarray:
    """Encoded image → float32 (size, size, 3) in [-1, 1]."""
    img = Image.open(io.BytesIO(data)).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5


class RecordFaceDataset:
    """Random-access (image, label) over an ArrayRecord pack (the
    reference's MXFaceDataset). `source` is the pack's path, or any reader
    with `num_records()` and `read([i])` → [record bytes]. Images are
    float32 (size, size, 3) in [-1, 1], labels int32."""

    def __init__(self, source, size: int = 112):
        self._reader = (_array_record().ArrayRecordReader(source)
                        if isinstance(source, str) else source)
        self.size = size
        self._n = self._reader.num_records()

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.int32]:
        rec = self._reader.read([int(idx)])[0]
        label = struct.unpack("<i", rec[:4])[0]
        return decode_image(rec[4:], self.size), np.int32(label)


class SyntheticFaceDataset:
    """Random images with one fixed label (the reference's
    SyntheticDataset), for speed runs without data."""

    def __init__(self, size: int = 112, length: int = 1_000_000,
                 seed: int = 0):
        self.size = size
        self._n = length
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.int32]:
        img = self._rng.standard_normal(
            (self.size, self.size, 3)).astype(np.float32)
        return img, np.int32(1)
