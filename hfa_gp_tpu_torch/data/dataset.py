"""Frame readers and batching (port of `HeadData`, `HeadDataTest`,
`BatchIterator` and `infinite_batches` of hfa_gp_tpu/data/dataset.py), as
`torch.utils.data.Dataset`s.

On-disk contract (the reference's):
  `{root}/{person}/{train|test2|test}/cropped_images/*.png` and
  `test.json` ({"labels": [[fname, [25 floats]], ...]}, raw OpenCV
  cameras), or any `ds_path` holding the same. Labels are keyed by
  `<stem>.png` whatever the frame suffix. The train split keeps the
  directory's listing order, every other split is sorted by name, as in
  the JAX reader.

Items are (image (size, size, 3) float32 in [-1, 1], label (25,)). The
port keeps its own readers so that its main paths import nothing of the
JAX package; tests hold them to the JAX readers (identical arrays, and
batches index for index).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator

import numpy as np
import torch
from PIL import Image


def load_image(path: str, size: int | None = None) -> np.ndarray:
    """PNG/JPG → float32 (H, W, 3) in [-1, 1], bilinear resize to size²."""
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, dtype=np.float32) / 255.0 - 0.5) / 0.5


def _label_key(frame_path: str) -> str:
    return os.path.basename(frame_path).rsplit(".", 1)[0] + ".png"


class HeadData(torch.utils.data.Dataset):
    """Frames of one split with their labels."""

    def __init__(self, split: str, size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 suffix: str = ".png", sort: bool | None = None):
        if ds_path is None:
            sub = {"train": "train", "test": "test2",
                   "val": "test"}.get(split, split)
            ds_path = os.path.join(root, person, sub, "cropped_images")
        self.ds_path = ds_path
        self.size = size
        with open(os.path.join(ds_path, "test.json"), "rb") as f:
            self.labels = {k: np.asarray(v, dtype=np.float32)
                           for k, v in dict(json.load(f)["labels"]).items()}
        self.frames = glob.glob(os.path.join(ds_path, "*" + suffix))
        if sort if sort is not None else (split != "train"):
            self.frames = sorted(self.frames)
        if not self.frames:
            raise FileNotFoundError(f"no frames in {ds_path}")

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        frame = self.frames[idx]
        return (torch.from_numpy(load_image(frame, self.size)),
                torch.from_numpy(self.labels[_label_key(frame)]))


class HeadDataTest(HeadData):
    """Sorted inference frames with their labels, optionally smoothed in
    time by a Gaussian of `smooth_sigma` frames."""

    def __init__(self, split: str = "test", size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 suffix: str = ".png", smooth_sigma: float | None = None):
        super().__init__(split, size, root, person, ds_path, suffix,
                         sort=True)
        if smooth_sigma:
            from scipy.ndimage import gaussian_filter1d
            keys = [_label_key(f) for f in self.frames]
            arr = gaussian_filter1d(np.stack([self.labels[k] for k in keys]),
                                    smooth_sigma, axis=0)
            self.labels = {k: arr[i] for i, k in enumerate(keys)}


class BatchIterator:
    """Epoch batcher → stacked tensors; a last partial batch is dropped.
    The index permutation comes from numpy's `default_rng(seed)`, one draw
    per epoch, so the batches equal the JAX package's `BatchIterator`
    index for index. One process only: the port has no sharded reader."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        n, bs = len(self.dataset), self.batch_size
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, (n // bs) * bs, bs):
            items = [self.dataset[int(j)] for j in order[i:i + bs]]
            yield tuple(torch.stack(col) for col in zip(*items))

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size


def infinite_batches(loader: BatchIterator) -> Iterator:
    """Epoch after epoch, for ever."""
    while True:
        yield from loader
