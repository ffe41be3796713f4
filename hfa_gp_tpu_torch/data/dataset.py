"""Reenactment input frames (port of the `HeadDataTest` reader of
hfa_gp_tpu/data/dataset.py), as a `torch.utils.data.Dataset`.

On-disk contract (the reference's):
  `{root}/{person}/test2/cropped_images/*.png` and `test.json`
  ({"labels": [[fname, [25 floats]], ...]}, raw OpenCV cameras), or any
  `ds_path` holding the same. Frames are sorted by name; labels are keyed
  by `<stem>.png` whatever the frame suffix.

Items are (image (size, size, 3) float32 in [-1, 1], label (25,)). The
port keeps its own reader so that its main path imports nothing of the
JAX package; tests/test_torch_slice.py holds it to the JAX reader.
"""

from __future__ import annotations

import glob
import json
import os

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


class HeadDataTest(torch.utils.data.Dataset):
    """Sorted inference frames with their labels, optionally smoothed in
    time by a Gaussian of `smooth_sigma` frames."""

    def __init__(self, split: str = "test", size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 suffix: str = ".png", smooth_sigma: float | None = None):
        if ds_path is None:
            sub = {"train": "train", "test": "test2",
                   "val": "test"}.get(split, split)
            ds_path = os.path.join(root, person, sub, "cropped_images")
        self.ds_path = ds_path
        self.size = size
        with open(os.path.join(ds_path, "test.json"), "rb") as f:
            self.labels = {k: np.asarray(v, dtype=np.float32)
                           for k, v in dict(json.load(f)["labels"]).items()}
        self.frames = sorted(glob.glob(os.path.join(ds_path, "*" + suffix)))
        if not self.frames:
            raise FileNotFoundError(f"no frames in {ds_path}")
        if smooth_sigma:
            from scipy.ndimage import gaussian_filter1d
            keys = [_label_key(f) for f in self.frames]
            arr = gaussian_filter1d(np.stack([self.labels[k] for k in keys]),
                                    smooth_sigma, axis=0)
            self.labels = {k: arr[i] for i, k in enumerate(keys)}

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        frame = self.frames[idx]
        return (torch.from_numpy(load_image(frame, self.size)),
                torch.from_numpy(self.labels[_label_key(frame)]))
