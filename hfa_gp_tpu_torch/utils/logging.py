"""Image output and scalar logging of the port (counterpart of
hfa_gp_tpu/utils/logging.py): `save_image`, the trainer's min-max
`display_image`, and `MetricsWriter` (always a JSONL file; TensorBoard
beside it where `torch.utils.tensorboard` imports)."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
from PIL import Image


def save_image(img: torch.Tensor | np.ndarray, path: str) -> None:
    """(H, W, 3) or (B, H, W, 3) image in [-1, 1] → 8-bit PNG (a batch is
    stacked vertically), rounded as torchvision's save_image(normalize=True,
    range=(-1, 1)) does."""
    arr = _as_numpy(img)
    if arr.ndim == 4:
        arr = np.concatenate(list(arr), axis=0)
    arr = (arr.clip(-1.0, 1.0) + 1.0) / 2.0
    arr = (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr, "RGB").save(path)


def _as_numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img, dtype=np.float32)


def display_image(img: torch.Tensor | np.ndarray, path: str) -> None:
    """(H, W, 3) or (B, H, W, 3) image → 8-bit PNG, clipped to [-1, 1] and
    then min-max normalised (the trainer's display images)."""
    arr = _as_numpy(img)
    if arr.ndim == 4:
        arr = np.concatenate(list(arr), axis=0)
    arr = arr.clip(-1, 1)
    arr = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-8)
    arr = (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr, "RGB").save(path)


class MetricsWriter:
    """Scalars to `{log_dir}/metrics.jsonl` (one JSON object a call), and
    scalars and images to TensorBoard where it is installed. With
    `primary=False` (a rank other than 0) every method does nothing."""

    def __init__(self, log_dir: str, primary: bool = True):
        self._primary = primary
        self._tb = None
        if not primary:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def scalars(self, step: int, **values: float) -> None:
        if not self._primary:
            return
        vals = {k: float(v) for k, v in values.items()}
        self._jsonl.write(json.dumps(
            {"step": int(step), "time": time.time(), **vals}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(k, v, int(step))

    def image(self, step: int, tag: str, img) -> None:
        if self._tb is not None:
            arr = _as_numpy(img)
            if arr.ndim == 4:
                arr = arr[0]
            self._tb.add_image(tag, ((arr.clip(-1, 1) + 1) / 2)
                               .transpose(2, 0, 1), int(step))

    def close(self) -> None:
        if not self._primary:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
