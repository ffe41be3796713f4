"""Image output of the port (counterpart of `save_image` in
hfa_gp_tpu/utils/logging.py)."""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image


def save_image(img: torch.Tensor | np.ndarray, path: str) -> None:
    """(H, W, 3) or (B, H, W, 3) image in [-1, 1] → 8-bit PNG (a batch is
    stacked vertically), rounded as torchvision's save_image(normalize=True,
    range=(-1, 1)) does."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 4:
        arr = np.concatenate(list(arr), axis=0)
    arr = (arr.clip(-1.0, 1.0) + 1.0) / 2.0
    arr = (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr, "RGB").save(path)
