"""5-point similarity alignment + EG3D-convention cropping (port of
hfa_gp_tpu/preprocess/align.py, the same numpy and PIL code).

Rebuilds reference eg3d-pose-detection/crop_images.py:10-131 bit-for-bit:
POS least-squares (5 landmarks ↔ standard 3D points), rescale to
`rescale_factor`, 1024² alignment crop, center 700² crop, Lanczos resize
to 512². The pixel-resampling steps stay on PIL (host CPU) for exact
parity with the reference's output images; the landmark math is numpy.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

# the "standard" 5-point 3D landmarks used by Deep3DFaceRecon; persisted
# per-video in cropping_params.json as 'lm3d_std' (crop_images.py:121)
# magic constants of the EG3D convention (test.py:70-87)
RESCALE_FACTOR_RECON = 466.285     # pass feeding the 224² recon net
RESCALE_FACTOR_CROP = 300.0        # pass producing the training crop
CENTER_CROP_SIZE = 700
OUTPUT_SIZE = 512
TARGET_SIZE = 1024.0


def pos(xp: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, float]:
    """Least-squares 2D↔3D similarity (crop_images.py:10-33).
    xp: (2, 5) image points; x: (3, 5) standard 3D points →
    (t (2,1 each), scale)."""
    npts = xp.shape[1]
    A = np.zeros([2 * npts, 8])
    A[0:2 * npts - 1:2, 0:3] = x.T
    A[0:2 * npts - 1:2, 3] = 1
    A[1:2 * npts:2, 4:7] = x.T
    A[1:2 * npts:2, 7] = 1
    b = np.reshape(xp.T, [2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(A, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, float(s)


def extract_5p(lm: np.ndarray) -> np.ndarray:
    """68 → 5 landmarks (crop_images.py:35-40)."""
    lm_idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5p = np.stack([
        lm[lm_idx[0]], np.mean(lm[lm_idx[[1, 2]]], 0),
        np.mean(lm[lm_idx[[3, 4]]], 0), lm[lm_idx[5]], lm[lm_idx[6]]],
        axis=0)
    return lm5p[[1, 2, 0, 3, 4], :]


def resize_n_crop_img(img: Image.Image, lm: np.ndarray, t, s,
                      target_size: float = TARGET_SIZE):
    """(crop_images.py:43-62)."""
    w0, h0 = img.size
    tx, ty = (float(v) for v in np.ravel(t)[:2])
    w = np.int32(w0 * s)
    h = np.int32(h0 * s)
    left = np.int32(w / 2 - target_size / 2 + (tx - w0 / 2) * s)
    right = left + target_size
    up = np.int32(h / 2 - target_size / 2 + (h0 / 2 - ty) * s)
    below = up + target_size
    img = img.resize((int(w), int(h)), resample=Image.LANCZOS)
    img = img.crop((int(left), int(up), int(right), int(below)))
    lm = np.stack([lm[:, 0] - tx + w0 / 2,
                   lm[:, 1] - ty + h0 / 2], axis=1) * s
    lm = lm - np.array([[w / 2 - target_size / 2,
                         h / 2 - target_size / 2]])
    return img, lm


def align_img(img: Image.Image, lm: np.ndarray, lm3d_std: np.ndarray,
              target_size: float = TARGET_SIZE,
              rescale_factor: float = RESCALE_FACTOR_RECON):
    """(crop_images.py:66-98). Returns (trans_params, img224, lm_new,
    img1024)."""
    w0, h0 = img.size
    lm5p = extract_5p(lm) if lm.shape[0] != 5 else lm
    t, s = pos(lm5p.T, lm3d_std.T)
    s = rescale_factor / s
    img_new, lm_new = resize_n_crop_img(img, lm, t, s,
                                        target_size=target_size)
    trans_params = np.array([w0, h0, s, t[0].item(), t[1].item()])
    lm_new = lm_new * 224 / 1024.0
    img_low = img_new.resize((224, 224), resample=Image.LANCZOS)
    return trans_params, img_low, lm_new, img_new


def crop_final(img1024: Image.Image,
               center_crop_size: int = CENTER_CROP_SIZE,
               output_size: int = OUTPUT_SIZE) -> Image.Image:
    """Center 700² crop + Lanczos 512² (crop_images.py:123-128)."""
    left = int(img1024.size[0] / 2 - center_crop_size / 2)
    upper = int(img1024.size[1] / 2 - center_crop_size / 2)
    box = (left, upper, left + center_crop_size, upper + center_crop_size)
    return img1024.crop(box).resize((output_size, output_size),
                                    resample=Image.LANCZOS)


def flip_landmarks_y(lm: np.ndarray, height: int) -> np.ndarray:
    """image-v → math-y flip (crop_images.py:119: lm[:,1] = H-1-lm[:,1])."""
    out = lm.copy()
    out[:, -1] = height - 1 - out[:, -1]
    return out
