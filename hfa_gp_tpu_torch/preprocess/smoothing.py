"""Temporal landmark smoothing (reference smooth.py:28-47): Gaussian σ = 2
along the frame axis over the per-frame 5-point landmark files.

Host work: `scipy.ndimage.gaussian_filter1d` with its 'reflect' boundary,
which repeats the edge sample (torch's `F.pad(mode='reflect')` does not, and
refuses a pad wider than the sequence; at σ 2 the radius is 8).
"""

from __future__ import annotations

import os

import numpy as np
from scipy.ndimage import gaussian_filter1d


def smooth_landmark_sequence(lms: np.ndarray, sigma: float = 2.0
                             ) -> np.ndarray:
    """(T, 5, 2) [or (T, K)] landmark sequence → smoothed along T."""
    return gaussian_filter1d(np.asarray(lms, np.float32), sigma, axis=0,
                             mode="reflect")


def smooth_detection_dir(detection_dir: str, sigma: float = 2.0) -> int:
    """In-place smoothing of `detections/*.txt` (smooth.py:44-47).
    Returns the number of files rewritten."""
    files = sorted(f for f in os.listdir(detection_dir)
                   if f.endswith(".txt"))
    if not files:
        return 0
    lms = np.stack([np.loadtxt(os.path.join(detection_dir, f))
                    .astype(np.float32) for f in files])
    sm = smooth_landmark_sequence(lms, sigma)
    for f, lm in zip(files, sm):
        np.savetxt(os.path.join(detection_dir, f), lm)
    return len(files)
