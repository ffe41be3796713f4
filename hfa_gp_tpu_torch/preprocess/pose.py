"""BFM pose → EG3D camera labels (port of hfa_gp_tpu/preprocess/pose.py).

Rebuilds reference eg3d-pose-detection/3dface2idr.py:14-100 and
camera2label.py:14-30 as batched functions: Euler angles → R (transposed
product convention), camera position c = −R·(t + [0,0,−10]), the ×0.27
scale and (+0.006, +0.161) offsets, the diag(1,−1,−1) axis flip, and the
25-dim label with the fixed normalized intrinsics (focal 2985.29/700 =
4.2647).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..core.camera import FIXED_INTRINSICS
from .bfm import compute_rotation

FOCAL_1024 = 2985.29
SCALE = 0.27
OFFSET_Y = 0.006
OFFSET_Z = 0.161
Z_SHIFT = -10.0

_AXIS_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float32)


def pose_from_coeffs(angle: torch.Tensor, trans: torch.Tensor
                     ) -> torch.Tensor:
    """(B, 3) Euler angles + (B, 3) translations → (B, 4, 4) EG3D pose
    (3dface2idr.py:54-93)."""
    b = angle.shape[0]
    R = compute_rotation(angle)                         # (B, 3, 3)
    shift = torch.tensor([0.0, 0.0, Z_SHIFT], dtype=trans.dtype,
                         device=trans.device)
    c = -torch.einsum("bij,bj->bi", R, trans + shift) * SCALE
    c = c + torch.tensor([0.0, OFFSET_Y, OFFSET_Z], dtype=c.dtype,
                         device=c.device)
    flip = torch.as_tensor(_AXIS_FLIP, dtype=R.dtype, device=R.device)
    pose = torch.eye(4, dtype=R.dtype, device=R.device).repeat(b, 1, 1)
    pose[:, :3, :3] = R @ flip
    pose[:, :3, 3] = c
    return pose


def intrinsics_1024() -> np.ndarray:
    """Pixel-space K of the 1024² aligned image (3dface2idr.py:75-87)."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = FOCAL_1024
    K[0, 2] = K[1, 2] = 512.0
    return K


def labels_from_coeffs(angle: torch.Tensor, trans: torch.Tensor
                       ) -> torch.Tensor:
    """(B,3),(B,3) → (B, 25) raw-convention labels (camera2label.py:20-24:
    flattened pose ++ normalized fixed intrinsics)."""
    pose = pose_from_coeffs(angle, trans)
    b = pose.shape[0]
    intr = torch.as_tensor(FIXED_INTRINSICS, dtype=pose.dtype,
                           device=pose.device).expand(b, 9)
    return torch.cat([pose.reshape(b, 16), intr], dim=-1)


def write_label_json(names: list[str], labels: np.ndarray,
                     path: str) -> None:
    """Emit test.json in the reference's format (camera2label.py:29-30)."""
    entries = [[n, np.asarray(lab, dtype=np.float64).tolist()]
               for n, lab in zip(names, labels)]
    with open(path, "w") as f:
        json.dump({"labels": entries}, f, indent="\t")


def write_cameras_json(names: list[str], poses: np.ndarray,
                       angles: np.ndarray, path: str) -> None:
    """Emit cameras.json (3dface2idr.py:95-100,127-130)."""
    K = intrinsics_1024().tolist()
    out = {}
    for n, p, a in zip(names, poses, angles):
        out[n] = {"intrinsics": K,
                  "pose": np.asarray(p, dtype=np.float64).tolist(),
                  "angle": (np.asarray(a) * [1, -1, 1]).flatten().tolist()}
    with open(path, "w") as f:
        json.dump(out, f, indent=4)
