"""Tri-plane sampler: dispatching wrapper, plain version and launch count.

Replaces the TPU kernel `hfa_gp_tpu/core/pallas/triplane.py::
_sampler_kernel` (via `_sample_blocked_impl`, reached from the JAX
renderer's `eval_points`) and fuses the plane mean the JAX renderer runs
right after it. The kernel is `csrc/triplane.cu`; its header says what
bounds it on the H100 (gather bytes) and how the design answers that.

The JAX chip path reads bf16 slabs and matches the exact lookup only to
about 4e-2; this port is held to the exact fp32 lookup
(`renderer.sample_from_planes`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import build

# Launches of the CUDA kernel in this process (see `sample_mean`).
LAUNCHES = 0

# rows: world axes spanning each plane (the corrected EG3D convention)
PLANE_AXES = np.array([
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
    [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
], dtype=np.float32)
PLANE_INV = np.linalg.inv(PLANE_AXES)  # (3, 3, 3)


def project_onto_planes(coordinates: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) world coords → (B, 3, M, 2) per-plane uv."""
    inv = torch.as_tensor(PLANE_INV, dtype=coordinates.dtype,
                          device=coordinates.device)
    return torch.einsum("bmj,pjk->bpmk", coordinates, inv)[..., :2]


def sample_from_planes(planes: torch.Tensor, coordinates: torch.Tensor,
                       box_warp: float) -> torch.Tensor:
    """planes (B, 3, H, W, C), coordinates (B, M, 3) → (B, 3, M, C):
    F.grid_sample per plane, bilinear, zeros padding, align_corners=False."""
    b, n_planes, h, w, c = planes.shape
    uv = project_onto_planes((2.0 / box_warp) * coordinates)
    grid = uv.reshape(b * n_planes, 1, -1, 2)
    img = planes.reshape(b * n_planes, h, w, c).permute(0, 3, 1, 2)
    feats = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)          # (B·3, C, 1, M)
    return feats[:, :, 0].permute(0, 2, 1).reshape(b, n_planes, -1, c)


def sample_mean_plain(planes: torch.Tensor, coordinates: torch.Tensor,
                      box_warp: float) -> torch.Tensor:
    """The plain PyTorch version: (B, M, C) plane-averaged features."""
    return sample_from_planes(planes, coordinates, box_warp).mean(1)


def sample_mean(planes: torch.Tensor, coordinates: torch.Tensor,
                box_warp: float) -> torch.Tensor:
    """Plane-averaged tri-plane features (B, M, C).

    A CPU tensor goes to `sample_mean_plain`; a CUDA tensor launches the
    kernel (fp32, contiguous) or raises."""
    if planes.device.type == "cpu":
        return sample_mean_plain(planes, coordinates, box_warp)
    if planes.device.type != "cuda":
        raise ValueError(f"sample_mean: unsupported device {planes.device}")
    b, n_planes, h, w, c = planes.shape
    if n_planes != 3 or coordinates.shape[0] != b \
            or coordinates.shape[-1] != 3 or coordinates.ndim != 3:
        raise ValueError(f"sample_mean: planes {tuple(planes.shape)}, "
                         f"coordinates {tuple(coordinates.shape)}")
    for name, t in (("planes", planes), ("coordinates", coordinates)):
        if t.device != planes.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"sample_mean: {name} must be a contiguous "
                             f"fp32 tensor on {planes.device}")
    m = coordinates.shape[1]
    if b * m >= 2 ** 31:
        raise ValueError("sample_mean: B·M exceeds the kernel's int32 range")
    out = torch.empty((b, m, c), dtype=torch.float32, device=planes.device)
    lib = build.library()
    global LAUNCHES
    with torch.cuda.device(planes.device):
        err = lib.hfa_triplane_mean(
            planes.data_ptr(), coordinates.data_ptr(), out.data_ptr(),
            b, m, h, w, c, 2.0 / box_warp,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_mean")
    LAUNCHES += 1
    return out
