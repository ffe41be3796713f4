"""Camera and label math (port of hfa_gp_tpu/core/camera.py).

Labels are 25-dim: a flattened 4x4 cam2world pose and the flattened 3x3
normalized intrinsics. `flip_yz_label` is the one OpenCV↔OpenGL flip;
sampled cameras are OpenGL, dataset labels OpenCV (see
models/avatar/heads._normalize_label).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import ops

FIXED_INTRINSICS = np.array(
    [4.2647, 0.0, 0.5, 0.0, 4.2647, 0.5, 0.0, 0.0, 1.0], dtype=np.float32)

FLIP_MASK = np.ones(25, dtype=np.float32)
FLIP_MASK[[1, 2, 5, 6, 9, 10]] = -1.0


def flip_yz_label(label: torch.Tensor) -> torch.Tensor:
    """Negate the y/z rotation columns of the packed pose."""
    return label * ops.device_constant(FLIP_MASK, label.dtype, label.device)


def pack_label(cam2world: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) pose → (..., 25) label with the fixed intrinsics."""
    batch = cam2world.shape[:-2]
    pose = cam2world.reshape(*batch, 16)
    intr = ops.device_constant(FIXED_INTRINSICS, pose.dtype,
                               pose.device).expand(*batch, 9)
    return torch.cat([pose, intr], dim=-1)


def unpack_label(label: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 25) → ((..., 4, 4) cam2world, (..., 3, 3) intrinsics)."""
    batch = label.shape[:-1]
    return (label[..., :16].reshape(*batch, 4, 4),
            label[..., 16:25].reshape(*batch, 3, 3))


def normalize_vecs(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def create_cam2world_matrix(forward_vector: torch.Tensor,
                            origin: torch.Tensor) -> torch.Tensor:
    """Look-at cam2world; rotation columns (-left, up, -forward), world
    up (0, 1, 0)."""
    f = normalize_vecs(forward_vector)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f.dtype,
                      device=f.device).expand_as(f)
    left = normalize_vecs(torch.linalg.cross(up, f, dim=-1))
    up2 = normalize_vecs(torch.linalg.cross(f, left, dim=-1))
    rot = torch.stack((-left, up2, -f), dim=-1)
    m = torch.eye(4, dtype=f.dtype, device=f.device).repeat(
        *f.shape[:-1], 1, 1)
    m[..., :3, :3] = rot
    m[..., :3, 3] = origin
    return m


def sample_camera_positions(generator: torch.Generator | None, n: int = 1,
                            r: float = 1.0, horizontal_stddev: float = 1.0,
                            vertical_stddev: float = 1.0,
                            horizontal_mean: float = math.pi * 0.5,
                            vertical_mean: float = math.pi * 0.5,
                            mode: str | None = "normal"):
    """n camera origins on a radius-r sphere → (points (n, 3), phi, theta).

    mode=None returns the distribution mean and needs no generator; every
    other mode draws from `generator` (on the CPU)."""
    if mode is None:
        theta = torch.full((n, 1), horizontal_mean)
        phi = torch.full((n, 1), vertical_mean)
    else:
        if generator is None:
            raise ValueError(f"mode {mode!r} needs a torch.Generator")

        def uni():
            return torch.rand((n, 1), generator=generator)

        def nrm():
            return torch.randn((n, 1), generator=generator)

        def tnrm():
            t = torch.empty((n, 1))
            return torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0,
                                               generator=generator)

        if mode == "uniform":
            theta = (uni() - 0.5) * 2 * horizontal_stddev + horizontal_mean
            phi = (uni() - 0.5) * 2 * vertical_stddev + vertical_mean
        elif mode in ("normal", "gaussian"):
            theta = nrm() * horizontal_stddev + horizontal_mean
            phi = nrm() * vertical_stddev + vertical_mean
        elif mode == "spherical_uniform":
            theta = (uni() - 0.5) * 2 * horizontal_stddev + horizontal_mean
            v = (uni() - 0.5) * 2 * (vertical_stddev / math.pi) \
                + vertical_mean / math.pi
            phi = torch.arccos(1 - 2 * v.clamp(1e-5, 1 - 1e-5))
        elif mode == "truncated_gaussian":
            theta = tnrm() * horizontal_stddev + horizontal_mean
            phi = tnrm() * vertical_stddev + vertical_mean
        elif mode == "hybrid":
            pick = bool(torch.rand((), generator=generator) < 0.5)
            u_theta = (uni() - 0.5) * 4 * horizontal_stddev + horizontal_mean
            u_phi = (uni() - 0.5) * 4 * vertical_stddev + vertical_mean
            g_theta = nrm() * horizontal_stddev + horizontal_mean
            g_phi = nrm() * vertical_stddev + vertical_mean
            theta, phi = (u_theta, u_phi) if pick else (g_theta, g_phi)
        else:
            raise ValueError(f"unknown mode {mode!r}")

    phi = phi.clamp(1e-5, math.pi - 1e-5)
    x = r * torch.sin(phi) * torch.cos(theta)
    z = r * torch.sin(phi) * torch.sin(theta)
    y = r * torch.cos(phi)
    return torch.cat([x, y, z], dim=-1), phi, theta


def sample_camera_label(generator: torch.Generator | None, n: int = 1,
                        r: float = 2.7,
                        horizontal_mean: float = 0.5 * math.pi,
                        vertical_mean: float = 0.5 * math.pi,
                        horizontal_stddev: float = 0.3,
                        vertical_stddev: float = 0.155,
                        mode: str | None = "gaussian") -> torch.Tensor:
    """Look-at-origin camera packed to an (n, 25) OpenGL label."""
    points, _, _ = sample_camera_positions(
        generator, n=n, r=r, horizontal_mean=horizontal_mean,
        vertical_mean=vertical_mean, horizontal_stddev=horizontal_stddev,
        vertical_stddev=vertical_stddev, mode=mode)
    return pack_label(create_cam2world_matrix(-points, points))


def generate_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor,
                  resolution: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel rays (EG3D RaySampler): cam2world (B, 4, 4) OpenCV,
    intrinsics (B, 3, 3) normalized → (origins (B, R, 3), directions
    (B, R, 3)), R = resolution², pixel centres at (i + 0.5)/resolution,
    x = column, y = row."""
    b = cam2world.shape[0]
    fx = intrinsics[:, 0, 0, None]
    fy = intrinsics[:, 1, 1, None]
    cx = intrinsics[:, 0, 2, None]
    cy = intrinsics[:, 1, 2, None]
    sk = intrinsics[:, 0, 1, None]

    i = (torch.arange(resolution, dtype=cam2world.dtype,
                      device=cam2world.device) + 0.5) / resolution
    yy, xx = torch.meshgrid(i, i, indexing="ij")
    x_cam = xx.reshape(1, -1)
    y_cam = yy.reshape(1, -1)
    z_cam = torch.ones_like(x_cam)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    x_lift, y_lift, z_lift = torch.broadcast_tensors(x_lift, y_lift, z_cam)
    dirs_cam = torch.stack([x_lift, y_lift, z_lift], dim=-1)  # (B, R, 3)
    dirs = torch.einsum("bij,brj->bri", cam2world[:, :3, :3], dirs_cam)
    dirs = normalize_vecs(dirs)
    origins = cam2world[:, None, :3, 3].expand(b, dirs.shape[1], 3)
    return origins, dirs
