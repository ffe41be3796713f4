"""NeRF-style pose helpers (port of hfa_gp_tpu/data/poses.py, numpy as
there): the average and centring of camera poses, and spiral and spheric
camera paths for novel-view rendering. Offline path generators, not
hot-path code; poses are (3, 4) camera-to-world matrices [x y z | centre].
"""

from __future__ import annotations

import numpy as np


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 3, 4) → (3, 4): the mean centre, the mean z axis, and the mean
    y axis made orthogonal to it."""
    center = poses[..., 3].mean(0)
    z = normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Poses (N, 3, 4) in the frame of their average → (centred poses
    (N, 3, 4), the inverse of the average pose (4, 4))."""
    pose_avg_homo = np.eye(4)
    pose_avg_homo[:3] = average_poses(poses)
    last_row = np.tile(np.array([0, 0, 0, 1]), (len(poses), 1, 1))
    poses_homo = np.concatenate([poses, last_row], 1)
    inv = np.linalg.inv(pose_avg_homo)
    return (inv @ poses_homo)[:, :3], inv


def create_spiral_poses(radii: np.ndarray, focus_depth: float,
                        n_poses: int = 120) -> np.ndarray:
    """Two turns of a spiral of `radii` (3,), each camera looking at the
    point (0, 0, −focus_depth) → (n_poses, 3, 4)."""
    out = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        x = normalize(np.cross(np.array([0, 1, 0]), z))
        y = np.cross(z, x)
        out.append(np.stack([x, y, z, center], 1))
    return np.stack(out, 0)


def create_spheric_poses(radius: float, n_poses: int = 120) -> np.ndarray:
    """A circle of cameras at `radius`, tilted down by π/5, around the
    vertical axis → (n_poses, 3, 4)."""
    def spheric_pose(theta, phi, r):
        trans_t = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * r],
                            [0, 0, 1, r], [0, 0, 0, 1]])
        rot_phi = np.array([[1, 0, 0, 0],
                            [0, np.cos(phi), -np.sin(phi), 0],
                            [0, np.sin(phi), np.cos(phi), 0],
                            [0, 0, 0, 1]])
        rot_theta = np.array([[np.cos(theta), 0, -np.sin(theta), 0],
                              [0, 1, 0, 0],
                              [np.sin(theta), 0, np.cos(theta), 0],
                              [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans_t
        c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                        [0, 0, 0, 1]]) @ c2w
        return c2w[:3]

    return np.stack([spheric_pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi,
                                           n_poses + 1)[:-1]], 0)
