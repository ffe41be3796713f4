"""The avatars' input pool (the `inputs` of `models/hfagp.py`): driving
frames or audio windows and camera labels, made on the device from the
seed; and `batches`, which cuts any adapter's pool before the window.

Traffic parameters (`traffic/<traffic>.json`): "pool", the number of
distinct inputs; "batch"; "pose", the spread of the head's yaw and pitch
around the frontal pose, in radians, and the camera's distance. Every
seed draws the same sizes; only the values differ. Labels are in the
dataset's OpenCV convention: a look-at-origin camera, OpenGL axes flipped
in y and z, with EG3D's fixed intrinsics.
"""

from __future__ import annotations

import math

import torch

from .weights import generator

INPUTS_STREAM = 3
INTRINSICS = (4.2647, 0.0, 0.5, 0.0, 4.2647, 0.5, 0.0, 0.0, 1.0)
FLIP = (1, 2, 5, 6, 9, 10)       # the y and z rotation columns
DEEPSPEECH_FEATURES = 29


def labels(g: torch.Generator, n: int, pose: dict, device) -> torch.Tensor:
    """(n, 25) OpenCV labels around the frontal pose."""
    yaw = math.pi / 2 + pose["yaw_std"] * torch.randn(n, generator=g,
                                                      device=device)
    pitch = (math.pi / 2 + pose["pitch_std"]
             * torch.randn(n, generator=g, device=device)).clamp(1e-5,
                                                                 math.pi - 1e-5)
    r = pose["radius"]
    origin = torch.stack([r * torch.sin(pitch) * torch.cos(yaw),
                          r * torch.cos(pitch),
                          r * torch.sin(pitch) * torch.sin(yaw)], dim=-1)
    fwd = -origin / origin.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], device=device).expand_as(fwd)
    left = torch.linalg.cross(up, fwd, dim=-1)
    left = left / left.norm(dim=-1, keepdim=True)
    up2 = torch.linalg.cross(fwd, left, dim=-1)
    up2 = up2 / up2.norm(dim=-1, keepdim=True)
    m = torch.eye(4, device=device).repeat(n, 1, 1)
    m[:, :3, :3] = torch.stack([-left, up2, -fwd], dim=-1)
    m[:, :3, 3] = origin
    label = torch.cat([m.reshape(n, 16),
                       torch.tensor(INTRINSICS, device=device).expand(n, 9)],
                      dim=-1)
    label[:, list(FLIP)] *= -1
    return label


def pool(config: dict, traffic: dict, seed: int, device) -> dict:
    """{"label": (P, 25)} and "image" (P, size, size, 3) in [-1, 1] for an
    RGB-driven model, or "window" (P, smo_size, win_size, 29) of
    DeepSpeech-like features for an audio-driven one."""
    g = generator(seed, INPUTS_STREAM, device)
    n = traffic["pool"]
    out = {"label": labels(g, n, traffic["pose"], device)}
    if config["driving"] == "rgb":
        s = config["encoder"]["size"]
        out["image"] = torch.rand((n, s, s, 3), generator=g,
                                  device=device) * 2 - 1
    else:
        a = config["audio"]
        out["window"] = torch.randn((n, a["smo_size"], a["win_size"],
                                     DEEPSPEECH_FEATURES), generator=g,
                                    device=device)
    return out


def batches(p: dict, batch: int) -> list[dict]:
    """The pool cut into whole batches, each a contiguous copy, made
    before the window so that no gather runs in it."""
    n = next(iter(p.values())).shape[0] // batch
    return [{k: v[i * batch:(i + 1) * batch].contiguous()
             for k, v in p.items()} for i in range(n)]
