"""LPIPS perceptual distance in PyTorch (port of hfa_gp_tpu/models/lpips.py):
AlexNet feature taps (relu1..relu5), per-channel unit normalisation, squared
differences, non-negative 1x1 linear heads, spatial mean, sum over layers.

Images are (B, H, W, 3) in [-1, 1] at the interface, like the rest of the
port; the convolutions run NCHW with OIHW weights (`utils.convert.from_jax`
carries the JAX tree: 4-D `weight` HWIO → OIHW, the 1-D lin weights as
they are). Without converted weights of the `lpips` package the params are
a seeded random init: a fixed random deep-feature distance, which keeps
the training loop and its tests meaningful but is not perceptual.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import ops

# torchvision AlexNet.features: (out_ch, kernel, stride, pad)
ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))
# max-pool (k=3, s=2) after taps 1 and 2
POOL_AFTER = (0, 1)

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
# kept on the device once (`ops.device_constant`): a copy from the host at
# every call would stop a CUDA graph's capture
_SHIFT, _SCALE = np.asarray(SHIFT), np.asarray(SCALE)


def init_lpips(g: torch.Generator) -> dict:
    """Random LPIPS params from `g`, as a nested dict of CPU tensors (wrap
    with `utils.convert.ParamTree` and move to a device)."""
    p: dict = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(ALEX_CONVS):
        bound = 1.0 / math.sqrt(in_ch * k * k)
        p[f"conv{i}"] = {
            "weight": (torch.rand((out_ch, in_ch, k, k), generator=g) * 2 - 1)
            * bound,
            "bias": torch.zeros(out_ch)}
        # linear head: non-negative 1x1 weights (the lpips convention)
        p[f"lin{i}"] = {"weight": torch.rand(out_ch, generator=g)
                        * (2.0 / out_ch)}
        in_ch = out_ch
    return p


def alex_features(params, x: torch.Tensor) -> list[torch.Tensor]:
    """x (B, 3, H, W), already shifted and scaled → the five relu taps."""
    feats = []
    for i, (_, _, stride, pad) in enumerate(ALEX_CONVS):
        conv = params[f"conv{i}"]
        x = F.relu(F.conv2d(x, conv["weight"], conv["bias"], stride=stride,
                            padding=pad))
        feats.append(x)
        if i in POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + eps)


def lpips_distance(params, img0: torch.Tensor,
                   img1: torch.Tensor) -> torch.Tensor:
    """img0, img1 (B, H, W, 3) in [-1, 1] → (B,) perceptual distance."""
    shift = ops.device_constant(_SHIFT, img0.dtype, img0.device)
    scale = ops.device_constant(_SCALE, img0.dtype, img0.device)
    f0 = alex_features(params, ((img0 - shift) / scale).permute(0, 3, 1, 2))
    f1 = alex_features(params, ((img1 - shift) / scale).permute(0, 3, 1, 2))
    total = 0.0
    for i, (a, b) in enumerate(zip(f0, f1)):
        d = (_unit_normalize(a) - _unit_normalize(b)).square()
        w = F.relu(params[f"lin{i}"]["weight"])          # non-negative
        total = total + (d * w[None, :, None, None]).sum(1).mean(dim=(1, 2))
    return total
