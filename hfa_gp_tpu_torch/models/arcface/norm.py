"""BatchNorm of the arcface backbones, as the JAX package computes it
(`_bn` of hfa_gp_tpu/models/arcface/{iresnet,mobilefacenet}.py, `_bn1d` of
vit.py), not as `nn.BatchNorm` does:

  * an fp32 island: the input is taken to fp32, normalised there with fp32
    statistics and affine, and handed back in its own dtype, so that the
    layers around it stay in bf16 when the trunk runs in bf16;
  * the running variance takes the biased batch variance (torch's takes
    the unbiased one), momentum 0.1 in the torch convention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.1   # torch convention: new = (1-m)*old + m*batch


def batch_norm(p, stats, x: torch.Tensor, train: bool, eps: float):
    """x (B, C, H, W) or (B, C) in any float dtype; p {"scale", "bias"},
    stats {"mean", "var"}. Returns (y in x.dtype, new_stats)."""
    xf = x.float()
    if not train:
        y = F.batch_norm(xf, stats["mean"], stats["var"], p["scale"],
                         p["bias"], False, 0.0, eps)
        return y.to(x.dtype), stats
    # one fused pass: normalises with the biased batch variance and hands
    # back the batch mean and 1/sqrt(var + eps), from which the running
    # moments are updated by hand
    y, mean, invstd = torch.native_batch_norm(
        xf, p["scale"], p["bias"], None, None, True, 0.0, eps)
    with torch.no_grad():
        var = torch.clamp(1.0 / (invstd * invstd) - eps, min=0.0)
        new_stats = {
            "mean": (1 - BN_MOMENTUM) * stats["mean"] + BN_MOMENTUM * mean,
            "var": (1 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * var,
        }
    return y.to(x.dtype), new_stats
