"""BatchNorm of the arcface backbones, as the JAX package computes it
(`_bn` of hfa_gp_tpu/models/arcface/{iresnet,mobilefacenet}.py, `_bn1d` of
vit.py), not as `nn.BatchNorm` does:

  * an fp32 island: the input is taken to fp32, normalised there with fp32
    statistics and affine, and handed back in its own dtype, so that the
    layers around it stay in bf16 when the trunk runs in bf16;
  * the running variance takes the biased batch variance (torch's takes
    the unbiased one), momentum 0.1 in the torch convention;
  * in training under `synced(mesh)` (a mesh with several data indices)
    the statistics are those of the global batch, as JAX's
    are of its one sharded array: each rank's mean and sum of squared
    deviations are gathered over the group and combined, and the backward
    sums its two per-channel terms over the group (SyncBatchNorm's
    scheme). Every rank of the group ends with the same running moments.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ...parallel import mesh

BN_MOMENTUM = 0.1   # torch convention: new = (1-m)*old + m*batch

# the `parallel.mesh.Mesh` while `synced` is active
_SYNC: mesh.Mesh | None = None


@contextlib.contextmanager
def synced(m: mesh.Mesh):
    """Train-mode BatchNorm over the global batch of m's data axis."""
    global _SYNC
    prev, _SYNC = _SYNC, m
    try:
        yield
    finally:
        _SYNC = prev


class _SyncBatchNorm(torch.autograd.Function):
    """fp32 x (B, C, ...) → (y, mean, biased var) of the group's batch."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = x.numel() / x.shape[1]
        mean = x.mean(dims)
        m2 = (x - mean.view(shape)).square().sum(dims)
        # (count, C, 3): each rank's rows, mean and sum of squared
        # deviations, combined as in a parallel variance
        part = torch.stack([torch.full_like(mean, n), mean, m2], -1)
        m = ctx.sync = _SYNC
        counts, means, m2s = mesh.gather_rows(
            part[None], m.data_group).unbind(-1)
        total = counts.sum(0)
        gmean = (counts * means).sum(0) / total
        var = (m2s.sum(0) + (counts * (means - gmean).square()).sum(0)) \
            / total
        invstd = torch.rsqrt(var + eps)
        xhat = (x - gmean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, scale, invstd)
        ctx.total, ctx.dims, ctx.shape = total, dims, shape
        y = xhat * scale.view(shape) + bias.view(shape)
        return y, gmean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, scale, invstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        # this rank's parts of d scale and d bias: the trainer joins them
        # over the group with the other parameters' gradients
        d_scale, d_bias = sum_dy_xhat, sum_dy
        # the backward runs after `synced` has exited: the group is ctx's
        both = mesh.all_reduce_(torch.stack([sum_dy, sum_dy_xhat]),
                                ctx.sync.data_group)
        mean_dy = (both[0] / ctx.total).view(shape)
        mean_dy_xhat = (both[1] / ctx.total).view(shape)
        dx = (dy - mean_dy - xhat * mean_dy_xhat) \
            * (invstd * scale).view(shape)
        return dx, d_scale, d_bias, None


def batch_norm(p, stats, x: torch.Tensor, train: bool, eps: float):
    """x (B, C, H, W) or (B, C) in any float dtype; p {"scale", "bias"},
    stats {"mean", "var"}. Returns (y in x.dtype, new_stats)."""
    xf = x.float()
    if train and _SYNC is not None:
        y, mean, var = _SyncBatchNorm.apply(xf, p["scale"], p["bias"], eps)
        with torch.no_grad():
            new_stats = {
                "mean": (1 - BN_MOMENTUM) * stats["mean"]
                + BN_MOMENTUM * mean,
                "var": (1 - BN_MOMENTUM) * stats["var"] + BN_MOMENTUM * var,
            }
        return y.to(x.dtype), new_stats
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
