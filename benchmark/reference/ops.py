"""StyleGAN2 / EG3D primitives in plain PyTorch, NCHW with OIHW weights.

A frozen copy of the plain paths that the port runs (its `core/ops.py`),
kept here so that what decides `correct` does not move when the port does.
fp32 throughout; convolutions go to cuDNN and products to cuBLAS, so the
caller's TF32 switches decide their precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _channel(v: torch.Tensor, ndim: int, dim: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[dim] = -1
    return v.reshape(shape)


def fused_leaky_relu(x, bias=None, slope=0.2, scale=math.sqrt(2.0)):
    if bias is not None:
        x = x + _channel(bias, x.ndim, 1)
    return F.leaky_relu(x, slope) * scale


def bias_act(x, bias=None, *, act="linear", clamp=None, dim=1):
    """EG3D bias_act for the two activations the avatar uses."""
    if bias is not None:
        x = x + _channel(bias, x.ndim, dim)
    if act == "lrelu":
        x = F.leaky_relu(x, 0.2) * math.sqrt(2.0)
    elif act != "linear":
        raise ValueError(act)
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def fir_kernel(taps) -> np.ndarray:
    k = np.asarray(taps, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x, kernel, *, up=1, down=1, pad=(0, 0), gain=1.0):
    """Zero-stuff upsample, pad, FIR (a true convolution), downsample."""
    kernel = np.asarray(kernel, np.float32)
    if kernel.ndim == 1:
        kernel = fir_kernel(kernel)
    kh, kw = kernel.shape
    b, c, h, w = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, c, h, 1, w, 1),
                  (0, up - 1, 0, 0, 0, up - 1)).reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    k = torch.as_tensor(np.ascontiguousarray(kernel[::-1, ::-1]) * gain,
                        dtype=x.dtype, device=x.device)
    return F.conv2d(x, k[None, None].expand(c, 1, kh, kw), stride=down,
                    groups=c)


def upsample2d(x, kernel, factor=2):
    kh = np.asarray(kernel).shape[0]
    return upfirdn2d(x, kernel, up=factor,
                     pad=((kh + factor - 1) // 2, (kh - factor) // 2),
                     gain=float(factor) ** 2)


def equal_linear(x, weight, bias=None):
    y = x @ (weight * (1.0 / math.sqrt(weight.shape[1]))).T
    return y if bias is None else y + bias


def equal_conv2d(x, weight, bias=None, *, stride=1, padding=0):
    _, cin, kh, kw = weight.shape
    return F.conv2d(x, weight * (1.0 / math.sqrt(cin * kh * kw)), bias,
                    stride=stride, padding=padding)


def fully_connected(x, weight, bias=None, *, act="linear", lr_mul=1.0):
    y = x @ (weight * (lr_mul / math.sqrt(weight.shape[1]))).T
    return bias_act(y, None if bias is None else bias * lr_mul, act=act,
                    dim=-1)


def modulated_conv2d(x, weight, styles, *, demodulate=True, up=1,
                     padding=0, fir=(1, 3, 3, 1), eps=1e-8):
    """StyleGAN2 modulated conv, each sample with its own folded weight
    (one grouped conv over the batch); up=2 is a stride-2 transposed
    conv with the kernel flipped, then the FIR."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    wb = weight[None] * styles[:, None, :, None, None]
    if demodulate:
        wb = wb * torch.rsqrt(wb.square().sum(dim=(2, 3, 4), keepdim=True)
                              + eps)
    xg = x.reshape(1, b * cin, h, w)
    if up == 1:
        y = F.conv2d(xg, wb.reshape(b * cout, cin, kh, kw), padding=padding,
                     groups=b)
    else:
        k = fir_kernel(fir)
        wt = wb.flip(3, 4).transpose(1, 2).reshape(b * cin, cout, kh, kw)
        y = F.conv_transpose2d(xg, wt, stride=2, groups=b)
        ptot = k.shape[0] + 1 - kh
        y = upfirdn2d(y, k, pad=((ptot + 1) // 2, ptot // 2), gain=4.0)
    return y.reshape(b, cout, y.shape[2], y.shape[3])


def avg_pool_to(x, size):
    """(B, H, W, C) → (B, size, size, C) by block means."""
    b, h, w, c = x.shape
    if h == size:
        return x
    return x.reshape(b, size, h // size, size, w // size, c).mean(dim=(2, 4))
