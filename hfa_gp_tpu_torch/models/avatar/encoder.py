"""RGB driving-signal encoder in PyTorch (port of
hfa_gp_tpu/models/avatar/encoder.py): a 1x1 stem, ResBlocks halving the
resolution down to 4², a 4x4 valid conv to a 512-d appearance code, and a
5-layer EqualLinear stack to `dim_shape` driving weights (plus an
optional 25-d pose head).

`encoder_apply` takes images (B, size, size, 3) as the JAX function does;
the conv layers run NCHW with OIHW weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...core import ops

CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
            256: 64, 512: 32, 1024: 16}

BLUR_KERNEL = (1, 3, 3, 1)


def _init_conv(g, in_ch, out_ch, k) -> torch.Tensor:
    return torch.randn((out_ch, in_ch, k, k), generator=g)


def init_conv_layer(g, in_ch, out_ch, k, *, bias=True,
                    activate=True) -> dict:
    p = {"weight": _init_conv(g, in_ch, out_ch, k)}
    if activate and bias:
        p["act_bias"] = torch.zeros(out_ch)
    elif bias and not activate:
        p["bias"] = torch.zeros(out_ch)
    return p


def conv_layer_apply(p, x: torch.Tensor, *, downsample: bool = False,
                     activate: bool = True) -> torch.Tensor:
    """ConvLayer: optional blur + stride 2, equal-lr conv, bias + lrelu."""
    k = p["weight"].shape[-1]
    if downsample:
        ptot = (len(BLUR_KERNEL) - 2) + (k - 1)
        x = ops.blur(x, ops.make_fir_kernel(BLUR_KERNEL),
                     pad=((ptot + 1) // 2, ptot // 2))
        stride, padding = 2, 0
    else:
        stride, padding = 1, k // 2
    y = ops.equal_conv2d(x, p["weight"], p.get("bias"), stride=stride,
                         padding=padding)
    if activate:
        if "act_bias" in p:
            y = ops.fused_leaky_relu(y, p["act_bias"])
        else:
            y = F.leaky_relu(y, 0.2)                     # ScaledLeakyReLU
    return y


def init_res_block(g, in_ch, out_ch) -> dict:
    return {
        "conv1": init_conv_layer(g, in_ch, in_ch, 3),
        "conv2": init_conv_layer(g, in_ch, out_ch, 3),
        "skip": init_conv_layer(g, in_ch, out_ch, 1, bias=False,
                                activate=False),
    }


def res_block_apply(p, x: torch.Tensor) -> torch.Tensor:
    out = conv_layer_apply(p["conv1"], x)
    out = conv_layer_apply(p["conv2"], out, downsample=True)
    skip = conv_layer_apply(p["skip"], x, downsample=True, activate=False)
    return (out + skip) / math.sqrt(2.0)


def init_encoder_app(g, size: int, w_dim: int = 512) -> dict:
    log_size = int(math.log2(size))
    p = {"stem": init_conv_layer(g, 3, CHANNELS[size], 1)}
    in_ch = CHANNELS[size]
    for i, res_exp in enumerate(range(log_size, 2, -1)):
        out_ch = CHANNELS[2 ** (res_exp - 1)]
        p[f"res{i}"] = init_res_block(g, in_ch, out_ch)
        in_ch = out_ch
    p["final"] = {"weight": _init_conv(g, in_ch, w_dim, 4)}
    return p


def encoder_app_apply(p, x: torch.Tensor) -> torch.Tensor:
    """(B, size, size, 3) → (B, w_dim) appearance code."""
    h = conv_layer_apply(p["stem"], x.permute(0, 3, 1, 2))
    i = 0
    while f"res{i}" in p:
        h = res_block_apply(p[f"res{i}"], h)
        i += 1
    h = ops.equal_conv2d(h, p["final"]["weight"], None, padding=0)
    return h[:, :, 0, 0]


def init_linear_stack(g, dims: list[int]) -> dict:
    return {f"fc{i}": {"weight": torch.randn((dims[i + 1], dims[i]),
                                             generator=g),
                       "bias": torch.zeros(dims[i + 1])}
            for i in range(len(dims) - 1)}


def linear_stack_apply(p, x: torch.Tensor) -> torch.Tensor:
    """EqualLinear layers with no activation between them (as the
    reference builds its weight heads)."""
    i = 0
    while f"fc{i}" in p:
        fc = p[f"fc{i}"]
        x = ops.equal_linear(x, fc["weight"], fc["bias"])
        i += 1
    return x


def init_encoder(g, size: int, dim: int = 512, dim_shape: int = 50,
                 out_pose: bool = False) -> dict:
    p = {"net_app": init_encoder_app(g, size, dim),
         "fc": init_linear_stack(g, [dim] * 5 + [dim_shape])}
    if out_pose:
        p["pose"] = init_linear_stack(g, [dim] * 5 + [25])
    return p


def encoder_apply(p, x: torch.Tensor, *, use_softmax: bool = False):
    """(B, size, size, 3) → driving weights (B, dim_shape) [, pose (B, 25)]."""
    h = encoder_app_apply(p["net_app"], x)
    w = linear_stack_apply(p["fc"], h)
    if use_softmax:
        w = torch.softmax(w, dim=1)
    if "pose" in p:
        return w, linear_stack_apply(p["pose"], h)
    return w
