"""iresnet{18,34,50,100,200,2060} face-embedding backbones (port of
hfa_gp_tpu/models/arcface/iresnet.py).

BN-first basic blocks with PReLU, a stride-1 3×3 stem on 112² inputs and a
BN → FC → BN1d embedding head (512-d). Functional form, as in the JAX
package: a `ParamTree` of parameters and a `ParamTree` of BN running
moments with the same keys; `iresnet_apply(..., train=True)` returns
(embeddings, new_batch_stats), inference uses the stored moments.

Layout: images arrive as the JAX package takes them, (B, H, W, 3), and run
as NCHW inside; conv weights are OIHW. The FC after the last stage flattens
(c, h, w) here where the JAX package flattens (h, w, c): `convert.py`
permutes its columns.

BatchNorm follows the JAX package, not `nn.BatchNorm2d` (`norm.py`): the
running variance takes the biased batch variance (torch's takes the
unbiased one), momentum 0.1 in the torch convention, eps 1e-5, statistics
in fp32 whatever the trunk's dtype.
Deep stages run as a plain loop: the JAX package's remat'd `lax.scan`
exists for XLA's compile time.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ...utils.convert import ParamTree
from .norm import batch_norm

IRESNET_LAYERS = {
    "iresnet18": (2, 2, 2, 2),
    "iresnet34": (3, 4, 6, 3),
    "iresnet50": (3, 4, 14, 3),
    "iresnet100": (3, 13, 30, 5),
    "iresnet200": (6, 26, 60, 6),
    "iresnet2060": (3, 128, 896, 3),
}

_CHANNELS = (64, 128, 256, 512)
_BN_EPS = 1e-5


def _conv_init(g: torch.Generator, k: int, cin: int, cout: int
               ) -> torch.Tensor:
    # kaiming normal (fan_out), OIHW
    std = math.sqrt(2.0 / (k * k * cout))
    return torch.randn((cout, cin, k, k), generator=g) * std


def _init_bn(c: int) -> dict[str, torch.Tensor]:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_bn_stats(c: int) -> dict[str, torch.Tensor]:
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def _prelu(p, x: torch.Tensor) -> torch.Tensor:
    return F.prelu(x, p["alpha"].to(x.dtype))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return F.conv2d(x, w, None, stride, w.shape[-1] // 2)


def _init_block(g: torch.Generator, cin: int, cout: int, stride: int):
    p = {
        "bn1": _init_bn(cin),
        "conv1": _conv_init(g, 3, cin, cout),
        "bn2": _init_bn(cout),
        "prelu": {"alpha": torch.full((cout,), 0.25)},
        "conv2": _conv_init(g, 3, cout, cout),
        "bn3": _init_bn(cout),
    }
    st = {"bn1": _init_bn_stats(cin), "bn2": _init_bn_stats(cout),
          "bn3": _init_bn_stats(cout)}
    if stride != 1 or cin != cout:
        p["down_conv"] = _conv_init(g, 1, cin, cout)
        p["down_bn"] = _init_bn(cout)
        st["down_bn"] = _init_bn_stats(cout)
    return p, st


def _block(p, st, x: torch.Tensor, stride: int, train: bool):
    dt = x.dtype
    out, s1 = batch_norm(p["bn1"], st["bn1"], x, train, _BN_EPS)
    out = _conv(out, p["conv1"].to(dt))
    out, s2 = batch_norm(p["bn2"], st["bn2"], out, train, _BN_EPS)
    out = _prelu(p["prelu"], out)
    out = _conv(out, p["conv2"].to(dt), stride)
    out, s3 = batch_norm(p["bn3"], st["bn3"], out, train, _BN_EPS)
    new_st = {"bn1": s1, "bn2": s2, "bn3": s3}
    if "down_conv" in p:
        idn = _conv(x, p["down_conv"].to(dt), stride)
        idn, new_st["down_bn"] = batch_norm(p["down_bn"], st["down_bn"],
                                            idn, train, _BN_EPS)
    else:
        idn = x
    return out + idn, new_st


def init_iresnet(generator: torch.Generator, name: str = "iresnet50",
                 embedding_dim: int = 512, input_size: int = 112,
                 device: torch.device | str = "cpu"
                 ) -> tuple[ParamTree, ParamTree]:
    """(params, batch_stats) on `device`, drawn on the CPU from `generator`
    so that one seed gives one model on every device."""
    layers = IRESNET_LAYERS[name]
    g = generator
    p: dict[str, Any] = {"stem_conv": _conv_init(g, 3, 3, 64),
                         "stem_bn": _init_bn(64),
                         "stem_prelu": {"alpha": torch.full((64,), 0.25)}}
    st: dict[str, Any] = {"stem_bn": _init_bn_stats(64)}
    cin = 64
    for stage, (n, cout) in enumerate(zip(layers, _CHANNELS)):
        for i in range(n):
            stride = 2 if i == 0 else 1
            p[f"s{stage}_b{i}"], st[f"s{stage}_b{i}"] = _init_block(
                g, cin, cout, stride)
            cin = cout
    feat = input_size // 16
    p["bn2"] = _init_bn(512)
    st["bn2"] = _init_bn_stats(512)
    fc_in = 512 * feat * feat
    p["fc"] = {"weight": torch.randn((embedding_dim, fc_in),
                                     generator=g) * 0.01,
               "bias": torch.zeros(embedding_dim)}
    # 'features' BN1d
    p["features_bn"] = _init_bn(embedding_dim)
    st["features_bn"] = _init_bn_stats(embedding_dim)
    return ParamTree(p).to(device), ParamTree(st).to(device)


def iresnet_apply(params, batch_stats, x: torch.Tensor,
                  name: str = "iresnet50", *, train: bool = False,
                  dtype: torch.dtype = torch.float32):
    """x: (B, 112, 112, 3) in [-1, 1] → (B, 512) fp32 embeddings
    [, new_batch_stats (a nested dict of tensors) when train].

    `dtype` is the trunk's: the input and the conv and FC weights are cast
    to it, BN runs as an fp32 island (`norm.batch_norm`) whose output goes
    back to it, as in the JAX package."""
    layers = IRESNET_LAYERS[name]
    x = x.to(dtype).permute(0, 3, 1, 2).contiguous()
    new_st: dict[str, Any] = {}
    h = _conv(x, params["stem_conv"].to(dtype))
    h, new_st["stem_bn"] = batch_norm(params["stem_bn"],
                                      batch_stats["stem_bn"], h, train,
                                      _BN_EPS)
    h = _prelu(params["stem_prelu"], h)
    for stage, n in enumerate(layers):
        for i in range(n):
            k = f"s{stage}_b{i}"
            h, new_st[k] = _block(params[k], batch_stats[k], h,
                                  2 if i == 0 else 1, train)
    h, new_st["bn2"] = batch_norm(params["bn2"], batch_stats["bn2"], h,
                                  train, _BN_EPS)
    h = h.flatten(1)                                   # (c, h, w) order
    # the product in the trunk's dtype; its fp32 bias makes the sum fp32,
    # as JAX's type promotion does
    h = F.linear(h, params["fc"]["weight"].to(dtype)) + params["fc"]["bias"]
    h, new_st["features_bn"] = batch_norm(params["features_bn"],
                                          batch_stats["features_bn"], h,
                                          train, _BN_EPS)
    h = h.float()
    if train:
        return h, new_st
    return h
