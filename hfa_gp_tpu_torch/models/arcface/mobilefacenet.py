"""MobileFaceNet face-embedding backbones, "mbf" and "mbf_large" (port of
hfa_gp_tpu/models/arcface/mobilefacenet.py).

A ConvBlock stem at 64·scale channels, DepthWise inverted-residual stages
(pw-expand → depthwise 3×3 → pw-linear; the expansion widths are the
reference's literal `groups` arguments 128/256/512), a 1×1 conv to 512 and
the GDC head: a global 7×7 depthwise LinearBlock (no padding, no PReLU),
flatten, a bias-free FC and a BN1d. "mbf" is blocks (1, 4, 6, 2) at scale
2, "mbf_large" blocks (2, 8, 12, 4) at scale 4.

Functional form, as the iresnet port: a `ParamTree` of parameters and one
of BN running moments with the JAX package's keys; images arrive
(B, H, W, 3) and run NCHW inside; conv weights are OIHW (grouped ones
(cout, cin/groups, k, k), the same grouping as JAX's HWIO with
`feature_group_count`). The head's spatial size is 1 × 1, so its flatten
needs no permutation. Traps kept from the JAX package:

  * with blocks[0] == 1 the stem's follower is a grouped ConvBlock with a
    literal `groups=64` on 64·scale channels (2 channels a group in "mbf");
  * `pw2` has no PReLU;
  * the GDC conv has `pad=0` and no PReLU;
  * in bf16 the embedding leaves the last BN in bf16 and is then widened
    to fp32 (the FC before it has no fp32 bias to promote it).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ...utils.convert import ParamTree
from .norm import batch_norm

_BN_EPS = 1e-5

MBF_CONFIGS = {
    # name: (blocks, scale)
    "mbf": ((1, 4, 6, 2), 2),
    "mbf_large": ((2, 8, 12, 4), 4),
}


def _conv_init(g: torch.Generator, k: int, cin: int, cout: int,
               groups: int = 1) -> torch.Tensor:
    # kaiming normal (fan_out), OIHW
    std = math.sqrt(2.0 / (k * k * cout))
    return torch.randn((cout, cin // groups, k, k), generator=g) * std


def _init_bn(c: int):
    return ({"scale": torch.ones(c), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def _init_cb(g, k, cin, cout, groups=1, prelu=True):
    """ConvBlock (prelu=True) / LinearBlock (prelu=False)."""
    p: dict[str, Any] = {"w": _conv_init(g, k, cin, cout, groups)}
    p["bn"], st = _init_bn(cout)
    if prelu:
        p["prelu"] = {"alpha": torch.full((cout,), 0.25)}
    return p, {"bn": st}


def _cb(p, st, x: torch.Tensor, stride: int = 1, groups: int = 1,
        train: bool = False, pad: int | None = None):
    w = p["w"]
    pad = w.shape[-1] // 2 if pad is None else pad
    y = F.conv2d(x, w.to(x.dtype), None, stride, pad, 1, groups)
    y, new = batch_norm(p["bn"], st["bn"], y, train, _BN_EPS)
    if "prelu" in p:
        y = F.prelu(y, p["prelu"]["alpha"].to(y.dtype))
    return y, {"bn": new}


def _arch(blocks, scale):
    """DepthWise descriptors (cin, cout, expansion, stride, residual), in
    order. The blocks[0] == 1 stem follower is a plain grouped ConvBlock,
    handled in init and apply."""
    c1, c2 = 64 * scale, 128 * scale
    arch = []
    if blocks[0] > 1:
        arch += [(c1, c1, 128, 1, True)] * blocks[0]
    arch += [(c1, c1, 128, 2, False)]
    arch += [(c1, c1, 128, 1, True)] * blocks[1]
    arch += [(c1, c2, 256, 2, False)]
    arch += [(c2, c2, 256, 1, True)] * blocks[2]
    arch += [(c2, c2, 512, 2, False)]
    arch += [(c2, c2, 256, 1, True)] * blocks[3]
    return arch


def init_mobilefacenet(generator: torch.Generator, embedding_dim: int = 512,
                       name: str = "mbf",
                       device: torch.device | str = "cpu"
                       ) -> tuple[ParamTree, ParamTree]:
    """(params, batch_stats) on `device`, drawn on the CPU from
    `generator`."""
    blocks, scale = MBF_CONFIGS[name]
    arch = _arch(blocks, scale)
    c1 = 64 * scale
    g = generator
    p: dict[str, Any] = {}
    st: dict[str, Any] = {}
    p["stem"], st["stem"] = _init_cb(g, 3, 3, c1)
    if blocks[0] == 1:
        p["stem_dw"], st["stem_dw"] = _init_cb(g, 3, c1, c1, groups=64)
    for i, (cin, cout, exp, _, _) in enumerate(arch):
        bp: dict[str, Any] = {}
        bs: dict[str, Any] = {}
        bp["pw1"], bs["pw1"] = _init_cb(g, 1, cin, exp)
        bp["dw"], bs["dw"] = _init_cb(g, 3, exp, exp, groups=exp)
        bp["pw2"], bs["pw2"] = _init_cb(g, 1, exp, cout, prelu=False)
        p[f"b{i}"], st[f"b{i}"] = bp, bs
    c_last = arch[-1][1]
    p["head_pw"], st["head_pw"] = _init_cb(g, 1, c_last, 512)
    p["head_gdw"], st["head_gdw"] = _init_cb(g, 7, 512, 512, groups=512,
                                             prelu=False)
    p["fc"] = {"weight": torch.randn((embedding_dim, 512), generator=g)
               * 0.01}
    p["feat_bn"], st["feat_bn"] = _init_bn(embedding_dim)
    return ParamTree(p).to(device), ParamTree(st).to(device)


def mobilefacenet_apply(params, batch_stats, x: torch.Tensor, *,
                        name: str = "mbf", train: bool = False,
                        dtype: torch.dtype = torch.float32):
    """x (B, 112, 112, 3) → (B, embedding_dim) fp32 [, new_batch_stats].
    `dtype` is the trunk's, as in `iresnet.iresnet_apply`."""
    blocks, scale = MBF_CONFIGS[name]
    arch = _arch(blocks, scale)
    h = x.to(dtype).permute(0, 3, 1, 2).contiguous()
    new: dict[str, Any] = {}
    h, new["stem"] = _cb(params["stem"], batch_stats["stem"], h, stride=2,
                         train=train)
    if blocks[0] == 1:
        h, new["stem_dw"] = _cb(params["stem_dw"], batch_stats["stem_dw"], h,
                                groups=64, train=train)
    for i, (_, _, exp, stride, residual) in enumerate(arch):
        bp, bs = params[f"b{i}"], batch_stats[f"b{i}"]
        nb: dict[str, Any] = {}
        y, nb["pw1"] = _cb(bp["pw1"], bs["pw1"], h, train=train)
        y, nb["dw"] = _cb(bp["dw"], bs["dw"], y, stride=stride, groups=exp,
                          train=train)
        y, nb["pw2"] = _cb(bp["pw2"], bs["pw2"], y, train=train)
        h = h + y if residual else y
        new[f"b{i}"] = nb
    h, new["head_pw"] = _cb(params["head_pw"], batch_stats["head_pw"], h,
                            train=train)
    h, new["head_gdw"] = _cb(params["head_gdw"], batch_stats["head_gdw"], h,
                             groups=512, train=train, pad=0)
    h = h.flatten(1)
    h = F.linear(h, params["fc"]["weight"].to(h.dtype))
    h, new["feat_bn"] = batch_norm(params["feat_bn"], batch_stats["feat_bn"],
                                   h, train, _BN_EPS)
    h = h.float()
    if train:
        return h, new
    return h
