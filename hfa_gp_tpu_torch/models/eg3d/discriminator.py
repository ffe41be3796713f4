"""EG3D's dual discriminator in PyTorch (`training/dual_discriminator.py`
`DualDiscriminator` over StyleGAN2's resnet `DiscriminatorBlock`s,
`DiscriminatorEpilogue` and a label-only `MappingNetwork`).

The image (B, 3, 512, 512) and the raw neural render (B, 3, 128, 128),
resized to 512² by antialiased bilinear (EG3D's `filtered_resizing`),
enter as one 6-channel image. Blocks at 512, 256, …, 8 halve it; at 4²
the epilogue appends the minibatch standard deviation, and the logit is
the projection of its output onto the mapped camera label.

`init_discriminator` builds a nested dict whose keys are NVIDIA's
state-dict names (`b512.fromrgb`, `b256.conv0`, `b4.fc`, `mapping.fc7`,
…), so that a converter maps their `D` one to one; `discriminator_apply`
reads it (a dict or a `utils.convert.ParamTree`). Convolutions go to
cuDNN; every FIR is `core/ops.upfirdn2d`, the hand-written kernel K9 on
the card. fp32 throughout (EG3D runs the top four resolutions in fp16).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...core import ops


@dataclass(frozen=True)
class DiscriminatorConfig:
    """`DualDiscriminator` of EG3D's FFHQ 512 recipe."""
    c_dim: int = 25
    img_resolution: int = 512
    img_channels: int = 3               # of each image; 6 enter
    channel_base: int = 32768
    channel_max: int = 512
    conv_clamp: float | None = 256.0
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    mapping_layers: int = 8
    mapping_lr_multiplier: float = 0.01
    fir: tuple[int, ...] = (1, 3, 3, 1)

    def channels(self, res: int) -> int:
        return min(self.channel_base // res, self.channel_max)

    @property
    def block_resolutions(self) -> tuple[int, ...]:
        n = int(math.log2(self.img_resolution))
        return tuple(2 ** i for i in range(n, 2, -1))

    @property
    def cmap_dim(self) -> int:
        return self.channels(4)


# -- init ---------------------------------------------------------------------


def _conv(g, cin, cout, k, bias=True) -> dict:
    p = {"weight": torch.randn((cout, cin, k, k), generator=g)}
    if bias:
        p["bias"] = torch.zeros(cout)
    return p


def _fc(g, cin, cout, lr_mul=1.0) -> dict:
    return {"weight": torch.randn((cout, cin), generator=g) / lr_mul,
            "bias": torch.zeros(cout)}


def init_discriminator(g: torch.Generator, cfg: DiscriminatorConfig
                       ) -> dict:
    """Random parameters from `g` as EG3D initialises them: weights
    N(0, 1) (the mapping's layers N(0, 1/lr_mul²)), biases 0; CPU
    tensors."""
    p = {}
    for res in cfg.block_resolutions:
        c, c2 = cfg.channels(res), cfg.channels(res // 2)
        b = {}
        if res == cfg.img_resolution:
            b["fromrgb"] = _conv(g, 2 * cfg.img_channels, c, 1)
        b["conv0"] = _conv(g, c, c, 3)
        b["conv1"] = _conv(g, c, c2, 3)
        b["skip"] = _conv(g, c, c2, 1, bias=False)
        p[f"b{res}"] = b
    c = cfg.channels(4)
    p["b4"] = {"conv": _conv(g, c + cfg.mbstd_num_channels, c, 3),
               "fc": _fc(g, c * 16, c),
               "out": _fc(g, c, cfg.cmap_dim)}
    m = {"embed": _fc(g, cfg.c_dim, cfg.cmap_dim)}
    for i in range(cfg.mapping_layers):
        m[f"fc{i}"] = _fc(g, cfg.cmap_dim, cfg.cmap_dim,
                          cfg.mapping_lr_multiplier)
    p["mapping"] = m
    return p


# -- layers -------------------------------------------------------------------


def conv2d_layer(p, x: torch.Tensor, *, act: str, fir, gain: float = 1.0,
                 down: int = 1, conv_clamp: float | None = None
                 ) -> torch.Tensor:
    """StyleGAN2's `Conv2dLayer`: weight · 1/√(cin·k²), at down 2 the FIR
    first (before a 1×1 with its down-sampling, before a 3×3 at stride
    2), then bias, the activation × its gain × `gain`, and the clamp at
    ±conv_clamp·gain."""
    w = p["weight"]
    _, cin, k, _ = w.shape
    w = w * (1.0 / math.sqrt(cin * k * k))
    if down == 1:
        x = F.conv2d(x, w, padding=k // 2)
    else:
        f = len(fir)
        pad = (k // 2 + (f - down + 1) // 2, k // 2 + (f - down) // 2)
        if k == 1:
            x = F.conv2d(ops.upfirdn2d(x, fir, down=down, pad=pad), w)
        else:
            x = F.conv2d(ops.upfirdn2d(x, fir, pad=pad), w, stride=down)
    act_gain = (math.sqrt(2.0) if act == "lrelu" else 1.0) * gain
    clamp = None if conv_clamp is None else conv_clamp * gain
    return ops.bias_act(x, p.get("bias"), act=act, gain=act_gain,
                        clamp=clamp)


def minibatch_std(x: torch.Tensor, group_size: int,
                  num_channels: int) -> torch.Tensor:
    """StyleGAN2's `MinibatchStdLayer`: the standard deviation over each
    group of samples (member i of group j is sample i·n + j), averaged
    over channels and pixels, appended as `num_channels` maps."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    f = num_channels
    y = x.reshape(g, -1, f, c // f, h, w)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


def mapping_apply(params, cfg: DiscriminatorConfig,
                  c: torch.Tensor) -> torch.Tensor:
    """The label's map (B, cmap_dim): `MappingNetwork` with z_dim 0, no
    w_avg and no broadcast."""
    e = params["embed"]
    x = ops.normalize_2nd_moment(ops.fully_connected(c, e["weight"],
                                                     e["bias"]))
    for i in range(cfg.mapping_layers):
        fc = params[f"fc{i}"]
        x = ops.fully_connected(x, fc["weight"], fc["bias"],
                                activation="lrelu",
                                lr_multiplier=cfg.mapping_lr_multiplier)
    return x


def resize_raw(image_raw: torch.Tensor, size: int) -> torch.Tensor:
    """EG3D's `filtered_resizing` in its 'antialiased' mode."""
    return F.interpolate(image_raw, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def discriminator_apply(params, cfg: DiscriminatorConfig,
                        image: torch.Tensor, image_raw: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """image (B, 3, 512, 512), image_raw (B, 3, r, r), label c (B, 25) →
    logits (B, 1)."""
    fir = ops.make_fir_kernel(cfg.fir)
    img = torch.cat([image, resize_raw(image_raw, image.shape[-1])], dim=1)
    clamp = cfg.conv_clamp
    x = None
    for res in cfg.block_resolutions:
        b = params[f"b{res}"]
        if x is None:
            x = conv2d_layer(b["fromrgb"], img, act="lrelu", fir=fir,
                             conv_clamp=clamp)
        half = math.sqrt(0.5)
        y = conv2d_layer(b["skip"], x, act="linear", fir=fir, gain=half,
                         down=2)
        x = conv2d_layer(b["conv0"], x, act="lrelu", fir=fir,
                         conv_clamp=clamp)
        x = conv2d_layer(b["conv1"], x, act="lrelu", fir=fir, gain=half,
                         down=2, conv_clamp=clamp)
        x = y + x
    cmap = mapping_apply(params["mapping"], cfg, c)
    e = params["b4"]
    x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels)
    x = conv2d_layer(e["conv"], x, act="lrelu", fir=fir, conv_clamp=clamp)
    x = ops.fully_connected(x.flatten(1), e["fc"]["weight"], e["fc"]["bias"],
                            activation="lrelu")
    x = ops.fully_connected(x, e["out"]["weight"], e["out"]["bias"])
    return (x * cmap).sum(dim=1, keepdim=True) * (1.0 / math.sqrt(
        cfg.cmap_dim))
