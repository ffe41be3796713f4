"""Deep3DFaceRecon inference net: ResNet-50 → 257 BFM coefficients (port of
hfa_gp_tpu/preprocess/facerecon.py).

Rebuilds reference eg3d-pose-detection/models/networks.py:69-104
(ReconNetWrapper): a torchvision-style ResNet-50 trunk (bottleneck blocks,
the final average pool kept as a 1×1 map), written here by hand, and seven
1×1 conv heads emitting [id 80 | exp 64 | tex 80 | angle 3 | gamma 27 |
tx,ty 2 | tz 1] = 257 coefficients. BatchNorm runs on its stored statistics
(eps 1e-5) in every mode: the net only ever runs inference.

Input: (B, 3, 224, 224) float in [0, 1], NCHW (the Deep3DFaceRecon
convention: images are fed un-normalized beyond /255).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LAYERS = (3, 4, 6, 3)             # resnet50
WIDTHS = (64, 128, 256, 512)
HEAD_DIMS = (80, 64, 80, 3, 27, 2, 1)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm over stored statistics: (x − mean)·rsqrt(var + eps)·scale
    + bias, whatever the module's training flag."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                            training=False, eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          pad: int | None = None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, k // 2 if pad is None else pad,
                     bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        cout = width * 4
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3, self.bn3 = _conv(width, cout, 1), FrozenBatchNorm2d(cout)
        if downsample:
            self.down_conv = _conv(cin, cout, 1, stride)
            self.down_bn = FrozenBatchNorm2d(cout)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(out + idn)


class FaceRecon(nn.Module):
    """ResNet-50 trunk + the seven coefficient heads. Submodule names are
    the JAX param tree's keys (`stem_conv`, `s{stage}_b{i}`, `head{i}`)."""

    def __init__(self):
        super().__init__()
        self.stem_conv = _conv(3, 64, 7, 2, 3)
        self.stem_bn = FrozenBatchNorm2d(64)
        cin = 64
        for stage, (blocks, width) in enumerate(zip(LAYERS, WIDTHS)):
            for i in range(blocks):
                stride = 1 if (stage == 0 or i > 0) else 2
                self.add_module(f"s{stage}_b{i}",
                                Bottleneck(cin, width, stride, i == 0))
                cin = width * 4
        for i, d in enumerate(HEAD_DIMS):
            self.add_module(f"head{i}", nn.Conv2d(2048, d, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) in [0, 1] → (B, 257) coefficients."""
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        h = F.max_pool2d(h, 3, 2, 1)                   # pads with −inf
        for stage, blocks in enumerate(LAYERS):
            for i in range(blocks):
                h = getattr(self, f"s{stage}_b{i}")(h)
        h = h.mean(dim=(2, 3), keepdim=True)           # (B, 2048, 1, 1)
        return torch.cat([getattr(self, f"head{i}")(h)
                          for i in range(len(HEAD_DIMS))], dim=1)[:, :, 0, 0]


def init_facerecon(generator: torch.Generator,
                   device: torch.device | str = "cpu") -> FaceRecon:
    """The JAX init's distributions: He-normal convs (std √(2 / (k²·cout))),
    BN at identity, zero heads (networks.py:92-95)."""
    net = FaceRecon()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                k, cout = m.kernel_size[0], m.out_channels
                if m.bias is not None:                 # a head
                    m.weight.zero_()
                    m.bias.zero_()
                else:
                    m.weight.copy_(torch.randn(
                        m.weight.shape, generator=generator)
                        * math.sqrt(2.0 / (k * k * cout)))
    return net.eval().requires_grad_(False).to(device)
