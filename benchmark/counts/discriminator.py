"""FLOPs of EG3D's dual discriminator (`DualDiscriminator`) forward for
one batch, from a configuration's "discriminator" group: at each block
resolution r from `img_resolution` down to 8 the skip's FIR and 1×1
convolution (at r/2), the 3×3 conv0 (at r), the FIR before conv1 (pad 2,
(r + 1)² outputs) and conv1 (stride 2, at r/2); fromrgb at the top; the
epilogue at 4² (its 3×3 conv over the minibatch-std channel, fc, out),
and the label's mapping. The resize of the raw image, the minibatch
standard deviation and the projection onto the label's map are not
counted, as `torch.utils.flop_counter` counts none of them."""

from __future__ import annotations

import math

from . import conv, fir, linear


def channels(d: dict, res: int) -> int:
    return min(d["channel_base"] // res, d["channel_max"])


def forward(d: dict, b: int) -> int:
    taps = len(d["fir"])
    top = d["img_resolution"]
    f = conv(b, 2 * d["img_channels"], channels(d, top), 1, top)
    for i in range(int(math.log2(top)), 2, -1):
        r = 2 ** i
        c, c2 = channels(d, r), channels(d, r // 2)
        f += fir(b, c, taps, r // 2) + conv(b, c, c2, 1, r // 2)     # skip
        f += conv(b, c, c, 3, r)                                     # conv0
        f += fir(b, c, taps, r + 1) + conv(b, c, c2, 3, r // 2)      # conv1
    c, cmap = channels(d, 4), channels(d, 4)
    f += conv(b, c + d["mbstd_num_channels"], c, 3, 4)
    f += linear(b, c * 16, c) + linear(b, c, cmap)
    f += linear(b, d["c_dim"], cmap) + d["mapping_layers"] * linear(
        b, cmap, cmap)
    return f
