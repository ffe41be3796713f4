"""FLOPs of the RGB avatar's driving side for one batch: the encoder
(a 1x1 stem, ResBlocks with FIR-blurred stride-2 convs down to 4², a 4x4
valid conv, five linear layers) and the subspace product."""

from __future__ import annotations

import math

from . import conv, fir, linear

CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
            256: 64, 512: 32, 1024: 16}
BLUR_TAPS = 4


def encoder(enc: dict, b: int) -> int:
    size, w_dim = enc["size"], enc["w_dim"]
    f = conv(b, 3, CHANNELS[size], 1, size)
    h, cin = size, CHANNELS[size]
    for _ in range(int(math.log2(size)) - 2):
        cout = CHANNELS[h // 2]
        f += conv(b, cin, cin, 3, h)                                # conv1
        f += fir(b, cin, BLUR_TAPS, h + 1) + conv(b, cin, cout, 3, h // 2)
        f += fir(b, cin, BLUR_TAPS, h - 1) + conv(b, cin, cout, 1, h // 2)
        h, cin = h // 2, cout
    f += conv(b, cin, w_dim, 4, 1)
    return f + 4 * linear(b, w_dim, w_dim) + linear(b, w_dim, enc["dim_shape"])


def subspace(enc: dict, num_ws: int, b: int) -> int:
    return linear(b, enc["dim_shape"], num_ws * enc["w_dim"])
