"""FLOPs of one LPIPS (AlexNet) feature pass over a batch of images."""

from __future__ import annotations

from . import conv

CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
         (256, 3, 1, 1))


def features(b: int, size: int) -> int:
    f, cin, h = 0, 3, size
    for i, (cout, k, stride, pad) in enumerate(CONVS):
        h = (h + 2 * pad - k) // stride + 1
        f += conv(b, cin, cout, k, h)
        if i < 2:
            h = (h - 3) // 2 + 1                       # max-pool 3, stride 2
        cin = cout
    return f
