"""FLOPs of the EG3D synthesis of one batch: the tri-plane backbone, the
rays, the OSG decoder at every sample, and the super-resolution head.
The tri-plane lookups and the march are memory-bound and count no FLOPs
here (their bytes are in `sampler.py` and `marcher.py`)."""

from __future__ import annotations

import math

from . import conv, fir, linear


def _block(b, cin, cout, out_ch, res, w_dim, taps, *, first, up_img):
    """A skip-architecture synthesis block at resolution `res`."""
    f = 0
    if not first:                     # conv0: 3x3 transposed from res / 2
        f += linear(b, w_dim, cin) + conv(b, cin, cout, 3, res // 2)
        f += fir(b, cout, taps, res)
    f += linear(b, w_dim, cout) + conv(b, cout, cout, 3, res)       # conv1
    f += linear(b, w_dim, cout) + conv(b, cout, out_ch, 1, res)     # torgb
    if up_img:
        f += fir(b, out_ch, taps, res)
    return f


def backbone(cfg: dict, b: int) -> int:
    bb = cfg["backbone"]
    taps = len(bb["fir"])
    f, cin = 0, 0
    for i in range(2, int(math.log2(bb["img_resolution"])) + 1):
        res = 2 ** i
        cout = min(bb["channel_base"] // res, bb["channel_max"])
        f += _block(b, cin, cout, bb["img_channels"], res, bb["w_dim"], taps,
                    first=res == 4, up_img=res != 4)
        cin = cout
    return f


def samples(cfg: dict, b: int) -> int:
    rc = cfg["render"]
    rays = rc["neural_rendering_resolution"] ** 2
    return b * rays * (rc["depth_resolution"]
                       + rc["depth_resolution_importance"])


def render(cfg: dict, b: int) -> int:
    """The rays' directions and the decoder MLP at every sample."""
    rc = cfg["render"]
    rays = rc["neural_rendering_resolution"] ** 2
    feats = cfg["backbone"]["img_channels"] // 3
    mlp = linear(1, feats, rc["decoder_hidden"]) \
        + linear(1, rc["decoder_hidden"], 1 + rc["decoder_output_dim"])
    return 2 * b * rays * 3 * 3 + samples(cfg, b) * mlp


def superresolution(cfg: dict, b: int) -> int:
    sr = cfg["sr"]
    taps = len(sr["fir"])
    c0, c1 = sr["block_channels"]
    out = sr["output_resolution"]
    return (_block(b, sr["in_channels"], c0, 3, out // 2, sr["w_dim"], taps,
                   first=False, up_img=True)
            + _block(b, c0, c1, 3, out, sr["w_dim"], taps, first=False,
                     up_img=True))


def synthesis(cfg: dict, b: int) -> int:
    return backbone(cfg, b) + render(cfg, b) + superresolution(cfg, b)
