"""FLOPs of the audio avatar's driving side for one batch: AudioNet on
each of the smo_size windows of a frame, AudioAttNet over their codes,
and the seven-layer weights MLP."""

from __future__ import annotations

from . import linear

FEATURES = 29


def _conv1d(rows, cin, cout, k, length):
    return 2 * rows * cin * cout * k * length


def audio_net(a: dict, rows: int) -> int:
    f, length = 0, a["win_size"]
    for cin, cout in ((FEATURES, 32), (32, 32), (32, 64), (64, 64)):
        length = (length + 2 - 3) // 2 + 1
        f += _conv1d(rows, cin, cout, 3, length)
    return f + linear(rows, 64, 64) + linear(rows, 64, a["dim_aud"])


def audio_att_net(a: dict, b: int) -> int:
    chans = (32, 16, 8, 4, 2, 1)
    f = sum(_conv1d(b, chans[i], chans[i + 1], 3, a["smo_size"])
            for i in range(5))
    return f + linear(b, a["smo_size"], a["smo_size"])


def weights_mlp(a: dict, w_dim: int, dim_shape: int, b: int) -> int:
    return linear(b, a["dim_aud"], w_dim) + 5 * linear(b, w_dim, w_dim) \
        + linear(b, w_dim, dim_shape)


def driving(a: dict, w_dim: int, dim_shape: int, b: int) -> int:
    return audio_net(a, b * a["smo_size"]) + audio_att_net(a, b) \
        + weights_mlp(a, w_dim, dim_shape, b)
