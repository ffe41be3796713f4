"""Audio driving-signal encoders in PyTorch (port of
hfa_gp_tpu/models/avatar/audio.py, AD-NeRF style): `AudioNet`, a 1-D conv
stack over a 16-frame DeepSpeech window (16 × 29 → dim_aud), and
`AudioAttNet`, a 1-D conv attention over the smoothing window of
smo_size codes.

Sequences are (batch, frames, channels) at the public functions, as in the
JAX package; the convs run (batch, channels, frames) with torch's
(cout, cin, k) weights (`utils.convert` turns the JAX package's WIO
weights so). The layers are plain Conv1d/Linear with torch's default
uniform init, not equal-lr layers, as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SLOPE = 0.02                     # LeakyReLU slope of both nets


def _uniform(g, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2 - 1) * bound


def _init_conv1d(g, cin: int, cout: int, k: int) -> dict:
    bound = 1.0 / math.sqrt(cin * k)
    return {"weight": _uniform(g, (cout, cin, k), bound),
            "bias": _uniform(g, (cout,), bound)}


def _init_linear(g, cin: int, cout: int) -> dict:
    bound = 1.0 / math.sqrt(cin)
    return {"weight": _uniform(g, (cout, cin), bound),
            "bias": _uniform(g, (cout,), bound)}


def _conv_lrelu(p, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Conv1d (k 3, padding 1) + LeakyReLU on (B, C, L)."""
    return F.leaky_relu(F.conv1d(x, p["weight"], p["bias"], stride=stride,
                                 padding=1), SLOPE)


def init_audio_net(g, dim_aud: int = 64, win_size: int = 16) -> dict:
    return {"conv0": _init_conv1d(g, 29, 32, 3),
            "conv1": _init_conv1d(g, 32, 32, 3),
            "conv2": _init_conv1d(g, 32, 64, 3),
            "conv3": _init_conv1d(g, 64, 64, 3),
            "fc0": _init_linear(g, 64, 64),
            "fc1": _init_linear(g, 64, dim_aud)}


def audio_net_apply(p, x: torch.Tensor, win_size: int = 16) -> torch.Tensor:
    """x (B, 16, 29) DeepSpeech window → (B, dim_aud).

    The crop is fixed around frame 8 (the reference's `8 - half : 8 +
    half`), whatever the window's length; four stride-2 convs, then two
    linear layers."""
    half = win_size // 2
    x = x[:, 8 - half:8 + half, :].transpose(1, 2)
    for name in ("conv0", "conv1", "conv2", "conv3"):
        x = _conv_lrelu(p[name], x, stride=2)
    x = x[:, :, 0]                                       # (B, 64)
    x = F.leaky_relu(F.linear(x, p["fc0"]["weight"], p["fc0"]["bias"]),
                     SLOPE)
    return F.linear(x, p["fc1"]["weight"], p["fc1"]["bias"])


def init_audio_att_net(g, dim_aud: int = 32, seq_len: int = 8) -> dict:
    chans = [dim_aud, 16, 8, 4, 2, 1]
    p = {f"conv{i}": _init_conv1d(g, chans[i], chans[i + 1], 3)
         for i in range(5)}
    p["att_fc"] = _init_linear(g, seq_len, seq_len)
    return p


def audio_att_net_apply(p, x: torch.Tensor, dim_aud: int = 32,
                        seq_len: int = 8) -> torch.Tensor:
    """x (B, seq_len, D) codes of each window → (B, D) attention-smoothed
    codes; the JAX function takes one window, (seq_len, D) → (D,), and is
    vmapped over the batch.

    The scores read only the first `dim_aud` (32) channels of the D-wide
    (64) code, as the reference's AudioAttNet() with its default dim_aud
    does; the weighted sum runs over the whole code."""
    y = x[:, :, :dim_aud].transpose(1, 2)                # (B, dim_aud, seq)
    for i in range(5):
        y = _conv_lrelu(p[f"conv{i}"], y, stride=1)
    scores = F.linear(y[:, 0, :], p["att_fc"]["weight"], p["att_fc"]["bias"])
    att = torch.softmax(scores, dim=1)[:, :, None]       # (B, seq, 1)
    return (att * x).sum(dim=1)
