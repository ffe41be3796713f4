"""DeepSpeech audio feature extraction, `aud.npy` from a 16 kHz wav (port
of hfa_gp_tpu/preprocess/deepspeech.py).

The reference consumes DeepSpeech features extracted by AD-NeRF's tooling
(reference README.md:41; `code/dataset.py:404` loads `aud.npy` of shape
(n_video_frames, 16, 29)). The chain:

  wav (16 kHz mono) ──mfcc──► (T, 26) @ 50 Hz ──context──► (T, 494)
      ──DS-0.1.0 net──► logits (T, 29) ──resample──► (N, 29) @ fps
      ──16-frame window──► aud.npy (N, 16, 29)

The feature math (MFCC, context stacking, resampling, windowing) is host
numpy, the same code as the JAX package's: python_speech_features defaults
(preemphasis 0.97, 25 ms rectangular frames at 10 ms hop, 512-pt power
spectrum, 26 mel filters to Nyquist, DCT-II(ortho), ceplifter 22,
log-energy as c0), every second frame (50 Hz), ±9-frame context with zero
edges and whole-utterance (x − mean)/std normalization.

The network is DS 0.1.0's, as an `nn.Module` on the caller's device: three
2048-wide clipped-ReLU (min(relu, 20)) dense layers, a bidirectional LSTM
of 2048 units, concat(fw, bw) → one more clipped-ReLU dense layer, and the
29-way logits. The LSTM is `nn.LSTM` (cuDNN on the card): TF's
BasicLSTMCell (one (cin + units, 4·units) kernel, gates i, j, f, o,
forget_bias 1.0 added at run time) maps onto it by splitting the kernel
into its x and h rows, reordering the gates to torch's (i, f, g, o) and
folding the forget bias into the f slice of `bias_ih`
(`lstm_weights_from_tf`). The net runs the utterance's true length.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

SAMPLE_RATE = 16000
N_CEP = 26          # MFCC coefficients (also n mel filters)
N_CONTEXT = 9       # ±9 frames of context
N_INPUT = N_CEP * (2 * N_CONTEXT + 1)   # 494
N_HIDDEN = 2048
N_CHARS = 29
WIN_LEN = 0.025     # python_speech_features defaults (25 ms / 10 ms)
WIN_STEP = 0.01
NFFT = 512
PREEMPH = 0.97
CEPLIFTER = 22
AUDIO_WINDOW = 16   # frames per aud.npy row


# ---------------------------------------------------------------------------
# MFCC (python_speech_features-default math, vectorized)
# ---------------------------------------------------------------------------


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def mel_filterbank(nfilt: int = N_CEP, nfft: int = NFFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """(nfilt, nfft//2+1) triangular mel filter bank, 0..Nyquist."""
    mels = np.linspace(_hz_to_mel(0), _hz_to_mel(sr / 2), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel_to_hz(mels) / sr).astype(np.int64)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for m in range(1, nfilt + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ctr):
            fb[m - 1, k] = (k - lo) / max(ctr - lo, 1)
        for k in range(ctr, hi):
            fb[m - 1, k] = (hi - k) / max(hi - ctr, 1)
    return fb


def _dct2_ortho_matrix(n: int) -> np.ndarray:
    """(n, n) DCT-II matrix with 'ortho' norm (scipy.fftpack.dct)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m


def mfcc(audio: np.ndarray, sr: int = SAMPLE_RATE,
         numcep: int = N_CEP) -> np.ndarray:
    """(S,) float/int16 audio → (T, numcep) MFCC at 100 Hz (pre-stride).

    python_speech_features.mfcc defaults: rectangular window, power
    spectrum |fft|²/NFFT, log mel energies floored at eps, DCT-II
    ortho + lifter, c0 replaced by log frame energy (appendEnergy)."""
    audio = np.asarray(audio, np.float64)
    # preemphasis
    audio = np.append(audio[0], audio[1:] - PREEMPH * audio[:-1])
    flen = int(round(WIN_LEN * sr))          # 400
    fstep = int(round(WIN_STEP * sr))        # 160
    n = len(audio)
    t = 1 if n <= flen else 1 + int(math.ceil((n - flen) / fstep))
    pad = np.zeros(max(0, (t - 1) * fstep + flen - n))
    audio = np.concatenate([audio, pad])
    idx = (np.arange(flen)[None, :]
           + fstep * np.arange(t)[:, None])
    frames = audio[idx]                      # (T, 400) rectangular
    pspec = (np.abs(np.fft.rfft(frames, NFFT)) ** 2) / NFFT
    energy = pspec.sum(axis=1)
    energy = np.where(energy == 0, np.finfo(np.float64).eps, energy)
    fb = mel_filterbank(numcep, NFFT, sr)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    feat = np.log(feat)
    feat = feat @ _dct2_ortho_matrix(numcep).T[:, :numcep]
    # liftering
    lift = 1 + (CEPLIFTER / 2.0) * np.sin(
        np.pi * np.arange(numcep) / CEPLIFTER)
    feat = feat * lift
    feat[:, 0] = np.log(energy)              # appendEnergy
    return feat.astype(np.float32)


def input_vectors(audio: np.ndarray, sr: int = SAMPLE_RATE) -> np.ndarray:
    """DS-0.1.0 `audiofile_to_input_vector`: MFCC → every 2nd frame
    (50 Hz) → ±9-frame zero-padded context stack → whole-utterance
    (x-mean)/std → (T50, 494)."""
    feat = mfcc(audio, sr)[::2]              # (T50, 26)
    t = feat.shape[0]
    padded = np.concatenate([np.zeros((N_CONTEXT, N_CEP), np.float32),
                             feat,
                             np.zeros((N_CONTEXT, N_CEP), np.float32)])
    ctx = np.stack([padded[i:i + 2 * N_CONTEXT + 1].ravel()
                    for i in range(t)])      # (T50, 494)
    ctx = (ctx - ctx.mean()) / max(ctx.std(), 1e-8)
    return ctx.astype(np.float32)


# ---------------------------------------------------------------------------
# DeepSpeech 0.1.0 network
# ---------------------------------------------------------------------------

FORGET_BIAS = 1.0


def _clipped_relu(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 20.0)


class DeepSpeech(nn.Module):
    """(T, 494) context vectors → (T, 29) logits. Submodule names are the
    JAX param tree's keys, but for the one bidirectional `lstm`, whose two
    directions are the tree's `lstm_fw` and `lstm_bw`."""

    def __init__(self, n_input: int = N_INPUT, n_hidden: int = N_HIDDEN,
                 n_chars: int = N_CHARS):
        super().__init__()
        self.h1 = nn.Linear(n_input, n_hidden)
        self.h2 = nn.Linear(n_hidden, n_hidden)
        self.h3 = nn.Linear(n_hidden, n_hidden)
        self.lstm = nn.LSTM(n_hidden, n_hidden, bidirectional=True)
        self.h5 = nn.Linear(2 * n_hidden, n_hidden)
        self.logits = nn.Linear(n_hidden, n_chars)

    @property
    def device(self) -> torch.device:
        return self.h1.weight.device

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        """The three clipped-ReLU layers before the LSTM."""
        h = _clipped_relu(self.h1(x))
        h = _clipped_relu(self.h2(h))
        return _clipped_relu(self.h3(h))

    def recur(self, h: torch.Tensor) -> torch.Tensor:
        """(T, units) → (T, 2·units): [forward | backward] hidden states."""
        return self.lstm(h)[0]

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.logits(_clipped_relu(self.h5(h)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.recur(self.dense(x)))


def lstm_weights_from_tf(kernel, bias, cin: int
                         ) -> tuple[torch.Tensor, ...]:
    """TF BasicLSTMCell (kernel (cin + units, 4·units), bias (4·units,),
    gates i, j, f, o) → torch's (w_ih, w_hh, b_ih, b_hh), gates i, f, g, o,
    with the forget bias folded into b_ih's f slice."""
    kernel = torch.from_numpy(np.array(kernel, np.float32))
    bias = torch.from_numpy(np.array(bias, np.float32))
    i, j, f, o = kernel.chunk(4, dim=1)
    k = torch.cat([i, f, j, o], dim=1)
    bi, bj, bf, bo = bias.chunk(4)
    b_ih = torch.cat([bi, bf + FORGET_BIAS, bj, bo])
    return (k[:cin].T.contiguous(), k[cin:].T.contiguous(), b_ih,
            torch.zeros_like(b_ih))


def init_deepspeech(generator: torch.Generator,
                    device: torch.device | str = "cpu") -> DeepSpeech:
    """The JAX init's distributions: dense weights U(±1/√cin), LSTM kernels
    U(±1/√(cin + units)), zero biases (so b_ih's f slice holds the forget
    bias alone)."""
    net = DeepSpeech()

    def uniform(shape, bound):
        return torch.rand(shape, generator=generator) * 2 * bound - bound

    with torch.no_grad():
        for layer in (net.h1, net.h2, net.h3, net.h5, net.logits):
            layer.weight.copy_(uniform(layer.weight.shape,
                                       1.0 / math.sqrt(layer.in_features)))
            layer.bias.zero_()
        units = net.lstm.hidden_size
        for sfx in ("", "_reverse"):
            kernel = uniform((2 * units, 4 * units),
                             1.0 / math.sqrt(2 * units))
            for name, t in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                                "bias_hh_l0"),
                               lstm_weights_from_tf(
                                   kernel, torch.zeros(4 * units), units)):
                getattr(net.lstm, name + sfx).copy_(t)
    return net.eval().requires_grad_(False).to(device)


# ---------------------------------------------------------------------------
# 50 Hz → video-fps resampling + windowing (AD-NeRF conventions)
# ---------------------------------------------------------------------------


def interpolate_features(feats: np.ndarray, input_rate: float,
                         output_rate: float,
                         output_len: int | None = None) -> np.ndarray:
    """Per-dim linear resampling (T_in, C) → (T_out, C)."""
    t_in = feats.shape[0]
    if output_len is None:
        output_len = int(t_in * output_rate / input_rate)
    tin = np.arange(t_in) / input_rate
    tout = np.arange(output_len) / output_rate
    return np.stack([np.interp(tout, tin, feats[:, i])
                     for i in range(feats.shape[1])],
                    axis=1).astype(np.float32)


def window_features(feats: np.ndarray,
                    win: int = AUDIO_WINDOW) -> np.ndarray:
    """(N, C) per-frame features → (N, win, C) zero-padded sliding
    windows centered per frame (matches the smo-window convention the
    dataset layer applies on top, data/dataset.py)."""
    n, c = feats.shape
    half = win // 2
    out = np.zeros((n, win, c), np.float32)
    for i in range(n):
        lo, hi = i - half, i + half
        slo, shi = max(lo, 0), min(hi, n)
        out[i, slo - lo:shi - lo] = feats[slo:shi]
    return out


def extract_features(net: DeepSpeech, audio: np.ndarray,
                     sr: int = SAMPLE_RATE, fps: float = 25.0,
                     n_frames: int | None = None) -> np.ndarray:
    """16 kHz mono samples → aud.npy array (n_frames, 16, 29); the net runs
    on its device over the utterance's true length."""
    vec = input_vectors(audio, sr)
    t = vec.shape[0]
    with torch.inference_mode():
        logits = net(torch.from_numpy(vec).to(net.device)).cpu().numpy()
    if n_frames is None:
        n_frames = int(t * fps / 50.0)
    return window_features(interpolate_features(logits, 50.0, fps, n_frames))


def load_or_init(path: str | None, device: torch.device | str = "cpu",
                 generator: torch.Generator | None = None) -> DeepSpeech:
    """The flat npz of a converted checkpoint (JAX layout, as
    `hfa_gp_tpu_torch.tools.convert_deepspeech` writes it) when given,
    random weights otherwise (loudly)."""
    if path:
        from ..utils.convert import load_npz
        from .convert import deepspeech_from_jax
        return deepspeech_from_jax(load_npz(path), device)
    import logging
    logging.getLogger(__name__).warning(
        "DeepSpeech weights not provided — using RANDOM weights; "
        "aud.npy content will not match AD-NeRF's. Convert the public "
        "deepspeech-0.1.0 checkpoint with `python -m "
        "hfa_gp_tpu_torch.tools.convert_deepspeech`.")
    return init_deepspeech(generator if generator is not None
                           else torch.Generator().manual_seed(0), device)
