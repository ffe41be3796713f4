"""Audio feature extraction CLI (port of hfa_gp_tpu/cli/extract_audio.py):
a 16 kHz wav → aud.npy (N, 16, 29).

Replaces the reference's external AD-NeRF/DeepSpeech tooling (reference
README.md:41; consumed at code/dataset.py:404) with the port's DeepSpeech
0.1.0 (preprocess/deepspeech.py). `--weights` is the JAX package's flat npz
of a converted checkpoint (tools/convert_deepspeech.py); without it the net
runs with random weights (a loud warning; structure and contract testing
only).

    python -m hfa_gp_tpu_torch.cli.extract_audio --wav sp.wav \
        --out datasets/obama/person_1/aud.npy --fps 25 \
        [--weights ds.npz] [--n_frames N] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np

from . import common


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Mono float samples + sample rate from a PCM wav (8/16/24/32-bit,
    channels averaged), with the standard library's `wave` only."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        ch = f.getnchannels()
        raw = f.readframes(n)
    if width == 3:
        # 24-bit PCM: sign-extend each little-endian triple into int32
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        audio = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int8).astype(np.int32) << 16)
                 ).astype(np.float32)
    elif width in (1, 2, 4):
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            audio = audio - 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width} bytes "
                         f"(supported: 8/16/24/32-bit PCM)")
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    return audio, sr


def resample_linear(audio: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return audio
    n_out = int(round(len(audio) * target / sr))
    t_in = np.arange(len(audio)) / sr
    t_out = np.arange(n_out) / target
    return np.interp(t_out, t_in, audio).astype(np.float32)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--wav", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="output aud.npy path")
    p.add_argument("--fps", type=float, default=25.0,
                   help="video frame rate the features lock to")
    p.add_argument("--n_frames", type=int, default=None,
                   help="pin the output frame count (video-locked)")
    p.add_argument("--weights", type=str, default=None,
                   help="converted deepspeech npz "
                        "(tools/convert_deepspeech.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the network")
    return p


def main(args) -> None:
    from ..preprocess import deepspeech as ds

    device = common.device_from_args(args)
    audio, sr = load_wav(args.wav)
    audio = resample_linear(audio, sr, ds.SAMPLE_RATE)
    net = ds.load_or_init(args.weights, device)
    feats = ds.extract_features(net, audio, fps=args.fps,
                                n_frames=args.n_frames)
    np.save(args.out, feats)
    print(f"wrote {args.out}: {feats.shape} "
          f"({len(audio) / ds.SAMPLE_RATE:.1f}s of audio)")


if __name__ == "__main__":
    main(build_argparser().parse_args(sys.argv[1:]))
