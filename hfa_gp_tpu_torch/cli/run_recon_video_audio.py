"""Audio-driven video reenactment on the port (counterpart of
hfa_gp_tpu/cli/run_recon_video_audio.py).

    python -m hfa_gp_tpu_torch.cli.run_recon_video_audio \
        --dataset_root ./datasets --dataset ad_dataset --person obama \
        --model_path exps/v1/checkpoint/000999 --smooth --demo_dir ./demo

Renders each frame of the split from its DeepSpeech window (AudioNet,
with `--smooth` over the smo_size windows around the frame and
AudioAttNet; then Weights_3DMM → subspace → EG3D), `--render_batch`
frames at a time, writes `{demo_dir}/{demo_name}/%05d.png` and assembles
`rec.mp4`. `--model_path` takes a checkpoint file written by the port's
`train_audio`; `--model_npz` the JAX package's flat-npz params of
`{"model", "audnet", "audattnet"}`, converted by utils/convert.py.
Without either the params are a seeded random init.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..data.dataset import HeadDataAudio
from ..train import audio as audio_train
from ..train import checkpoint as ckpt
from ..utils import convert
from ..utils.logging import save_image
from . import common

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_common_flags(p)
    p.add_argument("--dataset_type", type=str, default="val")
    p.add_argument("--dim_aud", type=int, default=64)
    p.add_argument("--win_size", type=int, default=16)
    p.add_argument("--smo_size", type=int, default=8)
    p.add_argument("--smooth", action="store_true", default=False,
                   help="smooth over the windows with AudioAttNet")
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint file of the port's train_audio")
    p.add_argument("--model_npz", type=str, default=None,
                   help="params-only npz (JAX pytree_io format)")
    p.add_argument("--demo_name", type=str, default="demoaudio")
    p.add_argument("--demo_dir", type=str, default="./demo")
    p.add_argument("--cat_video", action="store_true", default=False)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--render_batch", type=int, default=4)
    return p


def load_params(args, cfg, device: torch.device):
    if args.model_path is not None:
        return ckpt.load_params(args.model_path, device)
    if args.model_npz is not None:
        return convert.from_jax(convert.load_npz(args.model_npz), device)
    print("WARNING: no --model_path/--model_npz; using random init")
    return audio_train.init_audio_params(torch.Generator().manual_seed(SEED),
                                         cfg, device)


def main(args) -> None:
    cfg = dataclasses.replace(common.avatar_config(args),
                              dim_aud=args.dim_aud, win_size=args.win_size,
                              smo_size=args.smo_size)
    device = common.device_from_args(args)
    root = f"{args.dataset_root}/{args.dataset}"
    dataset = HeadDataAudio(args.dataset_type, size=args.size, root=root,
                            person=args.person, smo_size=args.smo_size)
    params = load_params(args, cfg, device)
    save_path = os.path.join(args.demo_dir, args.demo_name)
    os.makedirs(save_path, exist_ok=True)

    n, bs = len(dataset), max(args.render_batch, 1)
    frame_idx = 0
    with torch.inference_mode():
        for start in range(0, n, bs):
            ids = range(start, min(start + bs, n))
            labels = torch.stack([dataset[i][1] for i in ids]).to(device)
            wins = np.stack([dataset.get_audio_window(i) if args.smooth
                             else dataset.get_audio(i) for i in ids])
            out = audio_train.sample(params, cfg,
                                     torch.from_numpy(wins).to(device),
                                     labels, args.smooth)
            for frame in out.cpu():
                save_image(frame, os.path.join(save_path,
                                               f"{frame_idx:05d}.png"))
                frame_idx += 1

    gt_dir = dataset.ds_path if args.cat_video else None
    video = common.write_video(save_path, os.path.join(save_path, "rec.mp4"),
                               fps=args.fps, side_by_side_dir=gt_dir)
    print(f"==> wrote {frame_idx} frames to {save_path} ({video})")


if __name__ == "__main__":
    main(build_argparser().parse_args())
