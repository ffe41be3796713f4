"""Audio-driven training on the port (counterpart of
hfa_gp_tpu/cli/train_audio.py).

    python -m hfa_gp_tpu_torch.cli.train_audio \
        --dataset_root ./datasets --dataset ad_dataset --person obama \
        --batch_size 2 --nosmo_iters 300000 --exp_path ./exps/

Fits AudioNet, the Weights_3DMM MLP and the W+ subspace (and, from
`--tune_iter` on, the EG3D generator) to a subject's frames, driven by
the DeepSpeech features of `aud.npy`, in one process on one device.
Before `--nosmo_iters` each frame is driven by its own 16 × 29 window;
from it on by the smo_size windows around it, smoothed by AudioAttNet,
whose optimizer starts afresh at the switch. Writes under
`{exp_path}/{exp_name}/`: `log/metrics.jsonl`, `log/args.json`,
`display/{i}source.png` and `checkpoint/{i:06d}`. `--resume_ckpt` takes
one of those checkpoint files and continues from its step.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..data.dataset import BatchIterator, HeadDataAudio, infinite_batches
from ..train import audio as audio_train
from ..train import checkpoint as ckpt
from ..train.state import init_state
from ..utils.logging import MetricsWriter, display_image
from . import common

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_common_flags(p)
    p.add_argument("--params_len", type=int, default=76)
    p.add_argument("--dim_aud", type=int, default=64)
    p.add_argument("--win_size", type=int, default=16)
    p.add_argument("--smo_size", type=int, default=8)
    p.add_argument("--nosmo_iters", type=int, default=300000)
    return p


class _Indices:
    """Dataset indices as items, so that `BatchIterator` draws the JAX
    trainer's index batches."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> tuple[torch.Tensor]:
        return (torch.tensor(idx),)


def main(args) -> None:
    cfg = dataclasses.replace(common.avatar_config(args),
                              dim_aud=args.dim_aud, win_size=args.win_size,
                              smo_size=args.smo_size)
    device = common.device_from_args(args)
    dirs = common.make_dirs(args)
    common.save_args(args, dirs)
    root = f"{args.dataset_root}/{args.dataset}"

    print("==> preparing dataset")
    dataset = HeadDataAudio("train", size=args.size, root=root,
                            person=args.person, smo_size=args.smo_size)
    # index batches, so that each step reads the windows its phase needs
    idx_iter = infinite_batches(BatchIterator(_Indices(len(dataset)),
                                              args.batch_size))

    print("==> initializing trainer")
    params = audio_train.init_audio_params(
        torch.Generator().manual_seed(SEED), cfg, device,
        generator_params=common.load_generator_weights(args))
    lpips_params = common.load_lpips(args, device)
    state = init_state(params, args.lr)

    if args.resume_ckpt is not None:
        state = ckpt.restore(args.resume_ckpt, state)
        args.start_iter = state.step
        print(f"==> resume from iteration {args.start_iter}")

    # strictly '>' on resume: a checkpoint with step == nosmo_iters was
    # saved after the last plain step, before the switch has reset the
    # AudioAttNet's optimizer
    was_smooth = args.start_iter > args.nosmo_iters
    writer = MetricsWriter(dirs["log"])
    try:
        print("==> training")
        for idx in range(args.iter):
            i = idx + args.start_iter
            ids = [int(j) for j in next(idx_iter)[0]]
            items = [dataset[j] for j in ids]
            imgs = torch.stack([it[0] for it in items]).to(device)
            labels = torch.stack([it[1] for it in items]).to(device)
            smooth = i >= args.nosmo_iters
            if smooth and not was_smooth:
                audio_train.reset_audattnet_opt(state)
                print(f"==> iteration {i}: smoothing on, a fresh AudAtt "
                      f"optimizer")
                was_smooth = True
            wins = np.stack([dataset.get_audio_window(j) if smooth
                             else dataset.get_audio(j) for j in ids])
            metrics = audio_train.train_step(
                state, lpips_params, cfg, imgs, labels,
                torch.from_numpy(wins).to(device), smooth, args.tune_iter)
            writer.scalars(idx, l2_loss=metrics["l2_loss"],
                           lpips_loss=metrics["lpips_loss"])

            if (i + 1) % args.display_freq == 0:
                print(f"[Iter {i}/{args.iter}] "
                      f"[l2 loss: {float(metrics['l2_loss']):f}] "
                      f"[lpips loss: {float(metrics['lpips_loss']):f}]")
                display_image(imgs[:1], f"{dirs['display']}/{i}source.png")

            if (i + 1) % args.save_freq == 0:
                ckpt.save(state, dirs["checkpoint"], step=i)
    finally:
        writer.close()


if __name__ == "__main__":
    main(build_argparser().parse_args())
