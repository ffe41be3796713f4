"""RGB-driven training on the port (counterpart of
hfa_gp_tpu/cli/train_rgb.py).

    python -m hfa_gp_tpu_torch.cli.train_rgb \
        --dataset_root ./datasets --person person_3 --batch_size 2 \
        --exp_path ./exps/ --exp_name v1

Fits the encoder and the W+ subspace (and, from `--tune_iter` on, the EG3D
generator) to a subject's training frames with L2 + LPIPS, in one process
on one device. Writes under `{exp_path}/{exp_name}/`: `log/metrics.jsonl`
and `log/args.json`, `display/{i}source.png` and `{i}recon.png`,
`bases/{b}person_1.png`, and `checkpoint/{i:06d}`. `--resume_ckpt` takes
one of those checkpoint files and continues from its step. `--person_2`
adds a second person's subspace (from PTI pivots with `--init --run_id_2`),
which the RGB loss does not reach, so it is saved as it was initialised,
as in the JAX package.
"""

from __future__ import annotations

import argparse

import torch

from ..data.dataset import BatchIterator, HeadData, infinite_batches
from ..models.avatar import heads
from ..train import checkpoint as ckpt
from ..train import rgb as rgb_train
from ..train.state import init_state
from ..utils.logging import MetricsWriter, display_image
from . import common

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_common_flags(p)
    return p


def main(args) -> None:
    cfg = common.avatar_config(args)
    device = common.device_from_args(args)
    dirs = common.make_dirs(args)
    common.save_args(args, dirs)
    root = f"{args.dataset_root}/{args.dataset}"

    print("==> preparing dataset")
    dataset = HeadData("train", size=args.size, root=root,
                       person=args.person)
    dataset_test = HeadData("test", size=args.size, root=root,
                            person=args.person)
    loader = infinite_batches(BatchIterator(dataset, args.batch_size))
    loader_test = infinite_batches(
        BatchIterator(dataset_test, 1, shuffle=False))

    print("==> initializing trainer")
    params = heads.init_avatar_rgb(
        torch.Generator().manual_seed(SEED), cfg, device,
        generator_params=common.load_generator_weights(args),
        init_bases_2=common.load_init_bases_2(args, cfg))
    lpips_params = common.load_lpips(args, device)
    state = init_state(params, args.lr)

    if args.resume_ckpt is not None:
        state = ckpt.restore(args.resume_ckpt, state)
        args.start_iter = state.step
        print(f"==> resume from iteration {args.start_iter}")

    writer = MetricsWriter(dirs["log"])
    try:
        print("==> training")
        for idx in range(args.iter):
            i = idx + args.start_iter
            real_image, label = (t.to(device) for t in next(loader))
            metrics = rgb_train.train_step(state, lpips_params, cfg,
                                           real_image, label, args.tune_iter)
            writer.scalars(idx, l2_loss=metrics["l2_loss"],
                           lpips_loss=metrics["lpips_loss"])

            if (i + 1) % args.display_freq == 0:
                print(f"[Iter {i}/{args.iter}] "
                      f"[l2 loss: {float(metrics['l2_loss']):f}] "
                      f"[lpips loss: {float(metrics['lpips_loss']):f}]")
                real_t, label_t = (t.to(device) for t in next(loader_test))
                recon = rgb_train.sample(state.params, cfg, real_t, label_t)
                bases = rgb_train.sample_bases(state.params, cfg)
                for b_id in range(bases.shape[0]):
                    display_image(bases[b_id],
                                  f"{dirs['bases']}/{b_id}person_1.png")
                display_image(real_t, f"{dirs['display']}/{i}source.png")
                display_image(recon, f"{dirs['display']}/{i}recon.png")
                writer.image(i, "source", real_t)
                writer.image(i, "recon", recon)

            if (i + 1) % args.save_freq == 0:
                ckpt.save(state, dirs["checkpoint"], step=i)
    finally:
        writer.close()


if __name__ == "__main__":
    main(build_argparser().parse_args())
