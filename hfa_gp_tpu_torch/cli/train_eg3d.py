"""EG3D's GAN training on the port (NVlabs/eg3d `train.py`'s FFHQ recipe,
`--cfg=ffhq --gamma=1 --gen_pose_cond=True` on one card's share of the
batch):

    python -m hfa_gp_tpu_torch.cli.train_eg3d --data <dir> \
        --batch_size 4 --iter 1000 --exp_path ./exps/ --exp_name eg3d

`--data` is a directory of PNG frames with their camera labels in
`test.json`, EG3D's `dataset.json` layout ({"labels": [[file name, [25
floats]], ...]}, `data.dataset.HeadData`); frames are resized to the
generator's output resolution, and the generator's conditioning is
drawn from every label of the directory.
Trains `train.eg3d_gan.train_step` from random weights; step k draws
its noise, latents and jitter from a generator seeded with (`--seed`, k),
so a resumed run draws what an unbroken one would. Writes under
`{exp_path}/{exp_name}/`: `log/metrics.jsonl`, `log/args.json` and
`checkpoint/{i:06d}` every `--save_freq` steps and at the end (G, D,
G_ema, both Adams and the step; `--resume_ckpt` continues from one).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.dataset import EpochSeededBatches, HeadData
from ..models.eg3d import generator as gen
from ..train import checkpoint as ckpt
from ..train import eg3d_gan
from ..utils.convert import ParamTree
from ..utils.logging import MetricsWriter
from . import common

INIT_SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="./datasets/ffhq512")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--iter", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_freq", type=int, default=100)
    p.add_argument("--save_freq", type=int, default=1000)
    p.add_argument("--resume_ckpt", type=str, default=None)
    p.add_argument("--exp_path", type=str, default="./exps/")
    p.add_argument("--exp_name", type=str, default="eg3d")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; CUDA runs the hand-written kernels")
    return p


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s draws in a run seeded with `seed`."""
    return (seed * 1_000_003 + step) % 2 ** 63


def gan_config(args) -> eg3d_gan.GANConfig:
    """The recipe: EG3D ffhqrebalanced512-128's generator with the fine
    samples at global CDF quantiles, as EG3D places them."""
    import dataclasses
    g = gen.EG3DConfig()
    g = dataclasses.replace(g, render=dataclasses.replace(
        g.render, sampler_fine="global"))
    return eg3d_gan.GANConfig(generator=g)


def initial_state(cfg: eg3d_gan.GANConfig, device) -> eg3d_gan.GANState:
    """The state a run starts from: G and D drawn from INIT_SEED as EG3D
    initialises them (`train.eg3d_gan.init_networks`), on `device`."""
    G, D = eg3d_gan.init_networks(torch.Generator().manual_seed(INIT_SEED),
                                  cfg)
    return eg3d_gan.init_state(ParamTree(G).to(device),
                               ParamTree(D).to(device), cfg)


def main(args) -> None:
    device = common.device_from_args(args)
    cfg = gan_config(args)
    base = os.path.join(args.exp_path, args.exp_name)
    dirs = {"log": os.path.join(base, "log"),
            "checkpoint": os.path.join(base, "checkpoint")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    common.save_args(args, dirs)

    size = cfg.generator.sr.output_resolution
    data = HeadData("train", size=size, ds_path=args.data, sort=True)
    pool = torch.from_numpy(np.stack([data.labels[k]
                                      for k in sorted(data.labels)]))
    pool = pool.to(device)

    state = initial_state(cfg, device)
    if args.resume_ckpt is not None:
        state = ckpt.restore(args.resume_ckpt, state)
        print(f"==> resume from step {state.step}")

    batches = iter(EpochSeededBatches(data, args.batch_size, seed=args.seed,
                                      start_batch=state.step))
    rng = torch.Generator(device)
    writer = MetricsWriter(dirs["log"])
    try:
        for _ in range(args.iter):
            i = state.step
            image, label = (t.to(device) for t in next(batches))
            rng.manual_seed(step_seed(args.seed, i))
            terms = eg3d_gan.train_step(state, cfg, image, label, pool, rng)
            if (i + 1) % args.log_freq == 0:
                writer.scalars(i, **terms)
                print(f"[step {i}] " + " ".join(
                    f"{k} {float(v):.4f}" for k, v in terms.items()))
            if (i + 1) % args.save_freq == 0:
                ckpt.save(state, dirs["checkpoint"], step=i)
        if args.iter and state.step % args.save_freq:
            ckpt.save(state, dirs["checkpoint"], step=state.step - 1)
    finally:
        writer.close()


if __name__ == "__main__":
    main(build_argparser().parse_args())
