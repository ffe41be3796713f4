"""Arcface trainer on the port (counterpart of
hfa_gp_tpu/cli/train_arcface.py): the synthetic speed benchmark and
checkpointed training in one CLI, in one process on one device.

    python -m hfa_gp_tpu_torch.cli.train_arcface --network iresnet50 \
        --num_classes 1000000 --batch_size 256 --fp32 --num_steps 20

  * synthetic default: random 112² images and labels over `--num_classes`
    identities, made on the device from a generator seeded by the step, so
    a run measures the trainer and not the host link; the last line is
    `samples/sec: … (loss …, classes …, sample_rate …)`, with the first
    step left out of the clock;
  * `--sample_rate` below 1 trains the row-sparse PartialFC head;
  * `--output`, `--save_freq`, `--resume`: checkpoints of the whole state
    (backbone, running moments, the table, both optimizers, the step) in
    `{output}/checkpoint/{step:06d}`, a final one at the end, resume from
    the latest;
  * `--log_freq`: samples/sec, ETA, average loss and lr every N steps.

It runs on `--device cuda` (the flash-CE kernels) unless told `--device
cpu`. Not ported, each raises: running without `--fp32` (a bf16 backbone),
`--rec`, `--val_bin`, `--export`, `--n_model` above 1, several processes.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..parallel.partial_fc import PartialFC
from ..train import arcface as arc
from ..train import checkpoint as ckpt_mod
from ..utils.observability import ThroughputLogger, init_logging
from . import common


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--network", type=str, default="iresnet50")
    p.add_argument("--num_classes", type=int, default=3_000_000)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--num_steps", type=int, default=20)
    p.add_argument("--warmup_steps", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw"],
                   help="sgd = conv-backbone recipe; adamw = the ViT "
                        "recipe (PartialFCAdamW)")
    p.add_argument("--weight_decay", type=float, default=None,
                   help="default: 5e-4 for sgd, 0.1 for adamw")
    p.add_argument("--clip_grad", type=float, default=5.0,
                   help="backbone global-norm gradient clip; 0 disables")
    p.add_argument("--margin", type=str, default="arcface",
                   choices=["arcface", "cosface"])
    p.add_argument("--n_model", type=int, default=1,
                   help="class sharding; only 1 is supported")
    p.add_argument("--fp32", action="store_true", default=False,
                   help="required: the bf16 backbone is not ported")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; CUDA runs the hand-written kernels")
    p.add_argument("--rec", type=str, default=None,
                   help="ArrayRecord training pack (not ported: raises). "
                        "Default: on-device synthetic benchmark data")
    p.add_argument("--output", type=str, default=None,
                   help="work dir for checkpoints and logs")
    p.add_argument("--save_freq", type=int, default=0,
                   help="checkpoint every N steps into "
                        "{output}/checkpoint (0 = final save only; "
                        "needs --output)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume from the latest checkpoint in "
                        "{output}/checkpoint")
    p.add_argument("--export", action="store_true", default=False,
                   help="backbone export (not ported: raises)")
    p.add_argument("--log_freq", type=int, default=0,
                   help="interval logging every N steps (samples/sec, "
                        "ETA, loss, lr); 0 keeps the loop free of "
                        "device-to-host reads for benchmarking")
    p.add_argument("--val_bin", type=str, default=None,
                   help="in-training verification (not ported: raises)")
    p.add_argument("--verbose", type=int, default=10,
                   help="verification frequency in steps")
    # the JAX CLI's multi-host flags, accepted for command-line parity
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def check_supported(args) -> None:
    """Raise on every flag that asks for what the port does not do."""
    if not args.fp32:
        raise NotImplementedError(
            "the bf16 backbone is not ported: pass --fp32")
    if args.rec is not None:
        raise NotImplementedError("--rec: the ArrayRecord dataset is not "
                                  "ported")
    if args.val_bin is not None:
        raise NotImplementedError("--val_bin: in-training verification is "
                                  "not ported")
    if args.export:
        raise NotImplementedError("--export: the backbone export is not "
                                  "ported")
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: class sharding over "
                                  "several devices is not ported")
    if args.coordinator_address is not None \
            or (args.num_processes or 1) > 1:
        raise NotImplementedError("training over several processes is not "
                                  "ported")
    common.single_process()


def synth_batch(batch_size: int, num_classes: int,
                generator: torch.Generator, device: torch.device):
    """Random images (B, 112, 112, 3) and labels (B,), made on `device`."""
    imgs = torch.randn((batch_size, 112, 112, 3), generator=generator,
                       device=device)
    labs = torch.randint(0, num_classes, (batch_size,), generator=generator,
                         device=device)
    return imgs, labs


def main(args) -> float:
    check_supported(args)
    device = torch.device(args.device)
    if device.type == "cuda":
        common.fp32_backends()
    if args.output:
        os.makedirs(os.path.abspath(args.output), exist_ok=True)
    logger = init_logging(
        rank=0, log_file=(os.path.join(args.output, "training.log")
                          if args.output else None))
    num_classes = args.num_classes
    m2, m3 = (0.5, 0.0) if args.margin == "arcface" else (0.0, 0.4)
    pfc = PartialFC(num_classes, 512, m2=m2, m3=m3,
                    sample_rate=args.sample_rate, matmul_dtype=None,
                    n_model=args.n_model)
    wd = args.weight_decay if args.weight_decay is not None \
        else (0.1 if args.optimizer == "adamw" else 5e-4)
    tx, fc_tx = arc.make_optimizers(
        args.num_steps, lr=args.lr, warmup_steps=args.warmup_steps,
        weight_decay=wd, optimizer=args.optimizer,
        clip_grad_norm=args.clip_grad or None)
    step = arc.make_train_step(pfc, tx, fc_tx, args.network)

    ckpt_dir = None
    if args.output:
        ckpt_dir = os.path.join(os.path.abspath(args.output), "checkpoint")
        os.makedirs(ckpt_dir, exist_ok=True)

    state = arc.init_state(torch.Generator().manual_seed(args.seed), pfc,
                           tx, fc_tx, args.network, device)
    start_step = 0
    if args.resume and ckpt_dir:
        last = ckpt_mod.latest_step(ckpt_dir)
        if last is not None:
            state = ckpt_mod.restore(
                os.path.join(ckpt_dir, f"{last:06d}"), state)
            start_step = state.step
            logger.info("resumed from %s (step %d)", ckpt_dir, start_step)

    tlog = None
    if args.log_freq:
        tlog = ThroughputLogger(args.log_freq, args.num_steps,
                                args.batch_size, logger=logger)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gen = torch.Generator(device)
    t0 = time.perf_counter()
    timed_steps = 0
    metrics = {"loss": torch.zeros(())}
    for i in range(start_step, args.num_steps):
        # the batch and the step's sampling are functions of (seed, step),
        # so a resumed run continues the uninterrupted one exactly
        gen.manual_seed(args.seed * 1_000_003 + i)
        imgs, labs = synth_batch(args.batch_size, num_classes, gen, device)
        metrics = step(state, imgs, labs, gen)
        if i == start_step:
            # the first step carries first-use costs (the kernels' build,
            # cuDNN's algorithm search): restart the clock after it
            sync()
            t0 = time.perf_counter()
            timed_steps = 0
        else:
            timed_steps += 1
        if tlog and (i + 1) % args.log_freq == 0:
            tlog(i + 1, float(metrics["loss"]), lr=fc_tx.sched(i))
        if ckpt_dir and args.save_freq and (i + 1) % args.save_freq == 0:
            path = ckpt_mod.save(state, ckpt_dir)
            logger.info("checkpoint -> %s", path)
    sync()
    dt = time.perf_counter() - t0

    if ckpt_dir and state.step > (ckpt_mod.latest_step(ckpt_dir) or -1):
        path = ckpt_mod.save(state, ckpt_dir)
        logger.info("final checkpoint -> %s", path)

    sps = max(timed_steps, 1) * args.batch_size / dt if dt > 0 else 0.0
    print(f"samples/sec: {sps:.1f}  (loss {float(metrics['loss']):.4f}, "
          f"classes {num_classes}, sample_rate {args.sample_rate})")
    return sps


if __name__ == "__main__":
    main(build_argparser().parse_args())
