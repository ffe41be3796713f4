"""Arcface trainer on the port (counterpart of
hfa_gp_tpu/cli/train_arcface.py): the synthetic speed benchmark and
checkpointed training in one CLI, on one rank or several.

    python -m hfa_gp_tpu_torch.cli.train_arcface --network iresnet50 \
        --num_classes 1000000 --batch_size 256 --num_steps 20
    torchrun --nproc_per_node 4 -m hfa_gp_tpu_torch.cli.train_arcface \
        --device cpu --network iresnet18 --n_model 2 --batch_size 8 \
        --num_classes 64 --num_steps 2 --fp32

  * the backbone: every name of `registry.backbone_names()` and the
    reference's aliases (iresnet18 … 2060 / r18 … r2060, mbf, mbf_large /
    mobilefacenet, the vit_* family); `--optimizer adamw` is the ViT
    recipe;
  * precision: as in the JAX CLI, the backbone's trunk runs in bf16 and
    the head's cosine products take bf16 operands (the flash-CE kernels'
    bf16 route) unless `--fp32` is given; parameters, gradients and
    optimizer state are fp32 either way;
  * data: with `--rec`, an ArrayRecord pack (`data/record_dataset.py`:
    4-byte label + encoded image, PIL decode, bilinear to 112², [-1, 1]);
    batch i is `EpochSeededBatches.load(i)`, a function of (seed, i), so a
    resumed run reads the order the uninterrupted one would, and each host
    batch goes to the card from pinned memory without blocking. Without
    it, random 112² images and labels over `--num_classes` identities,
    made on the device from a generator seeded by the step, so a run
    measures the trainer and not the host link. The last line is
    `samples/sec: … (loss …, classes …, sample_rate …)`, with the first
    step left out of the clock;
  * `--sample_rate` below 1 trains the row-sparse PartialFC head;
  * `--output`, `--save_freq`, `--resume`: checkpoints of the whole state
    (backbone, running moments, the table, both optimizers, the step) in
    `{output}/checkpoint/{step:06d}`, a final one at the end, resume from
    the latest;
  * `--log_freq`: samples/sec, ETA, average loss and lr every N steps;
  * `--val_bin` (an LFW-style .bin): every `--verbose` steps the K-fold
    verification accuracy of the eval-mode (fp32) embedding is logged;
  * `--export` (with `--output`): after training, the backbone as a
    `torch.export` program with a dynamic batch, `{output}/model.pt2`, its
    weights in the JAX package's npz layout, `{output}/model.npz` (what
    `eval_verification` and `eval_ijb --weights` read), and its FLOPs for
    one image, `{output}/model_cost.json`.

Over several processes (`parallel/distributed.py`: the JAX CLI's flags,
or torchrun's WORLD_SIZE/RANK), the ranks form a (data, model) mesh,
`--n_model` of them splitting the class table (`--num_classes` padded to a
multiple of it, as in JAX) and the rest the global `--batch_size`. Each
rank makes the global synthetic batch from the step's generator and keeps
its data index's rows, or, with `--rec`, decodes only those rows. Only the
primary rank writes `training.log`, the checkpoints (the whole table,
gathered from the shards, so that a run resumes on any mesh) and the
`--export`; samples/sec counts the global batch.

It runs on `--device cuda` (the flash-CE kernels) unless told `--device
cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..data.dataset import EpochSeededBatches
from ..data.record_dataset import RecordFaceDataset
from ..models.arcface import convert, registry
from ..models.arcface.verification import evaluate_pairs
from ..parallel import distributed
from ..parallel import mesh as mesh_mod
from ..parallel.partial_fc import PartialFC
from ..train import arcface as arc
from ..train import checkpoint as ckpt_mod
from ..utils import convert as tree_io
from ..utils import export as export_mod
from ..utils.observability import ThroughputLogger, init_logging
from . import common
from .eval_verification import load_bin, make_embed_fn


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
                   help="ranks that split the class table (the mesh's "
                        "model axis)")
    p.add_argument("--fp32", action="store_true", default=False,
                   help="fp32 backbone and head products (default: bf16)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; CUDA runs the hand-written kernels")
    p.add_argument("--rec", type=str, default=None,
                   help="ArrayRecord training pack. Default: on-device "
                        "synthetic benchmark data")
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
                   help="export the trained backbone to "
                        "{output}/model.pt2 (torch.export) and "
                        "{output}/model.npz (JAX layout)")
    p.add_argument("--log_freq", type=int, default=0,
                   help="interval logging every N steps (samples/sec, "
                        "ETA, loss, lr); 0 keeps the loop free of "
                        "device-to-host reads for benchmarking")
    p.add_argument("--val_bin", type=str, default=None,
                   help="LFW-style .bin for in-training verification")
    p.add_argument("--verbose", type=int, default=10,
                   help="verification frequency in steps")
    distributed.add_distributed_flags(p)
    return p


def synth_batch(batch_size: int, num_classes: int,
                generator: torch.Generator, device: torch.device):
    """Random images (B, 112, 112, 3) and labels (B,), made on `device`."""
    imgs = torch.randn((batch_size, 112, 112, 3), generator=generator,
                       device=device)
    labs = torch.randint(0, num_classes, (batch_size,), generator=generator,
                         device=device)
    return imgs, labs


def record_batches(args, device: torch.device, mesh: mesh_mod.Mesh):
    """--rec: this rank's rows of batch i of the pack as (images, int64
    labels) on `device`; a label outside [0, --num_classes) raises."""
    stream = EpochSeededBatches(RecordFaceDataset(args.rec, size=112),
                                args.batch_size, seed=args.seed,
                                num_shards=mesh.n_data,
                                shard_index=mesh.data_index)

    def get(i: int) -> tuple[torch.Tensor, torch.Tensor]:
        imgs, labs = stream.load(i)
        labs = labs.long()
        if labs.min() < 0 or labs.max() >= args.num_classes:
            raise ValueError(f"batch {i} of {args.rec} has labels in "
                             f"[{int(labs.min())}, {int(labs.max())}], "
                             f"outside --num_classes {args.num_classes}")
        if device.type == "cuda":
            # both pinned: a copy from pageable memory waits for the
            # stream, and the host could no longer decode batch i + 1
            # while the card runs step i
            imgs, labs = imgs.pin_memory(), labs.pin_memory()
        return (imgs.to(device, non_blocking=True),
                labs.to(device, non_blocking=True))
    return get


def export_backbone(args, state, out_dir: str) -> str:
    """The trained backbone → `model.pt2`, `model.npz` and
    `model_cost.json` in `out_dir`. Returns the program's path."""
    path = os.path.join(out_dir, "model.pt2")
    export_mod.export_backbone(args.network, state.backbone,
                               state.batch_stats, path)
    params, stats = convert.backbone_to_jax(args.network, state.backbone,
                                            state.batch_stats)
    tree_io.save_npz({"params": params, "batch_stats": stats},
                     os.path.join(out_dir, "model.npz"))
    dev = state.fc_weight.device
    cost = export_mod.flops(
        lambda x: registry.backbone_apply(args.network, state.backbone,
                                          state.batch_stats, x),
        torch.zeros((1, 112, 112, 3), device=dev))
    with open(os.path.join(out_dir, "model_cost.json"), "w") as f:
        json.dump(cost, f, indent=2)
    return path


def main(args) -> float:
    device = common.device_from_args(args)
    distributed.maybe_initialize(args, device)
    mesh = mesh_mod.make_mesh_for_batch(args.batch_size, args.n_model)
    primary = distributed.is_primary()
    load_batch = record_batches(args, device, mesh) if args.rec else None
    if args.output and primary:
        os.makedirs(os.path.abspath(args.output), exist_ok=True)
    logger = init_logging(
        rank=mesh.rank, log_file=(os.path.join(args.output, "training.log")
                                  if args.output and primary else None))
    num_classes = args.num_classes
    if num_classes % mesh.n_model:
        num_classes += mesh.n_model - num_classes % mesh.n_model
    m2, m3 = (0.5, 0.0) if args.margin == "arcface" else (0.0, 0.4)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    pfc = PartialFC(num_classes, 512, m2=m2, m3=m3,
                    sample_rate=args.sample_rate,
                    matmul_dtype=None if args.fp32 else dtype, mesh=mesh)
    wd = args.weight_decay if args.weight_decay is not None \
        else (0.1 if args.optimizer == "adamw" else 5e-4)
    tx, fc_tx = arc.make_optimizers(
        args.num_steps, lr=args.lr, warmup_steps=args.warmup_steps,
        weight_decay=wd, optimizer=args.optimizer,
        clip_grad_norm=args.clip_grad or None)
    step = arc.make_train_step(pfc, tx, fc_tx, args.network, dtype=dtype)

    ckpt_dir = None
    if args.output:
        ckpt_dir = os.path.join(os.path.abspath(args.output), "checkpoint")
        if primary:
            os.makedirs(ckpt_dir, exist_ok=True)

    state = arc.init_state(torch.Generator().manual_seed(args.seed), pfc,
                           tx, fc_tx, args.network, device)
    start_step = 0
    # read once, before any rank writes: every rank takes part in a save,
    # so every rank must come to the same decision
    saved = ckpt_mod.latest_step(ckpt_dir) if ckpt_dir else None
    if args.resume and saved is not None:
        state = ckpt_mod.restore(os.path.join(ckpt_dir, f"{saved:06d}"),
                                 state, mesh)
        start_step = state.step
        logger.info("resumed from %s (step %d)", ckpt_dir, start_step)

    val = load_bin(args.val_bin) if args.val_bin and primary else None

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
        # every rank makes the global synthetic batch and keeps its rows
        imgs, labs = (load_batch(i) if load_batch else
                      mesh_mod.process_local_batch(synth_batch(
                          args.batch_size, num_classes, gen, device), mesh))
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
        if val is not None and (i + 1) % args.verbose == 0:
            embed = make_embed_fn(args.network, state.backbone,
                                  state.batch_stats, device)
            acc, std, _ = evaluate_pairs(embed, *val)
            logger.info("[step %d] verification acc %.4f ± %.4f", i + 1,
                        acc, std)
        if ckpt_dir and args.save_freq and (i + 1) % args.save_freq == 0:
            path = ckpt_mod.save(state, ckpt_dir, mesh=mesh)
            saved = state.step
            logger.info("checkpoint -> %s", path)
    sync()
    dt = time.perf_counter() - t0

    if ckpt_dir and state.step > (saved if saved is not None else -1):
        path = ckpt_mod.save(state, ckpt_dir, mesh=mesh)
        logger.info("final checkpoint -> %s", path)

    sps = max(timed_steps, 1) * args.batch_size / dt if dt > 0 else 0.0
    where = (f"mesh {mesh.n_data}x{mesh.n_model}, " if mesh.size > 1
             else "")
    print(f"samples/sec: {sps:.1f}  (loss {float(metrics['loss']):.4f}, "
          f"{where}classes {num_classes}, sample_rate {args.sample_rate})")
    if args.export and args.output and primary:
        path = export_backbone(args, state, os.path.abspath(args.output))
        logger.info("exported backbone -> %s", path)
    return sps


if __name__ == "__main__":
    main(build_argparser().parse_args())
