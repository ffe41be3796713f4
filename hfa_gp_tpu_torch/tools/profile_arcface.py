"""Where one arcface training step spends its time on the card, at full
width (iresnet50, 512-d embeddings, fp32, TF32 off).

    python -m hfa_gp_tpu_torch.tools.profile_arcface \
        [--num_classes 1000000] [--sample_rate 1.0] [--batch 256] [--steps 3]

Prints, for a seeded state and seeded synthetic batches:
  * the card's name and power limit (`nvidia-smi`);
  * the step's stages timed with CUDA events (median over --steps): the
    backbone's forward, the head's forward (for the row-sparse head with
    its sampling and row gather timed beside it), the backward, the
    backbone's optimizer and the head's optimizer;
  * from `torch.profiler` over --steps whole steps: the device time by
    kernel (top 25) and by group, the share of the flash-CE kernels, and
    the share of the profiled window in which the device was busy;
  * the peak device memory of a step.
Needs a CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common, train_arcface
from ..models.arcface import registry
from ..parallel.partial_fc import PartialFC
from ..train import arcface as arc
from .measure import card_line, events_ms
from .profile_train import device_report

SEED = 0
OUR_KERNELS = ("flash_ce_fwd_kernel", "flash_ce_reduce_kernel",
               "flash_ce_bwd_kernel")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--network", type=str, default="iresnet50")
    p.add_argument("--num_classes", type=int, default=1_000_000)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=3)
    return p


def main(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_arcface needs a CUDA card")
    common.fp32_backends()
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    pfc = PartialFC(args.num_classes, 512, sample_rate=args.sample_rate)
    sparse = args.sample_rate < 1.0
    tx, fc_tx = arc.make_optimizers(100, lr=0.1, warmup_steps=2)
    state = arc.init_state(torch.Generator().manual_seed(SEED), pfc, tx,
                           fc_tx, args.network, dev)
    step_fn = arc.make_train_step(pfc, tx, fc_tx, args.network)
    gen = torch.Generator(dev).manual_seed(SEED)
    imgs, labs = train_arcface.synth_batch(args.batch, args.num_classes, gen,
                                           dev)

    def step():
        return step_fn(state, imgs, labs, gen)

    for _ in range(2):                                   # warm up, build
        step()
    torch.cuda.synchronize()

    # -- stages of a step, CUDA events (the step of train/arcface.py, cut
    # at its stage boundaries)
    stages: dict[str, list[float]] = {}
    for _ in range(args.steps):
        state.optimizer.zero_grad(set_to_none=True)
        out = {}
        t_bb = events_ms(lambda: out.update(emb=registry.backbone_apply(
            args.network, state.backbone, state.batch_stats, imgs,
            train=True)[0]))
        t_sample = 0.0
        if sparse:
            def sample():
                out["index"] = pfc.sample_indices(labs, gen)
                out["head"] = pfc.take_rows(state.fc_weight, out["index"]) \
                    .requires_grad_(True)
            t_sample = events_ms(sample)
            t_head = events_ms(lambda: out.update(loss=pfc.loss_sampled(
                out["head"], out["emb"], labs, out["index"])))
        else:
            out["head"] = state.fc_weight.detach().requires_grad_(True)
            t_head = events_ms(lambda: out.update(loss=pfc.loss(
                out["head"], out["emb"], labs)))
        t_bwd = events_ms(lambda: out["loss"].backward())
        t_opt = events_ms(lambda: tx.step(state.optimizer, state.step))

        t_fc = events_ms(lambda: arc.update_head(
            pfc, fc_tx, state, out["head"], out.get("index")))
        for k, v in (("backbone forward", t_bb),
                     ("sampling + row gather", t_sample),
                     ("head forward (CE)", t_head), ("backward", t_bwd),
                     ("backbone optimizer", t_opt),
                     ("head optimizer", t_fc)):
            stages.setdefault(k, []).append(v)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    whole = sum(med.values())
    print(f"stages of one arcface step, {args.network}, {args.num_classes} "
          f"classes, sample_rate {args.sample_rate}, batch {args.batch}, "
          f"median of {args.steps} (CUDA events):")
    for k, v in med.items():
        print(f"  {k:26s} {v:9.3f} ms  {100 * v / whole:5.1f} % of "
              f"{whole:.3f}")

    # -- whole steps, peak memory
    torch.cuda.reset_peak_memory_stats()
    ms = [events_ms(step) for _ in range(args.steps)]
    print(f"whole step: {float(np.median(ms)):.3f} ms (median of "
          f"{args.steps}), {args.batch * 1e3 / float(np.median(ms)):.3f} "
          f"samples/s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # -- device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    device_report(prof, args.steps, OUR_KERNELS)


if __name__ == "__main__":
    main(build_argparser().parse_args())
