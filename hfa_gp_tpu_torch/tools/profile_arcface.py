"""Where one arcface training step spends its time on the card, at full
width (512-d embeddings, TF32 off; iresnet50 in fp32 unless told other).

    python -m hfa_gp_tpu_torch.tools.profile_arcface [--network iresnet50] \
        [--dtype fp32|bf16] [--optimizer sgd|adamw] \
        [--num_classes 1000000] [--sample_rate 1.0] [--batch 256] [--steps 3]
    python -m hfa_gp_tpu_torch.tools.profile_arcface --ablate_ce_backward

Prints, for a seeded state and seeded synthetic batches:
  * the card's name and power limit (`nvidia-smi`);
  * the whole step (CUDA events, median over --steps) and its samples/s;
  * from `torch.profiler` over --steps whole steps: the device time by
    kernel (top 25) and by group, the share of the flash-CE kernels, and
    the share of the profiled window in which the device was busy;
  * the peak device memory of a step.
With --ablate_ce_backward it prints instead a time per variant of the
flash-CE backward kernel with parts removed by compile-time switches
(`csrc/flash_ce_bwd_probe.cu`; the card's machine has no kernel profiler):
the whole kernel; without d norm_emb's atomics; without d w's store;
without the FMAs of one of its three products; with all of those off (the
copies, barriers and exp epilogue alone); without the operands' copies;
without copies, store and atomics (the FMAs, barriers and exp epilogue
alone); and without the barrier of each slice. A variant with a part removed computes something else; only its
time means anything.
Needs a CUDA card; the kernels are built at first use. The step's
stages inside the benchmark's arcface cell are its per-layer metrics
`forward_ms`, `backward_ms`, `optimizer_ms` and `rows_ms` (the class draw
and row gather, `sample`, with the rows' update, `head_update`), and
`ce_roofline` times the flash-CE kernels (`python benchmark/run.py
--workload arcface_fit_b256 --seed 1 --seconds 10 --trace 1`), read from
the port's profiler ranges (`train.arcface.make_train_step`) and
autograd's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common, train_arcface
from ..core.kernels import build, flash_ce
from ..parallel.partial_fc import PartialFC
from ..train import arcface as arc
from .measure import card_line, events_ms, median_ms
from .profile_train import device_report

SEED = 0
OUR_KERNELS = ("flash_ce_fwd_kernel", "flash_ce_reduce_kernel",
               "flash_ce_bwd_kernel", "flash_ce_fwd_bf16_kernel",
               "flash_ce_bwd_bf16_kernel", "transpose_embeddings_kernel",
               "round_embeddings_kernel")


# variants of csrc/flash_ce_bwd_probe.cu, by their number there
CE_BACKWARD_VARIANTS = ("whole", "no dne atomics", "no dW store",
                        "no cosine FMAs", "no dW FMAs", "no dne FMAs",
                        "copies, barriers and exp only", "no copies",
                        "FMAs, barriers and exp only", "no slice barriers")


def ce_backward_variant(norm_emb, w, local_lab, s: float, ct_se, ct_tgt,
                        variant: int):
    """(d norm_emb, d w) from variant `variant` of the flash-CE backward
    kernel (0: the whole kernel, equal to `flash_ce_stats_backward`; fp32
    operands). CUDA tensors only (fp32, contiguous); anything else raises."""
    flash_ce._check_cuda_inputs("ce_backward_variant", norm_emb, w, local_lab,
                                {"ct_se": ct_se, "ct_tgt": ct_tgt})
    (b, d), c = norm_emb.shape, w.shape[0]
    dw = torch.empty_like(w)
    dne = torch.zeros_like(norm_emb)
    with torch.cuda.device(norm_emb.device):
        err = build.library().hfa_flash_ce_bwd_probe(
            norm_emb.data_ptr(), w.data_ptr(), local_lab.data_ptr(),
            ct_se.data_ptr(), ct_tgt.data_ptr(), dw.data_ptr(),
            dne.data_ptr(), flash_ce.transposed_scratch(norm_emb).data_ptr(),
            b, d, c, float(s), variant,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_flash_ce_bwd_probe")
    return dne, dw


def ablate_ce_backward(norm_emb, w, local_lab, s: float, ct_se, ct_tgt,
                       iters: int = 5) -> dict[str, float]:
    """Median ms of each variant; checks first that the whole variant's d w
    equals the kernel's bit for bit."""
    want = flash_ce.flash_ce_stats_backward(norm_emb, w, local_lab, s, None,
                                            ct_se, ct_tgt)
    got = ce_backward_variant(norm_emb, w, local_lab, s, ct_se, ct_tgt, 0)
    torch.cuda.synchronize()
    if not torch.equal(got[1], want[1]):
        raise RuntimeError("the ablation's whole variant differs from the "
                           "flash-CE backward kernel in d w")
    del want, got
    times = {"flash_ce_stats_backward": median_ms(
        lambda: flash_ce.flash_ce_stats_backward(
            norm_emb, w, local_lab, s, None, ct_se, ct_tgt), iters, 2)}
    for i, name in enumerate(CE_BACKWARD_VARIANTS):
        times[name] = median_ms(lambda: ce_backward_variant(
            norm_emb, w, local_lab, s, ct_se, ct_tgt, i), iters, 2)
    return times


def main_ablate(args) -> dict[str, float]:
    """The flash-CE backward's ablation at the head's shapes: unit-row
    embeddings (--batch, 512), a table of --num_classes rows drawn as the
    trainer draws it, cotangents of the size the loss gives them."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(SEED)
    ne = torch.randn((args.batch, 512), generator=g, device=dev)
    ne = ne / ne.norm(dim=1, keepdim=True)
    w = torch.randn((args.num_classes, 512), generator=g, device=dev) * 0.01
    lab = torch.randint(0, args.num_classes, (args.batch,), generator=g,
                        device=dev).int()
    se, _ = flash_ce.flash_ce_stats(ne, w, lab, 64.0)
    ct_se = (torch.randn((args.batch,), generator=g, device=dev)
             / se).contiguous()
    ct_tgt = torch.randn((args.batch,), generator=g, device=dev)
    times = ablate_ce_backward(ne, w, lab, 64.0, ct_se, ct_tgt)
    print(f"flash-CE backward, B {args.batch}, d 512, C {args.num_classes}, "
          f"fp32, median of 5 (CUDA events):")
    for name, ms in times.items():
        print(f"  {name:32s} {ms:9.4f} ms", flush=True)
    return times


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--network", type=str, default="iresnet50")
    p.add_argument("--dtype", type=str, default="fp32",
                   choices=["fp32", "bf16"],
                   help="the trunk's dtype and the head products' operands "
                        "(bf16: train_arcface without --fp32)")
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw"])
    p.add_argument("--num_classes", type=int, default=1_000_000)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--ablate_ce_backward", action="store_true")
    return p


def main(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_arcface needs a CUDA card")
    common.fp32_backends()
    print(card_line(), flush=True)
    if args.ablate_ce_backward:
        main_ablate(args)
        return
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    pfc = PartialFC(args.num_classes, 512, sample_rate=args.sample_rate,
                    matmul_dtype=torch.bfloat16 if args.dtype == "bf16"
                    else None)
    adamw = args.optimizer == "adamw"          # chip_smoke.py [23]'s recipe
    tx, fc_tx = arc.make_optimizers(
        100, lr=1e-3 if adamw else 0.1, warmup_steps=2,
        optimizer=args.optimizer, weight_decay=0.1 if adamw else 5e-4)
    state = arc.init_state(torch.Generator().manual_seed(SEED), pfc, tx,
                           fc_tx, args.network, dev)
    step_fn = arc.make_train_step(pfc, tx, fc_tx, args.network, dtype=dtype)
    gen = torch.Generator(dev).manual_seed(SEED)
    imgs, labs = train_arcface.synth_batch(args.batch, args.num_classes, gen,
                                           dev)

    def step():
        return step_fn(state, imgs, labs, gen)

    for _ in range(2):                                   # warm up, build
        step()
    torch.cuda.synchronize()

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
