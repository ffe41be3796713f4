"""Where one reenactment batch spends its time on the card, at full width.

    python -m hfa_gp_tpu_torch.tools.profile_reenact [--batch 8] [--iters 5]
        [--bf16]

Prints, for seeded random params and a seeded batch (the inputs of
`chip_smoke.py` [6]) in fp32 with TF32 off (with `--bf16`: the synthesis
chains and the decoder in bf16, as `--bf16` of the CLIs), under inference
mode:
  * the card's name and power limit (`nvidia-smi`);
  * the whole batch (`run_recon_video_rgb.reenact`, median over --iters)
    and its frames/s, and the peak device memory;
  * from `torch.profiler` over --iters whole batches: the device time by
    kernel (top 25) and by group, the share of the hand-written kernels,
    and the share of the profiled window in which the device was busy.
Needs a CUDA card; the kernels are built at first use. The batch's
stages inside the benchmark's cells are its per-layer metrics
`encoder_ms`, `synthesis_ms`, `backbone_ms`, `render_ms`, `superres_ms`
and `audio_encoder_ms` (`python benchmark/run.py --workload
rgb_reenact_b8 --seed 1 --seconds 10 --trace 1`), read from the port's
profiler ranges.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common
from ..cli.run_recon_video_rgb import reenact
from ..core import camera
from ..models.avatar import heads
from .measure import card_line, events_ms
from .profile_train import OUR_KERNELS, device_report

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 synthesis chains and decoder")
    return p


def main(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_reenact needs a CUDA card")
    common.fp32_backends()
    print(card_line(), flush=True)
    dev = "cuda"
    cfg = heads.AvatarConfig()
    if args.bf16:
        cfg = common.with_dtype(cfg, torch.bfloat16)
    print(f"synthesis chains and decoder in "
          f"{'bf16' if args.bf16 else 'fp32'}", flush=True)
    params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED), cfg,
                                   dev)
    g = torch.Generator().manual_seed(SEED + 1)
    image = (torch.rand((args.batch, cfg.size, cfg.size, 3), generator=g)
             * 2 - 1).to(dev)
    label = camera.flip_yz_label(camera.sample_camera_label(
        None, mode=None)).repeat(args.batch, 1).to(dev)

    with torch.inference_mode():
        for _ in range(2):                               # warm up, build
            reenact(params, cfg, image, label)
        torch.cuda.synchronize()

        # -- whole batches: CUDA events, peak memory
        torch.cuda.reset_peak_memory_stats()
        ms = float(np.median([events_ms(lambda: reenact(params, cfg, image,
                                                        label))
                              for _ in range(args.iters)]))
        print(f"whole batch: {ms:.3f} ms (median of {args.iters}), "
              f"{args.batch * 1e3 / ms:.3f} frames/s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

        # -- device time by kernel
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                reenact(params, cfg, image, label)
            torch.cuda.synchronize()
    device_report(prof, args.iters, OUR_KERNELS)


if __name__ == "__main__":
    main(build_argparser().parse_args())
