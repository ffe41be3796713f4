"""Where one RGB training step spends its time on the card, at full width.

    python -m hfa_gp_tpu_torch.tools.profile_train [--batch 2] [--steps 3]
        [--bf16]

Prints, for seeded random params and a seeded batch in fp32 with TF32 off
(with `--bf16`: the synthesis chains and the decoder in bf16, as `--bf16`
of the CLIs; master weights, image, LPIPS and loss stay fp32):
  * the card's name and power limit (`nvidia-smi`);
  * the whole step (CUDA events, median over --steps);
  * from `torch.profiler` over --steps whole steps: the device time by
    kernel (top 25), the share of the four hand-written kernels, and the
    share of the profiled window in which the device was busy;
  * the peak device memory of a step.
Needs a CUDA card; the kernels are built at first use. The step's
stages inside the benchmark's fitting cell are its per-layer metrics
`forward_ms`, `backward_ms` and `optimizer_ms` (`python benchmark/run.py
--workload rgb_fit_b2 --seed 1 --seconds 10 --trace 1`), read from the
port's profiler ranges and autograd's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common
from ..core import camera
from ..models import lpips as lpips_mod
from ..models.avatar import heads
from ..train import rgb
from ..train.state import init_state
from ..utils.convert import ParamTree
from .measure import card_line, events_ms

SEED = 0
OUR_KERNELS = ("triplane_sampler_kernel", "triplane_bwd_kernel",
               "ray_march_warp_kernel", "ray_march_kernel",
               "ray_march_bwd_kernel")

# kernel-name substrings → group, first match wins (after the hand-written
# kernels, which the caller names)
GROUPS = (
    ("convolution (cuDNN, depthwise, FFT)",
     ("cudnn", "implicit_gemm", "dgrad", "wgrad", "fft", "conv", "winograd",
      # the complex products of cuDNN's FFT algorithms
      "cf32", "gemv2N_kernel<int, int, float2")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cublas", "cutlass")),
    ("memcpy / memset", ("Memcpy", "Memset")),
    ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
)


def _group(key: str, ours=OUR_KERNELS) -> str:
    for name, needles in (("hand-written kernels", ours), *GROUPS):
        if any(n in key for n in needles):
            return name
    return "elementwise, reductions, other"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 synthesis chains and decoder")
    return p


def main(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    common.fp32_backends()
    print(card_line(), flush=True)
    dev = "cuda"
    cfg = heads.AvatarConfig()
    if args.bf16:
        cfg = common.with_dtype(cfg, torch.bfloat16)
    print(f"synthesis chains and decoder in "
          f"{'bf16' if args.bf16 else 'fp32'}", flush=True)
    g = torch.Generator().manual_seed(SEED)
    state = init_state(heads.init_avatar_rgb(g, cfg, dev))
    lp = ParamTree(lpips_mod.init_lpips(g)).to(dev)
    image = (torch.rand((args.batch, cfg.size, cfg.size, 3), generator=g)
             * 2 - 1).to(dev)
    label = camera.flip_yz_label(camera.sample_camera_label(
        None, mode=None)).repeat(args.batch, 1).to(dev)

    def step():
        return rgb.train_step(state, lp, cfg, image, label, 0)

    for _ in range(2):                                   # warm up, build
        step()
    torch.cuda.synchronize()

    # -- whole steps: CUDA events, peak memory
    torch.cuda.reset_peak_memory_stats()
    ms = [events_ms(step) for _ in range(args.steps)]
    print(f"whole step: {float(np.median(ms)):.3f} ms (median of "
          f"{args.steps}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # -- device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
    device_report(prof, args.steps, OUR_KERNELS)


def on_device(e) -> bool:
    """Kernels and copies only: an operator's own entry, or an annotation's
    range, repeats the time of the kernels under it."""
    return str(e.device_type).endswith("CUDA") \
        and not getattr(e, "is_user_annotation", False)


def device_busy_us(prof) -> tuple[float, float]:
    """(µs in which a kernel or copy ran, µs from the first to the last)
    of a `torch.profiler` run."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    if not spans:
        return 0.0, 0.0
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def device_report(prof, steps: int, ours) -> None:
    """From a `torch.profiler` run over `steps` whole steps: device time by
    kernel (top 25) and by group, the share of the hand-written kernels
    named in `ours`, and the share of the window the device was busy."""
    rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                   for e in prof.key_averages() if on_device(e)),
                  reverse=True)
    kernels = [(us, key, n) for us, key, n in rows if us > 0]
    total = sum(us for us, _, _ in kernels)
    if total == 0:
        print("torch.profiler recorded no device time")
        return
    print(f"device time over {steps} profiled steps: "
          f"{total / 1e3:.3f} ms (by kernel name)")
    for us, key, n in kernels[:25]:
        print(f"  {100 * us / total:5.2f} %  {us / 1e3:9.3f} ms  x{n:<5d} "
              f"{key[:90]}")
    groups: dict[str, float] = {}
    for us, key, _ in kernels:
        groups[_group(key, ours)] = groups.get(_group(key, ours), 0.0) + us
    print("by group (kernel-name substrings, see GROUPS):")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / total:5.2f} %  {us / 1e3:9.3f} ms  {name}")
    for name in ours:
        hit = [(us, n) for us, key, n in kernels if name in key]
        us, n = (sum(h[0] for h in hit), sum(h[1] for h in hit))
        print(f"  ours: {name:26s} {100 * us / total:5.2f} %  "
              f"{us / 1e3:9.3f} ms  x{n}  "
              f"({us / 1e3 / max(n, 1):.3f} ms a launch)")
    busy, window = device_busy_us(prof)
    if window:
        print(f"device busy {busy / 1e3:.3f} of {window / 1e3:.3f} ms: "
              f"{100 * busy / window:.1f} %")


if __name__ == "__main__":
    main(build_argparser().parse_args())
