"""Where one RGB training step spends its time on the card, at full width.

    python -m hfa_gp_tpu_torch.tools.profile_train [--batch 2] [--steps 3]

Prints, for seeded random params and a seeded batch in fp32 with TF32 off:
  * the card's name and power limit (`nvidia-smi`);
  * the step's stages timed with CUDA events (median over --steps): the
    forward (`train.rgb.loss_fn`, with its sub-stages encoder, subspace,
    synthesis and loss timed alone under no_grad), the backward, and the
    optimizer (freeze gate + Adam);
  * from `torch.profiler` over --steps whole steps: the device time by
    kernel (top 25), the share of the four hand-written kernels, and the
    share of the profiled window in which the device was busy;
  * the peak device memory of a step.
Needs a CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common
from ..core import camera, ops
from ..models import lpips as lpips_mod
from ..models.avatar import heads
from ..train import rgb
from ..train.state import apply_generator_freeze, init_state
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
    return p


def main(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    common.fp32_backends()
    print(card_line(), flush=True)
    dev = "cuda"
    cfg = heads.AvatarConfig()
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

    # -- stages of a step, CUDA events
    stages: dict[str, list[float]] = {}
    for _ in range(args.steps):
        state.optimizer.zero_grad(set_to_none=True)
        out = {}
        t_fwd = events_ms(lambda: out.update(loss=rgb.loss_fn(
            state.params, lp, cfg, image, label)[0]))
        t_bwd = events_ms(lambda: out["loss"].backward())

        def optimizer():
            apply_generator_freeze(state.params, state.step, 0)
            state.optimizer.step()

        t_opt = events_ms(optimizer)
        with torch.no_grad():
            t_enc = events_ms(lambda: out.update(
                w=heads.rgb_get_weights(state.params, cfg, image)))
            t_sub = events_ms(lambda: out.update(
                lat=heads.get_latent(state.params, out["w"], cfg)))
            t_syn = events_ms(lambda: out.update(img=heads.get_image(
                state.params, cfg, out["lat"], label)))

            def loss_terms():
                gen = ops.avg_pool_to(out["img"], cfg.size)
                return (image - gen).square().mean() \
                    + lpips_mod.lpips_distance(lp, image, gen).mean()

            t_loss = events_ms(loss_terms)
        for k, v in (("forward", t_fwd), ("backward", t_bwd),
                     ("optimizer", t_opt), ("fwd: encoder", t_enc),
                     ("fwd: subspace (QR)", t_sub),
                     ("fwd: synthesis", t_syn),
                     ("fwd: pool + L2 + LPIPS", t_loss)):
            stages.setdefault(k, []).append(v)
    med = {k: float(np.median(v)) for k, v in stages.items()}
    whole = med["forward"] + med["backward"] + med["optimizer"]
    print(f"stages of one training step, batch {args.batch}, median of "
          f"{args.steps} (CUDA events; the fwd: rows were timed alone under "
          f"no_grad):")
    for k, v in med.items():
        print(f"  {k:26s} {v:9.3f} ms  {100 * v / whole:5.1f} % of "
              f"{whole:.3f}")

    # -- whole steps: host clock, peak memory
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


def device_report(prof, steps: int, ours) -> None:
    """From a `torch.profiler` run over `steps` whole steps: device time by
    kernel (top 25) and by group, the share of the hand-written kernels
    named in `ours`, and the share of the window the device was busy."""
    def on_device(e) -> bool:
        """Kernels and copies only: an operator's own entry, or an
        annotation's range, repeats the time of the kernels under it."""
        return str(e.device_type).endswith("CUDA") \
            and not getattr(e, "is_user_annotation", False)

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
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if on_device(e))
    if spans:
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in spans) - spans[0][0]
        print(f"device busy {busy / 1e3:.3f} of {window / 1e3:.3f} ms: "
              f"{100 * busy / window:.1f} %")


if __name__ == "__main__":
    main(build_argparser().parse_args())
