"""Where one reenactment batch spends its time on the card, at full width.

    python -m hfa_gp_tpu_torch.tools.profile_reenact [--batch 8] [--iters 5]
        [--bf16]

Prints, for seeded random params and a seeded batch (the inputs of
`chip_smoke.py` [6]) in fp32 with TF32 off (with `--bf16`: the synthesis
chains and the decoder in bf16, as `--bf16` of the CLIs), under inference
mode:
  * the card's name and power limit (`nvidia-smi`);
  * the batch's stages timed alone with CUDA events (median over --iters):
    the encoder, the subspace (QR and latent), and synthesis cut into the
    rays, the tri-plane backbone, `render_rays` (both sampler and marcher
    passes and the decoder) and the super-resolution network;
  * the whole batch (`run_recon_video_rgb.reenact`, median over --iters)
    and its frames/s, and the peak device memory;
  * from `torch.profiler` over --iters whole batches: the device time by
    kernel (top 25) and by group, the share of the hand-written kernels,
    and the share of the profiled window in which the device was busy.
Needs a CUDA card; the kernels are built at first use.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli import common
from ..cli.run_recon_video_rgb import reenact
from ..core import camera
from ..models.avatar import heads
from ..models.eg3d import networks as nets
from ..models.eg3d import renderer as rnd
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
    gen, ecfg = params["generator"], cfg.eg3d
    res = ecfg.render.neural_rendering_resolution

    with torch.inference_mode():
        for _ in range(2):                               # warm up, build
            reenact(params, cfg, image, label)
        torch.cuda.synchronize()

        # -- stages, each timed alone with CUDA events
        out: dict = {}

        def planes_of(ws):
            p = nets.backbone_apply(gen["backbone"], ecfg.backbone, ws,
                                    noise_mode="const",
                                    compute_dtype=ecfg.compute_dtype)
            h, w = p.shape[2:]
            return p.reshape(args.batch, 3, -1, h, w).permute(0, 1, 3, 4, 2) \
                .contiguous()

        stages = {
            "encoder": lambda: out.update(
                w=heads.rgb_get_weights(params, cfg, image)),
            "subspace (QR, latent)": lambda: out.update(
                ws=heads.get_latent(params, out["w"], cfg)),
            "rays": lambda: out.update(rays=camera.generate_rays(
                *camera.unpack_label(label), res)),
            "tri-plane backbone": lambda: out.update(
                planes=planes_of(out["ws"])),
            "render_rays": lambda: out.update(feats=rnd.render_rays(
                gen["decoder"], ecfg.render, out["planes"], *out["rays"],
                ray_grid=(res, res))[0]),
            "super-resolution": lambda: out.update(img=nets.superresolution_apply(
                gen["superresolution"], ecfg.sr,
                out["feats"].permute(0, 2, 1).reshape(
                    args.batch, -1, res, res)[:, :3],
                out["feats"].permute(0, 2, 1).reshape(args.batch, -1, res,
                                                      res),
                out["ws"], noise_mode="none",
                compute_dtype=ecfg.compute_dtype)),
        }
        times: dict[str, list[float]] = {k: [] for k in stages}
        for _ in range(args.iters):
            for k, fn in stages.items():
                times[k].append(events_ms(fn))
        med = {k: float(np.median(v)) for k, v in times.items()}
        total = sum(med.values())
        print(f"stages of one reenactment batch, batch {args.batch}, median "
              f"of {args.iters} (CUDA events, each stage alone):")
        for k, v in med.items():
            print(f"  {k:24s} {v:9.3f} ms  {100 * v / total:5.1f} % of "
                  f"{total:.3f}")

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
