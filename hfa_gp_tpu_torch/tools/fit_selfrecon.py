"""Self-reconstruction convergence demo on the port (counterpart of the
JAX package's tools/fit_selfrecon.py): evidence that the whole fit →
reenact loop recovers a subject, without external assets.

A frozen EG3D generator (random weights) plus a hidden ground-truth
subspace and per-frame weights α* produce K posed frames, the (image,
25-dim label) contract of `HeadData`. A fresh encoder and subspace over
the SAME frozen generator are then fit with the real RGB training step
(`train/rgb.py`: encoder → QR subspace → synthesis → pooled L2 + LPIPS →
Adam), and the reconstruction PSNR is reported on the training frames and
on held-out frames, before and after. PSNR is taken at the loss resolution
(cfg.size) on images in [-1, 1]: 10·log10(4 / MSE).

    python -m hfa_gp_tpu_torch.tools.fit_selfrecon [--steps N] [--batch B]
        [--n_frames K] [--small] [--device cuda|cpu]

`--small` is a tiny configuration for the CPU; without it the run is at
full width and wants a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..cli import common
from ..core import camera as cam
from ..core import ops
from ..models import lpips as lpips_mod
from ..models.avatar import encoder as enc
from ..models.avatar import heads
from ..models.avatar import subspace as sub
from ..models.eg3d import networks as nets
from ..models.eg3d import renderer as rnd
from ..models.eg3d.generator import EG3DConfig
from ..train import rgb as rgb_train
from ..train.state import init_state
from ..utils.convert import ParamTree

SEED = 0
FROZEN = 10 ** 9        # tune_iter: the generator stays frozen throughout


def build_cfg(small: bool) -> heads.AvatarConfig:
    if not small:
        return heads.AvatarConfig()
    eg3d = EG3DConfig(
        mapping=nets.MappingConfig(num_layers=2),
        backbone=nets.BackboneConfig(img_resolution=32, channel_base=2048,
                                     channel_max=128),
        sr=nets.SRConfig(input_resolution=16, output_resolution=64,
                         in_channels=32, block_channels=(32, 16)),
        render=rnd.RenderConfig(depth_resolution=8,
                                depth_resolution_importance=8,
                                neural_rendering_resolution=16))
    return heads.AvatarConfig(size=64, dim_shape=8, eg3d=eg3d)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(4.0 / (a - b).square().mean(dim=(1, 2, 3)))


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=None,
                   help="training steps (default 400, 30 with --small)")
    p.add_argument("--batch", type=int, default=None,
                   help="batch size (default 4, 2 with --small)")
    p.add_argument("--n_frames", type=int, default=24)
    p.add_argument("--small", action="store_true", default=False)
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(args) -> dict[str, float]:
    """Runs the fit; returns the PSNRs (dB) before and after and the
    seconds the training steps took. Raises if the training PSNR did not
    rise by 3 dB."""
    device = common.device_from_args(args)
    steps = args.steps if args.steps is not None else (30 if args.small
                                                       else 400)
    batch = args.batch if args.batch is not None else (2 if args.small else 4)
    n_frames, n_test = args.n_frames, max(2, args.n_frames // 6)
    cfg = build_cfg(args.small)
    g = torch.Generator().manual_seed(SEED)

    # the synthetic subject: hidden subspace + frozen generator
    params_gt = heads.init_avatar_rgb(g, cfg, device)
    alpha_gt = 2.0 * torch.randn((n_frames + n_test, cfg.dim_shape),
                                 generator=g).to(device)
    labels = cam.sample_camera_label(g, n=n_frames + n_test,
                                     mode="gaussian").to(device)
    with torch.no_grad():      # the frames feed autograd as constants
        frames = torch.cat([
            ops.avg_pool_to(heads.get_image(
                params_gt, cfg,
                heads.get_latent(params_gt, alpha_gt[i:i + batch], cfg),
                labels[i:i + batch], label_convention="opengl"), cfg.size)
            for i in range(0, n_frames + n_test, batch)])
    train_imgs, test_imgs = frames[:n_frames], frames[n_frames:]
    train_labs, test_labs = labels[:n_frames], labels[n_frames:]
    print(f"subject: {n_frames} train + {n_test} held-out frames at "
          f"{cfg.size}² (gt range [{float(frames.min()):.2f}, "
          f"{float(frames.max()):.2f}])", flush=True)

    # the trainable avatar: fresh encoder + subspace, the same generator
    params = ParamTree({
        "encoder": enc.init_encoder(g, cfg.size, cfg.dim, cfg.dim_shape,
                                    cfg.out_pose),
        "subspace": sub.init_subspace(g, cfg.dim_shape, cfg.eg3d.num_ws,
                                      cfg.dim)}).to(device)
    params.add_module("generator", params_gt["generator"])
    lp = ParamTree(lpips_mod.init_lpips(g)).to(device)
    state = init_state(params, 3e-4)

    def eval_psnr() -> list[float]:
        vals = []
        for imgs, labs in ((train_imgs, train_labs), (test_imgs, test_labs)):
            ps = [float(psnr(ops.avg_pool_to(rgb_train.sample(
                state.params, cfg, imgs[i:i + 1], labs[i:i + 1],
                label_convention="opengl"), cfg.size), imgs[i:i + 1])[0])
                for i in range(len(imgs))]
            vals.append(float(np.mean(ps)))
        return vals                           # [train, held-out]

    p0 = eval_psnr()
    print(f"before fit: train PSNR {p0[0]:.2f} dB / held-out {p0[1]:.2f} dB",
          flush=True)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for it in range(steps):
        idx = torch.from_numpy(rng.integers(0, n_frames, size=batch)) \
            .to(device)
        m = rgb_train.train_step(state, lp, cfg, train_imgs[idx],
                                 train_labs[idx], FROZEN,
                                 label_convention="opengl")
        if it == 0 or (it + 1) % max(1, steps // 8) == 0:
            # a scalar is fetched only at report points
            print(f"step {it + 1}: loss {float(m['loss']):.4f} "
                  f"(l2 {float(m['l2_loss']):.4f}) "
                  f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    p1 = eval_psnr()
    print(f"after {steps} steps: train PSNR {p1[0]:.2f} dB "
          f"(+{p1[0] - p0[0]:.2f}) / held-out {p1[1]:.2f} dB "
          f"(+{p1[1] - p0[1]:.2f}), {seconds:.1f} s of steps on {device}",
          flush=True)
    if not p1[0] > p0[0] + 3.0:
        raise RuntimeError("training did not materially improve PSNR: "
                           f"{p0[0]:.2f} → {p1[0]:.2f} dB")
    print("OK", flush=True)
    return {"train_before": p0[0], "test_before": p0[1],
            "train_after": p1[0], "test_after": p1[1], "seconds": seconds}


if __name__ == "__main__":
    main(build_argparser().parse_args())
