"""Shared CLI plumbing of the port (counterpart of hfa_gp_tpu/cli/common.py):
the flags `run_recon_video_rgb` reads, config construction and video
assembly.

Flags of the JAX CLI that select TPU machinery are accepted for
command-line parity. Where one asks for something this port does not do,
`avatar_config` raises; none is ignored silently.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..models.avatar.heads import AvatarConfig
from ..models.eg3d.generator import EG3DConfig


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--dataset", type=str, default="nerface_dataset")
    p.add_argument("--dataset_root", type=str, default="./datasets")
    p.add_argument("--person", type=str, default="person_3")
    p.add_argument("--latent_dim_style", type=int, default=512)
    p.add_argument("--latent_dim_shape", type=int, default=50)
    p.add_argument("--out_pose", action="store_true", default=False)
    p.add_argument("--use_softmax", action="store_true", default=False)
    p.add_argument("--person_2", type=str, default=None,
                   help="second-person subspace (not ported: raises)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; CUDA runs the hand-written kernels")
    # accepted for parity with the JAX CLI; see avatar_config
    p.add_argument("--bf16", action="store_true", default=False,
                   help="not ported: raises")
    p.add_argument("--n_model", type=int, default=1,
                   help="ray sharding; only 1 is supported")
    p.add_argument("--pallas_marcher", action="store_true", default=False,
                   help="no effect: the marcher kernel always runs on CUDA")
    p.add_argument("--pallas_sampler", action="store_true", default=None,
                   help="no effect: the sampler kernel always runs on CUDA")
    p.add_argument("--no_pallas_sampler", dest="pallas_sampler",
                   action="store_false",
                   help="not supported: raises")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="profiler trace (not ported: raises)")


def avatar_config(args) -> AvatarConfig:
    """AvatarConfig for the flags; raises on a flag the port cannot honour."""
    if args.bf16:
        raise NotImplementedError("--bf16: the port runs fp32 only")
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: the port runs on one device")
    if args.pallas_sampler is False:
        raise NotImplementedError("--no_pallas_sampler: on CUDA the port "
                                  "always runs its tri-plane sampler kernel")
    if args.trace_dir is not None:
        raise NotImplementedError("--trace_dir: profiler tracing is not "
                                  "ported")
    if args.person_2 is not None:
        raise NotImplementedError("--person_2: the second-person subspace "
                                  "is not ported")
    return AvatarConfig(size=args.size, dim=args.latent_dim_style,
                        dim_shape=args.latent_dim_shape,
                        use_softmax=args.use_softmax, out_pose=args.out_pose,
                        eg3d=EG3DConfig())


def fp32_backends() -> None:
    """Full fp32 on the card: cuDNN convolutions default to TF32, which
    keeps about three decimal digits; the slice turns TF32 off for convs
    and matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def write_video(png_dir: str, out_path: str, fps: int = 24,
                side_by_side_dir: str | None = None) -> str:
    """Assemble sorted pngs into a video (libx264 where an ffmpeg backend
    exists, MJPEG-AVI otherwise), optionally beside the ground-truth
    frames. Returns the written path."""
    from PIL import Image

    from ..utils.video import write_video_frames
    frames = sorted(glob.glob(os.path.join(png_dir, "*.png")))
    gt_frames = sorted(
        f for f in glob.glob(os.path.join(side_by_side_dir, "*"))
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )[:len(frames)] if side_by_side_dir else None

    def gen():
        for i, f in enumerate(frames):
            img = np.asarray(Image.open(f).convert("RGB"))
            if gt_frames:
                gt = np.asarray(Image.open(gt_frames[i]).convert("RGB")
                                .resize((img.shape[1], img.shape[0])))
                img = np.concatenate([gt, img], axis=1)
            yield img

    return write_video_frames(gen(), out_path, fps=fps)
