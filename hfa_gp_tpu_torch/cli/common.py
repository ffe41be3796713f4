"""Shared CLI plumbing of the port (counterpart of hfa_gp_tpu/cli/common.py):
the flags of the avatar CLIs (the reference's names and defaults), config
construction, weight loading, experiment directories and video assembly.

Every flag of the JAX CLI is accepted, so reference command lines port
over unchanged. `--addr` and `--port` are ignored, as in the JAX CLI. Where
another flag asks for something this port does not do (several processes
or devices, TPU machinery, `--trace_dir` outside `run_recon_video_rgb`),
`avatar_config` raises; none is ignored silently.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys

import numpy as np
import torch

from ..models import lpips as lpips_mod
from ..models.avatar.heads import AvatarConfig
from ..models.avatar.subspace import load_pti_bases
from ..utils import convert

LPIPS_SEED = 777


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--iter", type=int, default=800000)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--dataset", type=str, default="nerface_dataset")
    p.add_argument("--dataset_root", type=str, default="./datasets")
    p.add_argument("--person", type=str, default="person_3")
    p.add_argument("--resume_ckpt", type=str, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--start_iter", type=int, default=0)
    p.add_argument("--display_freq", type=int, default=5000)
    p.add_argument("--save_freq", type=int, default=5000)
    p.add_argument("--latent_dim_style", type=int, default=512)
    p.add_argument("--latent_dim_shape", type=int, default=50)
    p.add_argument("--exp_path", type=str, default="./exps/")
    p.add_argument("--exp_name", type=str, default="v1")
    p.add_argument("--tune_iter", type=int, default=50000)
    p.add_argument("--eg3d_weights", type=str, default=None,
                   help="generator npz of the JAX package's "
                        "tools/convert_pickle.py (ffhqrebalanced512-128)")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="npz of the JAX package's tools/convert_lpips.py")
    p.add_argument("--out_pose", action="store_true", default=False)
    p.add_argument("--use_softmax", action="store_true", default=False)
    p.add_argument("--person_2", type=str, default=None,
                   help="second-person subspace (RGB models)")
    p.add_argument("--run_id", type=str, default="nerface2")
    p.add_argument("--run_id_2", type=str, default=None)
    p.add_argument("--emb_dir", type=str, default="./PTI/embeddings/")
    p.add_argument("--init", action="store_true", default=False,
                   help="person-2 bases from the PTI pivots in "
                        "{emb_dir}/{run_id_2}/PTI (train_rgb)")
    p.add_argument("--same_bases", action="store_true", default=False,
                   help="person 2 shares the bases, with a delta of its own")
    # the reference's DDP rendezvous: accepted and ignored, as in JAX
    p.add_argument("--addr", type=str, default="localhost")
    p.add_argument("--port", type=str, default="12345")
    add_distributed_flags(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; CUDA runs the hand-written kernels")
    # accepted for parity with the JAX CLI; see avatar_config
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 synthesis chains and OSG decoder (fp32 "
                        "master weights, kernels, image and loss)")
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
                   help="torch.profiler trace of the render loop into this "
                        "dir (run_recon_video_rgb only, as in JAX; the "
                        "other CLIs raise)")


def add_distributed_flags(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's multi-host flags (hfa_gp_tpu/parallel/distributed.py),
    accepted for command-line parity; more than one process raises
    (`single_process`)."""
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (not ported: raises)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count (only 1 is supported)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank")


def avatar_config(args, tracing: bool = False) -> AvatarConfig:
    """AvatarConfig for the flags; raises on a flag the port cannot honour,
    and on `--trace_dir` unless the CLI traces (`tracing`). The avatar CLIs
    call it before anything else. `--bf16` runs the synthesis chains and
    the decoder in bf16, as the JAX CLI does."""
    single_process(args)
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: the port runs on one device")
    if args.pallas_sampler is False:
        raise NotImplementedError("--no_pallas_sampler: on CUDA the port "
                                  "always runs its tri-plane sampler kernel")
    if args.trace_dir is not None and not tracing:
        raise NotImplementedError("--trace_dir: only run_recon_video_rgb "
                                  "traces, as in the JAX package")
    cfg = AvatarConfig(size=args.size, dim=args.latent_dim_style,
                       dim_shape=args.latent_dim_shape,
                       use_softmax=args.use_softmax, out_pose=args.out_pose,
                       person_2=args.person_2 is not None,
                       same_bases=args.same_bases)
    return with_dtype(cfg, torch.bfloat16) if args.bf16 else cfg


def with_dtype(cfg: AvatarConfig, dtype: torch.dtype) -> AvatarConfig:
    """cfg with the EG3D synthesis chains and the OSG decoder in `dtype`
    (`--bf16`: torch.bfloat16, the JAX CLI's compute and decoder dtype)."""
    eg3d = cfg.eg3d
    return dataclasses.replace(cfg, eg3d=dataclasses.replace(
        eg3d, compute_dtype=dtype,
        render=dataclasses.replace(eg3d.render, decoder_dtype=dtype)))


def load_init_bases_2(args, cfg: AvatarConfig) -> torch.Tensor | None:
    """With `--init` and `--run_id_2`: person 2's bases from the PTI pivots
    in {emb_dir}/{run_id_2}/PTI (`subspace.load_pti_bases`); else None."""
    if not (args.init and args.run_id_2):
        return None
    return load_pti_bases(os.path.join(args.emb_dir, args.run_id_2, "PTI"),
                          cfg.dim_shape, cfg.eg3d.num_ws, cfg.dim)


def single_process(args) -> None:
    """The port runs in one process on one device: raise on WORLD_SIZE > 1,
    a coordinator or more than one process."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "WORLD_SIZE > 1: running over several processes is not ported")
    if args.coordinator_address is not None \
            or (args.num_processes or 1) > 1:
        raise NotImplementedError("--coordinator_address/--num_processes: "
                                  "running over several processes is not "
                                  "ported")


def load_generator_weights(args) -> dict | None:
    """--eg3d_weights (JAX-layout flat npz) → generator params in the
    port's layout, or None for a random generator."""
    if args.eg3d_weights is None:
        return None
    return convert.convert_tree(convert.load_npz(args.eg3d_weights))


def load_lpips(args, device: torch.device | str = "cpu"):
    """--lpips_weights (JAX-layout flat npz) → LPIPS params on `device`;
    without it a seeded random AlexNet, with a warning."""
    if args.lpips_weights is not None:
        return convert.from_jax(convert.load_npz(args.lpips_weights), device)
    print("=" * 70 + "\nWARNING: no --lpips_weights: the LPIPS loss uses "
          "RANDOM AlexNet\nfeatures (a random-projection distance, not "
          "perceptual). Convert the\ntorch `lpips` package weights with the "
          "JAX package's\ntools/convert_lpips.py for real runs.\n" + "=" * 70,
          file=sys.stderr)
    g = torch.Generator().manual_seed(LPIPS_SEED)
    return convert.ParamTree(lpips_mod.init_lpips(g)).to(device)


def make_dirs(args) -> dict[str, str]:
    base = os.path.join(args.exp_path, args.exp_name)
    dirs = {n: os.path.join(base, n)
            for n in ("log", "checkpoint", "display", "bases")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def save_args(args, dirs: dict[str, str]) -> None:
    """The run's flags as `args.json` beside the logs."""
    with open(os.path.join(dirs["log"], "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
                  f, indent=2)


def device_from_args(args) -> torch.device:
    """The device `--device` names, set up as every CLI runs it: a CUDA
    device without a card raises (no fallback to the CPU), and on CUDA the
    backends run full fp32 (`fp32_backends`)."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: no CUDA card is "
                               "available (pass --device cpu to run on the "
                               "CPU)")
        fp32_backends()
    return device


def fp32_backends() -> None:
    """Full fp32 on the card: cuDNN convolutions default to TF32, which
    keeps about three decimal digits; the port turns TF32 off for convs
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
