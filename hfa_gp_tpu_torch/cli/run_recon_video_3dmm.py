"""3DMM-driven video reenactment on the port (counterpart of
hfa_gp_tpu/cli/run_recon_video_3dmm.py).

    python -m hfa_gp_tpu_torch.cli.run_recon_video_3dmm \
        --dataset_root ./datasets --person person_3 \
        --model_path exps/v1/checkpoint/000999 --demo_dir ./demo

Renders each frame of the split from its expression coefficients
(Weights_3DMM → subspace → EG3D), `--render_batch` frames at a time,
writes `{demo_dir}/{demo_name}/%05d.png` and assembles `rec.mp4`.
`--fix_cam` renders every frame from the mean camera (a sampled, OpenGL
camera, flipped once by hand into the dataset's convention);
`--cam_angle` turns every dataset camera by that many degrees of yaw.
`--model_path` takes a checkpoint file written by the port's
`train_3dmm`; `--model_npz` the JAX package's flat-npz params, converted
by utils/convert.py. Without either the params are a seeded random init.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..core import camera as cam
from ..data.dataset import HeadData3DMM
from ..models.avatar import heads
from ..train import checkpoint as ckpt
from ..utils import convert
from ..utils.logging import save_image
from . import common

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_common_flags(p)
    p.add_argument("--dataset_type", type=str, default="test")
    p.add_argument("--params_len", type=int, default=76)
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint file of the port's train_3dmm")
    p.add_argument("--model_npz", type=str, default=None,
                   help="params-only npz (JAX pytree_io format)")
    p.add_argument("--demo_name", type=str, default="demo3dmm")
    p.add_argument("--demo_dir", type=str, default="./demo")
    p.add_argument("--cat_video", action="store_true", default=False)
    p.add_argument("--fix_cam", action="store_true", default=False)
    p.add_argument("--cam_angle", type=float, default=0.0,
                   help="extra yaw rotation (degrees) on every label")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--render_batch", type=int, default=4)
    return p


def load_params(args, cfg: heads.AvatarConfig, device: torch.device):
    if args.model_path is not None:
        return ckpt.load_params(args.model_path, device)
    if args.model_npz is not None:
        return convert.from_jax(convert.load_npz(args.model_npz), device)
    print("WARNING: no --model_path/--model_npz; using random init")
    return heads.init_avatar_3dmm(torch.Generator().manual_seed(SEED), cfg,
                                  device)


def main(args) -> None:
    cfg = dataclasses.replace(common.avatar_config(args),
                              params_len=args.params_len)
    device = common.device_from_args(args)
    root = f"{args.dataset_root}/{args.dataset}"
    dataset = HeadData3DMM(args.dataset_type, size=args.size, root=root,
                           person=args.person)
    if args.cam_angle:
        dataset.rotate_labels(args.cam_angle)
    params = load_params(args, cfg, device)
    save_path = os.path.join(args.demo_dir, args.demo_name)
    os.makedirs(save_path, exist_ok=True)
    fixed_label = cam.flip_yz_label(cam.sample_camera_label(
        None, n=1, mode=None))[0] if args.fix_cam else None

    n, bs = len(dataset), max(args.render_batch, 1)
    frame_idx = 0
    with torch.inference_mode():
        for start in range(0, n, bs):
            items = [dataset[i] for i in range(start, min(start + bs, n))]
            labels = torch.stack([fixed_label if fixed_label is not None
                                  else it[1] for it in items]).to(device)
            coeffs = torch.stack([it[2] for it in items]).to(device)
            out = heads.t3dmm_forward(params, cfg, coeffs, labels)
            for frame in out.cpu():
                save_image(frame, os.path.join(save_path,
                                               f"{frame_idx:05d}.png"))
                frame_idx += 1

    gt_dir = dataset.ds_path if args.cat_video else None
    video = common.write_video(save_path, os.path.join(save_path, "rec.mp4"),
                               fps=args.fps, side_by_side_dir=gt_dir)
    print(f"==> wrote {frame_idx} frames to {save_path} ({video})")


if __name__ == "__main__":
    main(build_argparser().parse_args())
