"""RGB-driven video reenactment on the port (counterpart of
hfa_gp_tpu/cli/run_recon_video_rgb.py).

    python -m hfa_gp_tpu_torch.cli.run_recon_video_rgb \
        --dataset_root ./datasets --person person_3 \
        --model_npz avatar.npz --demo_dir ./demo --render_batch 4

Reads the test frames and labels, renders each batch of `--render_batch`
frames (encoder → QR subspace → EG3D synthesis → SR), writes
`{demo_dir}/{demo_name}/%05d.png` and assembles a video. `--model_path`
takes a checkpoint file written by the port's trainer
(`cli/train_rgb.py`, with or without a second person's subspace);
`--model_npz` takes the JAX package's flat-npz params (utils/pytree_io.py
format; `tools/convert_avatar.py` writes them from a reference .pt
checkpoint), converted by utils/convert.py. Without either the params are a
seeded random init. `--trace_dir` writes a `torch.profiler` trace of the
render loop there, with the regions "encoder", "subspace" and "synthesis"
of each batch named.
Over several processes (`parallel/distributed.py`) each data index
renders its share of every batch (the last one padded, as in JAX); with
`--n_model` M > 1 the M ranks of a data index split each frame's rays
(ray sharding). The primary gathers the frames and alone writes them and
the video.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from ..data.dataset import HeadDataTest
from ..models.avatar import heads
from ..parallel import distributed
from ..parallel import mesh as mesh_mod
from ..train import checkpoint as ckpt
from ..utils import convert, observability
from ..utils.logging import save_image
from . import common

SEED = 0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_common_flags(p)
    p.add_argument("--dataset_type", type=str, default="test")
    p.add_argument("--suffix", type=str, default=".png")
    p.add_argument("--ds_path", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None,
                   help="checkpoint file of the port's train_rgb (an Orbax "
                        "directory of the JAX package raises)")
    p.add_argument("--model_npz", type=str, default=None,
                   help="params-only npz (JAX pytree_io format), e.g. "
                        "of a reference .pt by `python -m hfa_gp_tpu_torch."
                        "tools.convert_avatar --head rgb`")
    p.add_argument("--demo_name", type=str, default="demo")
    p.add_argument("--demo_dir", type=str, default="./demo")
    p.add_argument("--cat_video", action="store_true", default=False)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--render_batch", type=int, default=4)
    p.add_argument("--smooth_sigma", type=float, default=None)
    return p


def load_params(args, cfg: heads.AvatarConfig, device: torch.device):
    if args.model_path is not None:
        return ckpt.load_params(args.model_path, device)
    if args.model_npz is not None:
        return convert.from_jax(convert.load_npz(args.model_npz), device)
    print("WARNING: no --model_path/--model_npz; using random init")
    return heads.init_avatar_rgb(torch.Generator().manual_seed(SEED), cfg,
                                 device)


def reenact(params, cfg: heads.AvatarConfig, image: torch.Tensor,
            label: torch.Tensor, mesh=None) -> torch.Tensor:
    """image (B, size, size, 3), OpenCV label (B, 25) → (B, 512, 512, 3);
    with a model axis on `mesh` its ranks split the rays."""
    with observability.annotate("encoder"):
        weights = heads.rgb_get_weights(params, cfg, image)
    if cfg.out_pose:
        weights, _pose = weights
    with observability.annotate("subspace"):
        latent = heads.get_latent(params, weights, cfg)
    with observability.annotate("synthesis"):
        return heads.get_image(params, cfg, latent, label, mesh=mesh)


def main(args) -> None:
    cfg = common.avatar_config(args, tracing=True)
    device = common.device_from_args(args)
    distributed.maybe_initialize(args, device)
    mesh = mesh_mod.make_mesh_for_batch(max(args.render_batch, 1),
                                        args.n_model)
    primary = distributed.is_primary()
    root = f"{args.dataset_root}/{args.dataset}"
    dataset = HeadDataTest(args.dataset_type, size=args.size, root=root,
                           person=args.person, ds_path=args.ds_path,
                           suffix=args.suffix, smooth_sigma=args.smooth_sigma)
    params = load_params(args, cfg, device)
    save_path = os.path.join(args.demo_dir, args.demo_name)
    if primary:
        os.makedirs(save_path, exist_ok=True)

    frame_idx = 0
    tracer = observability.trace(args.trace_dir) \
        if args.trace_dir and primary else contextlib.nullcontext()
    with tracer, torch.inference_mode():
        # each rank loads and renders its rows; the primary writes them all
        for idxs, mine in common.reenact_batches(len(dataset),
                                                 args.render_batch, mesh):
            items = [dataset[i] for i in mine]
            imgs = torch.stack([it[0] for it in items]).to(device)
            labels = torch.stack([it[1] for it in items]).to(device)
            out = mesh_mod.host_gather(
                reenact(params, cfg, imgs, labels, mesh), mesh)[:len(idxs)]
            if primary:
                for frame in out.cpu():
                    save_image(frame, os.path.join(save_path,
                                                   f"{frame_idx:05d}.png"))
                    frame_idx += 1

    if not primary:
        return
    gt_dir = dataset.ds_path if args.cat_video else None
    video = common.write_video(
        save_path, os.path.join(save_path, f"{args.demo_name}"
                                f"{'cat' if args.cat_video else 'rec'}.mp4"),
        fps=args.fps, side_by_side_dir=gt_dir)
    print(f"==> wrote {frame_idx} frames to {save_path} ({video})")


if __name__ == "__main__":
    main(build_argparser().parse_args())
