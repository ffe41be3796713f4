"""Preprocessing CLI (port of hfa_gp_tpu/cli/process_video.py; reference
eg3d-pose-detection/process_test_video.py): a directory of frames →
`detections/*.txt`, `cropped_images/*.png` (512²), `cameras.json` and
`test.json`.

    python -m hfa_gp_tpu_torch.cli.process_video --in_root frames/ \
        [--mtcnn_weights mtcnn.npz] [--recon_weights recon.npz] \
        [--use_existing_detections] [--device cuda]

The weight files are the JAX package's flat npz (tools/convert_mtcnn.py,
tools/convert_facerecon.py), carried into the port's modules by
`preprocess.convert`; without them the networks run with random weights
(structure and contract testing only), and the CLI says so loudly.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..preprocess import convert, pipeline
from ..utils.convert import load_npz
from . import common


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--in_root", type=str, required=True,
                   help="directory of frames")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--mtcnn_weights", type=str, default=None)
    p.add_argument("--recon_weights", type=str, default=None)
    p.add_argument("--use_existing_detections", action="store_true",
                   default=False,
                   help="skip MTCNN; read {in_root}/detections/*.txt")
    p.add_argument("--smooth_sigma", type=float, default=2.0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the networks")
    return p


def main(args) -> None:
    device = common.device_from_args(args)
    cfg = pipeline.PipelineConfig(smooth_sigma=args.smooth_sigma,
                                  batch_size=args.batch_size)
    mtcnn_net = (convert.mtcnn_from_jax(load_npz(args.mtcnn_weights), device)
                 if args.mtcnn_weights else None)
    recon_net = (convert.facerecon_from_jax(load_npz(args.recon_weights),
                                            device)
                 if args.recon_weights else None)
    if mtcnn_net is None and not args.use_existing_detections:
        print("=" * 70 + "\nWARNING: no --mtcnn_weights — face detection "
              "runs with RANDOM weights.\nDetections/crops will be garbage "
              "on real video. Convert pretrained\nweights with "
              "tools/convert_mtcnn.py first.\n" + "=" * 70,
              file=sys.stderr)
    if recon_net is None:
        print("=" * 70 + "\nWARNING: no --recon_weights — the 3D face "
              "reconstruction net runs with\nRANDOM weights; extracted "
              "poses will be garbage on real video. Convert\nthe "
              "Deep3DFaceRecon epoch-20 checkpoint with "
              "tools/convert_facerecon.py.\n" + "=" * 70, file=sys.stderr)
    landmarks = None
    if args.use_existing_detections:
        landmarks = pipeline.smooth_landmarks(pipeline.load_detections(
            os.path.join(args.in_root, "detections"), args.in_root), cfg)
    out = pipeline.process_video(args.in_root, args.out_dir, cfg, mtcnn_net,
                                 recon_net, landmarks, device)
    print(f"==> wrote {out}")


if __name__ == "__main__":
    main(build_argparser().parse_args())
