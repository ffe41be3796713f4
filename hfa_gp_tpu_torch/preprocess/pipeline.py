"""End-to-end preprocessing pipeline (port of
hfa_gp_tpu/preprocess/pipeline.py).

Replaces the reference's 6-subprocess chain
(eg3d-pose-detection/process_test_video.py:17-65) with one in-process
program:

  1. MTCNN detection        (batch_mtcnn.py)      → 5-pt landmarks
  2. temporal smoothing     (smooth.py, σ=2)
  3. 3DMM regression        (test.py + FaceReconModel) → 257 coeffs
  4. EG3D cropping          (crop_images.py)      → 512² crops
  5. pose → extrinsics      (3dface2idr.py)       → cameras.json
  6. label packing          (camera2label.py)     → test.json

The networks (MTCNN, the ResNet-50 regressor) run on their module's device;
the regressor takes `batch_size` aligned 224² crops a call. The PIL
resampling, box arithmetic and JSON stay on the host, the same code as the
JAX package's, because the crops depend on it bit for bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from PIL import Image

from . import align as align_mod
from . import facerecon as recon_mod
from . import mtcnn as mtcnn_mod
from . import pose as pose_mod
from .bfm import split_coeff
from .smoothing import smooth_landmark_sequence

# Standard 5-point 3D landmarks of the BFM similarity transform (the
# `lm3d_std` recorded into cropping_params.json by the reference,
# test.py:70-87 / util.load_mats.load_lm3d). Users with BFM assets can
# override via PipelineConfig.lm3d_std.
DEFAULT_LM3D_STD = np.array([
    [-0.31148657, 0.09036078, 0.13377953],
    [0.30979887, 0.08972035, 0.13179526],
    [0.0032535, -0.24617933, 0.55244243],
    [-0.25216928, -0.5813392, 0.22405732],
    [0.2484662, -0.5812824, 0.22235769],
], dtype=np.float32)

FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")


@dataclass
class PipelineConfig:
    min_face_size: int = 20
    smooth_sigma: float = 2.0
    rescale_recon: float = align_mod.RESCALE_FACTOR_RECON   # 466.285
    rescale_crop: float = align_mod.RESCALE_FACTOR_CROP     # 300
    center_crop_size: int = align_mod.CENTER_CROP_SIZE      # 700
    output_size: int = align_mod.OUTPUT_SIZE                # 512
    batch_size: int = 16
    lm3d_std: np.ndarray = None

    def __post_init__(self):
        if self.lm3d_std is None:
            self.lm3d_std = DEFAULT_LM3D_STD


def list_frames(in_dir: str) -> list[str]:
    return sorted(os.path.join(in_dir, f) for f in os.listdir(in_dir)
                  if f.lower().endswith(FRAME_SUFFIXES))


def detect_landmarks(net: mtcnn_mod.MTCNN, frame_paths: list[str],
                     cfg: PipelineConfig,
                     out_dir: str | None = None) -> dict[str, np.ndarray]:
    """Stage 1: per-frame 5-point landmarks (+ optional detections/*.txt
    output matching batch_mtcnn.py:72-79)."""
    lms = {}
    for path in frame_paths:
        img = np.asarray(Image.open(path).convert("RGB"))
        best = mtcnn_mod.select_face(
            mtcnn_mod.detect_faces(net, img, cfg.min_face_size))
        if best is None:
            continue
        kp = best["keypoints"]
        lms[os.path.basename(path)] = np.array(
            [kp["left_eye"], kp["right_eye"], kp["nose"],
             kp["mouth_left"], kp["mouth_right"]], np.float32)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            stem = os.path.basename(path).rsplit(".", 1)[0]
            mtcnn_mod.write_detection(best, os.path.join(out_dir,
                                                         stem + ".txt"))
    return lms


def smooth_landmarks(lms: dict[str, np.ndarray],
                     cfg: PipelineConfig) -> dict[str, np.ndarray]:
    """Stage 2 (smooth.py:40): one entry a frame, in name order."""
    keys = sorted(lms)
    sm = smooth_landmark_sequence(np.stack([lms[k] for k in keys]),
                                  cfg.smooth_sigma)
    return {k: sm[i] for i, k in enumerate(keys)}


def regress_coeffs(net: recon_mod.FaceRecon, frame_paths: list[str],
                   lms: dict[str, np.ndarray], cfg: PipelineConfig
                   ) -> dict[str, np.ndarray]:
    """Stage 3: align at 466.285 → 224² → ResNet-50 → 257 coeffs, one
    device call a batch of `cfg.batch_size` crops (test.py:91-105)."""
    device = next(net.parameters()).device
    names, batch224 = [], []
    coeffs: dict[str, np.ndarray] = {}

    def flush():
        if not batch224:
            return
        x = torch.from_numpy(np.stack(batch224)).to(device) \
            .permute(0, 3, 1, 2)
        with torch.inference_mode():
            out = net(x).cpu().numpy()
        coeffs.update(zip(names, out))
        names.clear()
        batch224.clear()

    for path in frame_paths:
        name = os.path.basename(path)
        if name not in lms:
            continue
        img = Image.open(path).convert("RGB")
        lm = align_mod.flip_landmarks_y(lms[name], img.size[1])
        _, img224, _, _ = align_mod.align_img(
            img, lm, cfg.lm3d_std, rescale_factor=cfg.rescale_recon)
        batch224.append(np.asarray(img224, np.float32) / 255.0)
        names.append(name)
        if len(batch224) >= cfg.batch_size:
            flush()
    flush()
    return coeffs


def crop_frames(frame_paths: list[str], lms: dict[str, np.ndarray],
                cfg: PipelineConfig, out_dir: str) -> list[str]:
    """Stage 4: re-align at rescale 300 → 1024² → center 700² → 512²
    (crop_images.py:108-131)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for path in frame_paths:
        name = os.path.basename(path)
        if name not in lms:
            continue
        img = Image.open(path).convert("RGB")
        lm = align_mod.flip_landmarks_y(lms[name], img.size[1])
        _, _, _, img1024 = align_mod.align_img(
            img, lm, cfg.lm3d_std, rescale_factor=cfg.rescale_crop)
        out = align_mod.crop_final(img1024, cfg.center_crop_size,
                                   cfg.output_size)
        dst = os.path.join(out_dir, name)
        out.save(dst)
        written.append(dst)
    return written


def make_labels(coeffs: dict[str, np.ndarray], out_dir: str) -> None:
    """Stages 5+6: coeffs → cameras.json → test.json (on the host: 25
    numbers a frame)."""
    names = sorted(coeffs)
    cd = split_coeff(torch.from_numpy(np.stack([coeffs[n] for n in names])))
    angles, trans = cd["angle"], cd["trans"]
    poses = pose_mod.pose_from_coeffs(angles, trans).numpy()
    labels = pose_mod.labels_from_coeffs(angles, trans).numpy()
    png_names = [n.rsplit(".", 1)[0] + ".png" for n in names]
    pose_mod.write_cameras_json(png_names, poses.reshape(len(names), 16),
                                angles.numpy(),
                                os.path.join(out_dir, "cameras.json"))
    pose_mod.write_label_json(png_names, labels,
                              os.path.join(out_dir, "test.json"))


def _chain_device(device, *nets) -> torch.device:
    """The one device of `device` and the given nets; raises when they
    disagree or when there is neither."""
    found = {_resolved(torch.device(device))} if device is not None else set()
    found |= {next(n.parameters()).device for n in nets if n is not None}
    if len(found) != 1:
        raise ValueError("process_video needs one device: pass `device` or "
                         f"nets on one device (got {sorted(map(str, found))})")
    return found.pop()


def _resolved(device: torch.device) -> torch.device:
    """`cuda` as the index its tensors report (`cuda:0`)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def process_video(in_dir: str, out_dir: str | None = None,
                  cfg: PipelineConfig | None = None,
                  mtcnn_net: mtcnn_mod.MTCNN | None = None,
                  recon_net: recon_mod.FaceRecon | None = None,
                  landmarks: dict[str, np.ndarray] | None = None,
                  device: torch.device | str | None = None) -> str:
    """Full chain over a directory of frames. Returns the cropped_images
    dir. `landmarks` skips stages 1-2 (for detections/*.txt that exist
    already); a net not given is made with random weights on the chain's
    device: `device`, or else the given nets' device."""
    device = _chain_device(device, mtcnn_net, recon_net)
    cfg = cfg or PipelineConfig()
    frames = list_frames(in_dir)
    if not frames:
        raise FileNotFoundError(f"no frames in {in_dir}")
    out_dir = out_dir or os.path.join(in_dir, "cropped_images")

    if landmarks is None:
        if mtcnn_net is None:
            mtcnn_net = mtcnn_mod.init_mtcnn(
                torch.Generator().manual_seed(0), device)
        landmarks = detect_landmarks(
            mtcnn_net, frames, cfg,
            out_dir=os.path.join(in_dir, "detections"))
        if not landmarks:
            raise RuntimeError("no faces detected")
        landmarks = smooth_landmarks(landmarks, cfg)

    if recon_net is None:
        recon_net = recon_mod.init_facerecon(
            torch.Generator().manual_seed(1), device)
    coeffs = regress_coeffs(recon_net, frames, landmarks, cfg)
    crop_frames(frames, landmarks, cfg, out_dir)
    make_labels(coeffs, out_dir)
    return out_dir


def load_detections(detection_dir: str, in_root: str
                    ) -> dict[str, np.ndarray]:
    """Read detections/*.txt (written by stage 1 or the reference), each
    keyed by the frame of the same stem in `in_root`: one entry a frame, so
    that smoothing runs over the frame sequence as `smooth_detection_dir`
    does. A detection without a frame is skipped."""
    frames = {os.path.basename(p).rsplit(".", 1)[0]: os.path.basename(p)
              for p in list_frames(in_root)}
    out = {}
    for f in sorted(os.listdir(detection_dir)):
        if f.endswith(".txt") and f[:-4] in frames:
            out[frames[f[:-4]]] = np.loadtxt(
                os.path.join(detection_dir, f)).astype(np.float32)
    return out
