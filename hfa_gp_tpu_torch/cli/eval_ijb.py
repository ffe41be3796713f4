"""IJB-B / IJB-C template-based evaluation CLI (counterpart of
hfa_gp_tpu/cli/eval_ijb.py).

    python -m hfa_gp_tpu_torch.cli.eval_ijb --image_path root \
        --network iresnet50 --weights w.npz [--target IJBC] [--result_dir out]

  * the insightface layout under `--image_path`:
    `meta/{target}_face_tid_mid.txt` (name tid mid),
    `meta/{target}_template_pair_label.txt` (tid1 tid2 label),
    `meta/{target}_name_5pts_score.txt` (name, 10 landmark floats,
    faceness score), images in `loose_crop/`;
  * each image is placed top-left on a `--canvas`² uint8 canvas on the host
    (an image larger than the canvas is first scaled down to fit, and its
    landmarks with it); on the device each batch is aligned to the 112²
    ArcFace crop by the 5-point similarity (`preprocess/warp.py`:
    `umeyama_similarity`, `warp_affine`), normalised and embedded, with
    the horizontal flip's embedding beside it;
  * flip-test "add" mode, norm-score and detector-score switches (the
    reference's F2, N1, D1 defaults);
  * media → template pooling, cosine pair scores and the TAR@FAR table;
    1:N rank-k when `meta/{target}_1N_gallery.txt` and
    `meta/{target}_1N_probe.txt` (`template_id subject_id` lines) exist.

Writes `{result_dir}/{job}_scores.npy` and `{job}_metrics.json`. `--weights`
is a flat npz in the JAX package's layout; without it a seeded random
backbone runs, with a warning. It runs on `--device cuda` unless told
`--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..models.arcface import ijb, registry
from ..preprocess.warp import ARCFACE_5PTS, umeyama_similarity, warp_affine
from . import common
from .eval_verification import load_backbone


def read_meta(image_path: str, target: str):
    """The three meta files → (names, tids, mids), (pairs, labels),
    (names2, landmarks (N, 5, 2), faceness (N,))."""
    meta = os.path.join(image_path, "meta")
    tl = target.lower()
    tm = np.loadtxt(os.path.join(meta, f"{tl}_face_tid_mid.txt"),
                    dtype=str, ndmin=2)
    names, tids, mids = (tm[:, 0], tm[:, 1].astype(np.int64),
                         tm[:, 2].astype(np.int64))
    pr = np.loadtxt(os.path.join(meta, f"{tl}_template_pair_label.txt"),
                    dtype=np.int64, ndmin=2)
    pairs, labels = pr[:, :2], pr[:, 2]
    ln = np.loadtxt(os.path.join(meta, f"{tl}_name_5pts_score.txt"),
                    dtype=str, ndmin=2)
    lm = ln[:, 1:11].astype(np.float32).reshape(-1, 5, 2)
    faceness = ln[:, 11].astype(np.float32)
    return (names, tids, mids), (pairs, labels), (ln[:, 0], lm, faceness)


def _load_canvas(path: str, canvas: int):
    """Image → uint8 (canvas, canvas, 3), placed top-left, and the scale
    applied (the landmarks are multiplied by it)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = 1.0
    if max(w, h) > canvas:
        scale = canvas / max(w, h)
        img = img.resize((max(int(w * scale), 1), max(int(h * scale), 1)),
                         Image.BILINEAR)
        w, h = img.size
    out = np.zeros((canvas, canvas, 3), np.uint8)
    out[:h, :w] = np.asarray(img, np.uint8)
    return out, scale


def make_embedder(network: str, params, stats, flip: bool,
                  device: torch.device):
    """(B, canvas, canvas, 3) uint8 and (B, 5, 2) raster landmarks (numpy)
    → (B, 2D) numpy [embedding ‖ flipped embedding (zeros without
    flip)]. The similarity maps the raw raster landmarks onto the ArcFace
    points (IJB landmarks are already y-down)."""
    dst = torch.as_tensor(ARCFACE_5PTS, device=device)

    @torch.no_grad()
    def run(imgs_u8: np.ndarray, lm5: np.ndarray) -> np.ndarray:
        lm = torch.from_numpy(lm5).to(device=device, dtype=torch.float32)
        m = umeyama_similarity(lm, dst.expand(lm.shape[:-2] + (5, 2)))
        x = warp_affine(torch.from_numpy(imgs_u8).to(device).float(), m, 112)
        x = (x / 255.0 - 0.5) / 0.5
        e = registry.backbone_apply(network, params, stats, x)
        if flip:
            ef = registry.backbone_apply(network, params, stats,
                                         torch.flip(x, dims=[2]))
        else:
            ef = torch.zeros_like(e)
        return torch.cat([e, ef], dim=-1).cpu().numpy()

    return run


def extract_features(args, device: torch.device, names, lms,
                     faceness) -> np.ndarray:
    """Every listed crop → its feature (embedding, plus the flip's in
    "add" mode), batched on the device."""
    params, stats = load_backbone(args.network, args.weights, device)
    run = make_embedder(args.network, params, stats, not args.no_flip,
                        device)
    n = len(names)
    feats = None
    img_dir = os.path.join(args.image_path, "loose_crop")
    for start in range(0, n, args.batch_size):
        idx = range(start, min(start + args.batch_size, n))
        imgs, lm = [], []
        for i in idx:
            arr, scale = _load_canvas(os.path.join(img_dir, names[i]),
                                      args.canvas)
            imgs.append(arr)
            lm.append(lms[i] * scale)
        out = run(np.stack(imgs), np.stack(lm).astype(np.float32))
        if feats is None:
            feats = np.empty((n, out.shape[1]), np.float32)
        feats[start:start + len(idx)] = out
        if (start // args.batch_size) % 50 == 0:
            print(f"embedded {start + len(idx)}/{n}", flush=True)

    d = feats.shape[1] // 2
    feats = feats[:, :d] if args.no_flip else feats[:, :d] + feats[:, d:]
    if args.no_norm_score:                            # N1 off
        feats = feats / np.maximum(
            np.linalg.norm(feats, axis=1, keepdims=True), 1e-10)
    if not args.no_detector_score:                    # D1
        feats = feats * faceness[:, None]
    return feats


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="IJB-B/C evaluation")
    p.add_argument("--image_path", type=str, required=True,
                   help="root with meta/ and loose_crop/")
    p.add_argument("--target", type=str, default="IJBC",
                   choices=["IJBC", "IJBB"])
    p.add_argument("--network", type=str, default="iresnet50")
    p.add_argument("--weights", type=str, default=None,
                   help="flat npz (JAX layout) of the backbone")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--canvas", type=int, default=256,
                   help="host-side canvas the loose crops are placed on "
                        "before the on-device align + embed")
    p.add_argument("--result_dir", type=str, default=None)
    p.add_argument("--job", type=str, default="hfa_gp_tpu")
    p.add_argument("--no_flip", action="store_true",
                   help="disable the horizontal-flip test (F2 off)")
    p.add_argument("--no_norm_score", action="store_true",
                   help="unit-normalize features (N1 off)")
    p.add_argument("--no_detector_score", action="store_true",
                   help="don't weight by faceness (D1 off)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the alignment and backbone run on")
    return p


def main(args) -> dict:
    device = common.device_from_args(args)
    (names_t, tids, mids), (pairs, labels), (names_l, lms, faceness) = \
        read_meta(args.image_path, args.target)
    # the tid/mid list and the landmark list enumerate the same crops in
    # the same order (the insightface layout); check the lengths
    if len(names_t) != len(names_l):
        raise ValueError(f"meta files list {len(names_t)} and "
                         f"{len(names_l)} crops")

    feats = extract_features(args, device, names_l, lms, faceness)

    templates, uniq = ijb.pool_templates(feats, tids, mids)
    scores = ijb.verification_scores(templates, uniq, pairs)
    tar = ijb.tar_at_far(scores, labels)

    print(f"{args.target} 1:1 verification ({args.job}, "
          f"{len(scores)} pairs)")
    print("  " + " | ".join(f"1e{int(np.log10(f)):+d}"
                            for f in sorted(tar)))
    print("  " + " | ".join(f"{100 * tar[f]:6.2f}" for f in sorted(tar)))

    metrics = {"tar_at_far": {f"{f:.0e}": v for f, v in tar.items()}}

    meta = os.path.join(args.image_path, "meta")
    tl = args.target.lower()
    gal_p = os.path.join(meta, f"{tl}_1N_gallery.txt")
    prb_p = os.path.join(meta, f"{tl}_1N_probe.txt")
    if os.path.exists(gal_p) and os.path.exists(prb_p):
        row = {int(t): i for i, t in enumerate(uniq)}
        gal = np.loadtxt(gal_p, dtype=np.int64, ndmin=2)
        prb = np.loadtxt(prb_p, dtype=np.int64, ndmin=2)
        g = templates[[row[int(t)] for t in gal[:, 0]]]
        p = templates[[row[int(t)] for t in prb[:, 0]]]
        ranks = ijb.rank_k_identification(p, g, prb[:, 1], gal[:, 1])
        print("  1:N rank-k: " + "  ".join(
            f"R{k}={100 * v:.2f}" for k, v in ranks.items()))
        metrics["rank_k"] = {str(k): v for k, v in ranks.items()}

    if args.result_dir:
        os.makedirs(args.result_dir, exist_ok=True)
        np.save(os.path.join(args.result_dir, f"{args.job}_scores.npy"),
                scores)
        with open(os.path.join(args.result_dir,
                               f"{args.job}_metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main(build_argparser().parse_args())
