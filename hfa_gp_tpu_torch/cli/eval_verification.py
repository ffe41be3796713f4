"""Face-verification evaluation CLI (counterpart of
hfa_gp_tpu/cli/eval_verification.py).

    python -m hfa_gp_tpu_torch.cli.eval_verification --network iresnet50 \
        --weights w.npz (--bin lfw.bin | --synthetic) [--pca 0] \
        [--roc_out roc.png]

Loads an LFW-style .bin pair set (a pickled (image bytes list, issame
list), read with pickle and PIL, no mxnet), embeds every crop and its
horizontal flip with the chosen backbone in eval mode, and prints the
K-fold accuracy and best threshold in the JAX CLI's words. `--weights` is
a flat npz in the JAX package's layout, `{params/…, batch_stats/…}`
(`pytree_io.save_npz` of the JAX package, or `model.npz` of the port's
`train_arcface --export`); without it a seeded random backbone runs, with
a warning. `--synthetic` runs the protocol without data (two noisy views
per identity). It runs on `--device cuda` unless told `--device cpu`.
"""

from __future__ import annotations

import argparse
import io
import pickle

import numpy as np
import torch

from ..models.arcface import convert, registry
from ..models.arcface.verification import evaluate_pairs
from ..utils.convert import load_npz
from . import common


def load_bin(path: str, size: int = 112):
    """LFW-style .bin → (images1, images2, issame). Images are float32
    NHWC in [-1, 1]."""
    from PIL import Image
    with open(path, "rb") as f:
        try:
            bins, issame = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            bins, issame = pickle.load(f, encoding="bytes")
    imgs = []
    for b in bins:
        data = bytes(b) if not isinstance(b, bytes) else b
        img = Image.open(io.BytesIO(data)).convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        imgs.append((np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5)
    imgs = np.stack(imgs)
    return imgs[0::2], imgs[1::2], np.asarray(issame, bool)


def synthetic_pairs(n: int = 128, size: int = 112, seed: int = 0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    same = base + 0.05 * rng.standard_normal(base.shape).astype(np.float32)
    diff = rng.standard_normal(base.shape).astype(np.float32)
    img1 = np.concatenate([base, base])
    img2 = np.concatenate([same, diff])
    issame = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
    return img1, img2, issame


def load_backbone(network: str, weights: str | None, device: torch.device):
    """(params, batch_stats) on `device`: from a JAX-layout npz, or seeded
    random with a warning."""
    if weights:
        tree = load_npz(weights)
        return convert.backbone_from_jax(network, tree["params"],
                                         tree["batch_stats"], device)
    print(f"WARNING: no --weights given — evaluating {network} with RANDOM "
          "weights (protocol smoke test only)")
    return registry.init_backbone(torch.Generator().manual_seed(0), network,
                                  device=device)


def make_embed_fn(network: str, params, stats, device: torch.device):
    """numpy (B, H, W, 3) → numpy (B, D) embeddings, eval mode, fp32."""
    @torch.no_grad()
    def embed(x: np.ndarray) -> np.ndarray:
        return registry.backbone_apply(
            network, params, stats, torch.from_numpy(x).to(device)).cpu() \
            .numpy()
    return embed


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--network", type=str, default="iresnet50")
    p.add_argument("--weights", type=str, default=None,
                   help="flat npz (JAX layout) of the backbone")
    p.add_argument("--bin", type=str, default=None,
                   help="LFW-style .bin pair file")
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--pca", type=int, default=0,
                   help="per-fold PCA dims (reference verification.py:76)")
    p.add_argument("--roc_out", type=str, default=None,
                   help="write an ROC curve plot (png) here")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the backbone runs on")
    return p


def main(args) -> tuple[float, float, float]:
    device = common.device_from_args(args)
    params, stats = load_backbone(args.network, args.weights, device)
    embed = make_embed_fn(args.network, params, stats, device)

    if args.bin:
        img1, img2, issame = load_bin(args.bin)
    elif args.synthetic:
        img1, img2, issame = synthetic_pairs()
    else:
        raise SystemExit("need --bin or --synthetic")

    acc, std, thr = evaluate_pairs(embed, img1, img2, issame,
                                   batch_size=args.batch_size,
                                   pca=args.pca, roc_out=args.roc_out)
    print(f"accuracy {acc:.4f} ± {std:.4f} (threshold {thr:.3f}, "
          f"{len(issame)} pairs, {args.network}"
          + (f", pca {args.pca}" if args.pca else "") + ")")
    return acc, std, thr


if __name__ == "__main__":
    main(build_argparser().parse_args())
