"""Pretrained MTCNN weights → the JAX-layout flat npz that the port's
`process_video --mtcnn_weights` reads (counterpart of the repository's
tools/convert_mtcnn.py, without JAX). Two distributions of the same
Caffe model:

1. facenet-pytorch state dicts (pnet.pt / rnet.pt / onet.pt: `conv1.weight`,
   `prelu1.weight`, `dense5_1.weight`, ...):

       python -m hfa_gp_tpu_torch.tools.convert_mtcnn --pnet pnet.pt \
           --rnet rnet.pt --onet onet.pt --out mtcnn.npz

   Convs OIHW → HWIO; the FC layers' inputs were flattened after
   `permute(0, 3, 2, 1)` (the Matlab order, (W, H, C)), so their columns
   are reordered to the (H, W, C) flatten of the JAX layout; PReLU slopes
   as vectors.

2. David Sandberg's TF dicts (det1.npy / det2.npy / det3.npy, layer →
   {"weights", "biases", "alpha"}):

       python -m hfa_gp_tpu_torch.tools.convert_mtcnn --det_dir dets/ \
           --out mtcnn.npz [--no-transpose]

   Sandberg's runtime feeds transposed images (the Matlab legacy). By
   default that protocol is baked into the weights (`bake_transpose`):
   H/W-transposed kernels, the FC flatten's spatial order swapped, the
   box-regression pairs and landmark halves swapped, so the nets run on
   images the right way up.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..utils.convert import save_npz
from .convert_pickle import n_parameters


def _conv_from_torch(w: np.ndarray, b: np.ndarray,
                     alpha: np.ndarray | None) -> dict:
    """torch Conv2d (out, in, kh, kw) → HWIO."""
    p = {"weight": np.transpose(w, (2, 3, 1, 0)).astype(np.float32),
         "bias": b.astype(np.float32)}
    if alpha is not None:
        p["prelu"] = alpha.reshape(-1).astype(np.float32)
    return p


def _fc_from_torch(w: np.ndarray, b: np.ndarray, spatial: tuple[int, int],
                   channels: int, alpha: np.ndarray | None = None) -> dict:
    """torch Linear over a (W, H, C) flatten → the (H, W, C) order."""
    out_dim = w.shape[0]
    wd, ht = spatial
    w4 = np.transpose(w.reshape(out_dim, wd, ht, channels), (0, 2, 1, 3))
    p = {"weight": w4.reshape(out_dim, -1).astype(np.float32),
         "bias": b.astype(np.float32)}
    if alpha is not None:
        p["prelu"] = alpha.reshape(-1).astype(np.float32)
    return p


def _fc_plain(w: np.ndarray, b: np.ndarray) -> dict:
    return {"weight": w.astype(np.float32), "bias": b.astype(np.float32)}


def _head_conv(g: dict, name: str) -> dict:
    return {"weight": np.transpose(g[f"{name}.weight"],
                                   (2, 3, 1, 0)).astype(np.float32),
            "bias": g[f"{name}.bias"].astype(np.float32)}


def _convs(g: dict, n: int) -> dict:
    return {f"c{i}": _conv_from_torch(g[f"conv{i}.weight"],
                                      g[f"conv{i}.bias"],
                                      g[f"prelu{i}.weight"])
            for i in range(1, n + 1)}


def convert_facenet_pytorch(pnet_sd: dict, rnet_sd: dict,
                            onet_sd: dict) -> dict:
    """facenet-pytorch state dicts (numpy values) → the mtcnn params."""
    g = {k: np.asarray(v) for k, v in pnet_sd.items()}
    pnet = {**_convs(g, 3), "prob": _head_conv(g, "conv4_1"),
            "reg": _head_conv(g, "conv4_2")}
    g = {k: np.asarray(v) for k, v in rnet_sd.items()}
    rnet = {**_convs(g, 3),
            "fc": _fc_from_torch(g["dense4.weight"], g["dense4.bias"],
                                 (3, 3), 64, g["prelu4.weight"]),
            "prob": _fc_plain(g["dense5_1.weight"], g["dense5_1.bias"]),
            "reg": _fc_plain(g["dense5_2.weight"], g["dense5_2.bias"])}
    g = {k: np.asarray(v) for k, v in onet_sd.items()}
    onet = {**_convs(g, 4),
            "fc": _fc_from_torch(g["dense5.weight"], g["dense5.bias"],
                                 (3, 3), 128, g["prelu5.weight"]),
            "prob": _fc_plain(g["dense6_1.weight"], g["dense6_1.bias"]),
            "reg": _fc_plain(g["dense6_2.weight"], g["dense6_2.bias"]),
            "lmk": _fc_plain(g["dense6_3.weight"], g["dense6_3.bias"])}
    return {"pnet": pnet, "rnet": rnet, "onet": onet}


# -- Sandberg's transposed-image protocol -----------------------------------


def _swap_reg(p: dict) -> dict:
    """(dx1, dy1, dx2, dy2) ↔ (dy1, dx1, dy2, dx2) on the output axis (a
    conv head's last, an FC head's first)."""
    perm = np.array([1, 0, 3, 2])
    w = p["weight"]
    if w.ndim == 4:
        return {"weight": w[..., perm], "bias": p["bias"][perm]}
    return {"weight": w[perm], "bias": p["bias"][perm]}


def _swap_lmk(p: dict) -> dict:
    """The Matlab layout (5 x, then 5 y) with x and y swapped."""
    perm = np.concatenate([np.arange(5, 10), np.arange(5)])
    return {"weight": p["weight"][perm], "bias": p["bias"][perm]}


def _t_conv(p: dict) -> dict:
    return {**p, "weight": np.transpose(p["weight"], (1, 0, 2, 3))}


def _t_fc(p: dict, spatial: tuple[int, int], channels: int) -> dict:
    h, w = spatial
    w4 = p["weight"].reshape(-1, h, w, channels)
    return {**p, "weight": np.transpose(w4, (0, 2, 1, 3)).reshape(
        p["weight"].shape)}


def bake_transpose(params: dict) -> dict:
    """Weights whose nets on an image equal the original nets on its
    transpose, with the outputs mapped back."""
    pn, rn, on = params["pnet"], params["rnet"], params["onet"]
    pnet = {"c1": _t_conv(pn["c1"]), "c2": _t_conv(pn["c2"]),
            "c3": _t_conv(pn["c3"]),
            "prob": {"weight": np.transpose(pn["prob"]["weight"],
                                            (1, 0, 2, 3)),
                     "bias": pn["prob"]["bias"]},
            "reg": _swap_reg({"weight": np.transpose(
                pn["reg"]["weight"], (1, 0, 2, 3)),
                "bias": pn["reg"]["bias"]})}
    rnet = {"c1": _t_conv(rn["c1"]), "c2": _t_conv(rn["c2"]),
            "c3": _t_conv(rn["c3"]), "fc": _t_fc(rn["fc"], (3, 3), 64),
            "prob": rn["prob"], "reg": _swap_reg(rn["reg"])}
    onet = {"c1": _t_conv(on["c1"]), "c2": _t_conv(on["c2"]),
            "c3": _t_conv(on["c3"]), "c4": _t_conv(on["c4"]),
            "fc": _t_fc(on["fc"], (3, 3), 128), "prob": on["prob"],
            "reg": _swap_reg(on["reg"]), "lmk": _swap_lmk(on["lmk"])}
    return {"pnet": pnet, "rnet": rnet, "onet": onet}


def convert_sandberg(det_dir: str, transpose: bool = True) -> dict:
    """det1/det2/det3.npy → the mtcnn params. TF conv kernels are HWIO
    already; FC matrices are (in, out)."""
    def load(name):
        d = np.load(os.path.join(det_dir, name), allow_pickle=True,
                    encoding="latin1").item()
        # layer names differ in case between mirrors (PReLU1 / prelu1)
        return {k.lower(): {kk: np.asarray(vv) for kk, vv in v.items()}
                for k, v in d.items()}

    def conv(d, cname, pname=None):
        p = {"weight": d[cname]["weights"].astype(np.float32),
             "bias": d[cname]["biases"].astype(np.float32)}
        if pname is not None:
            p["prelu"] = d[pname]["alpha"].reshape(-1).astype(np.float32)
        return p

    def fc(d, cname, pname=None):
        p = {"weight": d[cname]["weights"].T.astype(np.float32),
             "bias": d[cname]["biases"].astype(np.float32)}
        if pname is not None:
            p["prelu"] = d[pname]["alpha"].reshape(-1).astype(np.float32)
        return p

    d1, d2, d3 = load("det1.npy"), load("det2.npy"), load("det3.npy")
    params = {
        "pnet": {"c1": conv(d1, "conv1", "prelu1"),
                 "c2": conv(d1, "conv2", "prelu2"),
                 "c3": conv(d1, "conv3", "prelu3"),
                 "prob": conv(d1, "conv4-1"), "reg": conv(d1, "conv4-2")},
        "rnet": {"c1": conv(d2, "conv1", "prelu1"),
                 "c2": conv(d2, "conv2", "prelu2"),
                 "c3": conv(d2, "conv3", "prelu3"),
                 "fc": fc(d2, "conv4", "prelu4"),
                 "prob": fc(d2, "conv5-1"), "reg": fc(d2, "conv5-2")},
        "onet": {"c1": conv(d3, "conv1", "prelu1"),
                 "c2": conv(d3, "conv2", "prelu2"),
                 "c3": conv(d3, "conv3", "prelu3"),
                 "c4": conv(d3, "conv4", "prelu4"),
                 "fc": fc(d3, "conv5", "prelu5"),
                 "prob": fc(d3, "conv6-1"), "reg": fc(d3, "conv6-2"),
                 "lmk": fc(d3, "conv6-3")},
    }
    return bake_transpose(params) if transpose else params


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pnet")
    ap.add_argument("--rnet")
    ap.add_argument("--onet")
    ap.add_argument("--det_dir", help="directory with det1/2/3.npy")
    ap.add_argument("--no-transpose", dest="transpose",
                    action="store_false", default=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    if args.det_dir:
        params = convert_sandberg(args.det_dir, args.transpose)
    elif args.pnet and args.rnet and args.onet:
        sds = [torch.load(p, map_location="cpu", weights_only=True)
               for p in (args.pnet, args.rnet, args.onet)]
        params = convert_facenet_pytorch(
            *[{k: v.numpy() for k, v in sd.items()} for sd in sds])
    else:
        ap.error("need --det_dir or all of --pnet/--rnet/--onet")
    save_npz(params, args.out)
    print(f"wrote {args.out} ({n_parameters(params):,} parameters)")


if __name__ == "__main__":
    main()
