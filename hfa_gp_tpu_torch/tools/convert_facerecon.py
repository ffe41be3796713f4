"""Deep3DFaceRecon checkpoint → the JAX-layout flat npz that the port's
`process_video --recon_weights` reads (counterpart of the repository's
tools/convert_facerecon.py, without JAX).

    python -m hfa_gp_tpu_torch.tools.convert_facerecon epoch_20.pth \
        facerecon.npz

The source is the checkpoint of the reference's FaceReconModel
(eg3d-pose-detection/models/facerecon_model.py): the `net_recon` state
dict, a torchvision ResNet-50 under `backbone.` and seven 1×1 coefficient
heads under `final_layers.`, bare or wrapped in "net_recon",
"state_dict" or "model", with or without a `module.` prefix. The output is
the tree of the JAX package's `preprocess.facerecon`: HWIO convs, BN as
scale / bias / mean / var, `s{stage}_b{i}` blocks and `head{0..6}`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..utils.convert import save_npz

_LAYERS = (3, 4, 6, 3)


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _bn(sd: dict, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"],
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}


def convert(sd: dict) -> dict:
    """State dict (numpy values) → the facerecon params tree."""
    for wrap in ("net_recon", "state_dict", "model"):
        if wrap in sd and isinstance(sd[wrap], dict):
            sd = sd[wrap]
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def pick(name: str) -> str:
        for cand in (name, f"backbone.{name}"):
            if cand in sd:
                return cand
        raise KeyError(name)

    tree: dict = {"stem_conv": _hwio(sd[pick("conv1.weight")]),
                  "stem_bn": _bn(sd, pick("bn1.weight").rsplit(".", 1)[0])}
    for stage, blocks in enumerate(_LAYERS):
        for i in range(blocks):
            pre = pick(f"layer{stage + 1}.{i}.conv1.weight") \
                .rsplit(".conv1.weight", 1)[0]
            blk = {"conv1": _hwio(sd[f"{pre}.conv1.weight"]),
                   "bn1": _bn(sd, f"{pre}.bn1"),
                   "conv2": _hwio(sd[f"{pre}.conv2.weight"]),
                   "bn2": _bn(sd, f"{pre}.bn2"),
                   "conv3": _hwio(sd[f"{pre}.conv3.weight"]),
                   "bn3": _bn(sd, f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = _hwio(sd[f"{pre}.downsample.0.weight"])
                blk["down_bn"] = _bn(sd, f"{pre}.downsample.1")
            tree[f"s{stage}_b{i}"] = blk
    for i in range(7):
        pre = pick(f"final_layers.{i}.weight").rsplit(".weight", 1)[0]
        tree[f"head{i}"] = {"weight": _hwio(sd[f"{pre}.weight"]),
                            "bias": sd[f"{pre}.bias"]}
    return tree


def _to_np(d: dict) -> dict:
    return {k: _to_np(v) if isinstance(v, dict)
            else (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
            for k, v in d.items()}


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="Deep3DFaceRecon checkpoint (epoch_20.pth)")
    p.add_argument("out", help="output npz")
    args = p.parse_args(argv)
    save_npz(convert(_to_np(torch.load(args.src, map_location="cpu"))),
             args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
