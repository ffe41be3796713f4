"""LPIPS (AlexNet) weights → the JAX-layout flat npz that the port's
`--lpips_weights` reads (counterpart of the repository's
tools/convert_lpips.py, without JAX).

    python -m hfa_gp_tpu_torch.tools.convert_lpips lpips_alex.pt lpips.npz
    python -m hfa_gp_tpu_torch.tools.convert_lpips auto lpips.npz

The source is the `lpips` package's state dict: `net.slice{1..5}.<i>.weight
/ bias`, AlexNet's five convs (OIHW), and `lin{0..4}.model.1.weight`, the
(1, C, 1, 1) heads. `auto` builds it from an installed `lpips` package and
raises ImportError without one. The output is `conv{i}` (HWIO weight, bias)
and `lin{i}` ((C,) weight), the tree of `models/lpips.init_lpips`.
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from ..utils.convert import save_npz


def convert(sd: dict) -> dict:
    """The `lpips` state dict (tensors or arrays) → the LPIPS tree."""
    convs, lins = {}, {}
    for k, v in sd.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if ".features." in k or ".slice" in k:
            convs[k] = v
        elif k.startswith("lin"):
            lins[k] = v
    # AlexNet's convs in order of their numeric indices
    conv_ws = sorted((k for k in convs if k.endswith("weight")),
                     key=lambda k: [int(t) for t in re.findall(r"\d+", k)])
    tree: dict = {}
    for i, wk in enumerate(conv_ws):
        tree[f"conv{i}"] = {
            "weight": np.ascontiguousarray(convs[wk].transpose(2, 3, 1, 0)),
            "bias": convs[wk[:-6] + "bias"]}
    for i in range(5):
        for cand in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if cand in lins:
                tree[f"lin{i}"] = {"weight": lins[cand].reshape(-1)}
                break
    missing = [n for i in range(5) for n in (f"conv{i}", f"lin{i}")
               if n not in tree]
    if missing:
        raise KeyError(f"not an LPIPS AlexNet state dict: no {missing} "
                       f"(found {sorted(tree)})")
    return tree


def load_source(src: str) -> dict:
    """A saved state dict, or with `auto` the `lpips` package's own."""
    if src != "auto":
        return torch.load(src, map_location="cpu")
    try:
        import lpips
    except ImportError as e:
        raise ImportError("convert_lpips auto needs the `lpips` package "
                          "(pip install lpips) and its downloaded weights; "
                          "or pass a saved state dict") from e
    return lpips.LPIPS(net="alex").state_dict()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="LPIPS state dict (.pt), or 'auto'")
    p.add_argument("out", help="output npz")
    args = p.parse_args(argv)
    save_npz(convert(load_source(args.src)), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
