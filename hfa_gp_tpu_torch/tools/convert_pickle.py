"""EG3D generator pickle → the JAX-layout flat npz that the port's CLIs read
(`--eg3d_weights`; counterpart of the repository's
tools/convert_pickle.py, without JAX).

    python -m hfa_gp_tpu_torch.tools.convert_pickle \
        ffhqrebalanced512-128.pkl eg3d.npz

NVIDIA's `torch_utils.persistence` pickles each network as
`_reconstruct_persistent_obj(meta)`, where `meta["state"]` is the module's
`__dict__`. Neither `dnnlib` nor `torch_utils` is needed: every class of
`dnnlib`, `torch_utils`, `training` or `legacy` unpickles as a dict that
keeps its state. The tensors of `G_ema` (or of the whole pickle, when it
has no `G_ema`) are collected under their `state_dict` names: the path of
attributes with `state`, `_modules`, `_parameters` and `_buffers` left out,
so a pickle of persistent modules and a pickle of a flat state dict give
the same names.

Layout (torch NCHW → the JAX package's NHWC), which the port's
`utils/convert.convert_tree` undoes on load:
  * conv weights OIHW → HWIO;
  * `conv0` of an up-sampling block (every synthesis block above b4 and
    both SR blocks) is also flipped in both spatial axes: the JAX up path
    is zero-stuffing then correlation, a transposed conv with a flipped
    kernel;
  * the `const` input (C, H, W) → (H, W, C);
  * FC and affine weights keep torch's (out, in).
"""

from __future__ import annotations

import argparse
import pickle
import re
from typing import Any

import numpy as np
import torch

from ..utils.convert import save_npz

# path components of a pickled module that are not part of its state_dict
# names: the persistence wrapper's `state` and nn.Module's containers
_CONTAINERS = frozenset(("state", "_modules", "_parameters", "_buffers"))


class _Captured(dict):
    """Stand-in for any persisted NVIDIA object: keeps the pickled state."""

    def __init__(self, *a, **kw):
        super().__init__()

    def __setstate__(self, state):
        self.update(state if isinstance(state, dict) else {"state": state})


def _reconstruct_persistent_obj(meta) -> _Captured:
    obj = _Captured()
    obj.update(meta if isinstance(meta, dict) else {"meta": meta})
    return obj


class _StubUnpickler(pickle.Unpickler):
    _OURS = re.compile(r"^(dnnlib|torch_utils|training|legacy)")

    def find_class(self, module: str, name: str):
        if self._OURS.match(module):
            if name == "_reconstruct_persistent_obj":
                return _reconstruct_persistent_obj
            return _Captured
        return super().find_class(module, name)


def load_pickle_states(path: str) -> Any:
    """The pickle's objects, NVIDIA's classes as `_Captured` dicts."""
    with open(path, "rb") as f:
        return _StubUnpickler(f).load()


def state_dict(obj) -> dict[str, np.ndarray]:
    """Every tensor under `obj` by its state_dict name (see the module
    docstring), as numpy."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path: tuple[str, ...]) -> None:
        if isinstance(node, torch.Tensor):
            out[".".join(p for p in path if p not in _CONTAINERS)] = \
                node.detach().cpu().numpy()
        elif isinstance(node, torch.nn.Module):
            walk(vars(node), path)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, (*path, str(k)))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, (*path, str(i)))

    walk(obj, ())
    return out


def _conv_hwio(w: np.ndarray, flip: bool = False) -> np.ndarray:
    w = w.transpose(2, 3, 1, 0)          # OIHW → HWIO
    if flip:
        w = w[::-1, ::-1]
    return np.ascontiguousarray(w)


def convert_generator(sd: dict[str, np.ndarray]) -> dict:
    """G_ema state dict (numpy values) → the JAX package's EG3D params
    tree."""
    tree: dict[str, Any] = {"mapping": {}, "backbone": {}, "decoder": {},
                            "superresolution": {}}

    def put(dst: dict, path: list[str], val: np.ndarray) -> None:
        for p in path[:-1]:
            dst = dst.setdefault(p, {})
        dst[path[-1]] = val

    def convert_block(src: str, dst: dict, *, up: bool) -> None:
        for conv in ("conv0", "conv1"):
            if f"{src}.{conv}.weight" not in sd:
                continue
            flip = up and conv == "conv0"
            put(dst, [conv, "weight"],
                _conv_hwio(sd[f"{src}.{conv}.weight"], flip=flip))
            put(dst, [conv, "bias"], sd[f"{src}.{conv}.bias"])
            put(dst, [conv, "affine", "weight"],
                sd[f"{src}.{conv}.affine.weight"])
            put(dst, [conv, "affine", "bias"], sd[f"{src}.{conv}.affine.bias"])
            ns = f"{src}.{conv}.noise_strength"
            if ns in sd:
                put(dst, [conv, "noise_strength"], sd[ns])
                put(dst, [conv, "noise_const"],
                    sd[f"{src}.{conv}.noise_const"])
        if f"{src}.const" in sd:
            dst["const"] = np.ascontiguousarray(
                sd[f"{src}.const"].transpose(1, 2, 0))
        t = f"{src}.torgb"
        if f"{t}.weight" in sd:
            put(dst, ["torgb", "weight"], _conv_hwio(sd[f"{t}.weight"]))
            put(dst, ["torgb", "bias"], sd[f"{t}.bias"])
            put(dst, ["torgb", "affine", "weight"], sd[f"{t}.affine.weight"])
            put(dst, ["torgb", "affine", "bias"], sd[f"{t}.affine.bias"])

    for k, v in sd.items():
        m = re.fullmatch(r"backbone\.mapping\.(fc\d+)\.(weight|bias)", k)
        if m:
            put(tree["mapping"], [m.group(1), m.group(2)], v)
    if "backbone.mapping.embed.weight" in sd:
        tree["mapping"]["embed"] = {
            "weight": sd["backbone.mapping.embed.weight"],
            "bias": sd["backbone.mapping.embed.bias"]}
    if "backbone.mapping.w_avg" in sd:
        tree["mapping"]["w_avg"] = sd["backbone.mapping.w_avg"]

    resolutions = sorted({int(m.group(1)) for k in sd for m in [re.match(
        r"backbone\.synthesis\.b(\d+)\.", k)] if m})
    for res in resolutions:
        convert_block(f"backbone.synthesis.b{res}",
                      tree["backbone"].setdefault(f"b{res}", {}),
                      up=res != 4)

    # the OSG decoder: net.0 / net.2 around the softplus
    tree["decoder"]["fc0"] = {"weight": sd["decoder.net.0.weight"],
                              "bias": sd["decoder.net.0.bias"]}
    tree["decoder"]["fc1"] = {"weight": sd["decoder.net.2.weight"],
                              "bias": sd["decoder.net.2.bias"]}

    for blk in ("block0", "block1"):
        convert_block(f"superresolution.{blk}",
                      tree["superresolution"].setdefault(blk, {}), up=True)
    return tree


def n_parameters(tree: dict) -> int:
    """The number of array elements in a nested dict of arrays."""
    return sum(n_parameters(v) if isinstance(v, dict) else np.size(v)
               for v in tree.values())


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pkl", help="EG3D network pickle (e.g. "
                               "ffhqrebalanced512-128.pkl)")
    p.add_argument("out", help="output npz")
    args = p.parse_args(argv)
    data = load_pickle_states(args.pkl)
    g_ema = data.get("G_ema", data) if isinstance(data, dict) else data
    tree = convert_generator(state_dict(g_ema))
    save_npz(tree, args.out)
    print(f"wrote {args.out} ({n_parameters(tree):,} parameters)")


if __name__ == "__main__":
    main()
