"""JAX arcface state → the port's (numpy arrays in, `ParamTree`s out), and
back (`backbone_to_jax`, for the npz that `--export` writes).

  * every 4-D leaf is a conv weight (the iresnets' `stem_conv`, `conv1`,
    `conv2`, `down_conv`; MobileFaceNet's `w`, grouped ones included):
    HWIO → OIHW;
  * the iresnets' `fc/weight` (embedding_dim, h·w·c): the JAX package
    flattens NHWC, the port NCHW, so its columns go from (h, w, c) order
    to (c, h, w). MobileFaceNet's FC follows a 1 × 1 map and needs no
    permutation;
  * the ViTs have no 4-D leaf: every linear weight is (out, in) in both
    packages and the port's patch embedding is the same linear layer, so
    their trees carry over unchanged;
  * everything else (BN scale / bias, PReLU alpha, FC bias, the running
    moments, the PartialFC table) carries over as it is. The running
    variance is the biased batch variance in both packages.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...utils.convert import ParamTree
from . import iresnet, registry

_FINAL_CHANNELS = 512


def _convert_params(tree: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _convert_params(v)
            continue
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        out[k] = t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t
    return out


def iresnet_from_jax(params: dict[str, Any], batch_stats: dict[str, Any],
                     device: torch.device | str = "cpu"
                     ) -> tuple[ParamTree, ParamTree]:
    """JAX iresnet `params` and `batch_stats` (nested dicts of arrays) →
    the port's (params, batch_stats)."""
    p = _convert_params(params)
    w = p["fc"]["weight"]
    e, fc_in = w.shape
    hw = fc_in // _FINAL_CHANNELS
    p["fc"]["weight"] = w.reshape(e, hw, _FINAL_CHANNELS).permute(0, 2, 1) \
        .reshape(e, fc_in).contiguous()
    return (ParamTree(p).to(device),
            ParamTree(_convert_params(batch_stats)).to(device))


def backbone_from_jax(name: str, params: dict[str, Any],
                      batch_stats: dict[str, Any],
                      device: torch.device | str = "cpu"
                      ) -> tuple[ParamTree, ParamTree]:
    """Any backbone of `registry.backbone_names()` (or an alias): the JAX
    `init_backbone` output or a `load_npz` tree → the port's. The iresnets
    permute their FC columns; every other family only turns its 4-D leaves
    HWIO → OIHW (a ViT has none, so its tree carries over unchanged)."""
    name = registry.canonical_name(name)
    if name not in registry.backbone_names():
        raise ValueError(f"unknown backbone {name!r}; available: "
                         f"{registry.backbone_names()}")
    if name in iresnet.IRESNET_LAYERS:
        return iresnet_from_jax(params, batch_stats, device)
    return (ParamTree(_convert_params(params)).to(device),
            ParamTree(_convert_params(batch_stats)).to(device))


def _to_jax_tree(tree) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_jax_tree(v)
            continue
        t = v.detach().float().cpu()
        out[k] = (t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy().copy()
    return out


def backbone_to_jax(name: str, params, batch_stats
                    ) -> tuple[dict[str, Any], dict[str, Any]]:
    """The inverse of `backbone_from_jax`: the port's (params, batch_stats)
    → nested dicts of numpy arrays in the JAX package's layout."""
    def nested(module) -> dict[str, Any]:
        tree: dict[str, Any] = {}
        for key, t in module.state_dict().items():
            *path, leaf = key.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
        return tree

    p = _to_jax_tree(nested(params))
    if registry.canonical_name(name) in iresnet.IRESNET_LAYERS:
        w = p["fc"]["weight"]                     # (c, h, w) → (h, w, c)
        e, fc_in = w.shape
        p["fc"]["weight"] = np.ascontiguousarray(
            w.reshape(e, _FINAL_CHANNELS, fc_in // _FINAL_CHANNELS)
            .transpose(0, 2, 1).reshape(e, fc_in))
    return p, _to_jax_tree(nested(batch_stats))


def fc_table_from_jax(table, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    """The PartialFC table (num_classes, d): the same layout."""
    return torch.from_numpy(np.array(table, dtype=np.float32)).to(device)
