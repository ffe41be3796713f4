"""JAX param trees → the port's modules (counterpart of
hfa_gp_tpu/utils/pytree_io.py).

A JAX param tree is a nested dict of arrays, stored flat in an npz with
`/`-joined keys. `from_jax` carries it into a `ParamTree`, an nn.Module
with the same keys, so a `state_dict` key is the npz key with `/` → `.`.

Layout changes on the way:
  * every 4-D `weight` (encoder, synthesis and torgb convs) HWIO → OIHW;
  * every 3-D `weight` (the audio nets' conv1d layers) WIO → OIW, torch's
    (cout, cin, k); no other tree the port converts has a 3-D `weight`;
  * the backbone `const` (res, res, C) → (C, res, res);
  * everything else as it is: FC weights are (out, in) in both packages,
    and `noise_const` / `noise_strength` carry over unchanged.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


class ParamTree(nn.Module):
    """A param tree as a module: tensor leaves are (frozen) parameters,
    sub-dicts are submodules (a `ParamTree` value is taken as it is), keys
    are kept. Supports `p["key"]`, `"key" in p` and `p.get("key")`, so the
    apply functions read it like the JAX dicts."""

    def __init__(self, tree: dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, ParamTree):
                self.add_module(k, v)
            else:
                self.register_parameter(
                    k, nn.Parameter(torch.as_tensor(v), requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def load_npz(path: str) -> dict[str, Any]:
    """Flat npz (`a/b/c` keys) → nested dict of numpy arrays."""
    tree: dict[str, Any] = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def save_npz(tree: dict[str, Any], path: str) -> None:
    """Nested dict of numpy arrays → flat npz with `/`-joined keys, the
    layout `load_npz` (and the JAX package's `pytree_io`) reads."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: dict[str, Any], prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def _convert_leaf(name: str, v) -> torch.Tensor:
    t = torch.from_numpy(np.array(v, dtype=np.float32))
    if name == "weight" and t.ndim == 4:
        return t.permute(3, 2, 0, 1).contiguous()        # HWIO → OIHW
    if name == "weight" and t.ndim == 3:
        return t.permute(2, 1, 0).contiguous()           # WIO → OIW
    if name == "const" and t.ndim == 3:
        return t.permute(2, 0, 1).contiguous()           # HWC → CHW
    return t


def convert_tree(tree: dict[str, Any]) -> dict[str, Any]:
    """Nested dict of JAX-layout arrays → nested dict of torch tensors in
    the port's layout."""
    return {k: convert_tree(v) if isinstance(v, dict) else _convert_leaf(k, v)
            for k, v in tree.items()}


def from_jax(tree: dict[str, Any],
             device: torch.device | str = "cpu") -> ParamTree:
    """JAX param tree (numpy arrays, e.g. from `heads.init_avatar_rgb` or
    `load_npz`) → `ParamTree` on `device`."""
    return ParamTree(convert_tree(tree)).to(device)
