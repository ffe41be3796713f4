"""JAX arcface state → the port's (numpy arrays in, `ParamTree`s out).

  * every 4-D leaf is a conv weight (`stem_conv`, `conv1`, `conv2`,
    `down_conv`): HWIO → OIHW;
  * `fc/weight` (embedding_dim, h·w·c): the JAX package flattens NHWC, the
    port NCHW, so its columns go from (h, w, c) order to (c, h, w);
  * everything else (BN scale / bias, PReLU alpha, FC bias, the running
    moments, the PartialFC table) carries over as it is. The running
    variance is the biased batch variance in both packages.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...utils.convert import ParamTree

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


def fc_table_from_jax(table, device: torch.device | str = "cpu"
                      ) -> torch.Tensor:
    """The PartialFC table (num_classes, d): the same layout."""
    return torch.from_numpy(np.array(table, dtype=np.float32)).to(device)
