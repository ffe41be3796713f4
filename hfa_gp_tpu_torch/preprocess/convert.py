"""JAX preprocessing param trees → the port's modules.

The trees are those of the JAX package's `init_mtcnn`, `init_facerecon` and
`init_deepspeech`, as numpy arrays or as the `load_npz` of a flat npz that
`tools/convert_{mtcnn,facerecon}.py` (or `pytree_io.save_npz`) wrote.
Layout changes on the way:
  * every 4-D conv weight HWIO → OIHW, the 1×1 heads included;
  * MTCNN's R-/O-Net `fc/weight` (out, h·w·c): the JAX package flattens
    NHWC, the port NCHW, so its columns go from (h, w, c) order to (c, h, w);
  * MTCNN's `prelu` vectors → `nn.PReLU` weights;
  * DeepSpeech's dense weights (cin, cout) → `nn.Linear`'s (cout, cin), and
    its two TF BasicLSTMCells → the bidirectional `nn.LSTM`
    (`deepspeech.lstm_weights_from_tf`);
  * everything else (biases, BN statistics) as it is.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import deepspeech, facerecon, mtcnn


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _oihw(v) -> torch.Tensor:
    return _t(v).permute(3, 2, 0, 1).contiguous()


def _load(module: torch.nn.Module, state: dict[str, torch.Tensor],
          device) -> torch.nn.Module:
    module.load_state_dict(state, strict=True)
    return module.eval().requires_grad_(False).to(device)


def _conv_prelu(prefix: str, p: dict) -> dict[str, torch.Tensor]:
    return {f"{prefix}.conv.weight": _oihw(p["weight"]),
            f"{prefix}.conv.bias": _t(p["bias"]),
            f"{prefix}.prelu.weight": _t(p["prelu"])}


def _dense(prefix: str, p: dict, channels: int | None = None
           ) -> dict[str, torch.Tensor]:
    w = _t(p["weight"])
    if channels is not None:                     # (h, w, c) → (c, h, w)
        out, n = w.shape
        w = w.reshape(out, n // channels, channels).permute(0, 2, 1) \
            .reshape(out, n).contiguous()
    state = {f"{prefix}.fc.weight": w, f"{prefix}.fc.bias": _t(p["bias"])}
    if "prelu" in p:
        state[f"{prefix}.prelu.weight"] = _t(p["prelu"])
    return state


def mtcnn_from_jax(tree: dict[str, Any],
                   device: torch.device | str = "cpu") -> mtcnn.MTCNN:
    state: dict[str, torch.Tensor] = {}
    pn = tree["pnet"]
    for c in ("c1", "c2", "c3"):
        state.update(_conv_prelu(f"pnet.{c}", pn[c]))
    for h in ("prob", "reg"):
        state[f"pnet.{h}.weight"] = _oihw(pn[h]["weight"])
        state[f"pnet.{h}.bias"] = _t(pn[h]["bias"])
    for net, convs, fc_channels, heads in (
            ("rnet", ("c1", "c2", "c3"), 64, ("prob", "reg")),
            ("onet", ("c1", "c2", "c3", "c4"), 128, ("prob", "reg", "lmk"))):
        p = tree[net]
        for c in convs:
            state.update(_conv_prelu(f"{net}.{c}", p[c]))
        state.update(_dense(f"{net}.fc", p["fc"], fc_channels))
        for h in heads:
            state.update(_dense(f"{net}.{h}", p[h]))
    return _load(mtcnn.MTCNN(), state, device)


def facerecon_from_jax(tree: dict[str, Any],
                       device: torch.device | str = "cpu"
                       ) -> facerecon.FaceRecon:
    """A bare 4-D leaf (`stem_conv`, `conv1`, `down_conv`, …) is its conv's
    weight; dict leaves keep their names (`scale`, `mean`, head `weight`)."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + ".")
            elif np.ndim(v) == 4:
                state[key if k == "weight" else key + ".weight"] = _oihw(v)
            else:
                state[key] = _t(v)

    walk(tree, "")
    return _load(facerecon.FaceRecon(), state, device)


def deepspeech_from_jax(tree: dict[str, Any],
                        device: torch.device | str = "cpu"
                        ) -> deepspeech.DeepSpeech:
    state: dict[str, torch.Tensor] = {}
    for layer in ("h1", "h2", "h3", "h5", "logits"):
        state[f"{layer}.weight"] = _t(tree[layer]["weight"]).T.contiguous()
        state[f"{layer}.bias"] = _t(tree[layer]["bias"])
    cin = state["h3.weight"].shape[0]
    for direction, sfx in (("lstm_fw", ""), ("lstm_bw", "_reverse")):
        ws = deepspeech.lstm_weights_from_tf(tree[direction]["kernel"],
                                             tree[direction]["bias"], cin)
        for name, w in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                            "bias_hh_l0"), ws):
            state[f"lstm.{name}{sfx}"] = w
    n_input, n_hidden = state["h1.weight"].shape[1], cin
    n_chars = state["logits.weight"].shape[0]
    return _load(deepspeech.DeepSpeech(n_input, n_hidden, n_chars), state,
                 device)
