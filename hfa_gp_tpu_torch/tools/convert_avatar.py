"""Reference HFA-GP avatar checkpoint (.pt) → the JAX-layout flat npz that
the port's `run_recon_video_{rgb,3dmm,audio} --model_npz` read
(counterpart of the repository's tools/convert_avatar.py, without JAX).

    python -m hfa_gp_tpu_torch.tools.convert_avatar --ckpt 025000.pt \
        --head rgb --out avatar.npz

The reference saves `{"gen": state_dict, "g_optim": ..., "args": ...}`
(its trainer_rgb.py; trainer_3dmm.py has "w_optim"; trainer_audio.py adds
"AudNet" and "AudAttNet"). The module names map onto the params tree:

  RGB   (HeadNeRF_final): encoder.* → encoder, bases/delta[/bases_2/
        delta_2] → subspace[_2], generator.* → the EG3D tree
        (`convert_pickle.convert_generator`);
  3DMM  (HeadNeRF_3DMM): weights_3dmm.fc.i → weights_mlp.fc{i};
  audio (HeadNeRF_Audio with the AudNet/AudAttNet state dicts):
        encoder_conv.{0,2,4,6} → audnet.conv0..3 (Conv1d OIW → WIO),
        encoder_fc1.{0,2} → fc0/fc1; attentionConvNet.{0,2,4,6,8} →
        audattnet.conv0..4, attentionNet.0 → att_fc; the npz holds
        {"model", "audnet", "audattnet"}.

The optimizer state is not carried over: rendering needs only "gen".
"args" is written beside the npz as `<out>.args.json`.
"""

from __future__ import annotations

import argparse
import json
from typing import Any

import numpy as np
import torch

from ..utils.convert import save_npz
from .convert_pickle import convert_generator, n_parameters


def _np(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _conv2d_hwio(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 1, 0))


def _sub_sd(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_linear_stack(sd: dict, prefix: str) -> dict:
    """nn.Sequential of EqualLinear → {"fc{i}": {weight, bias}}."""
    out: dict[str, Any] = {}
    i = 0
    while f"{prefix}{i}.weight" in sd:
        out[f"fc{i}"] = {"weight": _np(sd[f"{prefix}{i}.weight"]),
                         "bias": _np(sd[f"{prefix}{i}.bias"])}
        i += 1
    if not out:
        raise KeyError(f"no linear stack at {prefix!r}")
    return out


def convert_encoder(sd: dict) -> dict:
    """The reference's Encoder (encoder3d.py) → the encoder tree.

    A ConvLayer is an nn.Sequential: [EqualConv2d, FusedLeakyReLU] (0, 1)
    without down-sampling, [Blur, EqualConv2d, FusedLeakyReLU] (1, 2) with
    it; Blur's `kernel` buffer is a constant the port makes itself."""
    app: dict[str, Any] = {
        "stem": {"weight": _conv2d_hwio(sd["net_app.convs.0.0.weight"]),
                 "act_bias": _np(sd["net_app.convs.0.1.bias"]).reshape(-1)}}
    i = 0
    while f"net_app.convs.{i + 1}.conv1.0.weight" in sd:
        b = f"net_app.convs.{i + 1}"
        app[f"res{i}"] = {
            "conv1": {"weight": _conv2d_hwio(sd[f"{b}.conv1.0.weight"]),
                      "act_bias": _np(sd[f"{b}.conv1.1.bias"]).reshape(-1)},
            "conv2": {"weight": _conv2d_hwio(sd[f"{b}.conv2.1.weight"]),
                      "act_bias": _np(sd[f"{b}.conv2.2.bias"]).reshape(-1)},
            "skip": {"weight": _conv2d_hwio(sd[f"{b}.skip.1.weight"])},
        }
        i += 1
    # the last layer: EqualConv2d(in, w_dim, 4, bias=False)
    app["final"] = {"weight": _conv2d_hwio(
        sd[f"net_app.convs.{i + 1}.weight"])}
    p: dict[str, Any] = {"net_app": app,
                         "fc": convert_linear_stack(sd, "fc.")}
    if "pose.0.weight" in sd:
        p["pose"] = convert_linear_stack(sd, "pose.")
    return p


def convert_audnet(sd: dict) -> dict:
    """AudioNet (headnerf.py) → the audnet tree (Conv1d OIW → WIO)."""
    out: dict[str, Any] = {}
    for j, idx in enumerate((0, 2, 4, 6)):
        out[f"conv{j}"] = {
            "weight": np.transpose(_np(sd[f"encoder_conv.{idx}.weight"]),
                                   (2, 1, 0)),
            "bias": _np(sd[f"encoder_conv.{idx}.bias"])}
    for j, idx in enumerate((0, 2)):
        out[f"fc{j}"] = {"weight": _np(sd[f"encoder_fc1.{idx}.weight"]),
                         "bias": _np(sd[f"encoder_fc1.{idx}.bias"])}
    return out


def convert_audattnet(sd: dict) -> dict:
    """AudioAttNet (headnerf.py) → the audattnet tree."""
    out: dict[str, Any] = {}
    for j, idx in enumerate((0, 2, 4, 6, 8)):
        out[f"conv{j}"] = {
            "weight": np.transpose(
                _np(sd[f"attentionConvNet.{idx}.weight"]), (2, 1, 0)),
            "bias": _np(sd[f"attentionConvNet.{idx}.bias"])}
    out["att_fc"] = {"weight": _np(sd["attentionNet.0.weight"]),
                     "bias": _np(sd["attentionNet.0.bias"])}
    return out


def convert_avatar_checkpoint(ckpt: dict, head: str) -> dict:
    """{"gen": state dict, ...} (numpy values) → the avatar params tree;
    for the audio head {"model", "audnet", "audattnet"}."""
    if head not in ("rgb", "3dmm", "audio"):
        raise ValueError(f"head must be rgb/3dmm/audio, got {head!r}")
    sd = {k: np.asarray(v) for k, v in ckpt["gen"].items()}
    params: dict[str, Any] = {
        "subspace": {"bases": _np(sd["bases"]).reshape(
            sd["bases"].shape[0], -1),
            "delta": _np(sd["delta"]).reshape(-1)},
        "generator": convert_generator(_sub_sd(sd, "generator.")),
    }
    if "bases_2" in sd or "delta_2" in sd:
        sub2 = {}
        if "bases_2" in sd:
            sub2["bases"] = _np(sd["bases_2"]).reshape(
                sd["bases_2"].shape[0], -1)
        sub2["delta"] = _np(sd["delta_2"]).reshape(-1)
        params["subspace_2"] = sub2

    has_enc = any(k.startswith("encoder.") for k in sd)
    has_mlp = any(k.startswith("weights_3dmm.") for k in sd)
    if head == "rgb" and not has_enc:
        raise SystemExit("checkpoint has no encoder.* keys — this is a "
                         "3DMM/audio checkpoint; use --head 3dmm or audio")
    if head in ("3dmm", "audio") and not has_mlp:
        raise SystemExit("checkpoint has no weights_3dmm.* keys — this is "
                         "an RGB checkpoint; use --head rgb")
    if head == "rgb":
        params["encoder"] = convert_encoder(_sub_sd(sd, "encoder."))
        return params
    params["weights_mlp"] = convert_linear_stack(
        _sub_sd(sd, "weights_3dmm."), "fc.")
    if head == "3dmm":
        return params
    return {"model": params,
            "audnet": convert_audnet(
                {k: np.asarray(v) for k, v in ckpt["AudNet"].items()}),
            "audattnet": convert_audattnet(
                {k: np.asarray(v) for k, v in ckpt["AudAttNet"].items()})}


def load_checkpoint(path: str) -> dict:
    """The reference's .pt (it pickles an argparse.Namespace, so not
    weights-only), every state dict's tensors as numpy."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {k: ({kk: vv.numpy() if hasattr(vv, "numpy") else vv
                 for kk, vv in v.items()} if isinstance(v, dict) else v)
            for k, v in ckpt.items()}


def args_record(args) -> Any:
    """The checkpoint's "args" as the `.args.json` side file holds it."""
    if hasattr(args, "__dict__"):
        return {k: repr(v) for k, v in vars(args).items()}
    return repr(args)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="reference .pt checkpoint")
    ap.add_argument("--head", choices=("rgb", "3dmm", "audio"),
                    default="rgb")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    ckpt = load_checkpoint(args.ckpt)
    tree = convert_avatar_checkpoint(ckpt, args.head)
    save_npz(tree, args.out)
    if "args" in ckpt:
        with open(args.out + ".args.json", "w") as f:
            json.dump(args_record(ckpt["args"]), f, indent=2)
    print(f"wrote {args.out} ({n_parameters(tree):,} parameters, "
          f"head={args.head})")


if __name__ == "__main__":
    main()
