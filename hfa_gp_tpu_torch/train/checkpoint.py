"""Checkpoint and resume (port of hfa_gp_tpu/train/checkpoint.py, Orbax
there, `torch.save` here).

A checkpoint is one file `{checkpoint_path}/{step:06d}`. For the avatar
trainers' `TrainState` it holds {"params": state_dict, "optimizer":
state_dict, "step": int}; for the arcface trainer's `ArcFaceState` the
whole state: {"backbone", "batch_stats", "fc_weight", "optimizer",
"fc_opt_state", "step"}. The file is named after the loop index the
trainer passes (the state's step when it passes none); the saved `step`
is the number of updates done, and resume takes it from the file, not the
name.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from ..utils.convert import ParamTree
from .arcface import ArcFaceState
from .state import TrainState


def _payload(state: TrainState | ArcFaceState) -> dict[str, Any]:
    if isinstance(state, ArcFaceState):
        return {"backbone": state.backbone.state_dict(),
                "batch_stats": state.batch_stats.state_dict(),
                "fc_weight": state.fc_weight,
                "optimizer": state.optimizer.state_dict(),
                "fc_opt_state": state.fc_opt_state,
                "step": state.step}
    return {"params": state.params.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step}


def save(state: TrainState | ArcFaceState, checkpoint_path: str,
         step: int | None = None) -> str:
    step = state.step if step is None else int(step)
    os.makedirs(checkpoint_path, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoint_path, f"{step:06d}"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_payload(state), tmp)
    os.replace(tmp, path)                # never a half-written checkpoint
    return path


def latest_step(checkpoint_path: str) -> int | None:
    r"""Largest step file under checkpoint_path (`{step:06d}` is a minimum
    width, so match \d{6,})."""
    if not os.path.isdir(checkpoint_path):
        return None
    steps = [int(d) for d in os.listdir(checkpoint_path)
             if re.fullmatch(r"\d{6,}", d)]
    return max(steps) if steps else None


def _load(path: str) -> dict[str, Any]:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX "
            "package?); the port reads the files its own trainer writes")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(path: str, state: TrainState | ArcFaceState
            ) -> TrainState | ArcFaceState:
    """Load the checkpoint file `path` into `state` (params, optimizer
    moments and step counts, step; for an `ArcFaceState` also the running
    moments, the table and the head's buffers) in place, onto the devices
    `state` lives on, and return it."""
    ckpt = _load(path)
    if isinstance(state, ArcFaceState):
        state.backbone.load_state_dict(ckpt["backbone"])
        state.batch_stats.load_state_dict(ckpt["batch_stats"])
        with torch.no_grad():
            state.fc_weight.copy_(ckpt["fc_weight"])
            for k, v in state.fc_opt_state.items():
                v.copy_(ckpt["fc_opt_state"][k])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state
    state.params.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def load_params(path: str, device: torch.device | str = "cpu") -> ParamTree:
    """The params of a checkpoint as a (frozen) `ParamTree`, rebuilt from
    the state_dict's dotted keys."""
    tree: dict[str, Any] = {}
    for key, value in _load(path)["params"].items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return ParamTree(tree).to(device)
