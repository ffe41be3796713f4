"""Checkpoint and resume (port of hfa_gp_tpu/train/checkpoint.py, Orbax
there, `torch.save` here).

A checkpoint is one file `{checkpoint_path}/{step:06d}` holding
{"params": state_dict, "optimizer": state_dict, "step": int}. The file is
named after the loop index the trainer passes; the saved `step` is the
number of updates done, and resume takes it from the file, not the name.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

from ..utils.convert import ParamTree
from .state import TrainState


def save(state: TrainState, checkpoint_path: str,
         step: int | None = None) -> str:
    step = state.step if step is None else int(step)
    os.makedirs(checkpoint_path, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoint_path, f"{step:06d}"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"params": state.params.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
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


def restore(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint file `path` into `state` (params, optimizer
    moments and step counts, step) in place and return it."""
    ckpt = _load(path)
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
