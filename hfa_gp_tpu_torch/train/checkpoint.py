"""Checkpoint and resume (port of hfa_gp_tpu/train/checkpoint.py, Orbax
there, `torch.save` here).

A checkpoint is one file `{checkpoint_path}/{step:06d}`. For the avatar
trainers' `TrainState` it holds {"params": state_dict, "optimizer":
state_dict, "step": int}; for the arcface trainer's `ArcFaceState` the
whole state: {"backbone", "batch_stats", "fc_weight", "optimizer",
"fc_opt_state", "step"}; for EG3D's GAN trainer's `GANState` {"G", "D",
"G_ema", "opt_G", "opt_D", "step"}. The file is named after the loop index the
trainer passes (the state's step when it passes none); the saved `step`
is the number of updates done, and resume takes it from the file, not the
name.

On a mesh the checkpoint does not depend on the mesh: `save` gathers the
table and its buffers from the model axis's shards and the primary rank
alone writes the whole of them, in the one-rank format; `restore` reads
each rank's rows (the file memory-mapped, so no rank holds the whole
table). A run on 2 × 2 ranks resumes on one, and the other way round.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

import torch.distributed as dist

from ..parallel import distributed
from ..parallel.mesh import Mesh
from ..utils.convert import ParamTree
from .arcface import ArcFaceState
from .eg3d_gan import GANState
from .state import TrainState

State = TrainState | ArcFaceState | GANState


def _payload(state: State) -> dict[str, Any]:
    if isinstance(state, GANState):
        return {"G": state.G.state_dict(), "D": state.D.state_dict(),
                "G_ema": state.G_ema.state_dict(),
                "opt_G": state.opt_G.state_dict(),
                "opt_D": state.opt_D.state_dict(), "step": state.step}
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


def _whole(shard: torch.Tensor, mesh: Mesh) -> torch.Tensor | None:
    """The model axis's shards of a table, concatenated on the primary
    (None on the other ranks). The ranks of data index 0 take part: the
    gather runs on host copies under gloo, on the card under nccl."""
    if mesh.data_index != 0:
        return None
    t = shard if distributed.backend() == "nccl" else shard.cpu()
    parts = ([torch.empty_like(t) for _ in range(mesh.n_model)]
             if distributed.is_primary() else None)
    dist.gather(t, parts, dst=0, group=mesh.model_group)
    return torch.cat(parts).cpu() if parts is not None else None


def save(state: State, checkpoint_path: str,
         step: int | None = None, mesh: Mesh | None = None) -> str | None:
    """Write the checkpoint on the primary rank; returns its path there and
    None on the others. Every rank of `mesh` calls it."""
    step = state.step if step is None else int(step)
    payload = _payload(state)
    if isinstance(state, ArcFaceState) and mesh is not None \
            and mesh.n_model > 1:
        payload["fc_weight"] = _whole(state.fc_weight, mesh)
        payload["fc_opt_state"] = {k: _whole(v, mesh)
                                   for k, v in state.fc_opt_state.items()}
    if not distributed.is_primary():
        return None
    os.makedirs(checkpoint_path, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoint_path, f"{step:06d}"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
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


def _load(path: str, mmap: bool = False) -> dict[str, Any]:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an Orbax checkpoint of the JAX "
            "package?); the port reads the files its own trainer writes")
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=mmap)


def restore(path: str, state: State, mesh: Mesh | None = None) -> State:
    """Load the checkpoint file `path` into `state` (params, optimizer
    moments and step counts, step; for an `ArcFaceState` also the running
    moments, the table and the head's buffers: the rows of this rank's
    shard on `mesh`; for a `GANState` both networks, G_ema and both
    Adams) in place, onto the devices `state` lives on, and return it."""
    if isinstance(state, GANState):
        ckpt = _load(path)
        for k in ("G", "D", "G_ema"):
            getattr(state, k).load_state_dict(ckpt[k])
        state.opt_G.load_state_dict(ckpt["opt_G"])
        state.opt_D.load_state_dict(ckpt["opt_D"])
        state.step = int(ckpt["step"])
        return state
    if isinstance(state, ArcFaceState):
        ckpt = _load(path, mmap=True)
        state.backbone.load_state_dict(ckpt["backbone"])
        state.batch_stats.load_state_dict(ckpt["batch_stats"])
        rows = state.fc_weight.shape[0]
        lo = (mesh.model_index if mesh is not None else 0) * rows
        if ckpt["fc_weight"].shape[0] != rows * (mesh.n_model if mesh
                                                 else 1):
            raise ValueError(f"{path} holds {ckpt['fc_weight'].shape[0]} "
                             f"classes; this run has {rows} a shard")
        with torch.no_grad():
            state.fc_weight.copy_(ckpt["fc_weight"][lo:lo + rows])
            for k, v in state.fc_opt_state.items():
                v.copy_(ckpt["fc_opt_state"][k][lo:lo + rows])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state
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
