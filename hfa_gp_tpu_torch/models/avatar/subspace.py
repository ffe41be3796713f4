"""Personalized latent subspace in EG3D's W+ space (port of
hfa_gp_tpu/models/avatar/subspace.py).

`bases` (dim_shape, num_ws·dim) is orthonormalized by QR on every call;
driving weights α mix the columns and `delta` recenters:
w+ = α @ Qᵀ + delta, reshaped (B, num_ws, dim).

QR signs: torch's CPU QR and JAX's CPU QR are both LAPACK Householder
and agree (tests/test_torch_slice.py); a flipped column sign would change
the latent, not only the span.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def init_subspace(g: torch.Generator, dim_shape: int, num_ws: int = 14,
                  dim: int = 512, init_bases=None) -> dict:
    """`init_bases` (dim_shape, num_ws·dim), e.g. from `load_pti_bases`,
    takes the place of the random draw (nothing is drawn from g then)."""
    if init_bases is not None:
        bases = torch.as_tensor(init_bases, dtype=torch.float32) \
            .reshape(dim_shape, -1)
    else:
        bases = torch.randn((dim_shape, num_ws * dim), generator=g)
    return {"bases": bases, "delta": bases.mean(dim=0)}


def load_pti_bases(emb_dir: str, dim_shape: int, num_ws: int = 14,
                   dim: int = 512) -> torch.Tensor:
    """W+ pivots of PTI embeddings as a second person's bases →
    (dim_shape, num_ws·dim). The first `dim_shape` directories of
    `emb_dir`, sorted, each give `0.npy` or else `0.pt` ((1,) 18 × 512,
    cut to num_ws rows); a direction without a pivot keeps its draw from
    `np.random.default_rng(0)`, so the result equals the JAX package's."""
    dirs = sorted(os.listdir(emb_dir))[:dim_shape]
    out = np.random.default_rng(0).standard_normal(
        (dim_shape, num_ws, dim)).astype(np.float32)
    for i, d in enumerate(dirs):
        npy, pt = (os.path.join(emb_dir, d, f) for f in ("0.npy", "0.pt"))
        if os.path.exists(npy):
            base = np.load(npy)
        elif os.path.exists(pt):
            base = torch.load(pt, map_location="cpu", weights_only=True) \
                .squeeze(0).numpy()
        else:
            continue
        out[i] = base[:num_ws]
    return torch.from_numpy(out.reshape(dim_shape, num_ws * dim))


def orthonormal_basis(params, eps: float = 1e-8) -> torch.Tensor:
    """Q (num_ws·dim, dim_shape) with orthonormal columns."""
    return torch.linalg.qr((params["bases"] + eps).T).Q


def get_latent(params, weights: torch.Tensor, dim: int = 512,
               eps: float = 1e-8) -> torch.Tensor:
    """weights (B, dim_shape) → W+ latent (B, num_ws, dim)."""
    q = orthonormal_basis(params, eps)
    out = weights @ q.T
    return out.reshape(weights.shape[0], -1, dim) \
        + params["delta"].reshape(1, -1, dim)
