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

import torch


def init_subspace(g: torch.Generator, dim_shape: int, num_ws: int = 14,
                  dim: int = 512) -> dict:
    bases = torch.randn((dim_shape, num_ws * dim), generator=g)
    return {"bases": bases, "delta": bases.mean(dim=0)}


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
