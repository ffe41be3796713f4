"""Basel Face Model 2009 parametric head (port of
hfa_gp_tpu/preprocess/bfm.py).

Rebuilds reference eg3d-pose-detection/models/bfm.py:26-299
(ParametricFaceModel): linear id/expression blend shapes, texture, Euler
rotation, perspective projection, 68-landmark selection and 3-band
spherical-harmonics shading, as functions over a `BFMData` of tensors
loaded from `BFM_model_front.mat` (or synthesized for tests).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

# camera/projection constants (bfm.py:27-37)
CAMERA_DISTANCE = 10.0
FOCAL = 1015.0
CENTER = 112.0
INIT_LIT = np.array([0.8, 0, 0, 0, 0, 0, 0, 0, 0], dtype=np.float32)

# SH band constants (bfm.py:19-22)
_SH_A = np.array([np.pi, 2 * np.pi / np.sqrt(3.0),
                  2 * np.pi / np.sqrt(8.0)], dtype=np.float32)
_SH_C = np.array([1 / np.sqrt(4 * np.pi),
                  np.sqrt(3.0) / np.sqrt(4 * np.pi),
                  3 * np.sqrt(5.0) / np.sqrt(12 * np.pi)],
                 dtype=np.float32)


@dataclass(frozen=True)
class BFMData:
    mean_shape: torch.Tensor    # (3N,)   recentered
    id_base: torch.Tensor       # (3N, 80)
    exp_base: torch.Tensor      # (3N, 64)
    mean_tex: torch.Tensor      # (3N,)
    tex_base: torch.Tensor      # (3N, 80)
    keypoints: torch.Tensor     # (68,) vertex ids
    face_buf: torch.Tensor      # (F, 3) triangle vertex ids
    point_buf: torch.Tensor     # (N, 8) faces per vertex; F (or -1) is the
    #                             zero face compute_norm appends

    def to(self, device: torch.device | str) -> "BFMData":
        return BFMData(**{f.name: getattr(self, f.name).to(device)
                          for f in fields(self)})


def load_bfm(path: str, device: torch.device | str = "cpu") -> BFMData:
    """Load BFM_model_front.mat (reference bfm.py:39-70, recenter=True)."""
    from scipy.io import loadmat
    m = loadmat(path)
    mean_shape = m["meanshape"].astype(np.float32).reshape(-1, 3)
    mean_shape = mean_shape - mean_shape.mean(axis=0, keepdims=True)

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype)))

    return BFMData(
        mean_shape=t(mean_shape.reshape(-1)),
        id_base=t(m["idBase"]),
        exp_base=t(m["exBase"]),
        mean_tex=t(m["meantex"].reshape(-1)),
        tex_base=t(m["texBase"]),
        keypoints=t(np.squeeze(m["keypoints"]), np.int64) - 1,
        face_buf=t(m["tri"], np.int64) - 1,
        point_buf=t(m["point_buf"], np.int64) - 1,
    ).to(device)


def split_coeff(coeffs: torch.Tensor) -> dict[str, torch.Tensor]:
    """(B, 257) → id/exp/tex/angle/gamma/trans (bfm.py:252-273)."""
    return {
        "id": coeffs[:, :80],
        "exp": coeffs[:, 80:144],
        "tex": coeffs[:, 144:224],
        "angle": coeffs[:, 224:227],
        "gamma": coeffs[:, 227:254],
        "trans": coeffs[:, 254:257],
    }


def compute_shape(bfm: BFMData, id_coeff: torch.Tensor,
                  exp_coeff: torch.Tensor) -> torch.Tensor:
    """(B,80),(B,64) → (B,N,3) (bfm.py:86-99)."""
    b = id_coeff.shape[0]
    s = id_coeff @ bfm.id_base.T + exp_coeff @ bfm.exp_base.T \
        + bfm.mean_shape[None]
    return s.reshape(b, -1, 3)


def compute_texture(bfm: BFMData, tex_coeff: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
    b = tex_coeff.shape[0]
    t = tex_coeff @ bfm.tex_base.T + bfm.mean_tex[None]
    if normalize:
        t = t / 255.0
    return t.reshape(b, -1, 3)


def compute_rotation(angles: torch.Tensor) -> torch.Tensor:
    """(B, 3) radians → (B, 3, 3) with the pts @ R convention (bfm.py:
    174-207: returns (Rz·Ry·Rx)ᵀ)."""
    x, y, z = angles[:, 0], angles[:, 1], angles[:, 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    rot_x = torch.stack([one, zero, zero,
                         zero, cx, -sx,
                         zero, sx, cx], dim=1).reshape(-1, 3, 3)
    rot_y = torch.stack([cy, zero, sy,
                         zero, one, zero,
                         -sy, zero, cy], dim=1).reshape(-1, 3, 3)
    rot_z = torch.stack([cz, -sz, zero,
                         sz, cz, zero,
                         zero, zero, one], dim=1).reshape(-1, 3, 3)
    return (rot_z @ rot_y @ rot_x).transpose(1, 2)


def transform(face_shape: torch.Tensor, rot: torch.Tensor,
              trans: torch.Tensor) -> torch.Tensor:
    return face_shape @ rot + trans[:, None, :]


def to_camera(face_shape: torch.Tensor) -> torch.Tensor:
    """z ← camera_distance − z (bfm.py:210-212), non-mutating."""
    return torch.cat([face_shape[..., :2],
                      CAMERA_DISTANCE - face_shape[..., 2:]], dim=-1)


def to_image(face_shape: torch.Tensor, focal: float = FOCAL,
             center: float = CENTER) -> torch.Tensor:
    """(B,N,3) camera coords → (B,N,2) image points (bfm.py:214-226)."""
    proj = torch.tensor([[focal, 0, center], [0, focal, center], [0, 0, 1]],
                        dtype=face_shape.dtype, device=face_shape.device).T
    p = face_shape @ proj
    return p[..., :2] / p[..., 2:]


def compute_norm(bfm: BFMData, face_shape: torch.Tensor) -> torch.Tensor:
    """Per-vertex normals by face-normal accumulation (bfm.py:117-137).
    A zero face is appended at index F: `point_buf` pads with it."""
    v1 = face_shape[:, bfm.face_buf[:, 0]]
    v2 = face_shape[:, bfm.face_buf[:, 1]]
    v3 = face_shape[:, bfm.face_buf[:, 2]]
    face_norm = torch.linalg.cross(v1 - v2, v2 - v3, dim=-1)
    face_norm = face_norm / (torch.linalg.vector_norm(
        face_norm, dim=-1, keepdim=True) + 1e-12)
    face_norm = torch.cat([face_norm, torch.zeros_like(face_norm[:, :1])],
                          dim=1)
    vert = face_norm[:, bfm.point_buf].sum(dim=2)
    return vert / (torch.linalg.vector_norm(vert, dim=-1, keepdim=True)
                   + 1e-12)


def compute_color(face_texture: torch.Tensor, face_norm: torch.Tensor,
                  gamma: torch.Tensor) -> torch.Tensor:
    """3-band SH shading (bfm.py:140-171)."""
    b = gamma.shape[0]
    lit = torch.as_tensor(INIT_LIT, device=gamma.device, dtype=gamma.dtype)
    gamma = (gamma.reshape(b, 3, 9) + lit).transpose(1, 2)   # (B, 9, 3)
    a, c = _SH_A, _SH_C
    n = face_norm
    Y = torch.cat([
        float(a[0] * c[0]) * torch.ones_like(n[..., :1]),
        -float(a[1] * c[1]) * n[..., 1:2],
        float(a[1] * c[1]) * n[..., 2:],
        -float(a[1] * c[1]) * n[..., :1],
        float(a[2] * c[2]) * n[..., :1] * n[..., 1:2],
        -float(a[2] * c[2]) * n[..., 1:2] * n[..., 2:],
        float(0.5 * a[2] * c[2] / np.sqrt(3.0)) * (3 * n[..., 2:] ** 2 - 1),
        -float(a[2] * c[2]) * n[..., :1] * n[..., 2:],
        float(0.5 * a[2] * c[2]) * (n[..., :1] ** 2 - n[..., 1:2] ** 2),
    ], dim=-1)                                                # (B, N, 9)
    return torch.einsum("bnk,bkc->bnc", Y, gamma) * face_texture


def compute_for_render(bfm: BFMData, coeffs: torch.Tensor):
    """(B, 257) → (face_vertex, face_texture, landmark), the inference
    quantities (bfm.py:274-299; the renderer itself is disabled in the
    reference, facerecon_model.py:101-104)."""
    cd = split_coeff(coeffs)
    shape = compute_shape(bfm, cd["id"], cd["exp"])
    rot = compute_rotation(cd["angle"])
    vertex = to_camera(transform(shape, rot, cd["trans"]))
    landmark = to_image(vertex)[:, bfm.keypoints]
    texture = compute_texture(bfm, cd["tex"])
    return vertex, texture, landmark
