"""Bytes of the tri-plane sampler (plane-averaged bilinear lookups), fp32:
forward, planes (B, 3, H, W, C) and points (B, M, 3) in, features
(B, M, C) out; backward, the features' cotangent and the points in, the
planes' gradient out. `unit` counts the op of one unit from an EG3D
configuration, whatever launches the program splits it into."""

F32 = 4


def forward(b, m, h, w, c) -> int:
    return F32 * (b * 3 * h * w * c + b * m * 3 + b * m * c)


def backward(b, m, h, w, c) -> int:
    return F32 * (b * m * c + b * m * 3 + b * 3 * h * w * c)


def unit(config: dict, entry: str, b: int) -> dict:
    """Bytes of one unit's lookups (a batch served, a step trained): the
    planes sampled at the coarse, then at the fine points of every ray,
    {"fwd": …} and, for a step, {"bwd": …}, from the configuration's
    "eg3d" group."""
    g = config["eg3d"]
    rc, bb = g["render"], g["backbone"]
    rays = rc["neural_rendering_resolution"] ** 2
    res, c = bb["img_resolution"], bb["img_channels"] // 3
    passes = (rc["depth_resolution"], rc["depth_resolution_importance"])
    out = {"fwd": sum(forward(b, rays * n, res, res, c) for n in passes)}
    if entry == "fit":
        out["bwd"] = sum(backward(b, rays * n, res, res, c) for n in passes)
    return out
