"""Bytes of the ray marcher, fp32, for R rays of N samples of C channels:
forward, colours, densities and depths in, rgb, depth and the N − 1
weights out; backward under the rgb cotangent alone (what a loss on the
image passes back), colours, densities, depths and that cotangent in,
the colours' and densities' gradients out. `unit` counts the marches of
one unit from an EG3D configuration."""

F32 = 4


def forward(rays, n, c) -> int:
    return F32 * (rays * n * (c + 2) + rays * (c + 1) + rays * (n - 1))


def backward_rgb(rays, n, c) -> int:
    return F32 * (rays * n * (c + 2) + rays * c + rays * n * (c + 1))


def unit(config: dict, entry: str, b: int) -> dict:
    """Bytes of one unit's marches: every ray over its coarse samples,
    then over coarse and fine together, {"fwd": …} and, for a step, the
    second march's backward under the image's cotangent, {"bwd": …}, from
    the configuration's "eg3d" group."""
    rc = config["eg3d"]["render"]
    rays = b * rc["neural_rendering_resolution"] ** 2
    nc, nf = rc["depth_resolution"], rc["depth_resolution_importance"]
    c = rc["decoder_output_dim"]
    out = {"fwd": forward(rays, nc, c) + forward(rays, nc + nf, c)}
    if entry == "fit":
        out["bwd"] = backward_rgb(rays, nc + nf, c)
    return out
