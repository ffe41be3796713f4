"""EG3D synthesis in plain PyTorch: the tri-plane backbone, the importance
renderer (exact per-plane bilinear lookups by `F.grid_sample`, the
MipRayMarcher2 as tensor ops), the OSG decoder and the super-resolution
head, for one configuration dict (`configs/<config>.json`'s "eg3d").

A frozen copy of the port's plain paths, importing nothing of the port.
It renders without depth jitter, as the port's inference and training
paths do, and places the fine samples as the configuration says
("stratified": each static depth window gets its share at CDF quantiles;
"global": the reference EG3D's global quantiles).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import ops

# rows: the world axes that span each plane
PLANE_AXES = np.array([
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
    [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
    [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
], dtype=np.float32)


def block_resolutions(bb: dict) -> list[int]:
    return [2 ** i for i in range(2, int(math.log2(bb["img_resolution"])) + 1)]


def channels(bb: dict, res: int) -> int:
    return min(bb["channel_base"] // res, bb["channel_max"])


def num_ws(bb: dict) -> int:
    return 2 * len(block_resolutions(bb))


# -- synthesis network ----------------------------------------------------------


def _styles(p, w):
    return ops.fully_connected(w, p["affine"]["weight"], p["affine"]["bias"])


def synth_layer(p, x, w, *, up, fir, clamp, noise):
    y = ops.modulated_conv2d(x, p["weight"], _styles(p, w), up=up,
                             padding=p["weight"].shape[-1] // 2, fir=fir)
    if noise:                  # the backbone's stored noise; SR runs without
        y = y + (p["noise_const"] * p["noise_strength"])[None, None]
    return ops.bias_act(y, p["bias"], act="lrelu", clamp=clamp)


def torgb(p, x, w, *, clamp):
    styles = _styles(p, w) * (1.0 / math.sqrt(p["weight"].shape[1]))
    y = ops.modulated_conv2d(x, p["weight"], styles, demodulate=False)
    return ops.bias_act(y, p["bias"], clamp=clamp)


def block(p, x, img, ws3, *, fir, clamp, up, noise):
    """One skip-architecture block; ws3 (B, 3, w_dim): conv0, conv1, torgb."""
    i = 0
    if "const" in p:
        x = p["const"][None].expand(ws3.shape[0], -1, -1, -1)
    if "conv0" in p:
        x = synth_layer(p["conv0"], x, ws3[:, i], up=2 if up else 1, fir=fir,
                        clamp=clamp, noise=noise)
        i += 1
    x = synth_layer(p["conv1"], x, ws3[:, i], up=1, fir=fir, clamp=clamp,
                    noise=noise)
    y = torgb(p["torgb"], x, ws3[:, i + 1], clamp=clamp)
    if img is None:
        return x, y
    if up:
        img = ops.upsample2d(img, ops.fir_kernel(fir))
    return x, img + y


def backbone(params, bb: dict, ws):
    """ws (B, num_ws, w_dim) → planes (B, img_channels, res, res)."""
    x = img = None
    k = 0
    for res in block_resolutions(bb):
        n = 1 if res == 4 else 2
        w3 = ws[:, k:k + n + 1]
        if res == 4:
            w3 = torch.cat([w3, torch.zeros_like(w3[:, :1])], dim=1)
        x, img = block(params[f"b{res}"], x, img, w3, fir=bb["fir"],
                       clamp=bb["conv_clamp"], up=res != 4, noise=True)
        k += n
    return img


def superresolution(params, sr: dict, rgb, x, ws):
    if x.shape[2] < sr["input_resolution"]:
        size = (sr["input_resolution"],) * 2
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=sr["antialias"])
        rgb = F.interpolate(rgb, size=size, mode="bilinear",
                            align_corners=False, antialias=sr["antialias"])
    w3 = ws[:, -1:].expand(-1, 3, -1)
    for name in ("block0", "block1"):
        x, rgb = block(params[name], x, rgb, w3, fir=sr["fir"],
                       clamp=sr["conv_clamp"], up=True, noise=False)
    return rgb


# -- rays and the renderer ----------------------------------------------------------


def rays(label, resolution: int):
    """OpenCV label (B, 25) → (origins, unit directions), (B, R, 3) each,
    pixel centres at (i + 0.5) / resolution, row-major."""
    b = label.shape[0]
    c2w = label[:, :16].reshape(b, 4, 4)
    k = label[:, 16:25].reshape(b, 3, 3)
    fx, fy = k[:, 0, 0, None], k[:, 1, 1, None]
    cx, cy, sk = k[:, 0, 2, None], k[:, 1, 2, None], k[:, 0, 1, None]
    i = (torch.arange(resolution, dtype=label.dtype, device=label.device)
         + 0.5) / resolution
    yy, xx = torch.meshgrid(i, i, indexing="ij")
    xc, yc = xx.reshape(1, -1), yy.reshape(1, -1)
    x = (xc - cx + cy * sk / fy - sk * yc / fy) / fx
    y = (yc - cy) / fy
    x, y, z = torch.broadcast_tensors(x, y, torch.ones_like(xc))
    d = torch.einsum("bij,brj->bri", c2w[:, :3, :3], torch.stack([x, y, z], -1))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return c2w[:, None, :3, 3].expand(b, d.shape[1], 3), d


def sample_planes(planes, points, box_warp):
    """planes (B, 3, H, W, C), points (B, M, 3) → plane-averaged (B, M, C)."""
    b, n, h, w, c = planes.shape
    inv = torch.as_tensor(np.linalg.inv(PLANE_AXES), dtype=points.dtype,
                          device=points.device)
    uv = torch.einsum("bmj,pjk->bpmk", (2.0 / box_warp) * points, inv)[..., :2]
    img = planes.reshape(b * n, h, w, c).permute(0, 3, 1, 2)
    f = F.grid_sample(img, uv.reshape(b * n, 1, -1, 2), mode="bilinear",
                      padding_mode="zeros", align_corners=False)
    return f[:, :, 0].permute(0, 2, 1).reshape(b, n, -1, c).mean(1)


def decoder(params, rc: dict, feats):
    x = F.softplus(ops.fully_connected(feats, params["fc0"]["weight"],
                                       params["fc0"]["bias"],
                                       lr_mul=rc["decoder_lr_mul"]))
    x = ops.fully_connected(x, params["fc1"]["weight"], params["fc1"]["bias"],
                            lr_mul=rc["decoder_lr_mul"])
    return torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001, x[..., 0:1]


def march(colors, densities, depths, white_back=False):
    """MipRayMarcher2 → (rgb in [-1, 1], depth clipped to the call's
    depths, weights)."""
    delta = depths[:, :, 1:] - depths[:, :, :-1]
    c = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    s = F.softplus((densities[:, :, :-1] + densities[:, :, 1:]) / 2 - 1.0)
    z = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    alpha = 1.0 - torch.exp(-(s * delta))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :, :1]),
                                     1.0 - alpha + 1e-10], dim=2), dim=2)
    wts = alpha * trans[:, :, :-1]
    rgb = (wts * c).sum(2)
    total = wts.sum(2)
    depth = (wts * z).sum(2) / total.clamp_min(1e-10)
    if white_back:
        rgb = rgb + 1 - total
    return rgb * 2 - 1, depth.clamp(depths.min(), depths.max()), wts


def _smooth(w):
    m = F.max_pool1d(w[:, None], 2, 1, padding=1)
    return F.avg_pool1d(m, 2, 1)[:, 0] + 0.01


def _pdf_sample(bins, w, u, eps=1e-5):
    n_w = w.shape[1]
    w = w + eps
    pdf = w / w.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    lo, hi = (idx - 1).clamp_min(0), idx.clamp_max(n_w)
    bins = bins[:, :n_w + 1]
    c0, c1 = cdf.gather(1, lo), cdf.gather(1, hi)
    b0, b1 = bins.gather(1, lo), bins.gather(1, hi)
    den = c1 - c0
    den = torch.where(den < eps, torch.ones_like(den), den)
    return b0 + (u - c0) / den * (b1 - b0)


def _cdf_at(bins, cdf, x, eps=1e-5):
    k = bins.shape[1]
    idx = torch.searchsorted(bins.contiguous(), x.contiguous(), right=True)
    lo, hi = (idx - 1).clamp_min(0), idx.clamp_max(k - 1)
    b0, b1 = bins.gather(1, lo), bins.gather(1, hi)
    span = b1 - b0
    t = ((x - b0) / torch.where(span < eps, torch.ones_like(span), span))
    return cdf.gather(1, lo) + t.clamp(0, 1) * (cdf.gather(1, hi)
                                                - cdf.gather(1, lo))


def fine_depths(z_vals, weights, rc: dict):
    """Fine depths (B, R, n_fine, 1) from the coarse pass, without jitter."""
    b, r, n, _ = z_vals.shape
    nf = rc["depth_resolution_importance"]
    z = z_vals.reshape(b * r, n)
    w = _smooth(weights.reshape(b * r, -1))[:, 1:-1]
    mid = 0.5 * (z[:, :-1] + z[:, 1:])
    if rc["sampler_fine"] == "global":
        u = torch.linspace(0.0, 1.0, nf, device=z.device).expand(b * r, nf)
        fine = _pdf_sample(mid, w, u)
    else:
        per = rc["sampler_depth_window"]
        nwin = nf // per
        ww = w + 1e-5
        pdf = ww / ww.sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)],
                        -1)
        bins = mid[:, :cdf.shape[1]]
        edges = torch.linspace(rc["ray_start"], rc["ray_end"], nwin + 1,
                               device=z.device)
        fe = _cdf_at(bins, cdf, edges.expand(b * r, nwin + 1))
        frac = ((torch.arange(per, device=z.device, dtype=z.dtype) + 0.5)
                / per)[None, None]
        u = (fe[:, :-1, None] + frac * (fe[:, 1:, None] - fe[:, :-1, None]))
        fine = _pdf_sample(bins, w, u.reshape(b * r, nf))
    return fine.detach().reshape(b, r, nf, 1)


def render(dec, rc: dict, planes, origins, dirs):
    """planes (B, 3, H, W, C), rays (B, R, 3) → (features (B, R, C_out),
    depth (B, R, 1))."""
    b, r, _ = origins.shape

    def points(depths):
        n = depths.shape[2]
        pts = origins[:, :, None] + depths * dirs[:, :, None]
        rgb, sigma = decoder(dec, rc, sample_planes(planes, pts.reshape(b, -1, 3),
                                                    rc["box_warp"]))
        return rgb.reshape(b, r, n, -1), sigma.reshape(b, r, n, 1)

    n = rc["depth_resolution"]
    d_c = torch.linspace(rc["ray_start"], rc["ray_end"], n,
                         device=origins.device)[None, None, :, None] \
        .expand(b, r, n, 1)
    c_c, s_c = points(d_c)
    _, _, w = march(c_c, s_c, d_c, rc["white_back"])
    d_f = fine_depths(d_c, w, rc)
    c_f, s_f = points(d_f)
    d = torch.cat([d_c, d_f], 2)
    order = torch.sort(d[..., 0], dim=-1, stable=True).indices[..., None]
    d = d.gather(2, order)
    c = torch.cat([c_c, c_f], 2).gather(2, order.expand(-1, -1, -1,
                                                        c_c.shape[-1]))
    s = torch.cat([s_c, s_f], 2).gather(2, order)
    rgb, depth, _ = march(c, s, d, rc["white_back"])
    return rgb, depth


def synthesis(params, cfg: dict, ws, label):
    """ws (B, num_ws, w_dim), OpenCV label (B, 25) → image (B, 512, 512, 3)
    in [-1, 1]."""
    bb, rc = cfg["backbone"], cfg["render"]
    b = ws.shape[0]
    res = rc["neural_rendering_resolution"]
    origins, dirs = rays(label, res)
    planes = backbone(params["backbone"], bb, ws)
    h = planes.shape[2]
    planes = planes.reshape(b, 3, -1, h, h).permute(0, 1, 3, 4, 2) \
        .contiguous()
    feats, _ = render(params["decoder"], rc, planes, origins, dirs)
    fimg = feats.permute(0, 2, 1).reshape(b, -1, res, res)
    img = superresolution(params["superresolution"], cfg["sr"], fimg[:, :3],
                          fimg, ws)
    return img.permute(0, 2, 3, 1)
