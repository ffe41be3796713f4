"""Ablation probe of the tri-plane sampler on the card: which stage of
`csrc/triplane.cu` owns its time (port of the JAX package's
tools/probe_sampler.py and tools/probe_sampler2.py).

    python -m hfa_gp_tpu_torch.tools.probe_sampler [--iters 20] [--backward]

Builds `csrc/triplane_probe.cu` (the forward sampler's template,
`csrc/triplane_sampler.cuh`, with compile-time switches that remove one
stage each; `csrc/triplane.cu` is the same template with every stage on),
checks that the variant with every stage on equals `triplane.sample_mean`
bit for bit, and prints one timed
line per variant (device time over back-to-back calls, `measure.device_ms`)
at the TPU probes' shapes: batch 4,
128² rays × 48 depths, planes (4, 3, 256, 256, 32) fp32. A variant with a
stage removed computes something else; only its time means anything.

Stages and the TPU probes' switches they answer to:
  coords    the coordinate read            (do_txy)
  weights   the three axis footprints      (do_wbuild)
  gather    the 12 corner reads            (do_dma and do_matmul: the slab
                                            copy and the one-hot product
                                            are how the TPU gathers)
  epilogue  the plane mean                 (do_epi)
  store     the output store               (do_out)
TPU-only switches with no counterpart here: `const_slab`, `fp32_dot`,
`no_where`, `single_w` (they vary the one-hot matmul's operands, which
this sampler does not have) and the DMA double buffer.

With `--backward` it probes the backward kernel instead, on the same
points and their layout (128, 128, 48): `csrc/triplane_bwd_probe.cu`
(the template of `csrc/triplane_bwd.cuh`, which `csrc/triplane_bwd.cu`
instantiates with every stage on) at the kernel's tile, the whole variant
held to `triplane.sample_mean_backward` at `BWD_RTOL` (the atomics sum in
another order each run); a time for the kernel with and without the
layout and on shuffled points, one for each variant of `BWD_VARIANTS`,
and the whole variant at each tile of `BWD_TILES`.
"""

from __future__ import annotations

import argparse

import torch

from ..core import camera
from ..core.kernels import build, triplane
from .measure import card_line, device_ms

B, RES, ND, HW, C = 4, 128, 48, 256, 32
STAGES = ("coords", "weights", "gather", "epilogue", "store")
VARIANTS = {
    "full": (),
    "no-coords": ("coords",),
    "no-weights": ("weights",),
    "no-gather": ("gather",),
    "no-epilogue": ("epilogue",),
    "no-store": ("store",),
    "no-coords-no-store": ("coords", "store"),
    "gather only": ("coords", "weights", "epilogue", "store"),
    "nothing": STAGES,
}

# Launches of the probe kernels in this process: forward, backward.
LAUNCHES = 0
LAUNCHES_BWD = 0

# The backward probe's variants (csrc/triplane_bwd_probe.cu), by name
BWD_VARIANTS = {
    "whole": 0,
    "global reductions as stores": 1,
    "no g read": 2,
    "no coordinate read": 3,
    "direct only (no sorted path)": 4,
    "direct only, stores": 5,
    "no texel adds": 6,
}
# the backward kernel's tile (rays x rays x samples), as csrc/triplane_bwd.cu
# sets it; then the tiles swept (at most 256 points)
BWD_TILE = (8, 8, 4)
BWD_TILES = ((4, 4, 16), (4, 8, 8), (8, 8, 4), (8, 16, 2), (16, 16, 1),
             (4, 4, 8), (8, 8, 2), (8, 4, 8))
# the backward kernel against the plain version: relative to the gradient's
# scale (a texel sums thousands of terms, with atomics, in another order)
BWD_RTOL = 1e-4


def stage_mask(removed=()) -> int:
    unknown = set(removed) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; known: {STAGES}")
    return sum(1 << i for i, s in enumerate(STAGES) if s not in removed)


def probe(planes: torch.Tensor, coordinates: torch.Tensor, box_warp: float,
          removed=()) -> torch.Tensor:
    """The sampler with the stages in `removed` taken out: (B, M, C). CUDA
    tensors only (fp32, contiguous); anything else raises."""
    if planes.device.type != "cuda":
        raise ValueError(f"probe: the kernel needs CUDA tensors, got "
                         f"{planes.device}")
    triplane._check_cuda_inputs("probe", planes.shape, planes.device,
                                {"coordinates": coordinates,
                                 "planes": planes})
    b, _, h, w, c = planes.shape
    if c % 4:
        raise ValueError(f"probe: the channel count must be a multiple of 4, "
                         f"got {c}")
    m = coordinates.shape[1]
    out = torch.zeros((b, m, c), dtype=torch.float32, device=planes.device)
    lib = build.library()
    global LAUNCHES
    with torch.cuda.device(planes.device):
        err = lib.hfa_triplane_probe(
            planes.data_ptr(), coordinates.data_ptr(), out.data_ptr(),
            b, m, h, w, c, 2.0 / box_warp, stage_mask(removed),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_probe")
    LAUNCHES += 1
    return out


def probe_backward(g: torch.Tensor, planes_shape, coordinates: torch.Tensor,
                   box_warp: float, layout=None, variant: int = 0,
                   tile=BWD_TILE) -> torch.Tensor:
    """The backward kernel's variant `variant` (`BWD_VARIANTS`) at the
    given tile (rays x rays x samples, at most 256 points; clamped to the
    layout): d planes (B, 3, H, W, C). CUDA tensors only (fp32,
    contiguous, C a multiple of 4 up to 32); anything else raises."""
    if g.device.type != "cuda":
        raise ValueError(f"probe_backward: the kernel needs CUDA tensors, "
                         f"got {g.device}")
    b, _, h, w, c = planes_shape
    triplane._check_cuda_inputs("probe_backward", planes_shape, g.device,
                                {"coordinates": coordinates, "g": g})
    m = coordinates.shape[1]
    if g.shape != (b, m, c) or c % 4 or c > 32:
        raise ValueError(f"probe_backward: g {tuple(g.shape)}, planes "
                         f"{tuple(planes_shape)} (C a multiple of 4, at "
                         f"most 32)")
    lh, lw, ln = triplane.check_layout("probe_backward", layout, m) \
        or (1, 1, m)
    grad = torch.zeros(tuple(planes_shape), dtype=torch.float32,
                       device=g.device)
    lib = build.library()
    global LAUNCHES_BWD
    with torch.cuda.device(g.device):
        err = lib.hfa_triplane_bwd_probe(
            g.data_ptr(), coordinates.data_ptr(), grad.data_ptr(), b, m, h,
            w, c, 2.0 / box_warp, lh, lw, ln, *tile, variant,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "hfa_triplane_bwd_probe")
    LAUNCHES_BWD += 1
    return grad


def probe_inputs(device, seed: int = 0):
    """Planes (4, 3, 256, 256, 32) and the points of 128² rays × 48 depths
    from four cameras drawn around the mean pose."""
    g = torch.Generator().manual_seed(seed)
    planes = (torch.randn((B, 3, HW, HW, C), generator=g) * 0.5).to(device)
    label = camera.sample_camera_label(
        g, n=B, r=2.7, horizontal_stddev=0.3, vertical_stddev=0.2,
        mode="normal")
    c2w, intr = camera.unpack_label(camera.flip_yz_label(label).to(device))
    ro, rd = camera.generate_rays(c2w, intr, RES)
    depths = torch.linspace(2.25, 3.3, ND, device=device)
    pts = ro[:, :, None, :] + depths[None, None, :, None] * rd[:, :, None, :]
    return planes, pts.reshape(B, -1, 3).contiguous()


def ablate_backward(g: torch.Tensor, planes_shape, pts: torch.Tensor, layout,
                    iters: int = 20) -> dict[str, float]:
    """ms of each variant of `BWD_VARIANTS` at the kernel's tile (CUDA
    events, median of `iters`); a variant's result means nothing."""
    return {name: device_ms(lambda: probe_backward(
        g, planes_shape, pts, 1.0, layout, v), iters)
        for name, v in BWD_VARIANTS.items()}


def main_backward(planes, pts, iters: int, seed: int) -> dict[str, float]:
    """The backward probe: see the module's docstring."""
    layout = (RES, RES, ND)
    g = torch.randn(pts.shape[:2] + (C,),
                    generator=torch.Generator().manual_seed(seed + 1)) \
        .to(pts.device)
    want = triplane.sample_mean_backward(g, planes.shape, pts, 1.0, layout)
    got = probe_backward(g, planes.shape, pts, 1.0, layout)
    torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    if not err <= BWD_RTOL:
        raise RuntimeError(f"the backward probe's whole variant differs from "
                           f"sample_mean_backward by {err:.3e} of the "
                           f"gradient's scale")
    print(f"whole variant equals sample_mean_backward to {err:.3e} of the "
          f"gradient's scale (bound {BWD_RTOL:g}; g {tuple(g.shape)}, layout "
          f"{layout}, tile {BWD_TILE})", flush=True)
    shuffled = pts[:, torch.randperm(
        pts.shape[1], generator=torch.Generator().manual_seed(seed)).to(
        pts.device)].contiguous()
    times = {
        "kernel, layout": device_ms(lambda: triplane.sample_mean_backward(
            g, planes.shape, pts, 1.0, layout), iters),
        "kernel, no layout": device_ms(lambda: triplane.sample_mean_backward(
            g, planes.shape, pts, 1.0), iters),
        "kernel, shuffled points": device_ms(
            lambda: triplane.sample_mean_backward(g, planes.shape, shuffled,
                                                  1.0), iters),
        **ablate_backward(g, planes.shape, pts, layout, iters)}
    for tile in BWD_TILES:
        times[f"whole, tile {tile}"] = device_ms(
            lambda: probe_backward(g, planes.shape, pts, 1.0, layout, 0, tile),
            iters)
    for name, t in times.items():
        print(f"{name:>40}: {t:8.4f} ms", flush=True)
    return times


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backward", action="store_true",
                   help="probe the backward kernel instead")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sampler needs a CUDA card")
    device = torch.device("cuda")
    print(card_line(), flush=True)
    planes, pts = probe_inputs(device, args.seed)
    if args.backward:
        return main_backward(planes, pts, args.iters, args.seed)
    want = triplane.sample_mean(planes, pts, 1.0)
    got = probe(planes, pts, 1.0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(
            "the probe's full variant differs from sample_mean: max abs "
            f"{(got - want).abs().max().item():.3e}")
    print(f"full variant equals sample_mean bit for bit "
          f"(planes {tuple(planes.shape)}, points {tuple(pts.shape)})",
          flush=True)
    times = {"sample_mean": device_ms(
        lambda: triplane.sample_mean(planes, pts, 1.0), args.iters)}
    print(f"{'sample_mean':>20}: {times['sample_mean']:8.4f} ms", flush=True)
    for name, removed in VARIANTS.items():
        times[name] = device_ms(lambda: probe(planes, pts, 1.0, removed),
                              args.iters)
        print(f"{name:>20}: {times[name]:8.4f} ms", flush=True)
    return times


if __name__ == "__main__":
    main()
