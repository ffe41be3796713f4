"""Ablation probe of the tri-plane sampler on the card: which stage of
`csrc/triplane.cu` owns its time (port of the JAX package's
tools/probe_sampler.py and tools/probe_sampler2.py).

    python -m hfa_gp_tpu_torch.tools.probe_sampler [--iters 20]

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

# Launches of the probe kernel in this process.
LAUNCHES = 0


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


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_sampler needs a CUDA card")
    device = torch.device("cuda")
    print(card_line(), flush=True)
    planes, pts = probe_inputs(device, args.seed)
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
