#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`hfa_gp_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure exits non-zero before the
result line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the build of the CUDA kernels from `hfa_gp_tpu_torch/csrc`, timed;
  3. each kernel (sampler and marcher, forward and backward; the flash-CE
     statistics, forward and backward; the sampler's ablation probe)
     against its plain PyTorch version on the card, at the main paths'
     shapes, in fp32, with kernel, plain and library-call times (CUDA
     events, median of 20) beside the bound computed from the shapes; the
     sampler also at the reenactment path's batch 8, at channel counts
     that take its general paths and on planes with non-finite edges; its
     backward at batch 2 and 8 with the points' layout, without it and on
     shuffled points, on its general paths (C 8, 48, 30, a grazing camera,
     off-plane points), and its ablation (a time per variant); the marcher
     at N 96 and 48; the flash-CE kernels also at a batch above one group
     of rows with ragged class and depth counts, d w bit for bit across
     two launches, and the backward's ablation (a time per variant);
  4. the reenactment path through its entry point, `hfa_gp_tpu_torch.cli.
     run_recon_video_rgb.main`, at full width on a 4-frame synthetic
     dataset: 4 PNGs of 512², a video, finite frames, and each forward
     kernel launched exactly twice per batch;
  5. one frame rendered on the card (kernels) and on the CPU (plain
     versions) from the same seeded params;
  6. steady-state frames/s of encoder → subspace → synthesis at batch 8,
     and the peak device memory (printed, not asserted);
  7. the training path through `hfa_gp_tpu_torch.cli.train_rgb.main` at
     full width, batch 2, on a synthetic train/test dataset: 4 steps that
     cross --tune_iter, finite losses, the generator untouched before
     tune_iter and changed after, display and bases PNGs, checkpoints, the
     four kernels' launch counts; then a resumed run that continues from
     the saved step; then `run_recon_video_rgb.main --model_path` on the
     checkpoint;
  8. one training step's loss and gradients at full width, batch 1, card
     (kernels) against CPU (plain versions), from the same seeded params;
  9. steady-state training steps/s and frames/s at batch 2, and the peak
     device memory (printed, not asserted);
 10. the arcface training path through `hfa_gp_tpu_torch.cli.train_arcface.
     main` at full width (iresnet50, 512-d, batch 256, fp32): 6 steps at
     1,000,000 classes dense with checkpoints, a resumed run to 8 steps,
     and 6 steps at 3,000,000 classes with `--sample_rate 0.1`; finite
     losses of the expected size that do not rise, one forward and one
     backward flash-CE launch per step, and on the sparse run a peak
     memory that leaves no room for a table-sized gradient;
 11. one arcface step's loss and gradients (iresnet50, 10,000 classes,
     batch 8), card (kernels) against CPU (plain versions), from the same
     seeded state and batch;
 12. steady-state arcface samples/s and peak device memory at the two
     configurations of 10 (printed, not asserted);
 13. the sampler probes through their entry point, `hfa_gp_tpu_torch.
     tools.probe_sampler.main`: the forward's full variant equal to the
     sampler bit for bit, and a time per variant; with `--backward` the
     backward's whole variant held to the kernel, a time per variant and
     per tile.

Before the summary it prints, for each kernel, launches x (ms - bound) per
reenactment batch, RGB step and arcface step. The line before the last is a
JSON summary of the kernels; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, with no result line, when CUDA is unavailable or when
it is run outside a checkout. It imports nothing of JAX or of the JAX
package `hfa_gp_tpu`, and checks that before the result line.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# kernel vs plain on the card (fp32, TF32 off):
#   sampler: the coordinate unnormalization ((u+1)·W−1)/2 may round one ulp
#   differently from F.grid_sample's (FMA contraction), ~3e-5 texels at
#   W = 256, times a neighbour difference of unit-normal features (≤ ~4)
SAMPLER_ATOL = 1e-4
#   marcher: the bound of the JAX package's own kernel test
MARCH_RTOL, MARCH_ATOL = 1e-4, 1e-5
#   backward kernels: a plane texel sums thousands of fp32 contributions,
#   on the card with atomics whose order changes from run to run, in the
#   plain version in grid_sample's own order; a density sums ~N terms of a
#   running product. Relative to the gradient's scale (max abs)
BWD_RTOL = 1e-4
#   card vs CPU image: fp32 sums in other orders through ~40 conv layers;
#   relative to the image's scale
E2E_RTOL = 2e-3
#   card vs CPU, one training step: the same, forward and backward, plus
#   the atomics; loss relative, each gradient relative to its own scale
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_RTOL = 1e-2

#   flash-CE kernels vs plain: exp(s·cos − s) with s = 64 turns a cosine
#   error of 1e-7 (one fp32 product of depth 512, summed in another order)
#   into 6e-6 relative; se_x relative, tgt_raw absolute, the gradients
#   relative to their scale (d norm_emb is summed with atomics)
CE_SE_RTOL, CE_TGT_ATOL = 1e-4, 1e-6
#   with bf16 operands the kernel rounds draw to bfloat16 (2^-9 relative)
#   before the gradient products, the plain version's autograd does not:
#   the bound of the card-only test
CE_BF16_BWD_RTOL = 2e-2
#   card vs CPU, one arcface step (53 conv layers, train-mode BN at batch
#   8). PReLU's derivative jumps from 0.25 to 1 at 0: an input within
#   rounding of 0 takes one slope on the card and the other on the CPU, and
#   that one element moves the gradients of the conv and BN right in front of
#   it by a few per cent of their largest entry (2 % seen in the third
#   stage, 1,568 positions a channel; the last stage has 392). So with PReLU
#   every gradient is held to 1e-2 in the L2 norm and, as a coarse net, to
#   1e-1 at its worst entry, and the same step with a smooth activation in
#   PReLU's place to 1e-3 at its worst entry
ARC_LOSS_RTOL = 1e-4
ARC_GRAD_L2_RTOL = 1e-2
ARC_GRAD_RTOL = 1e-1
ARC_GRAD_SMOOTH_RTOL = 1e-3
#   the arcface loss may wander from step to step on fresh random batches;
#   it must not rise above the first step's by more than this factor
ARC_LOSS_RISE = 1.05

# the card's peaks for the bounds (NVIDIA H100 SXM data sheet): device
# memory rate, and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one fn(), after warm-up: the median of `iters`
    CUDA-event timings of about 2 ms of back-to-back calls, over their
    count (`tools.measure.device_ms`: the host's time to issue a call hides
    behind the card's work, as on the paths)."""
    from hfa_gp_tpu_torch.tools.measure import device_ms
    return device_ms(fn, iters, warmup)


def bound(n_bytes: float, n_flops: float) -> dict:
    """The least time the card could take: the larger of compulsory bytes
    over the memory rate and fp32 operations over the peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flops = n_flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, the same over want's max abs)."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def phase_build() -> None:
    from hfa_gp_tpu_torch.core.kernels import build
    t0 = time.perf_counter()
    build.library()
    log = build.BUILD_LOG
    print(f"[2] built {log['path']} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {log.get('seconds', 0.0):.2f} s; by source "
          f"{ {k: round(v, 1) for k, v in log.get('each', {}).items()} })",
          flush=True)
    for line in log.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    {line.strip()}", flush=True)


# how main_path_points lie: 128 x 128 rays, row-major, of 48 samples each
MAIN_LAYOUT = (128, 128, 48)


def grid_points(dev: torch.device, batch: int, res: int, n: int,
                yaw: float = 0.0) -> torch.Tensor:
    """(batch, res²·n, 3) stratified points of res² rays, n samples each,
    row-major and samples fastest (the layout (res, res, n)), from a camera
    turned `yaw` radians off the mean pose."""
    from hfa_gp_tpu_torch.core import camera
    from hfa_gp_tpu_torch.models.eg3d.renderer import (RenderConfig,
                                                       sample_stratified)
    rc = RenderConfig()
    label = camera.flip_yz_label(camera.sample_camera_label(
        None, mode=None, horizontal_mean=np.pi / 2 + yaw))
    c2w, intr = camera.unpack_label(label.repeat(batch, 1).to(dev))
    o, d = camera.generate_rays(c2w, intr, res)
    depths = sample_stratified(o, rc.ray_start, rc.ray_end, n)
    return (o[:, :, None] + depths * d[:, :, None]).reshape(batch, -1, 3) \
        .contiguous()


def main_path_points(dev: torch.device, batch: int) -> torch.Tensor:
    """(batch, 128²·48, 3) points of the coarse pass for the mean camera,
    laid out as MAIN_LAYOUT."""
    return grid_points(dev, batch, *MAIN_LAYOUT[1:])


def in_bounds_corners(pts: torch.Tensor, h: int, w: int) -> int:
    """How many (point, plane, corner) triples of the bilinear footprints
    lie inside the planes (box_warp 1): what the sampler kernels' arithmetic
    depends on in this run's data."""
    from hfa_gp_tpu_torch.core.kernels.triplane import project_onto_planes
    uv = project_onto_planes(2.0 * pts)                     # (B, 3, M, 2)
    fx = torch.floor(((uv[..., 0] + 1) * w - 1) / 2)
    fy = torch.floor(((uv[..., 1] + 1) * h - 1) / 2)
    nx = ((fx >= 0) & (fx < w)).long() + ((fx + 1 >= 0) & (fx + 1 < w)).long()
    ny = ((fy >= 0) & (fy < h)).long() + ((fy + 1 >= 0) & (fy + 1 < h)).long()
    return int((nx * ny).sum())


def phase_sampler_general_paths(dev: torch.device, g) -> None:
    """The sampler at channel counts other than 32 (16-byte lanes at another
    lane count, and one float a lane), on non-square planes, at off-plane
    points, and beside texels that are not finite."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    worst = 0.0
    for b, m, h, w, c in ((2, 40000, 64, 64, 8), (1, 40000, 32, 48, 48),
                          (1, 30000, 32, 32, 30), (3, 7777, 16, 16, 128)):
        planes = torch.randn((b, 3, h, w, c), generator=g).to(dev)
        for spread in (1.0, 3.0):
            pts = ((torch.rand((b, m, 3), generator=g) - 0.5) * spread).to(dev)
            got = triplane.sample_mean(planes, pts, 1.0)
            want = triplane.sample_mean_plain(planes, pts, 1.0)
            worst = max(worst, (got - want).abs().max().item())
    # NaN in every plane's last column and row: a point just outside the
    # first column or row has out-of-plane corners whose addresses fall on
    # those texels; they must contribute exactly 0
    planes = torch.randn((2, 3, 32, 32, 32), generator=g)
    planes[:, :, -1] = float("nan")
    planes[:, :, :, -1] = float("nan")
    planes = planes.to(dev)
    pts = (-0.5 + (torch.rand((2, 4096, 3), generator=g) - 0.5) / 32).to(dev)
    got = triplane.sample_mean(planes, pts, 1.0)
    want = triplane.sample_mean_plain(planes, pts, 1.0)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(want).all())
    worst = max(worst, (got - want).abs().max().item())
    print(f"[3] sampler kernel vs plain on its general paths (C 8, 48, 30, "
          f"128; 32 x 48 planes; off-plane points) and beside non-finite "
          f"texels: max abs err {worst:.3e} (bound {SAMPLER_ATOL:g}), finite "
          f"{finite}", flush=True)
    if not finite or not worst <= SAMPLER_ATOL:
        fail(f"sampler kernel on its general paths: err {worst}, finite "
             f"{finite}")


def sampler_at_batch(dev: torch.device, g, batch: int) -> dict:
    """The sampler's time, plain time and bound at another batch of the
    main path's points (the reenactment path renders batch 8)."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    planes = torch.randn((batch, 3, 256, 256, 32), generator=g).to(dev)
    pts = main_path_points(dev, batch)
    out = triplane.sample_mean(planes, pts, 1.0)
    want = triplane.sample_mean_plain(planes, pts, 1.0)
    torch.cuda.synchronize()
    err = (out - want).abs().max().item()
    if not err <= SAMPLER_ATOL:
        fail(f"sampler kernel disagrees with its plain version at batch "
             f"{batch}: {err}")
    ms = cuda_time_ms(lambda: triplane.sample_mean(planes, pts, 1.0))
    plain_ms = cuda_time_ms(lambda: triplane.sample_mean_plain(planes, pts,
                                                               1.0))
    corners = in_bounds_corners(pts, 256, 256)
    c = planes.shape[-1]
    bd = bound(nbytes(planes, pts, out),
               corners * 2 * c + pts.shape[0] * pts.shape[1] * (c + 60))
    print(f"    triplane_sampler at batch {batch}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']}, max abs err {err:.3e}; the gather reads "
          f"{corners * c * 4 / 1e6:.1f} MB", flush=True)
    return {f"ms_batch{batch}": ms, f"plain_ms_batch{batch}": plain_ms,
            f"bound_ms_batch{batch}": bd["bound_ms"]}


def sampler_bwd_cases(dev, g, planes_shape, pts):
    """K2 on the main path's points with their layout, without it, and on
    the same points shuffled (with their cotangents, so the gradient is
    the same): {case: (g, points, layout)}, and the plain version's
    gradient."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    b, m = pts.shape[:2]
    cot = torch.randn((b, m, planes_shape[-1]), generator=g).to(dev)
    perm = torch.randperm(m, generator=g).to(dev)
    cases = {"layout": (cot, pts, MAIN_LAYOUT), "no layout": (cot, pts, None),
             "shuffled": (cot[:, perm].contiguous(), pts[:, perm].contiguous(),
                          None)}
    return cases, triplane.sample_mean_backward_plain(cot, planes_shape, pts,
                                                      1.0)


def phase_sampler_backward(dev, g, planes, pts, off) -> dict:
    """K2/K3 at batch 2 and 8 (main path's points with their layout, without
    it, shuffled), off-plane, on its general paths; plain and library-call
    times; the ablation (a time per variant of the probe)."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    from hfa_gp_tpu_torch.tools import probe_sampler
    shape = planes.shape
    c = shape[-1]
    cases, want = sampler_bwd_cases(dev, g, shape, pts)
    cot_off = torch.randn((2, off.shape[1], c), generator=g).to(dev)
    errs = {}
    for name, (cot, p, layout) in cases.items():
        errs[name] = rel_err(triplane.sample_mean_backward(
            cot, shape, p, 1.0, layout), want)
    errs["off-plane"] = rel_err(
        triplane.sample_mean_backward(cot_off, shape, off, 1.0),
        triplane.sample_mean_backward_plain(cot_off, shape, off, 1.0))
    torch.cuda.synchronize()
    err = max(e for e, _ in errs.values())
    rel = max(r for _, r in errs.values())
    print(f"[3] sampler backward kernel vs plain, batch 2: "
          + ", ".join(f"{k} {r:.3e}" for k, (_, r) in errs.items())
          + f" of the gradient's scale (bound {BWD_RTOL:g}; g "
          f"{(2, pts.shape[1], c)}, layout {MAIN_LAYOUT}; off-plane "
          f"{tuple(cot_off.shape)})", flush=True)
    if not rel <= BWD_RTOL:
        fail(f"sampler backward kernel disagrees with its plain version: "
             f"{errs}")
    phase_sampler_bwd_general_paths(dev, g)
    times = {name: cuda_time_ms(lambda: triplane.sample_mean_backward(
        cot, shape, p, 1.0, layout)) for name, (cot, p, layout) in cases.items()}
    cot = cases["layout"][0]
    plain_ms = cuda_time_ms(lambda: triplane.sample_mean_backward_plain(
        cot, shape, pts, 1.0))
    # the library call: autograd's backward of F.grid_sample + mean alone
    # (the plain version also runs the forward)
    leaf = planes.clone().requires_grad_(True)
    graph = triplane.sample_mean_plain(leaf, pts, 1.0)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        graph, leaf, cot, retain_graph=True))
    del leaf, graph
    corners = in_bounds_corners(pts, shape[2], shape[3])
    n_points = pts.shape[0] * pts.shape[1]
    entry = kernel_entry(
        "triplane_sampler_bwd", "hfa_gp_tpu_torch/csrc/triplane_bwd.cu",
        "hfa_gp_tpu/core/pallas/triplane.py:466", err, times["layout"],
        plain_ms, library_ms, nbytes(cot, pts, planes),
        corners * 2 * c + n_points * (c + 60))
    # one kernel for both TPU backward kernels (VMEM and HBM accumulator)
    entry["also_replaces"] = "hfa_gp_tpu/core/pallas/triplane.py:414"
    entry["max_err_over_scale"] = rel
    entry["ms_no_layout"] = times["no layout"]
    entry["ms_shuffled"] = times["shuffled"]
    print(f"    batch 2: with the layout {times['layout']:.4f} ms, without "
          f"{times['no layout']:.4f} ms, shuffled points "
          f"{times['shuffled']:.4f} ms", flush=True)
    # what each stage costs: a time per variant of the probe (a variant's
    # result means nothing)
    ablation = probe_sampler.ablate_backward(cot, shape, pts, MAIN_LAYOUT)
    print("    sampler backward, ablation at batch 2 with the layout (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ablation.items()),
          flush=True)
    entry["ablation_ms"] = ablation
    del cases, want

    # batch 8, the reenactment path's batch
    shape8 = (8, *shape[1:])
    pts8 = main_path_points(dev, 8)
    cases, want = sampler_bwd_cases(dev, g, shape8, pts8)
    rel8 = max(rel_err(triplane.sample_mean_backward(cot, shape8, p, 1.0,
                                                     layout), want)[1]
               for cot, p, layout in cases.values())
    torch.cuda.synchronize()
    if not rel8 <= BWD_RTOL:
        fail(f"sampler backward kernel disagrees with its plain version at "
             f"batch 8: {rel8} of the gradient's scale")
    times8 = {name: cuda_time_ms(lambda: triplane.sample_mean_backward(
        cot, shape8, p, 1.0, layout)) for name, (cot, p, layout)
        in cases.items()}
    cot = cases["layout"][0]
    plain8 = cuda_time_ms(lambda: triplane.sample_mean_backward_plain(
        cot, shape8, pts8, 1.0), iters=5)
    corners8 = in_bounds_corners(pts8, shape[2], shape[3])
    bd8 = bound(nbytes(cot, pts8) + 4 * int(np.prod(shape8)),
                corners8 * 2 * c + pts8.shape[0] * pts8.shape[1] * (c + 60))
    print(f"    batch 8: with the layout {times8['layout']:.4f} ms, without "
          f"{times8['no layout']:.4f} ms, shuffled points "
          f"{times8['shuffled']:.4f} ms; plain {plain8:.4f} ms, bound "
          f"{bd8['bound_ms']:.4f} ms by {bd8['bound_by']}; "
          f"{rel8:.3e} of the gradient's scale", flush=True)
    entry.update({"ms_batch8": times8["layout"],
                  "ms_no_layout_batch8": times8["no layout"],
                  "ms_shuffled_batch8": times8["shuffled"],
                  "plain_ms_batch8": plain8,
                  "bound_ms_batch8": bd8["bound_ms"]})
    del cases, want, pts8, cot
    torch.cuda.empty_cache()
    return entry


def phase_sampler_bwd_general_paths(dev, g) -> None:
    """K2 where the main path does not take it: C 8 (the sorted path, two
    lanes a texel row), 48 (the direct pass, 16 bytes a lane) and 30 (the
    direct pass, one float a lane), non-square planes, tiles whose boxes
    overflow the sorted path's buckets (a camera turned 1.3 rad), tiles cut
    by the edge of the layout, off-plane points, batch 3."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    worst = 0.0
    for b, (h, w), c, res, n, yaw, spread in (
            (3, (64, 64), 8, 37, 11, 0.0, None),
            (2, (32, 48), 48, 20, 7, 0.4, None),
            (2, (32, 32), 30, 16, 9, 0.0, None),
            (2, (256, 256), 32, 64, 48, 1.3, None),
            (2, (64, 64), 32, 30, 13, 0.0, 3.0)):
        shape = (b, 3, h, w, c)
        pts = grid_points(dev, b, res, n, yaw)
        if spread is not None:
            pts = ((torch.rand(pts.shape, generator=g) - 0.5) * spread).to(dev)
        cot = torch.randn((b, pts.shape[1], c), generator=g).to(dev)
        want = triplane.sample_mean_backward_plain(cot, shape, pts, 1.0)
        for layout in ((res, res, n), None):
            got = triplane.sample_mean_backward(cot, shape, pts, 1.0, layout)
            worst = max(worst, rel_err(got, want)[1])
    torch.cuda.synchronize()
    print(f"[3] sampler backward kernel vs plain on its general paths (C 8, "
          f"48, 30; 32 x 48 planes; a camera turned 1.3 rad; ragged tiles; "
          f"off-plane points; with and without the layout): {worst:.3e} of "
          f"the gradient's scale (bound {BWD_RTOL:g})", flush=True)
    if not worst <= BWD_RTOL:
        fail(f"sampler backward kernel on its general paths: {worst}")


def kernel_entry(name, source, replaces, err, ms, plain_ms, library_ms,
                 n_bytes, n_flops) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, **bound(n_bytes, n_flops),
             "library_ms": library_ms}
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"call {lib}, bound {entry['bound_ms']:.4f} ms by "
          f"{entry['bound_by']} ({n_bytes / 1e6:.1f} MB, "
          f"{n_flops / 1e9:.3f} GFLOP)", flush=True)
    return entry


def phase_kernels(dev: torch.device) -> list[dict]:
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    g = torch.Generator().manual_seed(SEED)
    results = []

    # -- sampler: planes (2, 3, 256, 256, 32), coarse-pass points
    planes = torch.randn((2, 3, 256, 256, 32), generator=g).to(dev)
    pts = main_path_points(dev, 2)
    off = ((torch.rand((2, 65536, 3), generator=g) - 0.5) * 3.0).to(dev)
    c = planes.shape[-1]
    err = 0.0
    for p in (pts, off):
        got = triplane.sample_mean(planes, p, 1.0)
        want = triplane.sample_mean_plain(planes, p, 1.0)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
    print(f"[3] sampler kernel vs plain: max abs err {err:.3e} "
          f"(bound {SAMPLER_ATOL:g}; planes {tuple(planes.shape)}, points "
          f"{tuple(pts.shape)} + {tuple(off.shape)} off-plane)", flush=True)
    if not err <= SAMPLER_ATOL:
        fail(f"sampler kernel disagrees with its plain version: {err}")
    phase_sampler_general_paths(dev, g)
    out = triplane.sample_mean(planes, pts, 1.0)
    ms = cuda_time_ms(lambda: triplane.sample_mean(planes, pts, 1.0))
    plain_ms = cuda_time_ms(lambda: triplane.sample_mean_plain(planes, pts,
                                                               1.0))
    # the library call: F.grid_sample on the three planes, then the mean
    # (the plain version is exactly that call; timed again on its own)
    library_ms = cuda_time_ms(lambda: triplane.sample_from_planes(
        planes, pts, 1.0).mean(1))
    corners = in_bounds_corners(pts, 256, 256)
    n_points = pts.shape[0] * pts.shape[1]
    # per in-bounds corner and channel a multiply and an add; per point the
    # /3 of each channel and ~60 operations of coordinates and weights
    results.append(kernel_entry(
        "triplane_sampler", "hfa_gp_tpu_torch/csrc/triplane.cu",
        "hfa_gp_tpu/core/pallas/triplane.py:299", err, ms, plain_ms,
        library_ms, nbytes(planes, pts, out),
        corners * 2 * c + n_points * (c + 60)))
    # the bound counts each plane byte once; the gather itself reads every
    # in-bounds corner's channels, from L1 and L2
    results[-1]["gather_bytes"] = corners * c * 4
    print(f"    the gather reads {corners} in-bounds corners x {c * 4} B = "
          f"{corners * c * 4 / 1e6:.1f} MB: {corners * c * 4 / ms / 1e6:.1f} "
          f"GB/s at the kernel's time", flush=True)
    results[-1].update(sampler_at_batch(dev, g, 8))

    # -- sampler backward: g (2, 786432, 32) → d planes
    results.append(phase_sampler_backward(dev, g, planes, pts, off))
    del planes, pts, off, out

    # -- marcher: (2, 16384, 96, 32), the unified pass; then (2, 16384, 48,
    # 32), the coarse pass
    b, r, c = 2, 16384, 32
    marcher = {}
    for n in (96, 48):
        colors = torch.rand((b, r, n, c), generator=g).to(dev)
        dens = (torch.randn((b, r, n, 1), generator=g) * 3.0).to(dev)
        depths = torch.sort(2.25 + 1.05 * torch.rand((b, r, n, 1),
                                                      generator=g),
                            dim=2).values.to(dev)
        got = raymarch.ray_march(colors, dens, depths)
        want = raymarch.ray_march_plain(colors, dens, depths)
        torch.cuda.synchronize()
        err = 0.0
        for name, x, y in zip(("rgb", "depth", "weights"), got, want):
            e = (x - y).abs()
            err = max(err, e.max().item())
            if not bool((e <= MARCH_ATOL + MARCH_RTOL * y.abs()).all()):
                fail(f"marcher kernel disagrees with its plain version on "
                     f"{name} at N {n}: max abs err {e.max().item()}")
        print(f"[3] marcher kernel vs plain: max abs err {err:.3e} (bound "
              f"rtol {MARCH_RTOL:g} atol {MARCH_ATOL:g}; colors "
              f"{tuple(colors.shape)})", flush=True)
        ms = cuda_time_ms(lambda: raymarch.ray_march(colors, dens, depths))
        plain_ms = cuda_time_ms(lambda: raymarch.ray_march_plain(
            colors, dens, depths))
        # per midpoint and channel 4 operations, per midpoint ~25 of
        # density and transmittance; no single PyTorch call computes the
        # march
        marcher[n] = kernel_entry(
            "ray_marcher", "hfa_gp_tpu_torch/csrc/raymarch.cu",
            "hfa_gp_tpu/core/pallas/raymarch.py:27", err, ms, plain_ms, None,
            nbytes(colors, dens, depths, *got),
            b * r * (n - 1) * (4 * c + 25))
        if n == 96:
            # the backward below runs on the unified pass's inputs
            march_in = (colors, dens, depths, want)
        del colors, dens, depths, got
    results.append(marcher[96])
    # one launch of each a reenactment batch or RGB step: the coarse pass's
    results[-1].update({"ms_n48": marcher[48]["ms"],
                        "plain_ms_n48": marcher[48]["plain_ms"],
                        "bound_ms_n48": marcher[48]["bound_ms"],
                        "max_abs_err_n48": marcher[48]["max_abs_err"]})
    colors, dens, depths, want = march_in
    n = 96
    del march_in

    # -- marcher backward: all three cotangents
    cots = [torch.randn(x.shape, generator=g).to(dev) for x in want]
    got = raymarch.ray_march_backward(colors, dens, depths, *cots)
    want = raymarch.ray_march_backward_plain(colors, dens, depths, *cots)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for x, y in zip(got, want):
        e, r_ = rel_err(x, y)
        err, rel = max(err, e), max(rel, r_)
    print(f"[3] marcher backward kernel vs plain: max abs err {err:.3e}, "
          f"{rel:.3e} of the gradient's scale (bound {BWD_RTOL:g}; "
          f"cotangents of rgb, depth and weights)", flush=True)
    if not rel <= BWD_RTOL:
        fail(f"marcher backward kernel disagrees with its plain version: "
             f"{rel} of the gradient's scale")
    ms = cuda_time_ms(lambda: raymarch.ray_march_backward(colors, dens,
                                                          depths, *cots))
    plain_ms = cuda_time_ms(lambda: raymarch.ray_march_backward_plain(
        colors, dens, depths, *cots))
    # per sample and channel 3 operations (dot product, d colors), per
    # midpoint ~40 of the two walks; no single PyTorch call computes it
    results.append(kernel_entry(
        "ray_marcher_bwd", "hfa_gp_tpu_torch/csrc/raymarch_bwd.cu",
        "hfa_gp_tpu/core/pallas/raymarch.py:27", err, ms, plain_ms, None,
        nbytes(colors, dens, depths, *cots, *got),
        b * r * (n * 3 * c + (n - 1) * 40)))
    results[-1]["note"] = ("the TPU kernel has no backward: the JAX package "
                           "differentiates renderer.ray_march instead")
    del colors, dens, depths, cots, got, want
    results += phase_kernels_flash_ce(dev, g)
    results.append(phase_kernels_probe(dev))
    return results


def ce_inputs(dev, g, b: int, d: int, c: int):
    """Unit-row embeddings, a PartialFC-sized table (N(0, 0.01²) rows, a few
    of them near their row's embedding so that some exp terms are not
    tiny), labels with a few −1."""
    ne = torch.randn((b, d), generator=g)
    ne = (ne / ne.norm(dim=1, keepdim=True)).to(dev)
    w = torch.randn((c, d), generator=torch.Generator(dev).manual_seed(SEED),
                    device=dev) * 0.01
    lab = torch.randint(0, c, (b,), generator=g).int()
    lab[::9] = -1
    lab = lab.to(dev)
    near = torch.arange(1, b, 7, device=dev)
    near = near[lab[near] >= 0]
    w[lab[near].long()] = 0.02 * ne[near] + 5e-4 * torch.randn(
        (near.numel(), d), generator=g).to(dev)
    return ne, w, lab


def phase_kernels_flash_ce(dev: torch.device, g) -> list[dict]:
    """K5 and K6 at the arcface path's shapes: B 256, d 512, fp32, the
    dense table of 1,000,000 classes and the 300,000 sampled rows of the
    3,000,000-class table."""
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    s, b, d = 64.0, 256, 512
    entries = {}
    for c in (300_000, 1_000_000):
        ne, w, lab = ce_inputs(dev, g, b, d, c)
        se, tgt = flash_ce.flash_ce_stats(ne, w, lab, s)
        se_p, tgt_p = flash_ce.flash_ce_stats_plain(ne, w, lab, s)
        torch.cuda.synchronize()
        se_rel = ((se - se_p).abs() / se_p.abs().clamp_min(1e-30)).max().item()
        tgt_err = (tgt - tgt_p).abs().max().item()
        print(f"[3] flash-CE forward kernel vs plain, C {c}: se_x max rel err "
              f"{se_rel:.3e} (bound {CE_SE_RTOL:g}), tgt_raw max abs err "
              f"{tgt_err:.3e} (bound {CE_TGT_ATOL:g}); se_x in "
              f"[{se_p.min().item():.3e}, {se_p.max().item():.3e}]",
              flush=True)
        if not se_rel <= CE_SE_RTOL or not tgt_err <= CE_TGT_ATOL:
            fail(f"flash-CE forward kernel disagrees with its plain version "
                 f"at C {c}: se_x {se_rel}, tgt_raw {tgt_err}")
        if not bool((tgt[lab < 0] == 0).all()):
            fail("flash-CE forward: tgt_raw is not 0 where the label is < 0")
        # cotangents of the size the loss gives them: d log(se) and d tgt
        ct_se = (torch.randn((b,), generator=g).to(dev) / se_p).contiguous()
        ct_tgt = torch.randn((b,), generator=g).to(dev)
        got = flash_ce.flash_ce_stats_backward(ne, w, lab, s, None, ct_se,
                                               ct_tgt)
        want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, s, None,
                                                      ct_se, ct_tgt)
        torch.cuda.synchronize()
        errs = [rel_err(x, y) for x, y in zip(got, want)]
        rel = max(r for _, r in errs)
        print(f"[3] flash-CE backward kernel vs plain, C {c}: d norm_emb "
              f"{errs[0][1]:.3e}, d w {errs[1][1]:.3e} of the gradient's "
              f"scale (bound {BWD_RTOL:g})", flush=True)
        if not rel <= BWD_RTOL:
            fail(f"flash-CE backward kernel disagrees with its plain version "
                 f"at C {c}: {rel} of the gradient's scale")
        again = flash_ce.flash_ce_stats_backward(ne, w, lab, s, None, ct_se,
                                                 ct_tgt)
        torch.cuda.synchronize()
        if not torch.equal(again[1], got[1]):
            fail(f"flash-CE backward: d w differs between two launches at "
                 f"C {c}")
        run_to_run = rel_err(again[0], got[0])[1]
        print(f"    two launches: d w equal bit for bit, d norm_emb "
              f"{run_to_run:.3e} of its scale apart (atomics)", flush=True)
        del again
        if c != 1_000_000:
            del ne, w, lab, got, want
            continue
        ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats(ne, w, lab, s))
        plain_ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_plain(
            ne, w, lab, s))
        # no single PyTorch call computes the statistics; for the record,
        # the bare (B, d) x (d, C) product through torch.matmul
        matmul_ms = cuda_time_ms(lambda: torch.matmul(ne, w.T))
        print(f"    torch.matmul of the bare ({b}, {d}) x ({d}, {c}) product: "
              f"{matmul_ms:.4f} ms", flush=True)
        # the product, the row norms, and per cosine: scale, clip (2), the
        # exp's argument (2), the exp, the sum
        flops = 2.0 * b * d * c + 2.0 * c * d + 7.0 * b * c
        entries["fwd"] = kernel_entry(
            "flash_ce_fwd", "hfa_gp_tpu_torch/csrc/flash_ce.cu",
            "hfa_gp_tpu/parallel/pallas_ce.py:78", max(tgt_err, 0.0), ms,
            plain_ms, None, nbytes(ne, w, lab, se, tgt), flops)
        entries["fwd"]["max_rel_err_se_x"] = se_rel
        entries["fwd"]["matmul_ms"] = matmul_ms
        ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_backward(
            ne, w, lab, s, None, ct_se, ct_tgt))
        plain_ms = cuda_time_ms(
            lambda: flash_ce.flash_ce_stats_backward_plain(
                ne, w, lab, s, None, ct_se, ct_tgt))
        # three products (the recomputed cosines, d w, d norm_emb), the
        # norms, d w's second term (3 per element), ~14 per cosine
        flops = 6.0 * b * d * c + 5.0 * c * d + 14.0 * b * c
        entries["bwd"] = kernel_entry(
            "flash_ce_bwd", "hfa_gp_tpu_torch/csrc/flash_ce_bwd.cu",
            "hfa_gp_tpu/parallel/pallas_ce.py:108", max(e for e, _ in errs),
            ms, plain_ms, None, nbytes(ne, w, lab, ct_se, ct_tgt, *got),
            flops)
        entries["bwd"]["max_err_over_scale"] = rel
        # what each part of the backward kernel costs: a time per variant
        # with parts removed (a variant's result means nothing)
        from hfa_gp_tpu_torch.tools import profile_arcface
        ablation = profile_arcface.ablate_ce_backward(ne, w, lab, s, ct_se,
                                                      ct_tgt)
        print("    flash-CE backward, ablation (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ablation.items()), flush=True)
        entries["bwd"]["ablation_ms"] = ablation
        del ne, w, lab, got, want
    torch.cuda.empty_cache()
    phase_flash_ce_general_paths(dev, g)
    return [entries["fwd"], entries["bwd"]]


def phase_flash_ce_general_paths(dev: torch.device, g) -> None:
    """K5 and K6 where the fast path does not reach: more batch rows than a
    block holds at once (384 > 256), a ragged last class tile, a depth that
    is no multiple of 4 (scalar copies) and one that is no multiple of the
    slice depth, and bf16 operands."""
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    s = 64.0
    for b, d, c, mm in ((384, 512, 300_001, None), (384, 510, 30_001, None),
                        (8, 72, 1_000, None), (300, 128, 10_007,
                                               torch.bfloat16)):
        ne, w, lab = ce_inputs(dev, g, b, d, c)
        se, tgt = flash_ce.flash_ce_stats(ne, w, lab, s, mm)
        se_p, tgt_p = flash_ce.flash_ce_stats_plain(ne, w, lab, s, mm)
        ct_se = (torch.randn((b,), generator=g).to(dev) / se_p).contiguous()
        ct_tgt = torch.randn((b,), generator=g).to(dev)
        got = flash_ce.flash_ce_stats_backward(ne, w, lab, s, mm, ct_se,
                                               ct_tgt)
        again = flash_ce.flash_ce_stats_backward(ne, w, lab, s, mm, ct_se,
                                                 ct_tgt)
        want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, s, mm,
                                                      ct_se, ct_tgt)
        torch.cuda.synchronize()
        se_rel = ((se - se_p).abs() / se_p.abs().clamp_min(1e-30)).max().item()
        tgt_err = (tgt - tgt_p).abs().max().item()
        rel = max(rel_err(x, y)[1] for x, y in zip(got, want))
        # bf16 operands: the plain version rounds the same operands but sums
        # the gradient products of rounded draw in another order
        bound_ = BWD_RTOL if mm is None else CE_BF16_BWD_RTOL
        print(f"[3] flash-CE kernels vs plain, B {b}, d {d}, C {c}, operands "
              f"{'fp32' if mm is None else 'bf16'}: se_x {se_rel:.3e}, "
              f"tgt_raw {tgt_err:.3e}, gradients {rel:.3e} of their scale "
              f"(bound {bound_:g}); d w equal in two launches: "
              f"{torch.equal(got[1], again[1])}", flush=True)
        if not se_rel <= CE_SE_RTOL or not tgt_err <= CE_TGT_ATOL \
                or not rel <= bound_ or not torch.equal(got[1], again[1]):
            fail(f"flash-CE kernels at B {b}, d {d}, C {c}: se_x {se_rel}, "
                 f"tgt_raw {tgt_err}, gradients {rel}")
        del ne, w, lab, got, again, want
    torch.cuda.empty_cache()


def phase_kernels_probe(dev: torch.device) -> dict:
    """The sampler's ablation probe with every stage on, at the probe's
    shapes (batch 4, 128² x 48 points): equal to the sampler bit for bit."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    from hfa_gp_tpu_torch.tools import probe_sampler
    planes, pts = probe_sampler.probe_inputs(dev, SEED)
    got = probe_sampler.probe(planes, pts, 1.0)
    same = triplane.sample_mean(planes, pts, 1.0)
    want = triplane.sample_mean_plain(planes, pts, 1.0)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"[3] sampler probe, every stage on: equal to the sampler kernel "
          f"bit for bit: {torch.equal(got, same)}; vs plain max abs err "
          f"{err:.3e} (bound {SAMPLER_ATOL:g}; planes {tuple(planes.shape)}, "
          f"points {tuple(pts.shape)})", flush=True)
    if not torch.equal(got, same):
        fail("the probe's full variant differs from the sampler kernel")
    if not err <= SAMPLER_ATOL:
        fail(f"the probe disagrees with the sampler's plain version: {err}")
    ms = cuda_time_ms(lambda: probe_sampler.probe(planes, pts, 1.0))
    plain_ms = cuda_time_ms(lambda: triplane.sample_mean_plain(planes, pts,
                                                               1.0))
    library_ms = cuda_time_ms(lambda: triplane.sample_from_planes(
        planes, pts, 1.0).mean(1))
    c = planes.shape[-1]
    corners = in_bounds_corners(pts, 256, 256)
    n_points = pts.shape[0] * pts.shape[1]
    entry = kernel_entry(
        "triplane_probe", "hfa_gp_tpu_torch/csrc/triplane_probe.cu",
        "tools/probe_sampler.py:33", err, ms, plain_ms, library_ms,
        nbytes(planes, pts, got), corners * 2 * c + n_points * (c + 60))
    entry["also_replaces"] = "tools/probe_sampler2.py:32"
    return entry


def write_dataset(root: str, n: int = 4, size: int = 256,
                  split: str = "test2") -> None:
    """{root}/nerface_dataset/person_3/{split}/cropped_images: n PNGs and
    test.json (the layout of tests/fixtures.py), OpenCV labels of cameras
    around the mean pose."""
    from PIL import Image

    from hfa_gp_tpu_torch.core import camera
    d = os.path.join(root, "nerface_dataset", "person_3", split,
                     "cropped_images")
    os.makedirs(d)
    rng = np.random.default_rng(SEED + (split != "test2"))
    labels = []
    for i in range(n):
        fname = f"f_{i:04d}.png"
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8),
                        "RGB").save(os.path.join(d, fname))
        label = camera.flip_yz_label(camera.sample_camera_label(
            None, mode=None, horizontal_mean=np.pi / 2 + 0.05 * (i - 1.5)))
        labels.append([fname, label[0].tolist()])
    with open(os.path.join(d, "test.json"), "w") as f:
        json.dump({"labels": labels}, f)


# launches of each kernel on a reenactment batch, an RGB training step and
# an arcface step: what [4], [7] and [10] hold the counts to
LAUNCHES_PER_UNIT = {"triplane_sampler": (2, 2, 0),
                     "triplane_sampler_bwd": (0, 2, 0),
                     "ray_marcher": (2, 2, 0), "ray_marcher_bwd": (0, 1, 0),
                     "flash_ce_fwd": (0, 0, 1), "flash_ce_bwd": (0, 0, 1)}

NO_LAUNCHES = {"triplane_sampler": 0, "triplane_sampler_bwd": 0,
               "ray_marcher": 0, "ray_marcher_bwd": 0, "flash_ce_fwd": 0,
               "flash_ce_bwd": 0, "triplane_probe": 0,
               "triplane_bwd_probe": 0}


def reset_launches() -> None:
    from hfa_gp_tpu_torch.core.kernels import flash_ce, raymarch, triplane
    from hfa_gp_tpu_torch.tools import probe_sampler
    triplane.LAUNCHES = triplane.LAUNCHES_BWD = 0
    raymarch.LAUNCHES = raymarch.LAUNCHES_BWD = 0
    flash_ce.LAUNCHES = flash_ce.LAUNCHES_BWD = 0
    probe_sampler.LAUNCHES = probe_sampler.LAUNCHES_BWD = 0


def read_launches() -> dict[str, int]:
    from hfa_gp_tpu_torch.core.kernels import flash_ce, raymarch, triplane
    from hfa_gp_tpu_torch.tools import probe_sampler
    return {"triplane_sampler": triplane.LAUNCHES,
            "triplane_sampler_bwd": triplane.LAUNCHES_BWD,
            "ray_marcher": raymarch.LAUNCHES,
            "ray_marcher_bwd": raymarch.LAUNCHES_BWD,
            "flash_ce_fwd": flash_ce.LAUNCHES,
            "flash_ce_bwd": flash_ce.LAUNCHES_BWD,
            "triplane_probe": probe_sampler.LAUNCHES,
            "triplane_bwd_probe": probe_sampler.LAUNCHES_BWD}


def phase_main_path(tmp: str) -> dict[str, int]:
    from PIL import Image

    from hfa_gp_tpu_torch.cli import run_recon_video_rgb as cli
    n_frames, batch = 4, 4
    write_dataset(tmp, n_frames)
    args = cli.build_argparser().parse_args([
        "--dataset_root", tmp, "--person", "person_3", "--size", "256",
        "--render_batch", str(batch), "--demo_dir",
        os.path.join(tmp, "demo"), "--demo_name", "smoke", "--fps", "4",
        "--device", "cuda"])
    finite = []
    reenact = cli.reenact

    def checked(*a, **kw):
        out = reenact(*a, **kw)
        finite.append(bool(torch.isfinite(out).all()))
        return out

    cli.reenact = checked
    reset_launches()
    t0 = time.perf_counter()
    try:
        cli.main(args)
    finally:
        cli.reenact = reenact
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out_dir = os.path.join(tmp, "demo", "smoke")
    pngs = sorted(glob.glob(os.path.join(out_dir, "*.png")))
    videos = glob.glob(os.path.join(out_dir, "*.mp4")) \
        + glob.glob(os.path.join(out_dir, "*.avi"))
    sizes = {Image.open(p).size for p in pngs}
    n_batches = -(-n_frames // batch)
    print(f"[4] main path: {len(pngs)} PNGs {sorted(sizes)}, video "
          f"{[os.path.basename(v) for v in videos]}, finite {finite}, "
          f"launches {launches} over {n_batches} batch(es), {seconds:.2f} s "
          f"(params init and first-use costs included)", flush=True)
    if len(pngs) != n_frames or sizes != {(512, 512)}:
        fail(f"expected {n_frames} PNGs of 512², got {len(pngs)} {sizes}")
    if not videos:
        fail("no video written")
    if len(finite) != n_batches or not all(finite):
        fail(f"non-finite frames: {finite}")
    expected = {**NO_LAUNCHES, "triplane_sampler": 2 * n_batches,
                "ray_marcher": 2 * n_batches}
    if launches != expected:
        fail(f"reenactment launched {launches}, expected {expected}")
    return launches


def reference_inputs(cfg, batch: int):
    from hfa_gp_tpu_torch.core import camera
    g = torch.Generator().manual_seed(SEED + 1)
    image = torch.rand((batch, cfg.size, cfg.size, 3), generator=g) * 2 - 1
    label = camera.flip_yz_label(camera.sample_camera_label(None, mode=None))
    return image, label.repeat(batch, 1)


def phase_card_vs_cpu() -> None:
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    from hfa_gp_tpu_torch.models.avatar import heads, subspace
    cfg = heads.AvatarConfig()
    image, label = reference_inputs(cfg, 1)
    out = {}
    for dev in ("cuda", "cpu"):
        params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED),
                                       cfg, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            img = reenact(params, cfg, image.to(dev), label.to(dev)).cpu()
            q = subspace.orthonormal_basis(params["subspace"]).cpu()
        out[dev] = (img, q, time.perf_counter() - t0)
        del params
    (img_gpu, q_gpu, t_gpu), (img_cpu, q_cpu, t_cpu) = out["cuda"], out["cpu"]
    flips = int((torch.sign((q_gpu * q_cpu).sum(0)) < 0).sum())
    scale = max(1.0, img_cpu.abs().max().item())
    err = (img_gpu - img_cpu).abs().max().item()
    print(f"[5] card vs CPU, one frame at full width: max abs diff "
          f"{err:.3e}, image max abs {img_cpu.abs().max().item():.3e} (bound "
          f"{E2E_RTOL:g} x max(1, scale)); QR column sign flips {flips}; "
          f"card {t_gpu:.2f} s, CPU {t_cpu:.2f} s", flush=True)
    if not torch.isfinite(img_gpu).all():
        fail("non-finite card frame")
    if img_gpu.shape != (1, 512, 512, 3):
        fail(f"card frame shape {tuple(img_gpu.shape)}")
    if not err <= E2E_RTOL * scale:
        fail(f"card frame differs from the CPU frame by {err}")


def phase_throughput() -> None:
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    from hfa_gp_tpu_torch.models.avatar import heads
    batch, iters = 8, 5
    cfg = heads.AvatarConfig()
    params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED), cfg,
                                   "cuda")
    image, label = reference_inputs(cfg, batch)
    image, label = image.cuda(), label.cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: reenact(params, cfg, image, label),
                          iters=iters, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    fps = batch / (ms / 1e3)
    print(f"[6] batch {batch}: {ms:.2f} ms per batch (median of {iters}), "
          f"{fps:.3f} frames/s, peak device memory {peak / 2**30:.3f} GiB",
          flush=True)


def phase_train_path(tmp: str) -> dict[str, int]:
    """[7] train_rgb.main → resumed train_rgb.main → run_recon_video_rgb
    --model_path. Returns the first run's launch counts."""
    from hfa_gp_tpu_torch.cli import run_recon_video_rgb, train_rgb
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    steps, tune_iter, batch, n_bases = 4, 2, 2, 50
    write_dataset(tmp, 6, split="train")
    write_dataset(tmp, 4, split="test2")
    exp = os.path.join(tmp, "exps")
    base = os.path.join(exp, "smoke")

    def train_args(*extra):
        return train_rgb.build_argparser().parse_args([
            "--dataset_root", tmp, "--person", "person_3", "--size", "256",
            "--batch_size", str(batch), "--exp_path", exp, "--exp_name",
            "smoke", "--tune_iter", str(tune_iter), "--device", "cuda",
            *extra])

    reset_launches()
    t0 = time.perf_counter()
    train_rgb.main(train_args("--iter", str(steps), "--display_freq",
                              str(steps), "--save_freq", "2"))
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    with open(os.path.join(base, "log", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [(r["l2_loss"], r["lpips_loss"]) for r in recs]
    display = sorted(os.listdir(os.path.join(base, "display")))
    bases = os.listdir(os.path.join(base, "bases"))
    ckpts = sorted(os.listdir(os.path.join(base, "checkpoint")))
    shown = [(round(l2, 5), round(lp, 5)) for l2, lp in losses]
    print(f"[7] training path: {len(recs)} steps at batch {batch} in "
          f"{seconds:.2f} s (init, display and checkpoints included), "
          f"(l2, lpips) per step {shown}, display {display}, {len(bases)} "
          f"bases PNGs, checkpoints {ckpts}, launches {launches}", flush=True)
    if len(recs) != steps or not np.isfinite(np.array(losses)).all():
        fail(f"expected {steps} finite loss records, got {losses}")
    if display != [f"{steps - 1}recon.png", f"{steps - 1}source.png"] \
            or len(bases) != n_bases:
        fail(f"display {display}, {len(bases)} bases PNGs")
    if ckpts != ["000001", "000003"]:
        fail(f"checkpoints {ckpts}")
    # per step: both passes sample (2 forward, 2 backward launches), both
    # march forward, and only the unified march runs backward, since the
    # coarse march feeds nothing but the detached fine depths. The display
    # adds forward launches only: 2 + 2 for the test frame, and 2 + 2 for
    # each batch of 8 basis directions.
    n_fwd = 2 * steps + 2 + 2 * -(-n_bases // 8)
    expected = {**NO_LAUNCHES, "triplane_sampler": n_fwd,
                "ray_marcher": n_fwd, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    if launches != expected:
        fail(f"training launched {launches}, expected {expected}")

    # the generator: untouched while step < tune_iter, changed after
    init = heads.init_avatar_rgb(
        torch.Generator().manual_seed(train_rgb.SEED), heads.AvatarConfig())
    moved = {}
    for name in ckpts:
        got = ckpt.load_params(os.path.join(base, "checkpoint", name))
        moved[name] = {top: max(
            (p.detach() - got[top].get_parameter(n)).abs().max().item()
            for n, p in init[top].named_parameters())
            for top in ("encoder", "subspace", "generator")}
    print(f"    max abs change of the params against the seeded init: {moved}",
          flush=True)
    if moved["000001"]["generator"] != 0.0 \
            or not moved["000003"]["generator"] > 0.0 \
            or not moved["000001"]["encoder"] > 0.0:
        fail(f"--tune_iter {tune_iter} not honoured: {moved}")

    # resume: continues from the saved step (4 updates done)
    args = train_args("--iter", "1", "--display_freq", "100", "--save_freq",
                      "100", "--resume_ckpt",
                      os.path.join(base, "checkpoint", "000003"))
    reset_launches()
    train_rgb.main(args)
    resumed = read_launches()
    with open(os.path.join(base, "log", "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    print(f"    resumed from step {args.start_iter}: l2 {last['l2_loss']:.5f} "
          f"lpips {last['lpips_loss']:.5f}, launches {resumed}", flush=True)
    if args.start_iter != steps or not np.isfinite(
            [last["l2_loss"], last["lpips_loss"]]).all():
        fail(f"resume started at {args.start_iter}, last record {last}")
    if resumed != {**NO_LAUNCHES, "triplane_sampler": 2, "ray_marcher": 2,
                   "triplane_sampler_bwd": 2, "ray_marcher_bwd": 1}:
        fail(f"one resumed step launched {resumed}")

    # fit → reenact
    from PIL import Image
    demo = os.path.join(tmp, "demo_fit")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser().parse_args(
        ["--dataset_root", tmp, "--person", "person_3", "--size", "256",
         "--render_batch", "4", "--demo_dir", demo, "--demo_name", "fit",
         "--fps", "4", "--device", "cuda", "--model_path",
         os.path.join(base, "checkpoint", "000003")]))
    pngs = sorted(glob.glob(os.path.join(demo, "fit", "*.png")))
    sizes = {Image.open(p).size for p in pngs}
    print(f"    reenactment from the checkpoint: {len(pngs)} PNGs "
          f"{sorted(sizes)}", flush=True)
    if len(pngs) != 4 or sizes != {(512, 512)}:
        fail(f"reenactment from the checkpoint: {len(pngs)} PNGs {sizes}")
    return launches


def train_setup(dev: str, batch: int):
    """Seeded full-width params, LPIPS params and a batch on `dev`."""
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train.state import init_state
    from hfa_gp_tpu_torch.utils.convert import ParamTree
    cfg = heads.AvatarConfig()
    params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED), cfg,
                                   dev)
    lp = ParamTree(lpips.init_lpips(torch.Generator().manual_seed(SEED + 2))) \
        .to(dev)
    image, label = reference_inputs(cfg, batch)
    return cfg, init_state(params), lp, image.to(dev), label.to(dev)


def phase_step_card_vs_cpu() -> None:
    """[8] loss and every gradient of one training step, card vs CPU."""
    from hfa_gp_tpu_torch.train import rgb
    batch = 1
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, state, lp, image, label = train_setup(dev, batch)
        t0 = time.perf_counter()
        loss, _ = rgb.loss_fn(state.params, lp, cfg, image, label)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in state.params.named_parameters()
                 if p.grad is not None}
        out[dev] = (loss.item(), grads, time.perf_counter() - t0)
        del state, lp, loss
    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["cuda"], out["cpu"]
    if sorted(g_gpu) != sorted(g_cpu):
        fail("card and CPU give gradients to different parameters")
    rels = {n: rel_err(g_gpu[n], g_cpu[n])[1] for n in g_cpu
            if g_cpu[n].abs().max() > 0}
    worst = sorted(rels, key=rels.get)[-3:][::-1]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    print(f"[8] one training step at full width, batch {batch}, card vs CPU: "
          f"loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.3e}, bound "
          f"{STEP_LOSS_RTOL:g}); {len(rels)} gradients, worst max abs diff "
          f"over the gradient's scale "
          f"{[(n, float(f'{rels[n]:.3e}')) for n in worst]} (bound "
          f"{STEP_GRAD_RTOL:g}); card {t_gpu:.2f} s, CPU {t_cpu:.2f} s",
          flush=True)
    if not all(torch.isfinite(g).all() for g in g_gpu.values()):
        fail("non-finite gradient on the card")
    if not loss_rel <= STEP_LOSS_RTOL:
        fail(f"card loss {l_gpu} differs from the CPU loss {l_cpu}")
    if not rels[worst[0]] <= STEP_GRAD_RTOL:
        fail(f"card gradient of {worst[0]} differs from the CPU's by "
             f"{rels[worst[0]]} of its scale")


def phase_train_throughput() -> None:
    """[9] steady-state training steps/s at batch 2 (host clock around
    synchronised steps) and peak device memory."""
    from hfa_gp_tpu_torch.train import rgb
    batch, iters, warmup = 2, 5, 2
    cfg, state, lp, image, label = train_setup("cuda", batch)
    times = []
    for i in range(warmup + iters):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb.train_step(state, lp, cfg, image, label, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times[warmup:])) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[9] training, batch {batch}, generator unfrozen: {ms:.2f} ms per "
          f"step (median of {iters}), {1e3 / ms:.3f} steps/s, "
          f"{batch * 1e3 / ms:.3f} frames/s, peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)


ARC_NET, ARC_BATCH, ARC_DIM = "iresnet50", 256, 512
ARC_CONFIGS = {"dense": ["--num_classes", "1000000"],
               "sparse": ["--num_classes", "3000000", "--sample_rate", "0.1"]}
GIB = 2.0 ** 30


def arc_args(*extra):
    from hfa_gp_tpu_torch.cli import train_arcface
    return train_arcface.build_argparser().parse_args([
        "--network", ARC_NET, "--batch_size", str(ARC_BATCH), "--fp32",
        "--device", "cuda", *extra])


def run_arcface_cli(args) -> tuple[list[float], dict[str, int], float, float]:
    """`train_arcface.main(args)` with the step function wrapped so that
    every step's loss is kept: (losses, launches, seconds, peak bytes)."""
    from hfa_gp_tpu_torch.cli import train_arcface
    losses = []
    make = train_arcface.arc.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(out["loss"])
            return out
        return wrapped

    train_arcface.arc.make_train_step = recording
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        train_arcface.main(args)
    finally:
        train_arcface.arc.make_train_step = make
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ([float(x) for x in losses], launches, seconds,
            torch.cuda.max_memory_allocated())


def backbone_peak_bytes() -> int:
    """Peak device memory of one forward and backward of the backbone alone
    at the arcface batch (activations, parameters and their gradients)."""
    from hfa_gp_tpu_torch.models.arcface import registry
    params, stats = registry.init_backbone(
        torch.Generator().manual_seed(SEED), ARC_NET, ARC_DIM, "cuda")
    params.requires_grad_(True)
    x = torch.randn((ARC_BATCH, 112, 112, 3), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    emb, _ = registry.backbone_apply(ARC_NET, params, stats, x, train=True)
    emb.square().mean().backward()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def check_arcface_losses(what: str, losses, n_classes: int, steps: int):
    """Finite, of the size a random init gives (between ln C and ln C + 2s:
    the log of C terms near 1, less a target logit near s·cos(π/2 + m)),
    and not rising over the run."""
    lo, hi = np.log(n_classes), np.log(n_classes) + 2 * 64.0
    if len(losses) != steps or not np.isfinite(losses).all():
        fail(f"{what}: expected {steps} finite losses, got {losses}")
    if not lo < losses[0] < hi:
        fail(f"{what}: first loss {losses[0]} outside ({lo:.2f}, {hi:.2f})")
    if max(losses[1:]) > ARC_LOSS_RISE * losses[0]:
        fail(f"{what}: the loss rose: {losses}")


def phase_arcface_path(tmp: str) -> dict[str, int]:
    """[10] train_arcface.main: dense with checkpoints, resumed, sparse.
    Returns the dense run's launch counts."""
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    out = os.path.join(tmp, "arcface")
    steps = 6
    # -- dense, 1,000,000 classes
    losses, launches, seconds, peak = run_arcface_cli(arc_args(
        *ARC_CONFIGS["dense"], "--num_steps", str(steps), "--log_freq", "2",
        "--output", out, "--save_freq", "3"))
    cdir = os.path.join(out, "checkpoint")
    ckpts = sorted(os.listdir(cdir))
    print(f"[10] arcface path, {ARC_NET}, 1,000,000 classes dense, batch "
          f"{ARC_BATCH}: {steps} steps in {seconds:.2f} s (init, first-use "
          f"costs and checkpoints included), losses "
          f"{[round(x, 4) for x in losses]}, checkpoints {ckpts}, peak "
          f"{peak / GIB:.3f} GiB, launches {launches}", flush=True)
    check_arcface_losses("dense run", losses, 1_000_000, steps)
    if ckpts != ["000003", "000006"]:
        fail(f"checkpoints {ckpts}")
    expected = {**NO_LAUNCHES, "flash_ce_fwd": steps, "flash_ce_bwd": steps}
    if launches != expected:
        fail(f"the dense run launched {launches}, expected {expected}")

    # -- resumed to 8 steps
    r_losses, resumed, seconds, _ = run_arcface_cli(arc_args(
        *ARC_CONFIGS["dense"], "--num_steps", "8", "--output", out,
        "--resume"))
    last = ckpt.latest_step(cdir)
    saved = torch.load(os.path.join(cdir, f"{last:06d}"), weights_only=True,
                       map_location="cpu")
    print(f"     resumed from step {steps} to 8 in {seconds:.2f} s: losses "
          f"{[round(x, 4) for x in r_losses]}, latest checkpoint {last:06d} "
          f"holds step {saved['step']}, launches {resumed}", flush=True)
    if last != 8 or saved["step"] != 8 or len(r_losses) != 2 \
            or not np.isfinite(r_losses).all():
        fail(f"resume: latest {last}, step {saved['step']}, {r_losses}")
    if resumed != {**NO_LAUNCHES, "flash_ce_fwd": 2, "flash_ce_bwd": 2}:
        fail(f"two resumed steps launched {resumed}")
    del saved

    # -- sparse, 3,000,000 classes at sample_rate 0.1
    bb_peak = backbone_peak_bytes()
    s_losses, s_launches, seconds, peak = run_arcface_cli(arc_args(
        *ARC_CONFIGS["sparse"], "--num_steps", str(steps)))
    table = 3_000_000 * ARC_DIM * 4
    # table + momentum, the backbone's own peak, and 3 GiB for the sampled
    # rows' working set (300,000 rows are 0.57 GiB a copy); a table-sized
    # gradient would be 5.72 GiB more
    limit = 2 * table + bb_peak + 3 * GIB
    print(f"     3,000,000 classes at sample_rate 0.1: {steps} steps in "
          f"{seconds:.2f} s, losses {[round(x, 4) for x in s_losses]}, "
          f"launches {s_launches}; peak {peak / GIB:.3f} GiB against table + "
          f"momentum {2 * table / GIB:.3f} + backbone alone "
          f"{bb_peak / GIB:.3f} + 3 = {limit / GIB:.3f} GiB", flush=True)
    check_arcface_losses("sparse run", s_losses, 3_000_000, steps)
    if s_launches != expected:
        fail(f"the sparse run launched {s_launches}, expected {expected}")
    if not peak < limit:
        fail(f"the sparse run's peak {peak / GIB:.3f} GiB leaves room for a "
             f"table-sized gradient (limit {limit / GIB:.3f} GiB)")
    return launches


def phase_arcface_card_vs_cpu() -> None:
    """[11] loss and every gradient of one arcface step, card vs CPU; then
    the same with a smooth activation in PReLU's place."""
    from hfa_gp_tpu_torch.models.arcface import iresnet, registry
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    from hfa_gp_tpu_torch.train import arcface as arc
    classes, batch = 10_000, 8
    pfc = PartialFC(classes, ARC_DIM)
    tx, fc_tx = arc.make_optimizers(4)
    g = torch.Generator().manual_seed(SEED + 3)
    images = torch.randn((batch, 112, 112, 3), generator=g)
    labels = torch.randint(0, classes, (batch,), generator=g)
    states = {"cpu": arc.init_state(torch.Generator().manual_seed(SEED), pfc,
                                    tx, fc_tx, ARC_NET, "cpu")}
    # the same backbone (drawn on the CPU) and the CPU's table
    states["cuda"] = arc.init_state(torch.Generator().manual_seed(SEED), pfc,
                                    tx, fc_tx, ARC_NET, "cuda")
    states["cuda"].fc_weight.copy_(states["cpu"].fc_weight)

    def one_step(dev: str):
        state = states[dev]
        t0 = time.perf_counter()
        state.optimizer.zero_grad(set_to_none=True)
        w = state.fc_weight.detach().requires_grad_(True)
        emb, _ = registry.backbone_apply(ARC_NET, state.backbone,
                                         state.batch_stats, images.to(dev),
                                         train=True)
        loss = pfc.loss(w, emb, labels.to(dev))
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in
                 state.backbone.named_parameters() if p.grad is not None}
        grads["fc_weight"] = w.grad.cpu()
        return loss.item(), grads, time.perf_counter() - t0

    def smooth(p, x):
        # PReLU's slopes far from 0, no kink
        return 0.625 * x + 0.375 * torch.sqrt(x * x + 1.0)

    prelu = iresnet._prelu
    for act in ("PReLU", "a smooth activation in its place"):
        iresnet._prelu = prelu if act == "PReLU" else smooth
        try:
            (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = (one_step("cuda"),
                                                            one_step("cpu"))
        finally:
            iresnet._prelu = prelu
        # A per-channel constant in front of a train-mode BN changes
        # nothing: the FC bias and the last BN's (before the BN1d head) and
        # the bias of every block's last BN and of its shortcut's BN (the
        # sum runs down the identity path to the next BN) have gradient
        # zero, and what either device computes for them is rounding noise.
        # They are held to be tiny, not to agree.
        null = [n for n in g_cpu if n in ("fc.bias", "bn2.bias")
                or n.endswith(("bn3.bias", "down_bn.bias"))]
        top = max(x.abs().max().item() for x in g_cpu.values())
        noise = max(max(g_gpu[n].abs().max().item(),
                        g_cpu[n].abs().max().item()) for n in null)
        held = [n for n in g_cpu if n not in null]
        rels = {n: rel_err(g_gpu[n], g_cpu[n])[1] for n in held}
        l2 = {n: ((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm()).item()
              for n in held}
        worst = sorted(rels, key=rels.get)[-3:][::-1]
        worst_l2 = max(l2, key=l2.get)
        loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
        bound = ARC_GRAD_RTOL if act == "PReLU" else ARC_GRAD_SMOOTH_RTOL
        print(f"[11] one arcface step, {ARC_NET}, {classes} classes, batch "
              f"{batch}, card vs CPU, with {act}: loss {l_gpu:.6f} vs "
              f"{l_cpu:.6f} (rel {loss_rel:.3e}, bound {ARC_LOSS_RTOL:g}); "
              f"{len(held)} gradients, worst max abs diff over the "
              f"gradient's scale "
              f"{[(n, float(f'{rels[n]:.3e}')) for n in worst]} (bound "
              f"{bound:g}), worst relative L2 error {worst_l2} "
              f"{l2[worst_l2]:.3e} (bound {ARC_GRAD_L2_RTOL:g}); {len(null)} "
              f"gradients that are zero by construction: max abs "
              f"{noise:.3e} on either device against the largest "
              f"gradient's {top:.3e} (bound 1e-5 of it); card {t_gpu:.2f} s, "
              f"CPU {t_cpu:.2f} s", flush=True)
        if not all(torch.isfinite(x).all() for x in g_gpu.values()):
            fail("non-finite arcface gradient on the card")
        if sorted(g_gpu) != sorted(g_cpu) or len(null) != 2 + 24 + 4 \
                or any(g_cpu[n].abs().max() == 0 for n in held):
            fail(f"{len(null)} gradients taken as zero by construction; or "
                 "card and CPU differ in which gradients they give")
        if not noise <= 1e-5 * top:
            fail(f"a gradient that is zero by construction reads {noise}")
        if not loss_rel <= ARC_LOSS_RTOL:
            fail(f"card arcface loss {l_gpu} differs from the CPU's {l_cpu}")
        if not rels[worst[0]] <= bound:
            fail(f"card gradient of {worst[0]} differs from the CPU's by "
                 f"{rels[worst[0]]} of its scale (with {act})")
        if not l2[worst_l2] <= ARC_GRAD_L2_RTOL:
            fail(f"card gradient of {worst_l2} differs from the CPU's by "
                 f"{l2[worst_l2]} in the L2 norm (with {act})")


def phase_arcface_throughput() -> None:
    """[12] steady-state samples/s (host clock around synchronised steps)
    and peak device memory at the two configurations of [10]."""
    from hfa_gp_tpu_torch.cli import train_arcface
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    from hfa_gp_tpu_torch.train import arcface as arc
    iters, warmup = 5, 2
    for name, flags in ARC_CONFIGS.items():
        args = arc_args(*flags)
        pfc = PartialFC(args.num_classes, ARC_DIM,
                        sample_rate=args.sample_rate)
        tx, fc_tx = arc.make_optimizers(warmup + iters, lr=args.lr,
                                        warmup_steps=args.warmup_steps)
        step = arc.make_train_step(pfc, tx, fc_tx, ARC_NET)
        torch.cuda.empty_cache()
        state = arc.init_state(torch.Generator().manual_seed(SEED), pfc, tx,
                               fc_tx, ARC_NET, "cuda")
        gen = torch.Generator("cuda").manual_seed(SEED)
        times = []
        for i in range(warmup + iters):
            imgs, labs = train_arcface.synth_batch(
                ARC_BATCH, args.num_classes, gen, torch.device("cuda"))
            if i == warmup:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, imgs, labs, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times[warmup:])) * 1e3
        peak = torch.cuda.max_memory_allocated()
        print(f"[12] arcface training, {name}: {args.num_classes} classes, "
              f"sample_rate {args.sample_rate}, batch {ARC_BATCH}: {ms:.2f} "
              f"ms per step (median of {iters}), "
              f"{ARC_BATCH * 1e3 / ms:.3f} samples/s, peak device memory "
              f"{peak / GIB:.3f} GiB", flush=True)
        del state, step


def phase_probe_path() -> dict[str, int]:
    """[13] the sampler probes through their entry point: the forward's
    stages, then (`--backward`) the backward's variants and tiles."""
    from hfa_gp_tpu_torch.tools import probe_sampler
    reset_launches()
    times = probe_sampler.main(["--iters", "10"])
    launches = read_launches()
    print(f"[13] sampler probe: {len(times) - 1} variants timed, launches "
          f"{launches}", flush=True)
    if not all(np.isfinite(t) and t > 0 for t in times.values()):
        fail(f"probe times {times}")
    if launches["triplane_probe"] < len(probe_sampler.VARIANTS):
        fail(f"the probe launched {launches}")
    reset_launches()
    times = probe_sampler.main(["--iters", "10", "--backward"])
    bwd = read_launches()
    print(f"     sampler backward probe: {len(times)} timings, launches "
          f"{bwd}", flush=True)
    if not all(np.isfinite(t) and t > 0 for t in times.values()):
        fail(f"backward probe times {times}")
    if bwd["triplane_bwd_probe"] < len(probe_sampler.BWD_VARIANTS) \
            + len(probe_sampler.BWD_TILES):
        fail(f"the backward probe launched {bwd}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "hfa_gp_tpu_torch")):
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, ROOT)
    from hfa_gp_tpu_torch.cli import common
    common.fp32_backends()
    dev = torch.device("cuda")

    phase_card()
    phase_build()
    kernels = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        reenact_launches = phase_main_path(tmp)
    phase_card_vs_cpu()
    phase_throughput()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_train_path(tmp)
    phase_step_card_vs_cpu()
    phase_train_throughput()
    with tempfile.TemporaryDirectory() as tmp:
        arcface_launches = phase_arcface_path(tmp)
    phase_arcface_card_vs_cpu()
    phase_arcface_throughput()
    probe_launches = phase_probe_path()

    # launches, each from the run of the path that owns the kernel: the
    # RGB training path's first run (4 steps and one display; the
    # reenactment path's count beside it), the arcface path's dense run
    # (6 steps), the probe's entry point
    for k in kernels:
        if k["name"].startswith("flash_ce"):
            k["launches"] = arcface_launches[k["name"]]
        elif k["name"] == "triplane_probe":
            k["launches"] = probe_launches[k["name"]]
        else:
            k["launches"] = train_launches[k["name"]]
            k["launches_reenact"] = reenact_launches[k["name"]]
        if not k["launches"] > 0:
            fail(f"{k['name']} was not launched on its main path")
    # what each kernel loses on a unit of each path: launches x (ms - bound)
    # a reenactment batch / an RGB step / an arcface step (the sampler at
    # batch 2 here; its batch-8 figures are in its entry)
    print("launches x (ms - bound), ms a reenactment batch / RGB step / "
          "arcface step:", flush=True)
    for k in kernels:
        per_unit = LAUNCHES_PER_UNIT.get(k["name"])
        if per_unit is None:
            continue
        gap = k["ms"] - k["bound_ms"]
        if k["name"] == "ray_marcher":
            # half of its launches are the coarse pass's, at N 48
            gap = (gap + k["ms_n48"] - k["bound_ms_n48"]) / 2
        k["launches_per_unit"] = list(per_unit)
        k["launches_x_gap_ms"] = [n * gap for n in per_unit]
        print(f"    {k['name']}: " + " / ".join(
            f"{n} x {gap:.4f} = {n * gap:.4f}" for n in per_unit), flush=True)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax",
                                            "hfa_gp_tpu"))
    if foreign:
        fail(f"imported JAX or the JAX package: {foreign[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
