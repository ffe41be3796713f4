#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`hfa_gp_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure exits non-zero before the
result line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the build of the CUDA kernels from `hfa_gp_tpu_torch/csrc`, timed,
     with ptxas's registers (the marcher backward's two paths by name);
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
     at N 96 and 48; its backward against autograd of the plain march at
     N 96 and 48 under the cotangents of rgb alone, of all three outputs
     and of none, and on its other routes (C 3, 48, 130, N 1025, and
     N 2000 with its scratch buffer); the flash-CE kernels also at a batch
     above one group of rows with ragged class and depth counts, d w bit
     for bit across two launches, and the backward's ablation (a time per
     variant), and with bf16 operands (the JAX CLI's default) at the main
     path's shape, timed against a bound whose products run at the bf16
     rate;
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
     per tile;
 14. the 3DMM-driven training path through `hfa_gp_tpu_torch.cli.
     train_3dmm.main` at full width, batch 2, on a synthetic dataset with
     expressions: 4 steps across --tune_iter, finite losses, the generator
     untouched before tune_iter and changed after, display PNGs,
     checkpoints, the four kernels' launch counts (one marcher backward a
     step); then `run_recon_video_3dmm.main --model_path --fix_cam`;
 15. the audio-driven training path through `hfa_gp_tpu_torch.cli.
     train_audio.main`, the same way, 4 steps with --nosmo_iters 2: the
     AudioAttNet unchanged in the plain phase and changed after, its Adam
     state cleared exactly once (the step counts in the checkpoints), the
     same launch counts; then `run_recon_video_audio.main --smooth
     --model_path`;
 16. one audio step in its smooth phase, loss and gradients at full width,
     batch 1, card (kernels) against CPU (plain versions), from the same
     seeded params, at 8's tolerances (a gradient that misses them at a
     LeakyReLU kink held in the L2 norm, as 11 does);
 17. steady-state 3DMM and audio training steps/s at batch 2, and the
     peak device memory (printed, not asserted);
 18. the preprocessing path's detector: P-, R- and O-Net card against CPU
     on a synthetic 1280×720 frame (every pyramid level at min_face_size
     20, a full batch of 256 candidates), then `detect_faces` timed on the
     card and split into its stages and the nets' calls;
 19. the face-recon ResNet-50 at batch 16, 224², with random heads and BN
     statistics, card against CPU, its ms a batch and cuDNN's share;
 20. `hfa_gp_tpu_torch.cli.process_video.main --use_existing_detections`
     on the card over 48 synthetic 1280×720 frames: 48 crops of 512²,
     test.json with 25-number labels and cameras.json, no hand-written
     kernel launched, the port's HeadData reads them and `train_rgb.main`
     takes two steps on them at full width; frames/s, ms a frame for each
     stage and the device's busy share;
 21. `hfa_gp_tpu_torch.cli.extract_audio.main` on a 60 s, 16 kHz wav on
     the card: aud.npy of (1500, 16, 29) that HeadDataAudio reads,
     DeepSpeech's logits card against CPU on the first 10 s, seconds of
     audio a second split into MFCC, dense layers and LSTM, and the peak
     device memory;
 22. `train_arcface.main` with MobileFaceNet ("mbf"), fp32, 1,000,000
     classes dense, batch 256: 6 steps, finite losses that do not rise,
     one K5 and one K6 launch a step, the CLI's samples/s, peak memory;
 23. the same with "vit_t", AdamW at 1e-3, `--sample_rate 0.3`, 2,000,000
     classes, bf16, with masking once a step and drop path on both
     branches of every block after the first;
 24. the JAX CLI's default command, iresnet50 in bf16 (trunk and head
     products) at 1,000,000 classes dense, the same checks; then one bf16
     step's loss and gradients, card vs CPU;
 25. `train_arcface.main --val_bin --verbose 2 --export` (mbf, bf16) on a
     64-pair synthetic .bin: the accuracy lines, model.pt2 through
     `torch.export.load` against `backbone_apply` at batch 1 and 64, then
     `cli.eval_verification.main` on the exported model.npz, card vs CPU,
     and its pairs/s on the card with iresnet50;
 26. `cli.eval_ijb.main` on a synthetic IJB layout of 20 subjects × 2
     templates × 2 media with random weights: same-subject template pairs
     above cross-subject ones, rank-1 identification, scores card vs CPU
     (mbf), and images/s on the card with iresnet50;
 27. `run_recon_video_rgb.main --bf16 --trace_dir` at full width on 4's
     dataset: 4 PNGs of 512², finite frames, each forward kernel twice a
     batch, a Chrome trace naming the sampler and marcher kernels and the
     annotated regions (encoder, subspace, synthesis);
 28. `--bf16` card (kernels) against CPU (plain versions): one frame, each
     beside the card's fp32 frame, and one bf16 RGB step's loss and
     gradients at full width, batch 1, in the L2 norm;
 29. `--bf16` frames/s at batch 8 and RGB steps/s at batch 2 with peak
     memory, beside 6's and 9's fp32 figures (printed, not asserted); one
     RGB step under the renderer's `remat` against the plain step (the
     sampler launched 4 times, peak memory of each); one reenactment batch
     under `ray_chunk` 4096 against the port's CPU chunked render;
 30. `train_rgb.main --bf16 --person_2 --init --run_id_2` at full width on
     PTI pivots (.npy and .pt), 2 steps: person 2's bases as
     `load_pti_bases` gives them, unchanged while person 1's move, kept in
     the checkpoint, which `run_recon_video_rgb.main --bf16 --model_path`
     reads; then `train_3dmm.main` and `train_audio.main --bf16`, 2 steps
     each, with 14's and 15's launches a step.

Before the summary it prints, for each kernel, launches x (ms - bound) per
reenactment batch, RGB step and arcface step (a bf16 one for the bf16
entries, whose launches are [24]'s). The line before the last is a
JSON summary of the kernels; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, with no result line, when CUDA is unavailable or when
it is run outside a checkout. It imports nothing of JAX or of the JAX
package `hfa_gp_tpu`, and checks that before the result line.
"""

from __future__ import annotations

import copy
import glob
import json
import logging
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
# memory rate, fp32 outside the tensor cores, and dense bf16 on them (the
# rate a product of bf16 operands could run at)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


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


def bound(n_bytes: float, n_flops: float, n_flops_bf16: float = 0.0
          ) -> dict:
    """The least time the card could take: the larger of compulsory bytes
    over the memory rate and the operations over the peak rate for their
    type (fp32 operations, and the products of bf16 operands)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_flops = (n_flops / PEAK_FP32_FLOPS
               + n_flops_bf16 / PEAK_BF16_FLOPS) * 1e3
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
    ptxas = log.get("ptxas", "")
    print("    K4' registers: fast path (ray_march_bwd_warp_kernel) "
          f"{kernel_registers(ptxas, 'ray_march_bwd_warp_kernel')}, general "
          f"path (ray_march_bwd_kernel) "
          f"{kernel_registers(ptxas, 'ray_march_bwd_kernel')}", flush=True)


def kernel_registers(ptxas: str, kernel: str) -> int | None:
    """ptxas -v's register count of the kernel named `kernel` (its mangled
    name holds <len><name>E)."""
    import re
    lines = ptxas.splitlines()
    tag = f"{len(kernel)}{kernel}E"
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and tag in line:
            for after in lines[i + 1:]:
                m = re.search(r"Used (\d+) registers", after)
                if m:
                    return int(m.group(1))
    return None


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
                 n_bytes, n_flops, n_flops_bf16=0.0) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, **bound(n_bytes, n_flops, n_flops_bf16),
             "library_ms": library_ms}
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    bf16 = f" + {n_flops_bf16 / 1e9:.3f} GFLOP of bf16 products" \
        if n_flops_bf16 else ""
    print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"call {lib}, bound {entry['bound_ms']:.4f} ms by "
          f"{entry['bound_by']} ({n_bytes / 1e6:.1f} MB, "
          f"{n_flops / 1e9:.3f} GFLOP{bf16})", flush=True)
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

    # -- marcher backward: the fast path at N 96 and 48 under each mix of
    # cotangents, then its general path
    results.append(phase_marcher_backward(dev, g, (colors, dens, depths),
                                          want))
    del colors, dens, depths, want
    phase_marcher_bwd_general_paths(dev, g)
    results += phase_kernels_flash_ce(dev, g)
    results.append(phase_kernels_probe(dev))
    return results


# K4′'s cotangent mixes: rgb's alone (what training passes), all three
# (rgb, unclipped depth, weights), none
MARCH_COTANGENTS = {"rgb": (True, False, False), "all": (True, True, True),
                    "none": (False, False, False)}


def march_inputs(dev, g, b: int, r: int, n: int, c: int):
    colors = torch.rand((b, r, n, c), generator=g).to(dev)
    dens = (torch.randn((b, r, n, 1), generator=g) * 3.0).to(dev)
    depths = torch.sort(2.25 + 1.05 * torch.rand((b, r, n, 1), generator=g),
                        dim=2).values.to(dev)
    return colors, dens, depths


def marcher_bwd_check(dev, g, inputs, outs, what: str) -> tuple:
    """K4′ against autograd of the plain march (`ray_march_backward_plain`)
    under each cotangent mix; → (max abs err, its largest share of the
    gradient's scale, the cotangents by mix)."""
    from hfa_gp_tpu_torch.core.kernels import raymarch
    cots_all = [torch.randn(x.shape, generator=g).to(dev) for x in outs]
    err, rel, cots = 0.0, 0.0, {}
    for mix, used in MARCH_COTANGENTS.items():
        cots[mix] = [ct if u else None for ct, u in zip(cots_all, used)]
        got = raymarch.ray_march_backward(*inputs, *cots[mix])
        want = raymarch.ray_march_backward_plain(*inputs, *cots[mix])
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            if not bool(torch.isfinite(x).all()):
                fail(f"marcher backward kernel, {what}, cotangents {mix}: "
                     f"not finite")
            if mix == "none":
                if x.abs().max().item() != 0.0:
                    fail(f"marcher backward kernel, {what}: no cotangent "
                         f"but a gradient")
                continue
            e, r_ = rel_err(x, y)
            err, rel = max(err, e), max(rel, r_)
        del got, want
    if not rel <= BWD_RTOL:
        fail(f"marcher backward kernel disagrees with its plain version "
             f"({what}): {rel} of the gradient's scale")
    return err, rel, cots


def phase_marcher_backward(dev, g, inputs, outs) -> dict:
    """K4′ at the unified pass's (2, 16384, 96, 32) and the coarse pass's
    N 48: checked under each cotangent mix, timed under all three and
    under rgb's alone."""
    from hfa_gp_tpu_torch.core.kernels import raymarch
    colors, dens, depths = inputs
    b, r, n, c = colors.shape
    err, rel, cots = marcher_bwd_check(dev, g, inputs, outs, "N 96")
    inputs48 = march_inputs(dev, g, b, r, 48, c)
    with torch.no_grad():
        outs48 = raymarch.ray_march_plain(*inputs48)
    err48, rel48, cots48 = marcher_bwd_check(dev, g, inputs48, outs48,
                                             "N 48")
    print(f"[3] marcher backward kernel vs autograd of the plain version, "
          f"fast path, cotangents of rgb / all three / none: max abs err "
          f"{max(err, err48):.3e}, {max(rel, rel48):.3e} of the gradient's "
          f"scale (bound {BWD_RTOL:g}; colors {tuple(colors.shape)} and N "
          f"48)", flush=True)

    def run(inp, cts):
        return lambda: raymarch.ray_march_backward(*inp, *cts)

    ms = cuda_time_ms(run(inputs, cots["all"]))
    ms_rgb = cuda_time_ms(run(inputs, cots["rgb"]))
    ms48 = cuda_time_ms(run(inputs48, cots48["rgb"]))
    plain_ms = cuda_time_ms(lambda: raymarch.ray_march_backward_plain(
        *inputs, *cots["all"]))
    got = raymarch.ray_march_backward(*inputs, *cots["all"])
    # per sample and channel 3 operations (dot product, d colors), per
    # midpoint ~60 of the scans; no single PyTorch call computes it
    entry = kernel_entry(
        "ray_marcher_bwd", "hfa_gp_tpu_torch/csrc/raymarch_bwd.cu",
        "hfa_gp_tpu/core/pallas/raymarch.py:27", err, ms, plain_ms, None,
        nbytes(colors, dens, depths, *cots["all"], *got),
        b * r * (n * 3 * c + (n - 1) * 60))
    rgb_bytes = nbytes(colors, dens, depths, cots["rgb"][0], *got)
    b48 = bound(nbytes(*inputs48, cots48["rgb"][0], *inputs48[:2]),
                b * r * (48 * 3 * c + 47 * 60))["bound_ms"]
    entry.update({"note": "the TPU kernel has no backward: the JAX package "
                          "differentiates renderer.ray_march instead",
                  "ms_rgb_only": ms_rgb,
                  "bound_ms_rgb_only": bound(rgb_bytes, 0)["bound_ms"],
                  "ms_n48_rgb_only": ms48, "bound_ms_n48_rgb_only": b48,
                  "max_abs_err_n48": err48})
    print(f"    ray_marcher_bwd with rgb's cotangent alone (training): "
          f"{ms_rgb:.4f} ms (bound {entry['bound_ms_rgb_only']:.4f}); at N "
          f"48 {ms48:.4f} ms (bound {b48:.4f}); {ms / entry['bound_ms']:.2f} "
          f"x its bound with all three", flush=True)
    return entry


def phase_marcher_bwd_general_paths(dev, g) -> None:
    """K4′ on the other routes: C 3 (a lane a channel), C 48 (the fast
    path with 16 lanes a row, a quarter of them idle), C 130 (over the
    fast path's 128), N 1025 (over its 1024) and N 2000 (the general
    path's arrays in the scratch buffer: 7·N floats a warp exceed 48 KB),
    each under the three cotangent mixes."""
    from hfa_gp_tpu_torch.core.kernels import raymarch
    worst, cases = 0.0, []
    for r, n, c in ((4096, 96, 3), (4096, 96, 48), (512, 48, 130),
                    (64, 1025, 32), (256, 2000, 32), (64, 2000, 3)):
        inputs = march_inputs(dev, g, 1, r, n, c)
        with torch.no_grad():
            outs = raymarch.ray_march_plain(*inputs)
        worst = max(worst, marcher_bwd_check(dev, g, inputs, outs,
                                             f"N {n}, C {c}")[1])
        cases.append(f"N {n} C {c}"
                     + (" (scratch)" if raymarch.scratch_warps_for(r, n)
                        else ""))
        del inputs, outs
    print(f"[3] marcher backward kernel vs plain on its other routes "
          f"({', '.join(cases)}; cotangents of rgb / all three / none): "
          f"{worst:.3e} of the gradient's scale (bound {BWD_RTOL:g})",
          flush=True)


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
        del got, want
        entries.update(flash_ce_bf16_entries(ne, w, lab, s, ct_se, ct_tgt))
        del ne, w, lab
    torch.cuda.empty_cache()
    phase_flash_ce_general_paths(dev, g)
    return [entries[k] for k in ("fwd", "bwd", "fwd_bf16", "bwd_bf16")]


def flash_ce_bf16_entries(ne, w, lab, s: float, ct_se, ct_tgt) -> dict:
    """K5 and K6 with bf16 operands, the route of the JAX CLI's default
    (`train_arcface` without --fp32), at the main path's shape: against
    their plain versions, which round the same operands to bf16, and
    timed. The products' operations are bounded at the bf16 rate of the
    tensor cores, the rest at fp32's."""
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    bf = torch.bfloat16
    (b, d), c = ne.shape, w.shape[0]
    se, tgt = flash_ce.flash_ce_stats(ne, w, lab, s, bf)
    se_p, tgt_p = flash_ce.flash_ce_stats_plain(ne, w, lab, s, bf)
    torch.cuda.synchronize()
    se_rel = ((se - se_p).abs() / se_p.abs().clamp_min(1e-30)).max().item()
    tgt_err = (tgt - tgt_p).abs().max().item()
    got = flash_ce.flash_ce_stats_backward(ne, w, lab, s, bf, ct_se, ct_tgt)
    want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, s, bf, ct_se,
                                                  ct_tgt)
    torch.cuda.synchronize()
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    rel = max(r for _, r in errs)
    print(f"[3] flash-CE kernels vs plain with bf16 operands, B {b}, d {d}, "
          f"C {c}: se_x max rel err {se_rel:.3e} (bound {CE_SE_RTOL:g}), "
          f"tgt_raw {tgt_err:.3e} (bound {CE_TGT_ATOL:g}); d norm_emb "
          f"{errs[0][1]:.3e}, d w {errs[1][1]:.3e} of the gradient's scale "
          f"(bound {CE_BF16_BWD_RTOL:g})", flush=True)
    if not se_rel <= CE_SE_RTOL or not tgt_err <= CE_TGT_ATOL \
            or not rel <= CE_BF16_BWD_RTOL:
        fail(f"flash-CE kernels with bf16 operands at C {c}: se_x {se_rel}, "
             f"tgt_raw {tgt_err}, gradients {rel}")
    ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats(ne, w, lab, s, bf))
    plain_ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_plain(
        ne, w, lab, s, bf))
    out = {"fwd_bf16": kernel_entry(
        "flash_ce_fwd_bf16", "hfa_gp_tpu_torch/csrc/flash_ce.cu",
        "hfa_gp_tpu/parallel/pallas_ce.py:78", tgt_err, ms, plain_ms, None,
        nbytes(ne, w, lab, se, tgt), 2.0 * c * d + 7.0 * b * c,
        2.0 * b * d * c)}
    out["fwd_bf16"]["max_rel_err_se_x"] = se_rel
    ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_backward(
        ne, w, lab, s, bf, ct_se, ct_tgt))
    plain_ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_backward_plain(
        ne, w, lab, s, bf, ct_se, ct_tgt))
    out["bwd_bf16"] = kernel_entry(
        "flash_ce_bwd_bf16", "hfa_gp_tpu_torch/csrc/flash_ce_bwd.cu",
        "hfa_gp_tpu/parallel/pallas_ce.py:108", max(e for e, _ in errs), ms,
        plain_ms, None, nbytes(ne, w, lab, ct_se, ct_tgt, *got),
        5.0 * c * d + 14.0 * b * c, 6.0 * b * d * c)
    out["bwd_bf16"]["max_err_over_scale"] = rel
    for e in out.values():
        e["operands"] = "bf16"
    return out


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
                     "flash_ce_fwd": (0, 0, 1), "flash_ce_bwd": (0, 0, 1),
                     "flash_ce_fwd_bf16": (0, 0, 1),
                     "flash_ce_bwd_bf16": (0, 0, 1)}

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


def dtype_name(cfg) -> str:
    """"bf16" for an avatar config under --bf16, else "fp32"."""
    return "bf16" if cfg.eg3d.compute_dtype == torch.bfloat16 else "fp32"


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


def phase_throughput(cfg=None, tag: str = "[6]") -> dict:
    """[6] steady-state frames/s at batch 8 and peak device memory, for
    `cfg` (default: the full-width fp32 config); → {"fps", "gib"}."""
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    from hfa_gp_tpu_torch.models.avatar import heads
    batch, iters = 8, 5
    cfg = cfg or heads.AvatarConfig()
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
    print(f"{tag} batch {batch}, {dtype_name(cfg)}: {ms:.2f} ms per "
          f"batch (median of {iters}), {fps:.3f} frames/s, peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    return {"fps": fps, "gib": peak / 2**30}


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


def train_setup(dev: str, batch: int, cfg=None):
    """Seeded params of `cfg` (default: the full-width fp32 config) in a
    training state, LPIPS params and a batch on `dev`."""
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train.state import init_state
    from hfa_gp_tpu_torch.utils.convert import ParamTree
    cfg = cfg or heads.AvatarConfig()
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


def phase_train_throughput(cfg=None, tag: str = "[9]") -> dict:
    """[9] steady-state training steps/s at batch 2 (host clock around
    synchronised steps) and peak device memory, for `cfg` (default: the
    full-width fp32 config); → {"steps_per_s", "gib"}."""
    from hfa_gp_tpu_torch.train import rgb
    batch, iters, warmup = 2, 5, 2
    cfg, state, lp, image, label = train_setup("cuda", batch, cfg)
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
    print(f"{tag} training, batch {batch}, {dtype_name(cfg)}, "
          f"generator unfrozen: {ms:.2f} ms per step (median of {iters}), "
          f"{1e3 / ms:.3f} steps/s, {batch * 1e3 / ms:.3f} frames/s, peak "
          f"device memory {peak / 2**30:.3f} GiB", flush=True)
    return {"steps_per_s": 1e3 / ms, "gib": peak / 2**30}


ARC_NET, ARC_BATCH, ARC_DIM = "iresnet50", 256, 512
ARC_CONFIGS = {"dense": ["--num_classes", "1000000"],
               "sparse": ["--num_classes", "3000000", "--sample_rate", "0.1"]}
GIB = 2.0 ** 30


def arc_args(*extra):
    from hfa_gp_tpu_torch.cli import train_arcface
    return train_arcface.build_argparser().parse_args([
        "--network", ARC_NET, "--batch_size", str(ARC_BATCH), "--fp32",
        "--device", "cuda", *extra])


def run_arcface_cli(args) -> tuple[list[float], dict[str, int], float, float,
                                   float]:
    """`train_arcface.main(args)` with the step function wrapped so that
    every step's loss is kept: (losses, launches, seconds, peak bytes, the
    samples/s the CLI reports)."""
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
        sps = train_arcface.main(args)
    finally:
        train_arcface.arc.make_train_step = make
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ([float(x) for x in losses], launches, seconds,
            torch.cuda.max_memory_allocated(), sps)


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
    losses, launches, seconds, peak, _ = run_arcface_cli(arc_args(
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
    r_losses, resumed, seconds, _, _ = run_arcface_cli(arc_args(
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
    s_losses, s_launches, seconds, peak, _ = run_arcface_cli(arc_args(
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


def write_expressions(root: str, n: int, split: str) -> None:
    """{root}/nerface_dataset/person_3/transforms_{split}.json: a seeded
    76-d expression vector for each of write_dataset's n frames."""
    rng = np.random.default_rng(SEED + 3 + (split == "train"))
    frames = [{"file_path": f"./images/f_{i:04d}",
               "expression": rng.standard_normal(76).tolist()}
              for i in range(n)]
    with open(os.path.join(root, "nerface_dataset", "person_3",
                           f"transforms_{split}.json"), "w") as f:
        json.dump({"frames": frames}, f)


def write_audio_dataset(root: str, n_train: int = 6, n_val: int = 4,
                        size: int = 256) -> None:
    """{root}/ad_dataset/obama (the layout of tests/fixtures.py with
    audio=True): `<i>.jpg` frames and labels of cameras around the mean
    pose in train/ and test/, transforms_{train,val}.json with image and
    audio ids, and aud.npy of seeded (n_train + n_val, 16, 29) features."""
    from PIL import Image

    from hfa_gp_tpu_torch.core import camera
    person = os.path.join(root, "ad_dataset", "obama")
    rng = np.random.default_rng(SEED + 5)
    for split, sub, n in (("train", "train", n_train),
                          ("val", "test", n_val)):
        d = os.path.join(person, sub, "cropped_images")
        os.makedirs(d)
        labels = []
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8),
                            "RGB").save(os.path.join(d, f"{i}.jpg"))
            label = camera.flip_yz_label(camera.sample_camera_label(
                None, mode=None, horizontal_mean=np.pi / 2 + 0.05 * (i - 2)))
            labels.append([f"{i}.png", label[0].tolist()])
        with open(os.path.join(d, "test.json"), "w") as f:
            json.dump({"labels": labels}, f)
        with open(os.path.join(person, f"transforms_{split}.json"), "w") as f:
            json.dump({"frames": [{"img_id": i, "aud_id": i}
                                  for i in range(n)]}, f)
    np.save(os.path.join(person, "aud.npy"), rng.standard_normal(
        (n_train + n_val, 16, 29)).astype(np.float32))


def max_change(init, path: str, tops) -> dict[str, float]:
    """Max abs change of each top-level subtree's params in the checkpoint
    file `path` against `init`."""
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    got = ckpt.load_params(path).state_dict()
    return {top: max((v - got[k]).abs().max().item()
                     for k, v in init.state_dict().items()
                     if k.startswith(top + "."))
            for top in tops}


def check_pngs(what: str, pattern: str, n: int) -> None:
    from PIL import Image
    pngs = sorted(glob.glob(pattern))
    sizes = {Image.open(p).size for p in pngs}
    print(f"    {what}: {len(pngs)} PNGs {sorted(sizes)}", flush=True)
    if len(pngs) != n or sizes != {(512, 512)}:
        fail(f"{what}: {len(pngs)} PNGs {sizes}, expected {n} of 512²")


def train_losses(what: str, base: str, steps: int) -> list:
    with open(os.path.join(base, "log", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [(r["l2_loss"], r["lpips_loss"]) for r in recs]
    if len(recs) != steps or not np.isfinite(np.array(losses)).all():
        fail(f"{what}: expected {steps} finite loss records, got {losses}")
    return [(round(l2, 5), round(lp, 5)) for l2, lp in losses]


def phase_3dmm_path(tmp: str) -> dict[str, int]:
    """[14] train_3dmm.main at full width, batch 2, 4 steps across
    --tune_iter 2, then run_recon_video_3dmm.main --model_path --fix_cam
    on the checkpoint. Returns the training run's launch counts."""
    from hfa_gp_tpu_torch.cli import run_recon_video_3dmm, train_3dmm
    from hfa_gp_tpu_torch.models.avatar import heads
    steps, tune_iter, batch = 4, 2, 2
    write_dataset(tmp, 6, split="train")
    write_dataset(tmp, 4, split="test2")
    write_expressions(tmp, 6, "train")
    write_expressions(tmp, 4, "test")
    exp = os.path.join(tmp, "exps")
    base = os.path.join(exp, "smoke3dmm")
    args = train_3dmm.build_argparser().parse_args([
        "--dataset_root", tmp, "--person", "person_3", "--size", "256",
        "--batch_size", str(batch), "--exp_path", exp, "--exp_name",
        "smoke3dmm", "--tune_iter", str(tune_iter), "--device", "cuda",
        "--iter", str(steps), "--display_freq", str(steps), "--save_freq",
        "2"])
    reset_launches()
    t0 = time.perf_counter()
    train_3dmm.main(args)
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shown = train_losses("3DMM training", base, steps)
    display = sorted(os.listdir(os.path.join(base, "display")))
    ckpts = sorted(os.listdir(os.path.join(base, "checkpoint")))
    print(f"[14] 3DMM training path: {steps} steps at batch {batch} in "
          f"{seconds:.2f} s (init, display and checkpoints included), "
          f"(l2, lpips) per step {shown}, display {display}, checkpoints "
          f"{ckpts}, launches {launches}", flush=True)
    if display != [f"{steps - 1}recon.png", f"{steps - 1}source.png"]:
        fail(f"3DMM display {display}")
    if ckpts != ["000001", "000003"]:
        fail(f"3DMM checkpoints {ckpts}")
    # per step the RGB step's launches; the display renders one test frame
    n_fwd = 2 * steps + 2
    expected = {**NO_LAUNCHES, "triplane_sampler": n_fwd,
                "ray_marcher": n_fwd, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    if launches != expected:
        fail(f"3DMM training launched {launches}, expected {expected}")
    init = heads.init_avatar_3dmm(
        torch.Generator().manual_seed(train_3dmm.SEED), heads.AvatarConfig())
    moved = {c: max_change(init, os.path.join(base, "checkpoint", c),
                           ("weights_mlp", "subspace", "generator"))
             for c in ckpts}
    print(f"    max abs change of the params against the seeded init: "
          f"{moved}", flush=True)
    if moved["000001"]["generator"] != 0.0 \
            or not moved["000003"]["generator"] > 0.0 \
            or not moved["000001"]["weights_mlp"] > 0.0:
        fail(f"3DMM --tune_iter {tune_iter} not honoured: {moved}")

    demo = os.path.join(tmp, "demo3dmm")
    reset_launches()
    run_recon_video_3dmm.main(run_recon_video_3dmm.build_argparser()
                              .parse_args([
                                  "--dataset_root", tmp, "--person",
                                  "person_3", "--size", "256",
                                  "--render_batch", "4", "--demo_dir", demo,
                                  "--demo_name", "fix", "--fps", "4",
                                  "--device", "cuda", "--fix_cam",
                                  "--model_path",
                                  os.path.join(base, "checkpoint",
                                               "000003")]))
    check_pngs(f"3DMM reenactment from the checkpoint, --fix_cam, launches "
               f"{read_launches()}", os.path.join(demo, "fix", "*.png"), 4)
    return launches


def adam_counts(path: str) -> dict[str, set]:
    """Adam step counts in an avatar checkpoint, by top-level subtree."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    names = list(state["params"])
    out: dict[str, set] = {}
    for i, st in state["optimizer"]["state"].items():
        out.setdefault(names[i].split(".")[0], set()).add(int(st["step"]))
    return out


def phase_audio_path(tmp: str) -> dict[str, int]:
    """[15] train_audio.main at full width, batch 2, 4 steps with
    --nosmo_iters 2 and --tune_iter 2, then run_recon_video_audio.main
    --smooth --model_path on the checkpoint. Returns the training run's
    launch counts."""
    from hfa_gp_tpu_torch.cli import run_recon_video_audio, train_audio
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import audio as audio_train
    steps, nosmo, batch = 4, 2, 2
    write_audio_dataset(tmp)
    exp = os.path.join(tmp, "exps")
    base = os.path.join(exp, "smokeaudio")
    args = train_audio.build_argparser().parse_args([
        "--dataset_root", tmp, "--dataset", "ad_dataset", "--person",
        "obama", "--size", "256", "--batch_size", str(batch), "--exp_path",
        exp, "--exp_name", "smokeaudio", "--tune_iter", "2", "--nosmo_iters",
        str(nosmo), "--device", "cuda", "--iter", str(steps),
        "--display_freq", str(steps), "--save_freq", "2"])
    reset_launches()
    t0 = time.perf_counter()
    train_audio.main(args)
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    shown = train_losses("audio training", base, steps)
    display = sorted(os.listdir(os.path.join(base, "display")))
    ckpts = sorted(os.listdir(os.path.join(base, "checkpoint")))
    counts = {c: adam_counts(os.path.join(base, "checkpoint", c))
              for c in ckpts}
    print(f"[15] audio training path: {steps} steps at batch {batch} "
          f"(--nosmo_iters {nosmo}) in {seconds:.2f} s, (l2, lpips) per step "
          f"{shown}, display {display}, checkpoints {ckpts}, Adam counts "
          f"{counts}, launches {launches}", flush=True)
    if display != [f"{steps - 1}source.png"] or ckpts != ["000001",
                                                          "000003"]:
        fail(f"audio display {display}, checkpoints {ckpts}")
    # the AudAtt optimizer cleared once, at the switch: 2 steps since
    if counts["000001"] != {"model": {2}, "audnet": {2}, "audattnet": {2}} \
            or counts["000003"] != {"model": {4}, "audnet": {4},
                                    "audattnet": {steps - nosmo}}:
        fail(f"the AudAtt optimizer was not reset exactly once: {counts}")
    expected = {**NO_LAUNCHES, "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    if launches != expected:
        fail(f"audio training launched {launches}, expected {expected}")
    init = audio_train.init_audio_params(
        torch.Generator().manual_seed(train_audio.SEED), heads.AvatarConfig())
    moved = {c: max_change(init, os.path.join(base, "checkpoint", c),
                           ("audattnet", "audnet", "model"))
             for c in ckpts}
    print(f"    max abs change of the params against the seeded init: "
          f"{moved}", flush=True)
    if moved["000001"]["audattnet"] != 0.0 \
            or not moved["000003"]["audattnet"] > 0.0 \
            or not moved["000001"]["audnet"] > 0.0:
        fail(f"AudioAttNet moved in the plain phase or not after: {moved}")

    demo = os.path.join(tmp, "demoaudio")
    reset_launches()
    run_recon_video_audio.main(run_recon_video_audio.build_argparser()
                               .parse_args([
                                   "--dataset_root", tmp, "--dataset",
                                   "ad_dataset", "--person", "obama",
                                   "--size", "256", "--render_batch", "4",
                                   "--demo_dir", demo, "--demo_name", "smo",
                                   "--fps", "4", "--device", "cuda",
                                   "--smooth", "--model_path",
                                   os.path.join(base, "checkpoint",
                                                "000003")]))
    check_pngs(f"audio reenactment from the checkpoint, --smooth, launches "
               f"{read_launches()}", os.path.join(demo, "smo", "*.png"), 4)
    return launches


def avatar_batch(dev: str, batch: int):
    """The full-width config, seeded LPIPS params and a batch on `dev`."""
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.utils.convert import ParamTree
    cfg = heads.AvatarConfig()
    lp = ParamTree(lpips.init_lpips(torch.Generator().manual_seed(SEED + 2))) \
        .to(dev)
    image, label = reference_inputs(cfg, batch)
    return cfg, lp, image.to(dev), label.to(dev)


def audio_setup(dev: str, batch: int):
    """Seeded full-width audio params in a training state, LPIPS params, a
    batch and its smoothing windows on `dev`."""
    from hfa_gp_tpu_torch.train import audio as audio_train
    from hfa_gp_tpu_torch.train.state import init_state
    cfg, lp, image, label = avatar_batch(dev, batch)
    params = audio_train.init_audio_params(
        torch.Generator().manual_seed(SEED), cfg, dev)
    win = torch.randn((batch, cfg.smo_size, cfg.win_size, 29),
                      generator=torch.Generator().manual_seed(SEED + 4))
    return cfg, init_state(params), lp, image, label, win.to(dev)


def phase_audio_step_card_vs_cpu() -> None:
    """[16] loss and every gradient of one audio step in its smooth phase,
    card vs CPU, at [8]'s tolerances. LeakyReLU's derivative jumps from
    0.2 to 1 at 0 (0.02 to 1 in the audio nets), so a gradient that misses
    the entrywise bound is held as [11] holds PReLU's: 1e-2 in the L2 norm
    and 1e-1 at its worst entry; the step says which ones needed it."""
    from hfa_gp_tpu_torch.train import audio as audio_train
    out = {}
    for dev in ("cuda", "cpu"):
        cfg, state, lp, image, label, win = audio_setup(dev, 1)
        t0 = time.perf_counter()
        loss, _ = audio_train.loss_fn(state.params, lp, cfg, image, label,
                                      win, True)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in state.params.named_parameters()
                 if p.grad is not None}
        out[dev] = (loss.item(), grads, time.perf_counter() - t0)
        del state, lp, loss
    (l_gpu, g_gpu, t_gpu), (l_cpu, g_cpu, t_cpu) = out["cuda"], out["cpu"]
    if sorted(g_gpu) != sorted(g_cpu):
        fail("card and CPU give gradients to different parameters")
    if not all(torch.isfinite(g).all() for g in g_gpu.values()):
        fail("non-finite gradient on the card")
    rels, kinks = {}, {}
    for n, want in g_cpu.items():
        if want.abs().max() == 0:
            continue
        rels[n] = rel_err(g_gpu[n], want)[1]
        if rels[n] > STEP_GRAD_RTOL:
            kinks[n] = ((g_gpu[n] - want).norm() / want.norm()).item()
    worst = sorted(rels, key=rels.get)[-3:][::-1]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    print(f"[16] one audio step (smooth phase) at full width, batch 1, card "
          f"vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.3e}, "
          f"bound {STEP_LOSS_RTOL:g}); {len(rels)} gradients, worst max abs "
          f"diff over the gradient's scale "
          f"{[(n, float(f'{rels[n]:.3e}')) for n in worst]} (bound "
          f"{STEP_GRAD_RTOL:g}); held in the L2 norm (bound "
          f"{ARC_GRAD_L2_RTOL:g}, worst entry {ARC_GRAD_RTOL:g}): "
          f"{ {n: float(f'{v:.3e}') for n, v in kinks.items()} }; card "
          f"{t_gpu:.2f} s, CPU {t_cpu:.2f} s", flush=True)
    if not loss_rel <= STEP_LOSS_RTOL:
        fail(f"card audio loss {l_gpu} differs from the CPU loss {l_cpu}")
    for n, l2 in kinks.items():
        if not (l2 <= ARC_GRAD_L2_RTOL and rels[n] <= ARC_GRAD_RTOL):
            fail(f"card gradient of {n} differs from the CPU's by "
                 f"{rels[n]} of its scale, {l2} in the L2 norm")


def phase_3dmm_audio_throughput() -> None:
    """[17] steady-state 3DMM and audio (smooth phase) training steps/s at
    batch 2, generator unfrozen, and peak device memory (printed, not
    asserted)."""
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import audio as audio_train
    from hfa_gp_tpu_torch.train import t3dmm
    from hfa_gp_tpu_torch.train.state import init_state
    batch, iters, warmup = 2, 5, 2

    def steps(step) -> float:
        times = []
        for i in range(warmup + iters):
            if i == warmup:
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times[warmup:])) * 1e3

    cfg, lp, image, label = avatar_batch("cuda", batch)
    st = init_state(heads.init_avatar_3dmm(
        torch.Generator().manual_seed(SEED), cfg, "cuda"))
    coeffs = torch.randn((batch, cfg.params_len),
                         generator=torch.Generator().manual_seed(SEED + 6)) \
        .cuda()
    ms = steps(lambda: t3dmm.train_step(st, lp, cfg, image, label, coeffs, 0))
    peak = torch.cuda.max_memory_allocated()
    print(f"[17] 3DMM training, batch {batch}, generator unfrozen: {ms:.2f} "
          f"ms per step (median of {iters}), {1e3 / ms:.3f} steps/s, peak "
          f"device memory {peak / 2**30:.3f} GiB", flush=True)
    del st
    cfg, st, lp, image, label, win = audio_setup("cuda", batch)
    ms = steps(lambda: audio_train.train_step(st, lp, cfg, image, label,
                                              win, True, 0))
    peak = torch.cuda.max_memory_allocated()
    print(f"     audio training (smooth phase), batch {batch}, generator "
          f"unfrozen: {ms:.2f} ms per step (median of {iters}), "
          f"{1e3 / ms:.3f} steps/s, peak device memory "
          f"{peak / 2**30:.3f} GiB", flush=True)


# [18]-[21], the preprocessing path: no hand-written kernel lies on it, so
# each phase holds the path's networks card against CPU and times it.
#   card vs CPU, relative to the output's scale: MTCNN (three small nets),
#   the ResNet-50 regressor (53 fp32 conv layers, TF32 off) and DeepSpeech's
#   logits over 10 s (500 recurrent steps, cuDNN's order of sums)
PREPROC_RTOL = 1e-4
# labels and cameras of the chain on the card against the same chain on
# the CPU, the ResNet-50's coefficients ~1e-6 apart: absolute
LABEL_ATOL = 1e-5
FRAME_H, FRAME_W = 720, 1280
PREPROC_FRAMES = 48
AUDIO_SECONDS = 60


def synthetic_frame(rng, centre=(640.0, 330.0), eyes=120.0) -> np.ndarray:
    """A seeded 1280×720 RGB frame: smooth colour gradients with noise and
    a light face-sized ellipse around `centre` with darker eyes and mouth
    `eyes` pixels apart."""
    y, x = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float32)
    img = np.stack([60 + 80 * x / FRAME_W, 90 + 60 * y / FRAME_H,
                    np.full_like(x, 120)], axis=-1)
    cx, cy = centre
    face = ((x - cx) / (0.9 * eyes)) ** 2 + ((y - cy) / (1.2 * eyes)) ** 2 < 1
    img[face] = (210, 170, 150)
    for dx, dy, r in ((-0.5, -0.25, 0.12), (0.5, -0.25, 0.12),
                      (0.0, 0.55, 0.2)):
        blob = ((x - cx - dx * eyes) ** 2 + (y - cy - dy * eyes) ** 2
                < (r * eyes) ** 2)
        img[blob] = (60, 40, 40)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def face_landmarks(rng, centre, eyes) -> np.ndarray:
    """The 5 points (eyes, nose, mouth corners) of synthetic_frame's face,
    jittered by 1.5 px as a detector's would be."""
    cx, cy = centre
    pts = np.array([[-0.5, -0.25], [0.5, -0.25], [0.0, 0.15], [-0.4, 0.55],
                    [0.4, 0.55]]) * eyes + (cx, cy)
    return (pts + rng.normal(0, 1.5, pts.shape)).astype(np.float32)


class StageClock:
    """Host seconds spent in named functions of a module, each wrapped for
    the clock's lifetime; `sync` ends a call on the card first."""

    def __init__(self, module, names, sync: bool = False):
        self.module, self.sync = module, sync
        self.seconds = {n: 0.0 for n in names}
        self.orig = {n: getattr(module, n) for n in names}
        for n in names:
            setattr(module, n, self._wrap(n, self.orig[n]))

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            return out
        return timed

    def close(self) -> None:
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


class ForwardClock:
    """Seconds spent in each module's forward calls, each call ended on the
    card, while the clock is open."""

    def __init__(self, modules: dict):
        self.seconds = {name: 0.0 for name in modules}
        self._start: dict[str, float] = {}
        self._handles = []
        for name, m in modules.items():
            self._handles += [
                m.register_forward_pre_hook(
                    lambda *_, name=name: self._begin(name)),
                m.register_forward_hook(
                    lambda *_, name=name: self._end(name))]

    def _begin(self, name: str) -> None:
        torch.cuda.synchronize()
        self._start[name] = time.perf_counter()

    def _end(self, name: str) -> None:
        torch.cuda.synchronize()
        self.seconds[name] += time.perf_counter() - self._start[name]

    def close(self) -> None:
        for h in self._handles:
            h.remove()


def worst_rel(got, want) -> float:
    """The largest of rel_err(...)[1] over paired tensors."""
    return max(rel_err(g.float().cpu(), w.float().cpu())[1]
               for g, w in zip(got, want))


def phase_detector() -> None:
    """[18] P-, R- and O-Net card against CPU on a synthetic 1280×720 frame
    (every pyramid level at min_face_size 20; R- and O-Net on 256
    candidates), then detect_faces on the card, timed and split."""
    from PIL import Image

    from hfa_gp_tpu_torch.preprocess import mtcnn
    rng = np.random.default_rng(SEED + 7)
    img = synthetic_frame(rng)
    nets = {dev: mtcnn.init_mtcnn(torch.Generator().manual_seed(SEED), dev)
            for dev in ("cuda", "cpu")}
    scales = mtcnn.pyramid_scales(FRAME_H, FRAME_W)
    err, probs = 0.0, []
    with torch.inference_mode():
        for s in scales:
            hs, ws = int(np.ceil(FRAME_H * s)), int(np.ceil(FRAME_W * s))
            level = mtcnn._normalize(np.asarray(Image.fromarray(img).resize(
                (ws, hs), Image.BILINEAR))[None])
            out = {dev: net.pnet(mtcnn._to_device(level, torch.device(dev)))
                   for dev, net in nets.items()}
            err = max(err, worst_rel(out["cuda"], out["cpu"]))
            vh, vw = (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
            probs.append(out["cpu"][0][0, 1, :vh, :vw].flatten().numpy())
    probs = np.concatenate(probs)
    # thresholds: P-Net's lets its top 2048 windows through, enough for a
    # full batch of MAX_CANDIDATES after NMS (a lower one leaves the host's
    # NMS tens of thousands of random-weight windows); none for R-Net, so
    # that all its NMS survivors reach O-Net; O-Net's median
    t0 = float(np.sort(probs)[-2048])
    cand = mtcnn.stage_pnet(nets["cpu"], img, mtcnn.MIN_FACE_SIZE, t0)
    boxes = mtcnn._square_boxes_np(mtcnn._apply_regression_np(
        cand[:mtcnn.MAX_CANDIDATES, :4], cand[:mtcnn.MAX_CANDIDATES, 5:9]))
    r = {dev: mtcnn.stage_rnet(net, img, boxes) for dev, net in nets.items()}
    o = {dev: mtcnn.stage_onet(net, img, boxes) for dev, net in nets.items()}
    err_r = worst_rel(*[[torch.from_numpy(a) for a in r[d]]
                        for d in ("cuda", "cpu")])
    err_o = worst_rel(*[[torch.from_numpy(a) for a in o[d]]
                        for d in ("cuda", "cpu")])
    thresholds = (t0, 0.0, float(np.median(o["cpu"][0])))
    print(f"[18] detector on a {FRAME_W}x{FRAME_H} frame, {len(scales)} "
          f"pyramid levels, {probs.size} P-Net windows, {len(cand)} "
          f"candidates after NMS, {len(boxes)} to R-/O-Net: card vs CPU max "
          f"abs error over scale P-Net {err:.3e}, R-Net {err_r:.3e}, O-Net "
          f"{err_o:.3e} (bound {PREPROC_RTOL:g}); thresholds "
          f"{tuple(round(t, 6) for t in thresholds)}", flush=True)
    if len(boxes) != mtcnn.MAX_CANDIDATES:
        fail(f"{len(boxes)} candidates reached R-Net, not a full batch")
    if not max(err, err_r, err_o) <= PREPROC_RTOL:
        fail(f"detector card vs CPU: {err}, {err_r}, {err_o}")

    net = nets["cuda"]
    mtcnn.detect_faces(net, img, thresholds=thresholds)      # warm-up
    stages = StageClock(mtcnn, ("stage_pnet", "stage_rnet", "stage_onet"))
    nets_clock = ForwardClock({"pnet": net.pnet, "rnet": net.rnet,
                               "onet": net.onet})
    runs = []
    try:
        for _ in range(3):
            before = {**stages.seconds, **nets_clock.seconds}
            t0 = time.perf_counter()
            faces = mtcnn.detect_faces(net, img, thresholds=thresholds)
            total = time.perf_counter() - t0
            now = {**stages.seconds, **nets_clock.seconds}
            runs.append({"total": total,
                         **{k: now[k] - before[k] for k in now}})
    finally:
        stages.close()
        nets_clock.close()
    ms = {k: float(np.median([r[k] for r in runs])) * 1e3 for k in runs[0]}
    host = ms["total"] - ms["stage_pnet"] - ms["stage_rnet"] \
        - ms["stage_onet"]
    print(f"    detect_faces on the card: {ms['total']:.2f} ms a frame "
          f"(median of 3): pyramid + P-Net {ms['stage_pnet']:.2f} (P-Net "
          f"calls {ms['pnet']:.2f}), R-Net stage {ms['stage_rnet']:.2f} "
          f"(R-Net call {ms['rnet']:.2f}), O-Net stage "
          f"{ms['stage_onet']:.2f} (O-Net call {ms['onet']:.2f}), host "
          f"between stages {host:.2f}; the nets' calls "
          f"{ms['pnet'] + ms['rnet'] + ms['onet']:.2f} of {ms['total']:.2f}; "
          f"{len(faces)} faces", flush=True)


def random_recon_state(g: torch.Generator):
    """init_facerecon's trunk with seeded random heads and BN statistics
    (the init's heads are zero), coefficients of order 0.3."""
    from hfa_gp_tpu_torch.preprocess import facerecon
    net = facerecon.init_facerecon(g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, facerecon.FrozenBatchNorm2d):
                c = m.scale.shape
                m.scale.copy_(torch.rand(c, generator=g) * 0.5 + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.1)
                m.mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.var.copy_(torch.rand(c, generator=g) * 1.5 + 0.5)
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * 1e-3)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return net


def write_recon_npz(net: torch.nn.Module, path: str) -> None:
    """`net`'s state as the JAX-layout flat npz that `--recon_weights`
    reads (tools/convert_facerecon.py's layout): each trunk conv HWIO under
    its own name, a head's under `weight`."""
    flat = {}
    for k, v in net.state_dict().items():
        v = v.cpu().numpy()
        if v.ndim == 4:
            v = v.transpose(2, 3, 1, 0)
            if not k.startswith("head"):
                k = k.removesuffix(".weight")
        flat[k.replace(".", "/")] = v
    np.savez(path, **flat)


def set_tf32(on: bool) -> None:
    """TF32 for cuDNN's convolutions and the matmuls. The preprocessing
    phases turn it on before a CLI, so that the CLI computes in fp32 only
    if it turns TF32 off itself, as every CLI of the port does on the
    card."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def tf32_left_on() -> bool:
    return torch.backends.cudnn.allow_tf32 \
        or torch.backends.cuda.matmul.allow_tf32


def read_chain_outputs(out: str) -> tuple[dict, dict]:
    """test.json's labels and cameras.json, both keyed by frame."""
    with open(os.path.join(out, "test.json")) as f:
        labels = dict(json.load(f)["labels"])
    with open(os.path.join(out, "cameras.json")) as f:
        return labels, json.load(f)


def conv_flops(net: torch.nn.Module, x: torch.Tensor) -> float:
    """Operations of `net`'s convolutions on `x`: 2 per multiply-add."""
    total = [0.0]

    def count(m, _inp, out):
        total[0] += 2.0 * out.numel() * m.weight[0].numel()

    handles = [m.register_forward_hook(count) for m in net.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.inference_mode():
        net(x)
    for h in handles:
        h.remove()
    return total[0]


def phase_facerecon() -> None:
    """[19] the ResNet-50 regressor at batch 16, 224², card against CPU, and
    its device time a batch with cuDNN's share."""
    from torch.profiler import ProfilerActivity, profile

    from hfa_gp_tpu_torch.tools.profile_train import GROUPS, on_device
    cpu = random_recon_state(torch.Generator().manual_seed(SEED))
    card = random_recon_state(torch.Generator().manual_seed(SEED)).cuda()
    x = torch.rand((16, 3, 224, 224),
                   generator=torch.Generator().manual_seed(SEED + 8))
    xc = x.cuda()
    with torch.inference_mode():
        t0 = time.perf_counter()
        want = cpu(x)
        t_cpu = time.perf_counter() - t0
        got = card(xc).cpu()
        ms = cuda_time_ms(lambda: card(xc), iters=10)
        with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                card(xc)
            torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    flops = conv_flops(cpu, x[:1]) * x.shape[0]
    needles = dict(GROUPS)["convolution (cuDNN, depthwise, FFT)"]
    per = [(float(e.self_device_time_total), e.key)
           for e in prof.key_averages() if on_device(e)]
    total = sum(us for us, _ in per)
    conv = sum(us for us, k in per if any(n in k for n in needles))
    print(f"[19] face recon (ResNet-50) batch 16 at 224²: card vs CPU max abs "
          f"error {err:.3e}, {rel:.3e} of the scale "
          f"{want.abs().max().item():.3f} (bound {PREPROC_RTOL:g}); "
          f"{ms:.3f} ms a batch on the card ({16e3 / ms:.1f} crops/s; "
          f"{flops / 1e9:.1f} GFLOP of convolutions, "
          f"{flops / ms / 1e9:.1f} TFLOP/s), "
          f"convolutions (cuDNN) {100 * conv / max(total, 1e-9):.1f} % of its "
          f"device time; CPU {t_cpu:.2f} s", flush=True)
    if got.shape != (16, 257) or not torch.isfinite(got).all():
        fail(f"face recon output {tuple(got.shape)}")
    if not rel <= PREPROC_RTOL:
        fail(f"face recon card vs CPU: {rel} of the scale")


def write_video_frames(root: str, n: int) -> None:
    """{root}/frames: n synthetic frames of a face that drifts, as PNGs,
    and {root}/frames/detections: their 5 points."""
    from PIL import Image
    rng = np.random.default_rng(SEED + 9)
    det = os.path.join(root, "frames", "detections")
    os.makedirs(det)
    for i in range(n):
        centre = (640.0 + 40 * np.sin(i / 8), 330.0 + 10 * np.cos(i / 11))
        Image.fromarray(synthetic_frame(rng, centre)).save(
            os.path.join(root, "frames", f"{i:04d}.png"), compress_level=1)
        np.savetxt(os.path.join(det, f"{i:04d}.txt"),
                   face_landmarks(rng, centre, 120.0))


def phase_process_video(tmp: str) -> None:
    """[20] cli.process_video --use_existing_detections on the card over
    48 synthetic 1280×720 frames, with [19]'s random-head regressor as
    --recon_weights: 48 crops of 512², test.json and cameras.json, held
    against the same command on the CPU (crops byte for byte, labels and
    cameras to LABEL_ATOL); the port's HeadData reads them and train_rgb
    takes two steps on them at full width with [7]'s flags."""
    import shutil

    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from hfa_gp_tpu_torch.cli import process_video, train_rgb
    from hfa_gp_tpu_torch.data.dataset import HeadData
    from hfa_gp_tpu_torch.preprocess import pipeline
    from hfa_gp_tpu_torch.tools.profile_train import device_busy_us
    from hfa_gp_tpu_torch.preprocess import convert, pose
    from hfa_gp_tpu_torch.utils.convert import load_npz
    n = PREPROC_FRAMES
    write_video_frames(tmp, n)
    recon = random_recon_state(torch.Generator().manual_seed(SEED))
    weights = os.path.join(tmp, "recon.npz")
    write_recon_npz(recon, weights)
    back = convert.facerecon_from_jax(load_npz(weights)).state_dict()
    if any(not torch.equal(back[k], v)
           for k, v in recon.state_dict().items()):
        fail("the face-recon npz does not read back as written")
    out = os.path.join(tmp, "nerface_dataset", "person_3", "train",
                       "cropped_images")

    def cli_args(out_dir: str, device: str):
        return process_video.build_argparser().parse_args([
            "--in_root", os.path.join(tmp, "frames"), "--out_dir", out_dir,
            "--recon_weights", weights, "--use_existing_detections",
            "--device", device])

    args = cli_args(out, "cuda")
    stages = ("load_detections", "smooth_landmarks", "regress_coeffs",
              "crop_frames", "make_labels")
    clock = StageClock(pipeline, stages, sync=True)
    reset_launches()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            set_tf32(True)
            t0 = time.perf_counter()
            process_video.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        clock.close()
    launches = read_launches()
    if tf32_left_on():
        fail("cli.process_video left TF32 on")
    busy_us, _ = device_busy_us(prof)
    crops = sorted(glob.glob(os.path.join(out, "*.png")))
    sizes = {Image.open(p).size for p in crops}
    labels, cams = read_chain_outputs(out)

    # the same command on the CPU
    out_cpu = os.path.join(tmp, "cpu_chain")
    t0 = time.perf_counter()
    process_video.main(cli_args(out_cpu, "cpu"))
    cpu_s = time.perf_counter() - t0
    labels_cpu, cams_cpu = read_chain_outputs(out_cpu)
    same_crops = sum(
        open(p, "rb").read() == open(os.path.join(out_cpu,
                                                  os.path.basename(p)),
                                     "rb").read() for p in crops)
    label_err = max(np.abs(np.subtract(labels[k], labels_cpu[k])).max()
                    for k in labels_cpu)
    cam_err = max(np.abs(np.subtract(cams[k][f], cams_cpu[k][f])).max()
                  for k in cams_cpu for f in ("intrinsics", "pose", "angle"))
    # every frame's label against the one zero coefficients give (what
    # init_facerecon's zero heads return): the regressor moved them
    zero = pose.labels_from_coeffs(torch.zeros(1, 3),
                                   torch.zeros(1, 3))[0].numpy()
    moved = min(np.abs(np.subtract(v, zero)).max() for v in labels.values())
    per = {k: 1e3 * v / n for k, v in clock.seconds.items()}
    print(f"[20] process_video on the card, {n} frames of {FRAME_W}x"
          f"{FRAME_H}: {seconds:.2f} s, {n / seconds:.3f} frames/s (nets' "
          f"random init included); ms a frame: read detections "
          f"{per['load_detections']:.3f}, smooth {per['smooth_landmarks']:.3f}"
          f", align + recon {per['regress_coeffs']:.2f}, crop "
          f"{per['crop_frames']:.2f}, labels {per['make_labels']:.3f}; device "
          f"busy {busy_us / 1e3:.2f} ms = {100 * busy_us / 1e6 / seconds:.2f} "
          f"% of the run; {len(crops)} crops {sorted(sizes)}, {len(labels)} "
          f"labels, {len(cams)} cameras; launches {launches}", flush=True)
    print(f"    the same command on the CPU ({cpu_s:.2f} s): {same_crops} of "
          f"{len(crops)} crops equal byte for byte, labels max abs error "
          f"{label_err:.3e}, cameras {cam_err:.3e} (bound {LABEL_ATOL:g}); "
          f"each label at least {moved:.3f} from zero coefficients' label",
          flush=True)
    if len(crops) != n or sizes != {(512, 512)}:
        fail(f"process_video wrote {len(crops)} crops {sizes}")
    if len(labels) != n or {len(v) for v in labels.values()} != {25} \
            or not np.isfinite(list(labels.values())).all() \
            or len(cams) != n:
        fail(f"process_video labels {len(labels)}, cameras {len(cams)}")
    if sorted(labels_cpu) != sorted(labels) or sorted(cams_cpu) != \
            sorted(cams) or same_crops != n:
        fail(f"process_video card vs CPU: {same_crops} of {n} crops equal, "
             f"{len(labels_cpu)} labels, {len(cams_cpu)} cameras")
    if not max(label_err, cam_err) <= LABEL_ATOL:
        fail(f"process_video card vs CPU: labels {label_err}, cameras "
             f"{cam_err}")
    if not moved > 0.01:
        fail(f"the labels do not depend on the regressor: {moved}")
    if launches != NO_LAUNCHES:
        fail(f"a hand-written kernel ran on the preprocessing path: "
             f"{launches}")
    img, label = HeadData("train", size=256, root=os.path.join(
        tmp, "nerface_dataset"), person="person_3")[0]
    if img.shape != (256, 256, 3) or label.shape != (25,):
        fail(f"HeadData read {tuple(img.shape)}, {tuple(label.shape)}")
    shutil.copytree(out, os.path.join(tmp, "nerface_dataset", "person_3",
                                      "test2", "cropped_images"))

    steps = 2
    exp = os.path.join(tmp, "exps")
    reset_launches()
    train_rgb.main(train_rgb.build_argparser().parse_args([
        "--dataset_root", tmp, "--person", "person_3", "--size", "256",
        "--batch_size", "2", "--exp_path", exp, "--exp_name", "preproc",
        "--tune_iter", "2", "--device", "cuda", "--iter", str(steps),
        "--display_freq", "100", "--save_freq", "100"]))
    launches = read_launches()
    shown = train_losses("train_rgb on the crops",
                         os.path.join(exp, "preproc"), steps)
    print(f"    train_rgb on the crops: {steps} steps, (l2, lpips) {shown}, "
          f"launches {launches}", flush=True)
    expected = {**NO_LAUNCHES, "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    if launches != expected:
        fail(f"train_rgb on the crops launched {launches}, expected "
             f"{expected}")


def write_wav(path: str, seconds: float) -> None:
    """A seeded 16 kHz 16-bit mono wav: a gliding tone under noise."""
    import wave
    rng = np.random.default_rng(SEED + 10)
    t = np.arange(int(16000 * seconds)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * (200 + 30 * np.sin(t)) * t)
             * np.sin(2 * np.pi * 2 * t) + rng.normal(0, 0.05, t.shape))
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((audio * 8000).astype(np.int16).tobytes())


def phase_extract_audio(tmp: str) -> None:
    """[21] cli.extract_audio on a 60 s wav on the card: aud.npy of
    (1500, 16, 29) at 25 fps that HeadDataAudio reads; DeepSpeech's logits
    card against CPU on the first 10 s; seconds of audio per second, split
    into MFCC (host), dense layers and LSTM, and the peak memory."""
    from hfa_gp_tpu_torch.cli import extract_audio
    from hfa_gp_tpu_torch.data.dataset import HeadDataAudio
    from hfa_gp_tpu_torch.preprocess import deepspeech as ds
    wav = os.path.join(tmp, "sp.wav")
    write_wav(wav, AUDIO_SECONDS)
    write_audio_dataset(tmp)
    aud = os.path.join(tmp, "ad_dataset", "obama", "aud.npy")
    set_tf32(True)
    t0 = time.perf_counter()
    extract_audio.main(extract_audio.build_argparser().parse_args([
        "--wav", wav, "--out", aud, "--device", "cuda"]))
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    if tf32_left_on():
        fail("cli.extract_audio left TF32 on")
    feats = np.load(aud)
    item = HeadDataAudio("train", size=256, root=os.path.join(
        tmp, "ad_dataset"), person="obama")[0]
    print(f"[21] extract_audio on the card, {AUDIO_SECONDS} s of 16 kHz "
          f"audio: aud.npy {feats.shape}, {cli_s:.2f} s of command (the "
          f"net's random init included), HeadDataAudio item audio "
          f"{tuple(item[2].shape)}", flush=True)
    if feats.shape != (AUDIO_SECONDS * 25, 16, 29) \
            or not np.isfinite(feats).all() or item[2].shape != (16, 29):
        fail(f"aud.npy {feats.shape}, item {tuple(item[2].shape)}")

    audio, _ = extract_audio.load_wav(wav)
    cpu = ds.init_deepspeech(torch.Generator().manual_seed(SEED))
    net = copy.deepcopy(cpu).cuda()
    t0 = time.perf_counter()
    vec = ds.input_vectors(audio)
    mfcc_s = time.perf_counter() - t0
    x = torch.from_numpy(vec).cuda()
    with torch.inference_mode():
        head = vec[:500]
        want = cpu(torch.from_numpy(head))
        got = net(x[:500]).cpu()
        err, rel = rel_err(got, want)
        torch.cuda.reset_peak_memory_stats()
        h = net.dense(x)
        r = net.recur(h)
        dense_ms = cuda_time_ms(lambda: net.dense(x), iters=5, warmup=1)
        lstm_ms = cuda_time_ms(lambda: net.recur(h), iters=5, warmup=1)
        head_ms = cuda_time_ms(lambda: net.head(r), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ds.extract_features(net, audio)
    extract_s = time.perf_counter() - t0
    w_hh = nbytes(net.lstm.weight_hh_l0, net.lstm.weight_hh_l0_reverse)
    print(f"    DeepSpeech logits card vs CPU on the first 10 s: max abs "
          f"error {err:.3e}, {rel:.3e} of the scale "
          f"{want.abs().max().item():.3f} (bound {PREPROC_RTOL:g})", flush=True)
    print(f"    {AUDIO_SECONDS} s of audio: extract_features {extract_s:.3f} "
          f"s = {AUDIO_SECONDS / extract_s:.1f} s of audio a second "
          f"({AUDIO_SECONDS / cli_s:.1f} for the whole command); MFCC and "
          f"context (host) {mfcc_s * 1e3:.1f} ms, dense layers "
          f"{dense_ms + head_ms:.2f} ms (h1-h3 {dense_ms:.2f}, h5 + logits "
          f"{head_ms:.2f}), LSTM {lstm_ms:.2f} ms ({vec.shape[0]} steps, "
          f"both directions: {1e3 * lstm_ms / vec.shape[0]:.1f} µs a step, "
          f"whose recurrent weights ({w_hh / 2**20:.0f} MiB) take "
          f"{1e6 * w_hh / PEAK_BYTES_PER_S:.1f} µs to read at the memory "
          f"rate); peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    if not rel <= PREPROC_RTOL:
        fail(f"DeepSpeech card vs CPU: {rel} of the scale")

# [22]-[26], the rest of arcface: the other backbone families and the bf16
# route (the JAX CLI's default) through train_arcface.main at batch 256,
# in-training verification and the export, and the two evaluation CLIs
ARC_FAMILIES = {
    22: ("mbf", ["--fp32", "--num_classes", "1000000"]),
    # the reference's ViT recipe (AdamW at 1e-3, PartialFC at 0.3) at about
    # WebFace42M's 2.06M identities, in bf16
    23: ("vit_t", ["--optimizer", "adamw", "--lr", "1e-3", "--sample_rate",
                   "0.3", "--num_classes", "2000000"]),
    # the JAX CLI's default command: bf16 trunk and head products
    24: ("iresnet50", ["--num_classes", "1000000"]),
}
#   card vs CPU, one bf16 arcface step (iresnet50, batch 8): each device
#   rounds every conv output to bf16 with its own algorithms. The card's
#   readings barely move with the batch (backbone 0.107 at batch 8, 0.102 at
#   32 and 64; table 0.026, 0.024, 0.024): the spread is bf16's own, as
#   JAX's bf16 steps lie 0.085 from its fp32 steps (tests/
#   test_torch_arcface.py). So batch 8, and bounds about 2.5x its readings
#   (PERF.md §5): the loss to 1e-2, the backbone's gradients together to
#   0.25, the median tensor to 0.3, the worst to 0.5, the table to 0.07
ARC_BF16_STEP_BATCH = 8
ARC_BF16_LOSS_RTOL = 1e-2
ARC_BF16_GRAD_L2_RTOL = 0.25
ARC_BF16_MEDIAN_L2_RTOL = 0.3
ARC_BF16_TENSOR_L2_RTOL = 0.5
ARC_BF16_TABLE_L2_RTOL = 0.07
#   card vs CPU embeddings of the evaluation CLIs (fp32): relative to the
#   embeddings' scale; template cosines absolute
EVAL_EMB_RTOL = 1e-4
EVAL_SCORE_ATOL = 1e-4


def arc_family_args(network: str, *extra):
    from hfa_gp_tpu_torch.cli import train_arcface
    return train_arcface.build_argparser().parse_args([
        "--network", network, "--batch_size", str(ARC_BATCH), "--device",
        "cuda", *extra])


def phase_arcface_family(tag: int) -> dict:
    """[22]-[24] train_arcface.main on one more configuration: finite
    losses that do not rise, one K5 and one K6 launch a step, the CLI's
    samples/s and the peak device memory. For the ViT, masking once a step
    and drop path on both branches of every block after the first."""
    from hfa_gp_tpu_torch.models.arcface import vit
    network, flags = ARC_FAMILIES[tag]
    steps = 6
    args = arc_family_args(network, *flags, "--num_steps", str(steps))
    calls = {"random_masking": 0, "drop_path": 0}
    real = {k: getattr(vit, k) for k in calls}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for k in calls:
        setattr(vit, k, counted(k))
    try:
        losses, launches, seconds, peak, sps = run_arcface_cli(args)
    finally:
        for k, fn in real.items():
            setattr(vit, k, fn)
    print(f"[{tag}] arcface path, {network}, {args.num_classes:,} classes, "
          f"sample_rate {args.sample_rate}, {args.optimizer}, "
          f"{'fp32' if args.fp32 else 'bf16'}, batch {ARC_BATCH}: {steps} "
          f"steps in {seconds:.2f} s (init and first-use costs included), "
          f"losses {[round(x, 4) for x in losses]}, {sps:.3f} samples/s "
          f"(the CLI's clock, the first step left out), peak "
          f"{peak / GIB:.3f} GiB, launches {launches}, ViT draws {calls}",
          flush=True)
    check_arcface_losses(f"[{tag}] {network}", losses, args.num_classes,
                         steps)
    expected = {**NO_LAUNCHES, "flash_ce_fwd": steps, "flash_ce_bwd": steps}
    if launches != expected:
        fail(f"[{tag}] {network} launched {launches}, expected {expected}")
    if network.startswith("vit"):
        depth = vit.VIT_CONFIGS[network][2]
        want = {"random_masking": steps,
                "drop_path": steps * 2 * (depth - 1)}
        if calls != want:
            fail(f"[{tag}] ViT masking and drop path ran {calls}, expected "
                 f"{want}")
    return {"launches": launches, "samples_per_s": sps,
            "peak_gib": peak / GIB}


def phase_bf16_step_card_vs_cpu(batch: int = ARC_BF16_STEP_BATCH) -> None:
    """[24] loss and every gradient of one bf16 arcface step (bf16 trunk,
    bf16 operands of the head's products: K5/K6 with bf16=1 on the card),
    card vs CPU, from the same seeded state and batch: the loss, the
    backbone's gradients together and the median one, the worst tensor,
    and the table's gradient, each to its own bound. `batch` other than 8
    gives the readings of PERF.md §6 at other batches."""
    from hfa_gp_tpu_torch.models.arcface import registry
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    from hfa_gp_tpu_torch.train import arcface as arc
    classes, bf = 10_000, torch.bfloat16
    pfc = PartialFC(classes, ARC_DIM, matmul_dtype=bf)
    tx, fc_tx = arc.make_optimizers(4)
    g = torch.Generator().manual_seed(SEED + 4)
    images = torch.randn((batch, 112, 112, 3), generator=g)
    labels = torch.randint(0, classes, (batch,), generator=g)
    out = {}
    table = None
    for dev in ("cuda", "cpu"):
        state = arc.init_state(torch.Generator().manual_seed(SEED), pfc, tx,
                               fc_tx, ARC_NET, dev)
        if table is None:
            table = state.fc_weight.cpu()
        else:
            state.fc_weight.copy_(table)
        t0 = time.perf_counter()
        w = state.fc_weight.detach().to(dev).requires_grad_(True)
        emb, _ = registry.backbone_apply(ARC_NET, state.backbone,
                                         state.batch_stats, images.to(dev),
                                         train=True, dtype=bf)
        loss = pfc.loss(w, emb, labels.to(dev))
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in
                 state.backbone.named_parameters() if p.grad is not None}
        out[dev] = (loss.item(), grads, w.grad.cpu(),
                    time.perf_counter() - t0)
        del state, w, emb, loss
    (l_gpu, g_gpu, w_gpu, t_gpu), (l_cpu, g_cpu, w_cpu, t_cpu) = \
        out["cuda"], out["cpu"]
    # the gradients that are zero by construction ([11]) are left out
    held = [n for n in g_cpu if not (n in ("fc.bias", "bn2.bias")
                                     or n.endswith(("bn3.bias",
                                                    "down_bn.bias")))]
    l2 = {n: ((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm()).item()
          for n in held}
    whole = (torch.cat([(g_gpu[n] - g_cpu[n]).flatten() for n in held])
             .norm() / torch.cat([g_cpu[n].flatten() for n in held]).norm()
             ).item()
    table_l2 = ((w_gpu - w_cpu).norm() / w_cpu.norm()).item()
    worst = max(l2, key=l2.get)
    median = float(np.median(list(l2.values())))
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    print(f"[24] one bf16 arcface step, {ARC_NET}, {classes} classes, batch "
          f"{batch}, card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel "
          f"{loss_rel:.3e}, bound {ARC_BF16_LOSS_RTOL:g}); relative L2 of "
          f"the {len(held)} backbone gradients together {whole:.4e} (bound "
          f"{ARC_BF16_GRAD_L2_RTOL:g}), median a tensor {median:.4e} (bound "
          f"{ARC_BF16_MEDIAN_L2_RTOL:g}), worst {worst} {l2[worst]:.4e} "
          f"(bound {ARC_BF16_TENSOR_L2_RTOL:g}); the table's {table_l2:.4e} (bound "
          f"{ARC_BF16_TABLE_L2_RTOL:g}); card {t_gpu:.2f} s, CPU "
          f"{t_cpu:.2f} s", flush=True)
    if not all(torch.isfinite(x).all() for x in g_gpu.values()) \
            or not torch.isfinite(w_gpu).all():
        fail("non-finite bf16 arcface gradient on the card")
    if not loss_rel <= ARC_BF16_LOSS_RTOL:
        fail(f"bf16 step: card loss {l_gpu} vs CPU {l_cpu}")
    if not (whole <= ARC_BF16_GRAD_L2_RTOL
            and median <= ARC_BF16_MEDIAN_L2_RTOL
            and l2[worst] <= ARC_BF16_TENSOR_L2_RTOL):
        fail(f"bf16 step: backbone gradients card vs CPU {whole}, median "
             f"{median}, {worst} {l2[worst]}")
    if not table_l2 <= ARC_BF16_TABLE_L2_RTOL:
        fail(f"bf16 step: the table's gradient card vs CPU {table_l2}")


def write_pairs_bin(path: str, n_pairs: int, seed: int) -> str:
    """An LFW-style .bin: a pickled (PNG bytes list, issame list) of
    n_pairs pairs of 112² crops, a base and the same base with a little
    noise (issame) or two bases."""
    import io
    import pickle

    from PIL import Image
    rng = np.random.default_rng(seed)
    bins, issame = [], []
    for i in range(n_pairs):
        a = rng.integers(0, 256, (112, 112, 3))
        same = i % 2 == 0
        b = a + rng.integers(-8, 9, a.shape) if same \
            else rng.integers(0, 256, a.shape)
        for img in (a, b):
            buf = io.BytesIO()
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                buf, format="PNG")
            bins.append(buf.getvalue())
        issame.append(same)
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    return path


class _Records(logging.Handler):
    """A logging handler that keeps the messages."""

    def __init__(self):
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append(record.getMessage())


def phase_val_bin_export(tmp: str) -> dict:
    """[25] train_arcface.main --val_bin --verbose 2 --export (mbf, bf16,
    100,000 classes, 4 steps) on a 64-pair synthetic .bin: an accuracy line
    at steps 2 and 4; model.pt2 loaded with torch.export.load equal to
    backbone_apply at batch 1 and 64; then eval_verification on model.npz,
    card vs CPU; then pairs/s of eval_verification --synthetic with
    iresnet50 on the card."""
    from hfa_gp_tpu_torch.cli import eval_verification
    from hfa_gp_tpu_torch.models.arcface import registry
    from hfa_gp_tpu_torch.utils.observability import LOGGER_NAME
    net, steps, n_pairs = "mbf", 4, 64
    out = os.path.join(tmp, "val")
    vbin = write_pairs_bin(os.path.join(tmp, "pairs.bin"), n_pairs, SEED)
    records = _Records()
    logger = logging.getLogger(LOGGER_NAME)
    logger.addHandler(records)
    try:
        losses, launches, seconds, _, _ = run_arcface_cli(arc_family_args(
            net, "--num_classes", "100000", "--num_steps", str(steps),
            "--val_bin", vbin, "--verbose", "2", "--output", out,
            "--export"))
    finally:
        logger.removeHandler(records)
    acc_lines = [ln for ln in records.lines if "verification acc" in ln]
    files = sorted(os.listdir(out))
    with open(os.path.join(out, "model_cost.json")) as f:
        cost = json.load(f)
    print(f"[25] train_arcface --val_bin ({n_pairs} pairs) --verbose 2 "
          f"--export, {net}, bf16, {steps} steps in {seconds:.2f} s: losses "
          f"{[round(x, 4) for x in losses]}, {acc_lines}, {files}, "
          f"{cost['flops'] / 1e9:.3f} GFLOP an image, launches {launches}",
          flush=True)
    if [ln.split("]")[0] for ln in acc_lines] != ["[step 2", "[step 4"]:
        fail(f"--val_bin logged {acc_lines}")
    if not {"model.pt2", "model.npz", "model_cost.json"} <= set(files) \
            or not cost["flops"] > 0:
        fail(f"--export wrote {files}, {cost}")
    if launches != {**NO_LAUNCHES, "flash_ce_fwd": steps,
                    "flash_ce_bwd": steps}:
        fail(f"[25] launched {launches}")

    # the exported program against backbone_apply on the saved state
    saved = torch.load(os.path.join(out, "checkpoint", f"{steps:06d}"),
                       weights_only=True, map_location="cuda")
    params, stats = registry.init_backbone(torch.Generator(), net,
                                           device="cuda")
    params.load_state_dict(saved["backbone"])
    stats.load_state_dict(saved["batch_stats"])
    program = torch.export.load(os.path.join(out, "model.pt2")).module()
    errs = []
    for b in (1, 64):
        x = torch.randn((b, 112, 112, 3), device="cuda")
        with torch.no_grad():
            errs.append(rel_err(program(x), registry.backbone_apply(
                net, params, stats, x))[1])
    del saved, params, stats, program

    # eval_verification on the exported npz, card and CPU
    results, embs = {}, {}
    img1 = eval_verification.load_bin(vbin)[0][:16]
    for dev in ("cuda", "cpu"):
        args = eval_verification.build_argparser().parse_args([
            "--network", net, "--weights", os.path.join(out, "model.npz"),
            "--bin", vbin, "--device", dev])
        results[dev] = eval_verification.main(args)
        p, st = eval_verification.load_backbone(net, args.weights,
                                                torch.device(dev))
        embs[dev] = torch.from_numpy(eval_verification.make_embed_fn(
            net, p, st, torch.device(dev))(img1))
    emb_rel = rel_err(embs["cuda"], embs["cpu"])[1]
    (acc_g, _, thr_g), (acc_c, _, thr_c) = results["cuda"], results["cpu"]
    logged = acc_lines[-1].split("acc ")[1].split(" ")[0]
    print(f"     model.pt2 vs backbone_apply at batch 1 and 64: "
          f"{[f'{e:.3e}' for e in errs]} of the scale (bound "
          f"{EVAL_EMB_RTOL:g}); eval_verification on model.npz: card "
          f"{results['cuda']}, CPU {results['cpu']}, last logged accuracy "
          f"{logged}; embeddings card vs CPU {emb_rel:.3e} of the scale "
          f"(bound {EVAL_EMB_RTOL:g})", flush=True)
    if not max(errs) <= EVAL_EMB_RTOL or not emb_rel <= EVAL_EMB_RTOL:
        fail(f"exported program {errs}, embeddings card vs CPU {emb_rel}")
    # one pair may sit within rounding of a threshold of the 0.01 grid:
    # at most one pair of one fold, and the threshold one grid step
    if f"{acc_g:.4f}" != logged or abs(acc_g - acc_c) > 1.0 / n_pairs \
            or abs(thr_g - thr_c) > 0.01 + 1e-9:
        fail(f"eval_verification card {results['cuda']} vs CPU "
             f"{results['cpu']}, logged {logged}")

    # pairs/s of the protocol with iresnet50 on the card, warm
    args = eval_verification.build_argparser().parse_args([
        "--network", ARC_NET, "--synthetic", "--device", "cuda"])
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, _, _ = eval_verification.main(args)
        times.append(time.perf_counter() - t0)
    n = 2 * 128                        # synthetic_pairs' 128 identities
    print(f"     eval_verification --synthetic, {ARC_NET} (random weights), "
          f"{n} pairs on the card: {times[0]:.2f} s cold, {times[1]:.2f} s "
          f"warm, {n / times[1]:.1f} pairs/s (host synthesis and the K-fold "
          f"sweep included); accuracy {acc:.4f}", flush=True)
    return {"pairs_per_s": n / times[1], "seconds": times[1]}


def write_ijb_fixture(root: str, n_subjects: int) -> str:
    """The insightface IJB layout of tests/test_ijb.py for n_subjects × 2
    templates × 2 media: near-identical 130 × 120 crops of one random base
    per subject, landmarks at the ArcFace points shifted by the crop's
    offset, all template pairs, and a 1:N gallery (template 0 of each
    subject) and probe (template 1)."""
    from PIL import Image

    from hfa_gp_tpu_torch.preprocess.warp import ARCFACE_5PTS
    meta, crop = os.path.join(root, "meta"), os.path.join(root, "loose_crop")
    os.makedirs(meta)
    os.makedirs(crop)
    rng = np.random.default_rng(SEED)
    bases = rng.integers(0, 255, (n_subjects, 130, 120, 3)).astype(np.uint8)
    pts = " ".join(f"{v:.2f}" for v in
                   (ARCFACE_5PTS + np.array([4.0, 9.0])).reshape(-1))
    tid_mid, name_pts, subject = [], [], {}
    for s in range(n_subjects):
        for t in range(2):
            tid = 2 * s + t
            subject[tid] = s
            for m in range(2):
                name = f"s{s}_t{t}_m{m}.png"
                img = bases[s].astype(np.int16) + rng.integers(
                    -4, 5, bases[s].shape, dtype=np.int16)
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(crop, name))
                tid_mid.append(f"{name} {tid} {m}")
                name_pts.append(f"{name} {pts} 0.99")
    tids = sorted(subject)
    pairs = [f"{a} {b} {int(subject[a] == subject[b])}"
             for i, a in enumerate(tids) for b in tids[i + 1:]]
    for fname, lines in (
            ("ijbc_face_tid_mid.txt", tid_mid),
            ("ijbc_template_pair_label.txt", pairs),
            ("ijbc_name_5pts_score.txt", name_pts),
            ("ijbc_1N_gallery.txt", [f"{t} {s}" for t, s in subject.items()
                                     if t % 2 == 0]),
            ("ijbc_1N_probe.txt", [f"{t} {s}" for t, s in subject.items()
                                   if t % 2 == 1])):
        with open(os.path.join(meta, fname), "w") as f:
            f.write("\n".join(lines))
    return root


def phase_eval_ijb(tmp: str) -> dict:
    """[26] eval_ijb on a synthetic fixture of 20 subjects × 2 templates ×
    2 media (random weights, flip test, norm and detector scores): every
    same-subject pair above every cross-subject pair, rank-1 identification
    1.0, the scores card vs CPU (mbf); then images/s on the card with
    iresnet50, warm."""
    from hfa_gp_tpu_torch.cli import eval_ijb
    n_subjects = 20
    root = write_ijb_fixture(os.path.join(tmp, "ijb"), n_subjects)
    labels = np.loadtxt(os.path.join(root, "meta",
                                     "ijbc_template_pair_label.txt"),
                        dtype=np.int64, ndmin=2)[:, 2]
    n_images = n_subjects * 4

    def run(net: str, dev: str, job: str):
        args = eval_ijb.build_argparser().parse_args([
            "--image_path", root, "--network", net, "--canvas", "160",
            "--batch_size", "64", "--result_dir", os.path.join(tmp, "res"),
            "--job", job, "--device", dev])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = eval_ijb.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        scores = np.load(os.path.join(tmp, "res", f"{job}_scores.npy"))
        gap = float(scores[labels == 1].min() - scores[labels == 0].max())
        return metrics, scores, gap, seconds

    out = {dev: run("mbf", dev, f"mbf_{dev}") for dev in ("cuda", "cpu")}
    diff = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    run(ARC_NET, "cuda", "r50_warmup")
    m50, _, gap50, sec50 = run(ARC_NET, "cuda", "r50")
    print(f"[26] eval_ijb, {n_subjects} subjects x 2 templates x 2 media "
          f"({n_images} images, {len(labels)} template pairs), random "
          f"weights: mbf card {out['cuda'][0]}, same-subject minus "
          f"cross-subject score {out['cuda'][2]:.4f} (card) "
          f"{out['cpu'][2]:.4f} (CPU); scores card vs CPU {diff:.3e} (bound "
          f"{EVAL_SCORE_ATOL:g}); {ARC_NET} on the card: gap {gap50:.4f}, "
          f"{sec50:.2f} s warm, {n_images / sec50:.1f} images/s (PNG "
          f"decoding on the host included), card {out['cuda'][3]:.2f} s "
          f"and CPU {out['cpu'][3]:.2f} s for mbf", flush=True)
    for name, (metrics, _, gap, _) in (("mbf card", out["cuda"]),
                                       ("mbf CPU", out["cpu"]),
                                       (f"{ARC_NET} card", (m50, None, gap50,
                                                            None))):
        if not gap > 0 or metrics["rank_k"]["1"] != 1.0 \
                or metrics["tar_at_far"]["1e-01"] != 1.0:
            fail(f"[26] {name}: same-subject pairs not above the rest "
                 f"(gap {gap}, {metrics})")
    if not diff <= EVAL_SCORE_ATOL:
        fail(f"[26] scores card vs CPU differ by {diff}")
    return {"images_per_s": n_images / sec50, "seconds": sec50}


# [27]-[30], the avatar CLIs' remaining single-card flags: --bf16 (the JAX
# package's headline configuration: the EG3D synthesis chains and the OSG
# decoder in bf16, the kernels' fp32 interfaces unchanged), --trace_dir,
# the renderer's remat and ray_chunk, the second person's subspace.
#   card vs CPU in bf16: both round every conv output to bf16, cuDNN and
#   oneDNN after summing in their own orders. L2 norms relative to the
#   reference's; each bound about 2.5x its first reading on an H100 80GB
#   HBM3 at 700 W: the frame 3.7e-3 card vs CPU and 4.0e-3 from the card's
#   fp32 frame; the step's loss 6.9e-5, gradients 1.3e-3 to 1.5e-3 by group
#   and 1.0e-2 for the worst tensor (one of the 4x4 block's)
BF16_FRAME_L2 = 1e-2
BF16_VS_FP32_L2 = 1e-2
BF16_LOSS_RTOL = 2e-4
BF16_GROUP_L2 = 4e-3
BF16_TENSOR_L2 = 2.5e-2
#   remat recomputes the same forward; only the sampler backward's atomics
#   reorder fp32 sums (2.1e-5 of a gradient's scale at the first reading)
REMAT_GRAD_RTOL = 1e-4
RAY_CHUNK = 4096


def l2_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def bf16_config(cfg=None):
    from hfa_gp_tpu_torch.cli import common
    from hfa_gp_tpu_torch.models.avatar import heads
    return common.with_dtype(cfg or heads.AvatarConfig(), torch.bfloat16)


def with_render(cfg, **kw):
    """cfg with the renderer's fields in kw replaced."""
    import dataclasses
    return dataclasses.replace(cfg, eg3d=dataclasses.replace(
        cfg.eg3d, render=dataclasses.replace(cfg.eg3d.render, **kw)))


def phase_bf16_main_path(tmp: str) -> dict[str, int]:
    """[27] run_recon_video_rgb.main --bf16 --trace_dir at full width on
    [4]'s 4-frame dataset: 4 PNGs of 512², finite frames, each forward
    kernel twice a batch, and a Chrome trace whose events name the
    sampler and marcher kernels and the annotated regions."""
    from hfa_gp_tpu_torch.cli import run_recon_video_rgb as cli
    n_frames, batch = 4, 4
    write_dataset(tmp, n_frames)
    trace_dir = os.path.join(tmp, "trace")
    args = cli.build_argparser().parse_args([
        "--dataset_root", tmp, "--person", "person_3", "--size", "256",
        "--render_batch", str(batch), "--demo_dir",
        os.path.join(tmp, "demo"), "--demo_name", "bf16", "--fps", "4",
        "--device", "cuda", "--bf16", "--trace_dir", trace_dir])
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
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    names: set[str] = set()
    for path in traces:
        with open(path) as f:
            names |= {e.get("name", "") for e in json.load(f)["traceEvents"]}
    seen = {k: sum(k in n for n in names) > 0
            for k in ("triplane_sampler_kernel", "ray_march", "encoder",
                      "subspace", "synthesis")}
    n_batches = -(-n_frames // batch)
    print(f"[27] --bf16 --trace_dir reenactment: finite {finite}, launches "
          f"{launches} over {n_batches} batch(es), {seconds:.2f} s (tracing "
          f"and first-use costs included); {len(traces)} trace file(s), "
          f"{sum(os.path.getsize(t) for t in traces) / 2**20:.2f} MiB, "
          f"{len(names)} event names, named: {seen}", flush=True)
    check_pngs("--bf16 frames", os.path.join(tmp, "demo", "bf16", "*.png"),
               n_frames)
    if len(finite) != n_batches or not all(finite):
        fail(f"[27] non-finite frames: {finite}")
    expected = {**NO_LAUNCHES, "triplane_sampler": 2 * n_batches,
                "ray_marcher": 2 * n_batches}
    if launches != expected:
        fail(f"[27] launched {launches}, expected {expected}")
    if len(traces) != 1 or not all(seen.values()):
        fail(f"[27] trace files {traces}, named {seen}")
    return launches


def phase_bf16_card_vs_cpu() -> dict:
    """[28] --bf16 on the card (kernels) against the CPU (plain versions),
    from the same seeded params: one frame, each beside the card's fp32
    frame; then one bf16 RGB training step's loss and gradients at full
    width, batch 1, in the L2 norm (LeakyReLU's kink and bf16 rounding move
    single entries): each group of parameters together and each tensor."""
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import rgb
    cfg32, cfg16 = heads.AvatarConfig(), bf16_config()
    image, label = reference_inputs(cfg32, 1)
    frames, secs = {}, {}
    for name, dev, cfg in (("card16", "cuda", cfg16), ("card32", "cuda", cfg32),
                           ("cpu16", "cpu", cfg16)):
        params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED),
                                       cfg, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            frames[name] = reenact(params, cfg, image.to(dev),
                                   label.to(dev)).cpu()
        secs[name] = time.perf_counter() - t0
        del params
    frame = {"card vs CPU": l2_rel(frames["card16"], frames["cpu16"]),
             "card bf16 vs card fp32": l2_rel(frames["card16"],
                                              frames["card32"]),
             "CPU bf16 vs card fp32": l2_rel(frames["cpu16"],
                                             frames["card32"])}
    print(f"[28] one --bf16 frame at full width, L2 over the reference's "
          f"norm: { {k: float(f'{v:.3e}') for k, v in frame.items()} } "
          f"(bounds {BF16_FRAME_L2:g} card vs CPU, {BF16_VS_FP32_L2:g} to "
          f"fp32); max abs card vs CPU "
          f"{(frames['card16'] - frames['cpu16']).abs().max().item():.3e}; "
          f"card {secs['card16']:.2f} s, CPU {secs['cpu16']:.2f} s",
          flush=True)
    if frames["card16"].dtype != torch.float32 \
            or frames["card16"].shape != (1, 512, 512, 3) \
            or not torch.isfinite(frames["card16"]).all():
        fail(f"[28] card bf16 frame {frames['card16'].dtype} "
             f"{tuple(frames['card16'].shape)}")
    if not frame["card vs CPU"] <= BF16_FRAME_L2:
        fail(f"[28] bf16 frame card vs CPU {frame['card vs CPU']}")
    for k in ("card bf16 vs card fp32", "CPU bf16 vs card fp32"):
        if not 1e-4 < frame[k] <= BF16_VS_FP32_L2:
            fail(f"[28] {k}: {frame[k]} (bf16 did not run, or too far)")

    out = {}
    for dev in ("cuda", "cpu"):
        cfg, state, lp, img, lab = train_setup(dev, 1, cfg16)
        t0 = time.perf_counter()
        loss, aux = rgb.loss_fn(state.params, lp, cfg, img, lab)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in state.params.named_parameters()
                 if p.grad is not None}
        out[dev] = (loss.item(), grads, time.perf_counter() - t0,
                    aux["generated"].dtype)
        del state, lp, loss, aux
    (l_gpu, g_gpu, t_gpu, dt_gpu), (l_cpu, g_cpu, t_cpu, _) = \
        out["cuda"], out["cpu"]
    if sorted(g_gpu) != sorted(g_cpu):
        fail("[28] card and CPU give gradients to different parameters")
    if not all(torch.isfinite(g).all() for g in g_gpu.values()):
        fail("[28] non-finite gradient on the card")
    tensors = {n: l2_rel(g_gpu[n], g_cpu[n]) for n in g_cpu
               if g_cpu[n].abs().max() > 0}
    groups = {}
    for top in ("encoder", "subspace", "generator"):
        names = [n for n in tensors if n.startswith(top + ".")]
        groups[top] = l2_rel(torch.cat([g_gpu[n].flatten() for n in names]),
                             torch.cat([g_cpu[n].flatten() for n in names]))
    worst = sorted(tensors, key=tensors.get)[-3:][::-1]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    print(f"[28] one --bf16 training step at full width, batch 1, card vs "
          f"CPU: loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.3e}, bound "
          f"{BF16_LOSS_RTOL:g}); image {dt_gpu}; gradients by group in the L2 "
          f"norm { {k: float(f'{v:.3e}') for k, v in groups.items()} } (bound "
          f"{BF16_GROUP_L2:g}); {len(tensors)} tensors, median "
          f"{float(np.median(list(tensors.values()))):.3e}, worst "
          f"{[(n, float(f'{tensors[n]:.3e}')) for n in worst]} (bound "
          f"{BF16_TENSOR_L2:g}); card {t_gpu:.2f} s, CPU {t_cpu:.2f} s",
          flush=True)
    if dt_gpu != torch.float32:
        fail(f"[28] the bf16 step's image is {dt_gpu}, not fp32")
    if not loss_rel <= BF16_LOSS_RTOL:
        fail(f"[28] bf16 loss card {l_gpu} vs CPU {l_cpu}")
    if not max(groups.values()) <= BF16_GROUP_L2 \
            or not tensors[worst[0]] <= BF16_TENSOR_L2:
        fail(f"[28] bf16 gradients card vs CPU: {groups}, worst "
             f"{worst[0]} {tensors[worst[0]]}")
    return {"frame": frame, "loss_rel": loss_rel, "groups": groups,
            "worst_tensor": tensors[worst[0]]}


def phase_remat_ray_chunk(fp32_step: dict) -> dict:
    """[29] one RGB step under remat at batch 2 against the plain step
    (fp32, same seeded state and batch): the same loss, gradients within
    the sampler backward's atomics, the sampler four times, and the peak
    memory of each; then one reenactment batch of 2 under ray_chunk 4096
    on the card against the port's CPU chunked render, 4 chunks a pass."""
    from hfa_gp_tpu_torch.cli.run_recon_video_rgb import reenact
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train import rgb
    out = {}
    for remat in (False, True):
        cfg = with_render(heads.AvatarConfig(), remat=remat)
        cfg, state, lp, image, label = train_setup("cuda", 2, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        loss, _ = rgb.loss_fn(state.params, lp, cfg, image, label)
        loss.backward()
        torch.cuda.synchronize()
        out[remat] = (loss.item(), {n: p.grad.clone() for n, p in
                                    state.params.named_parameters()
                                    if p.grad is not None},
                      torch.cuda.max_memory_allocated() / 2**30,
                      read_launches())
        del state, lp, loss
    (l0, g0, gib0, _), (l1, g1, gib1, launches) = out[False], out[True]
    rels = {n: rel_err(g1[n], g0[n])[1] for n in g0 if g0[n].abs().max() > 0}
    worst = max(rels, key=rels.get)
    print(f"[29] one RGB step under remat, batch 2, fp32: loss {l1:.6f} vs "
          f"{l0:.6f} plain; {len(rels)} gradients, worst {worst} "
          f"{rels[worst]:.3e} of its scale (bound {REMAT_GRAD_RTOL:g}); "
          f"launches {launches}; peak device memory {gib1:.3f} GiB remat, "
          f"{gib0:.3f} GiB plain (loss and backward only; [9]'s step "
          f"{fp32_step['gib']:.3f})", flush=True)
    if sorted(g1) != sorted(g0) or not abs(l1 - l0) <= 1e-6 * abs(l0) \
            or not rels[worst] <= REMAT_GRAD_RTOL:
        fail(f"[29] remat step: loss {l1} vs {l0}, worst gradient {worst} "
             f"{rels[worst]}")
    remat_expected = {**NO_LAUNCHES, "triplane_sampler": 4,
                      "triplane_sampler_bwd": 2, "ray_marcher": 2,
                      "ray_marcher_bwd": 1}
    if launches != remat_expected:
        fail(f"[29] remat step launched {launches}, expected "
             f"{remat_expected}")

    cfg = with_render(heads.AvatarConfig(), ray_chunk=RAY_CHUNK)
    image, label = reference_inputs(cfg, 2)
    frames, secs = {}, {}
    for dev in ("cuda", "cpu"):
        params = heads.init_avatar_rgb(torch.Generator().manual_seed(SEED),
                                       cfg, dev)
        reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            frames[dev] = reenact(params, cfg, image.to(dev),
                                  label.to(dev)).cpu()
        secs[dev] = time.perf_counter() - t0
        if dev == "cuda":
            chunk_launches = read_launches()
            with torch.inference_mode():
                whole = reenact(params, heads.AvatarConfig(), image.cuda(),
                                label.cuda()).cpu()
        del params
    n_chunks = cfg.eg3d.render.neural_rendering_resolution ** 2 // RAY_CHUNK
    scale = max(1.0, frames["cpu"].abs().max().item())
    err = (frames["cuda"] - frames["cpu"]).abs().max().item()
    err_whole = (frames["cuda"] - whole).abs().max().item()
    print(f"[29] reenactment batch of 2 under ray_chunk {RAY_CHUNK} "
          f"({n_chunks} chunks a pass): card vs CPU max abs diff {err:.3e} "
          f"(bound {E2E_RTOL:g} x max(1, scale {scale:.3e})), against the "
          f"card's unchunked batch {err_whole:.3e}; launches "
          f"{chunk_launches}; card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s", flush=True)
    if not torch.isfinite(frames["cuda"]).all() or not err <= E2E_RTOL * scale:
        fail(f"[29] ray_chunk batch card vs CPU: {err}")
    chunk_expected = {**NO_LAUNCHES, "triplane_sampler": 2 * n_chunks,
                      "ray_marcher": 2 * n_chunks}
    if chunk_launches != chunk_expected:
        fail(f"[29] ray_chunk batch launched {chunk_launches}, expected "
             f"{chunk_expected}")
    return {"remat_launches": launches, "chunk_launches": chunk_launches,
            "remat_gib": gib1, "plain_gib": gib0}


def write_pivots(emb_dir: str, n_ws: int = 18, dim: int = 512) -> None:
    """Two PTI pivots of seeded W+ rows: a/0.npy (n_ws, dim) and a
    PyTorch-saved b/0.pt (1, n_ws, dim)."""
    rng = np.random.default_rng(SEED + 6)
    for name in ("a", "b"):
        os.makedirs(os.path.join(emb_dir, name))
    np.save(os.path.join(emb_dir, "a", "0.npy"),
            rng.standard_normal((n_ws, dim)).astype(np.float32))
    torch.save(torch.from_numpy(rng.standard_normal((1, n_ws, dim))
                                .astype(np.float32)),
               os.path.join(emb_dir, "b", "0.pt"))


def phase_person_2_bf16(tmp: str) -> None:
    """[30] train_rgb.main --bf16 --person_2 --init --run_id_2 at full
    width, batch 2, 2 steps on PTI pivots (.npy and .pt): person 2's bases
    start as load_pti_bases gives them and stay so while person 1's move,
    the checkpoint holds them, and run_recon_video_rgb --bf16 --model_path
    reads it; then train_3dmm.main and train_audio.main --bf16, 2 steps
    each, with [14]/[15]'s launches a step."""
    from hfa_gp_tpu_torch.cli import (run_recon_video_rgb, train_3dmm,
                                      train_audio, train_rgb)
    from hfa_gp_tpu_torch.models.avatar import heads, subspace
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    steps, batch = 2, 2
    write_dataset(tmp, 6, split="train")
    write_dataset(tmp, 4, split="test2")
    emb = os.path.join(tmp, "emb")
    write_pivots(os.path.join(emb, "r", "PTI"))
    exp = os.path.join(tmp, "exps")
    common_flags = ["--dataset_root", tmp, "--person", "person_3", "--size",
                    "256", "--batch_size", str(batch), "--exp_path", exp,
                    "--tune_iter", "0", "--device", "cuda", "--iter",
                    str(steps), "--display_freq", "100", "--save_freq",
                    str(steps), "--bf16"]
    per_step = {**NO_LAUNCHES, "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    reset_launches()
    t0 = time.perf_counter()
    train_rgb.main(train_rgb.build_argparser().parse_args(
        common_flags + ["--exp_name", "p2", "--person_2", "p", "--init",
                        "--run_id_2", "r", "--emb_dir", emb]))
    launches = read_launches()
    seconds = time.perf_counter() - t0
    shown = train_losses("--person_2 --bf16 training",
                         os.path.join(exp, "p2"), steps)
    path = os.path.join(exp, "p2", "checkpoint", f"{steps - 1:06d}")
    got = ckpt.load_params(path)
    cfg = heads.AvatarConfig()
    want = subspace.load_pti_bases(os.path.join(emb, "r", "PTI"),
                                   cfg.dim_shape, cfg.eg3d.num_ws, cfg.dim)
    init = heads.init_avatar_rgb(torch.Generator().manual_seed(
        train_rgb.SEED), cfg)
    moved_2 = (got["subspace_2"]["bases"] - want).abs().max().item()
    moved_1 = (got["subspace"]["bases"]
               - init["subspace"]["bases"]).abs().max().item()
    print(f"[30] train_rgb --bf16 --person_2 --init --run_id_2: {steps} steps "
          f"at batch {batch} in {seconds:.2f} s, (l2, lpips) {shown}, "
          f"launches {launches}; subspace_2 in the checkpoint "
          f"{'subspace_2' in got}, its bases' max abs change from "
          f"load_pti_bases {moved_2:.3e}, subspace's {moved_1:.3e}",
          flush=True)
    if launches != per_step:
        fail(f"[30] train_rgb launched {launches}, expected {per_step}")
    if "subspace_2" not in got or moved_2 != 0.0 or not moved_1 > 0.0:
        fail(f"[30] subspace_2: changed {moved_2}, subspace {moved_1}")
    demo = os.path.join(tmp, "demo_p2")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser().parse_args(
        ["--dataset_root", tmp, "--person", "person_3", "--size", "256",
         "--render_batch", "4", "--demo_dir", demo, "--demo_name", "p2",
         "--fps", "4", "--device", "cuda", "--bf16", "--model_path", path]))
    check_pngs("--bf16 reenactment from the person_2 checkpoint",
               os.path.join(demo, "p2", "*.png"), 4)

    write_expressions(tmp, 6, "train")
    write_expressions(tmp, 4, "test")
    write_audio_dataset(tmp)
    for name, cli, extra in (
            ("3DMM", train_3dmm, ["--exp_name", "b3dmm"]),
            ("audio", train_audio, ["--exp_name", "baudio", "--dataset",
                                    "ad_dataset", "--person", "obama",
                                    "--nosmo_iters", "1"])):
        reset_launches()
        t0 = time.perf_counter()
        cli.main(cli.build_argparser().parse_args(common_flags + extra))
        launches = read_launches()
        shown = train_losses(f"{name} --bf16 training",
                             os.path.join(exp, extra[1]), steps)
        print(f"[30] train_{name.lower()} --bf16: {steps} steps in "
              f"{time.perf_counter() - t0:.2f} s, (l2, lpips) {shown}, "
              f"launches {launches}", flush=True)
        if launches != per_step:
            fail(f"[30] {name} --bf16 launched {launches}, expected "
                 f"{per_step}")



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
    fp32_reenact = phase_throughput()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_train_path(tmp)
    phase_step_card_vs_cpu()
    fp32_step = phase_train_throughput()
    with tempfile.TemporaryDirectory() as tmp:
        arcface_launches = phase_arcface_path(tmp)
    phase_arcface_card_vs_cpu()
    phase_arcface_throughput()
    probe_launches = phase_probe_path()
    with tempfile.TemporaryDirectory() as tmp:
        t3dmm_launches = phase_3dmm_path(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        audio_launches = phase_audio_path(tmp)
    phase_audio_step_card_vs_cpu()
    phase_3dmm_audio_throughput()
    phase_detector()
    phase_facerecon()
    with tempfile.TemporaryDirectory() as tmp:
        phase_process_video(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_extract_audio(tmp)
    families = {tag: phase_arcface_family(tag) for tag in ARC_FAMILIES}
    phase_bf16_step_card_vs_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        phase_val_bin_export(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_eval_ijb(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        bf16_launches = phase_bf16_main_path(tmp)
    phase_bf16_card_vs_cpu()
    bf16_reenact = phase_throughput(bf16_config(), "[29]")
    bf16_step = phase_train_throughput(bf16_config(), "[29]")
    print(f"[29] bf16 over fp32 ([6], [9]): reenactment "
          f"{bf16_reenact['fps']:.3f} / {fp32_reenact['fps']:.3f} frames/s = "
          f"{bf16_reenact['fps'] / fp32_reenact['fps']:.3f}x, peak "
          f"{bf16_reenact['gib']:.3f} / {fp32_reenact['gib']:.3f} GiB; RGB "
          f"step {bf16_step['steps_per_s']:.3f} / "
          f"{fp32_step['steps_per_s']:.3f} steps/s = "
          f"{bf16_step['steps_per_s'] / fp32_step['steps_per_s']:.3f}x, "
          f"peak {bf16_step['gib']:.3f} / {fp32_step['gib']:.3f} GiB",
          flush=True)
    flags = phase_remat_ray_chunk(fp32_step)
    with tempfile.TemporaryDirectory() as tmp:
        phase_person_2_bf16(tmp)

    # launches, each from the run of the path that owns the kernel: the
    # RGB training path's first run (4 steps and one display; the
    # reenactment path's count beside it), the arcface path's dense run
    # (6 steps), the probe's entry point
    for k in kernels:
        if k["name"].endswith("_bf16"):
            # the JAX CLI's default command, [24]
            k["launches"] = families[24]["launches"][k["name"][:-5]]
        elif k["name"].startswith("flash_ce"):
            k["launches"] = arcface_launches[k["name"]]
        elif k["name"] == "triplane_probe":
            k["launches"] = probe_launches[k["name"]]
        else:
            k["launches"] = train_launches[k["name"]]
            k["launches_reenact"] = reenact_launches[k["name"]]
            k["launches_3dmm"] = t3dmm_launches[k["name"]]
            k["launches_audio"] = audio_launches[k["name"]]
            k["launches_bf16_reenact"] = bf16_launches[k["name"]]
            k["launches_remat_step"] = flags["remat_launches"][k["name"]]
            k["launches_ray_chunk_reenact"] = \
                flags["chunk_launches"][k["name"]]
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
