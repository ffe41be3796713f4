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
     off-plane points); the marcher at N 96 and 48; its backward against
     autograd of the plain march at N 96 and 48 under the cotangents of
     rgb alone, of all three outputs and of none, and on its other routes
     (C 3, 48, 130, N 1025, and N 2000 with its scratch buffer); the
     flash-CE kernels also at a batch above one group of rows with ragged
     class and depth counts, d w bit for bit across two launches, and with
     bf16 operands (the JAX CLI's default, on the tensor cores) at the
     main path's shape, se_x, tgt_raw and d w bit for
     bit across two launches, timed against a bound whose products run at
     the bf16 rate beside the bf16 `torch.matmul` of the bare product, and
     on their general paths (B 300 d 128, B 384 d 510, d 72, and d 700,
     whose backward takes the CUDA-core route);
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
 13. the sampler probe through its entry point, `hfa_gp_tpu_torch.
     tools.probe_sampler.main`: the full variant equal to the sampler bit
     for bit, and a time per variant;
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
 31. the ways in, with no JAX on the machine: reference-format sources at
     full width, written from seeded trees by the inverse of each map (an
     EG3D G_ema pickle of `torch_utils.persistence` modules; RGB (with
     `subspace_2`), 3DMM and audio avatar .pt checkpoints; LPIPS,
     facenet-pytorch and Sandberg MTCNN, Deep3DFaceRecon and DeepSpeech
     sources), each converted by `python -m hfa_gp_tpu_torch.tools.
     convert_*` in a process of its own (seconds, peak host memory, npz
     size), every npz equal to its source tree bit for bit and loadable
     by its module; then a batch of 8 through `run_recon_video_rgb`,
     `_3dmm` and `_audio --smooth` with `--model_npz`, each within 1e-6 of
     the same params rendered directly, K1 and K4 twice a batch;
 32. `train_arcface.main --rec` (iresnet50, fp32, 1,000,000 classes,
     batch 256, 6 steps) on 2,048 seeded-noise JPEG records, through an
     ArrayRecord file where `array_record` imports, else the same dataset
     and stream over an in-memory reader (it says which): the batches on
     the card equal to the CPU decode bit for bit, K5 and K6 once a step,
     finite losses, samples/s beside [10]'s and [12]'s synthetic figures;
 33. (retired: the native image loader's line moved to 39, now that the
     loader is ported);
 34. the port against the reference's golden seams (`tests/golden/
     seams.npz`, `hfa_gp_tpu_torch.tools.check_golden`) on the card:
     `ray_march` through the marcher kernel, `sample_pdf`,
     `bilinear_resize` and `block_apply` (up=True), each within
     `tests/test_golden.py`'s tolerance;
 35. several processes on the one card (each multi-rank run is this script
     started as ranks of its own, `--rank_worker`, through the CLIs' entry
     points, over gloo): each rank's backend and device, which collectives
     gloo runs on CUDA tensors (all-reduce, all-gather into one tensor and
     broadcast, which the port uses, must run), one rank's all-reduce of 175 MB
     (iresnet50's gradient) from device and from host memory, and one
     attempt at NCCL with two ranks on the card, whose refusal is printed
     and is no failure;
 36. `train_arcface.main` on 2 x 2 ranks (n_model 2): iresnet50 fp32,
     1,000,000 classes dense, global batch 256, 3 steps with checkpoints:
     losses and the table's sum of |w| against two one-rank runs of the
     same command, within 10 times their own spread (at least 1e-5), and
     what the steps moved the class rows that the labels touch by, read
     from the 2 x 2 run's final checkpoint (at least 1e-3); the ranks'
     labels make the one rank's batch; one K5 and one K6 launch a step on
     each rank, on its 500,000-row shard; the same backbone bits on every
     rank; the primary's files only; then one rank resumes the step-2
     checkpoint and its step 3 continues the 2 x 2 run, touched rows too;
     samples/s and each rank's peak memory;
 37. `train_rgb.main` on 2 ranks at full width, global batch 2, 2 steps:
     disjoint rows that make up the one-rank batch, losses and what the
     steps moved the params by against two one-rank runs (within 10 times
     their spread, at least 1e-5 and 1e-2), each rank's launches equal to
     one rank's, the primary's files only; then `run_recon_video_rgb.main`
     on 2 ranks at batch 8, frames within one level of one rank's, written
     by the primary alone;
 38. the same two commands with `--n_model 2` on 2 ranks (ray sharding:
     the ranks split each image's rays), on 37's dataset, against one rank
     with the same placement of the fine samples (the global quantiles,
     which the CLIs pick under a model axis): losses and what the steps
     moved the params by under 37's rule, the two ranks' params equal bit
     for bit, each rank's launches equal to one rank's with every launch
     of K1, K2, K4 and K4' on half the rays (the (batch, rays) of each
     printed), frames within one level, the primary's files only;
     steps/s and frames/s beside one rank's with the card's name and power
     limit (two ranks that share one card give no scaling figure);
 39. the native image loader (`hfa_gp_tpu_torch/data/native_loader.py`,
     built with g++ from `csrc/hfaio.cpp`) where the compiler finds
     libpng's and libjpeg's headers: PIL-written PNGs and a JPEG decoded
     at 64², against PIL's decode and the same resize, and a loader of 2
     workers; elsewhere one line naming what is missing.

Before the summary it prints, for each kernel, launches x (ms - bound) per
reenactment batch, RGB step and arcface step (a bf16 one for the bf16
entries, whose launches are [24]'s). The line before the last is a
JSON summary of the kernels; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits non-zero, with no result line, when CUDA is unavailable or when
it is run outside a checkout; a rank of [35]-[38] that fails fails the
script. It imports nothing of JAX, of the JAX
package `hfa_gp_tpu` or of the repository's root `tools`, and checks that
before the result line.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import json
import logging
import os
import re
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


def card_peak(key: str) -> float:
    """The card's published peak `key` (`benchmark/peaks.json`): the
    device memory rate, fp32 outside the tensor cores, and dense bf16 on
    them (the rate a product of bf16 operands could run at)."""
    from benchmark.metrics import peak as published
    value = published(key)
    if value is None:
        fail(f"benchmark/peaks.json holds no {key} for "
             f"{torch.cuda.get_device_name(0)}")
    return value


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
    t_bytes = n_bytes / card_peak("hbm_bytes_per_s") * 1e3
    t_flops = (n_flops / card_peak("fp32_flops")
               + n_flops_bf16 / card_peak("bf16_flops")) * 1e3
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


def osg_decoder(dev, g, c: int = 32) -> dict:
    """An OSG decoder as EG3D initialises it (unit normal weights), with
    non-zero biases so that their gains are checked too."""
    return {"fc0": {"weight": torch.randn(64, c, generator=g).to(dev),
                    "bias": (0.3 * torch.randn(64, generator=g)).to(dev)},
            "fc1": {"weight": torch.randn(33, 64, generator=g).to(dev),
                    "bias": (0.3 * torch.randn(33, generator=g)).to(dev)}}


# the fused kernel against K1 + the decoder's PyTorch ops, whose features
# are K1's to the bit: only the decoder's sums run in another order
DECODER_RTOL = 1e-5


def phase_kernels_sampler_decoder(dev, g) -> dict:
    """The sampler with the OSG decoder fused (`triplane.sample_decode`)
    at the main path's points, batch 8 and 1: against its plain version
    (`sample_decode_plain`) and the unfused route (K1, then
    `decode_plain`), its time beside its bound (the larger of the bytes in
    and out at the HBM rate and the decoder's 8,320 FLOP a point at the
    fp32 peak), the plain version's and the unfused route's; then C 8 and
    30, which the kernel refuses and the renderer leaves to K1."""
    from hfa_gp_tpu_torch.core.kernels import triplane
    from hfa_gp_tpu_torch.models.eg3d import renderer
    dec = osg_decoder(dev, g)
    entry = {}
    for batch in (8, 1):
        planes = torch.randn((batch, 3, 256, 256, 32), generator=g).to(dev)
        pts = main_path_points(dev, batch)
        with torch.inference_mode():
            got = triplane.sample_decode(planes, pts, 1.0, dec, 1.0)
            unfused = triplane.decode_plain(
                dec, 1.0, triplane.sample_mean(planes, pts, 1.0))
            plain = triplane.sample_decode_plain(planes, pts, 1.0, dec, 1.0)
            torch.cuda.synchronize()
            err = max(rel_err(x, y)[1] for x, y in zip(got, unfused))
            err_plain = max(rel_err(x, y)[1] for x, y in zip(got, plain))
            del unfused, plain
            ms = cuda_time_ms(lambda: triplane.sample_decode(
                planes, pts, 1.0, dec, 1.0))
            plain_ms = cuda_time_ms(lambda: triplane.sample_decode_plain(
                planes, pts, 1.0, dec, 1.0))
            unfused_ms = cuda_time_ms(lambda: triplane.decode_plain(
                dec, 1.0, triplane.sample_mean(planes, pts, 1.0)))
        n_points = pts.shape[0] * pts.shape[1]
        n_bytes, n_flops = nbytes(planes, pts, *got), n_points * 8320
        if not (err <= DECODER_RTOL and err_plain <= SAMPLER_ATOL):
            fail(f"the fused sampler + decoder at batch {batch}: {err} of "
                 f"the outputs' scale from the unfused route, {err_plain} "
                 f"from its plain version")
        if batch == 8:
            entry = kernel_entry(
                "triplane_sampler_decoder",
                "hfa_gp_tpu_torch/csrc/triplane.cu",
                "none (the JAX renderer's decoder_apply after the sampler, "
                "hfa_gp_tpu/models/eg3d/renderer.py:287)", err, ms, plain_ms,
                None, n_bytes, n_flops)
            entry.update({"max_err_vs_plain": err_plain,
                          "unfused_ms": unfused_ms})
        else:
            bd = bound(n_bytes, n_flops)
            entry.update({"ms_batch1": ms, "plain_ms_batch1": plain_ms,
                          "unfused_ms_batch1": unfused_ms,
                          "bound_ms_batch1": bd["bound_ms"]})
        print(f"[3] sampler + decoder fused at batch {batch}: kernel "
              f"{ms:.4f} ms, K1 + decoder ops {unfused_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound "
              f"{bound(n_bytes, n_flops)['bound_ms']:.4f} ms "
              f"({n_bytes / 1e9:.3f} GB, {n_flops / 1e9:.2f} GFLOP); "
              f"{err:.3e} of the outputs' scale from the unfused route, "
              f"{err_plain:.3e} from the plain version", flush=True)
        del planes, pts, got
    cfg = renderer.RenderConfig()
    for c in (8, 30):
        planes = torch.randn((1, 3, 32, 32, c), generator=g).to(dev)
        pts = (torch.rand((1, 4096, 3), generator=g) - 0.5).to(dev)
        dec_c = osg_decoder(dev, g, c)
        with torch.inference_mode():
            if renderer.decoder_fused(cfg, planes, pts, dec_c, False):
                fail(f"the fused route engages at C {c}")
            try:
                triplane.sample_decode(planes, pts, 1.0, dec_c, 1.0)
            except ValueError:
                continue
        fail(f"the fused kernel took C {c}")
    print("    at C 8 and 30 the fused kernel refuses and the route stays "
          "on K1", flush=True)
    return entry


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
    times."""
    from hfa_gp_tpu_torch.core.kernels import triplane
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


# what each of 2 ranks of a model axis renders: half of the 128 x 128 rays,
# 64 whole rows, so K2 gets the layout (64, 128, 48)
SHARD_RAYS = MAIN_LAYOUT[0] * MAIN_LAYOUT[1] // 2
SHARD_LAYOUT = (MAIN_LAYOUT[0] // 2, *MAIN_LAYOUT[1:])


def phase_kernels_ray_shard(dev, g, entries: dict) -> None:
    """K1, K2, K4 and K4′ at the shapes each rank of [38] gives them: the
    points of each half of the image's rows at batch 2 and 8 (K2 with the
    half's layout, without it, and the two halves' gradients summed
    against the whole image's), the marcher on (B, 8,192) rays at N 96 and
    48 with the depth clipped to a range wider than its own (the range of
    every rank's depths), and its backward at batch 2. Times at batch 2
    go into `entries` as *_ray_shard."""
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    h, w, n = MAIN_LAYOUT
    half = SHARD_RAYS * n
    err1, rel2 = 0.0, 0.0
    for b in (2, 8):
        shape = (b, 3, 256, 256, 32)
        planes = torch.randn(shape, generator=g).to(dev)
        whole = main_path_points(dev, b)
        cot = torch.randn((b, whole.shape[1], 32), generator=g).to(dev)
        summed = torch.zeros(shape, device=dev)
        for k in range(2):
            pts = whole[:, k * half:(k + 1) * half].contiguous()
            ct = cot[:, k * half:(k + 1) * half].contiguous()
            err1 = max(err1, (triplane.sample_mean(planes, pts, 1.0)
                              - triplane.sample_mean_plain(planes, pts, 1.0))
                       .abs().max().item())
            want = triplane.sample_mean_backward_plain(ct, shape, pts, 1.0)
            for layout in (SHARD_LAYOUT, None):
                got = triplane.sample_mean_backward(ct, shape, pts, 1.0,
                                                    layout)
                rel2 = max(rel2, rel_err(got, want)[1])
            summed += got
            del want, got
        rel2 = max(rel2, rel_err(summed, triplane.sample_mean_backward_plain(
            cot, shape, whole, 1.0))[1])
        torch.cuda.synchronize()
        if b == 2:
            # rank 1's share: rows [64, 128)
            ct = cot[:, half:].contiguous()
            timed = {
                "triplane_sampler": (
                    lambda: triplane.sample_mean(planes, pts, 1.0),
                    lambda: triplane.sample_mean_plain(planes, pts, 1.0),
                    nbytes(planes, pts) + 4 * b * half * 32, pts),
                "triplane_sampler_bwd": (
                    lambda: triplane.sample_mean_backward(
                        ct, shape, pts, 1.0, SHARD_LAYOUT),
                    lambda: triplane.sample_mean_backward_plain(
                        ct, shape, pts, 1.0),
                    nbytes(ct, pts) + 4 * int(np.prod(shape)), pts)}
            for name, (fn, plain, n_bytes, p) in timed.items():
                c = shape[-1]
                bd = bound(n_bytes, in_bounds_corners(p, 256, 256) * 2 * c
                           + p.shape[0] * p.shape[1] * (c + 60))
                entries[name].update({
                    "ms_ray_shard": cuda_time_ms(fn),
                    "plain_ms_ray_shard": cuda_time_ms(plain, iters=5),
                    "bound_ms_ray_shard": bd["bound_ms"]})
            entries["triplane_sampler_bwd"]["ms_ray_shard_no_layout"] = \
                cuda_time_ms(lambda: triplane.sample_mean_backward(
                    ct, shape, pts, 1.0))
        del planes, whole, cot, summed, pts, ct
    print(f"[3] sampler kernels at each rank's share under ray sharding "
          f"(rows [0, {h // 2}) and [{h // 2}, {h}) of the {h} x {w} rays, "
          f"batch 2 and 8): "
          f"forward max abs err {err1:.3e} (bound {SAMPLER_ATOL:g}); "
          f"backward with the layout {SHARD_LAYOUT} and without, and the "
          f"two halves summed against the whole image, {rel2:.3e} of the "
          f"gradient's scale (bound {BWD_RTOL:g})", flush=True)
    if not err1 <= SAMPLER_ATOL or not rel2 <= BWD_RTOL:
        fail(f"sampler kernels at the ray-sharded shapes: forward {err1}, "
             f"backward {rel2}")

    err4 = 0.0
    for b, nn in ((2, 96), (2, 48), (8, 96), (8, 48)):
        colors, dens, depths = march_inputs(dev, g, b, SHARD_RAYS, nn, 32)
        lo, hi = torch.aminmax(depths)
        rng = (lo - 0.5, hi + 0.5)
        got = raymarch.ray_march(colors, dens, depths, depth_range=rng)
        want = raymarch.ray_march_plain(colors, dens, depths,
                                        depth_range=rng)
        torch.cuda.synchronize()
        for name, x, y in zip(("rgb", "depth", "weights"), got, want):
            e = (x - y).abs()
            err4 = max(err4, e.max().item())
            if not bool((e <= MARCH_ATOL + MARCH_RTOL * y.abs()).all()):
                fail(f"marcher kernel disagrees with its plain version on "
                     f"{name} at (B, rays, N) {(b, SHARD_RAYS, nn)} with a "
                     f"depth range: max abs err {e.max().item()}")
        if (b, nn) == (2, 96):
            ent = entries["ray_marcher"]
            ent.update({
                "ms_ray_shard": cuda_time_ms(lambda: raymarch.ray_march(
                    colors, dens, depths, depth_range=rng)),
                "plain_ms_ray_shard": cuda_time_ms(
                    lambda: raymarch.ray_march_plain(
                        colors, dens, depths, depth_range=rng)),
                "bound_ms_ray_shard": bound(
                    nbytes(colors, dens, depths, *got),
                    b * SHARD_RAYS * (nn - 1) * (4 * 32 + 25))["bound_ms"]})
            with torch.no_grad():
                outs = raymarch.ray_march_plain(colors, dens, depths)
            err4b, rel4b, cots = marcher_bwd_check(
                dev, g, (colors, dens, depths), outs,
                f"(2, {SHARD_RAYS}, 96)")
            ct = cots["rgb"]
            ent = entries["ray_marcher_bwd"]
            ent.update({
                "ms_ray_shard_rgb_only": cuda_time_ms(
                    lambda: raymarch.ray_march_backward(colors, dens,
                                                        depths, *ct)),
                "plain_ms_ray_shard_rgb_only": cuda_time_ms(
                    lambda: raymarch.ray_march_backward_plain(
                        colors, dens, depths, *ct)),
                "bound_ms_ray_shard_rgb_only": bound(
                    nbytes(colors, dens, depths, ct[0], colors, dens),
                    0)["bound_ms"]})
            del outs, cots, ct
        del colors, dens, depths, got, want
    print(f"[3] marcher kernel at each rank's share (B 2 and 8, "
          f"{SHARD_RAYS} rays, N 96 and 48, the depth clipped to a wider "
          f"range): max abs err {err4:.3e} (bound rtol {MARCH_RTOL:g} atol "
          f"{MARCH_ATOL:g}); its backward at (2, {SHARD_RAYS}, 96, 32), "
          f"cotangents of rgb / all three / none: max abs err {err4b:.3e}, "
          f"{rel4b:.3e} of the gradient's scale (bound {BWD_RTOL:g})",
          flush=True)
    print("    at rank 1's share, batch 2 (ms): "
          + "; ".join(f"{k} kernel {e['ms_ray_shard' + suf]:.4f}, plain "
                      f"{e['plain_ms_ray_shard' + suf]:.4f}, bound "
                      f"{e['bound_ms_ray_shard' + suf]:.4f}"
                      for k, e, suf in (
                          ("K1", entries["triplane_sampler"], ""),
                          ("K2", entries["triplane_sampler_bwd"], ""),
                          ("K4", entries["ray_marcher"], ""),
                          ("K4' (rgb's cotangent)",
                           entries["ray_marcher_bwd"], "_rgb_only")))
          + "; K2 without the layout "
          f"{entries['triplane_sampler_bwd']['ms_ray_shard_no_layout']:.4f}",
          flush=True)
    torch.cuda.empty_cache()


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

    # -- the sampler with the decoder fused, at the cells' batches
    results.append(phase_kernels_sampler_decoder(dev, g))

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
    phase_kernels_ray_shard(dev, g, {e["name"]: e for e in results})
    results += phase_kernels_flash_ce(dev, g)
    results.append(phase_kernels_probe(dev))
    results.append(phase_kernels_fir(dev))
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
    se2, tgt2 = flash_ce.flash_ce_stats(ne, w, lab, s, bf)
    torch.cuda.synchronize()
    se_rel = ((se - se_p).abs() / se_p.abs().clamp_min(1e-30)).max().item()
    tgt_err = (tgt - tgt_p).abs().max().item()
    got = flash_ce.flash_ce_stats_backward(ne, w, lab, s, bf, ct_se, ct_tgt)
    want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, s, bf, ct_se,
                                                  ct_tgt)
    again = flash_ce.flash_ce_stats_backward(ne, w, lab, s, bf, ct_se, ct_tgt)
    torch.cuda.synchronize()
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    rel = max(r for _, r in errs)
    repeat = torch.equal(se, se2) and torch.equal(tgt, tgt2) \
        and torch.equal(got[1], again[1])
    print(f"[3] flash-CE kernels vs plain with bf16 operands, B {b}, d {d}, "
          f"C {c}: se_x max rel err {se_rel:.3e} (bound {CE_SE_RTOL:g}), "
          f"tgt_raw {tgt_err:.3e} (bound {CE_TGT_ATOL:g}); d norm_emb "
          f"{errs[0][1]:.3e}, d w {errs[1][1]:.3e} of the gradient's scale "
          f"(bound {CE_BF16_BWD_RTOL:g}); two launches each: se_x, tgt_raw "
          f"and d w equal bit for bit: {repeat}, d norm_emb "
          f"{rel_err(again[0], got[0])[1]:.3e} of its scale apart (atomics)",
          flush=True)
    if not se_rel <= CE_SE_RTOL or not tgt_err <= CE_TGT_ATOL \
            or not rel <= CE_BF16_BWD_RTOL:
        fail(f"flash-CE kernels with bf16 operands at C {c}: se_x {se_rel}, "
             f"tgt_raw {tgt_err}, gradients {rel}")
    if not repeat:
        fail(f"flash-CE kernels with bf16 operands at C {c}: se_x, tgt_raw "
             f"or d w differ between two launches")
    del se2, tgt2, again
    ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats(ne, w, lab, s, bf))
    plain_ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_plain(
        ne, w, lab, s, bf))
    # no single PyTorch call computes the statistics; for the record, the
    # bare (B, d) x (d, C) product of the operands cast to bf16 beforehand
    ne_bf, w_bf_t = ne.to(bf), w.to(bf).T
    matmul_ms = cuda_time_ms(lambda: torch.matmul(ne_bf, w_bf_t))
    del ne_bf, w_bf_t
    print(f"    torch.matmul of the bare ({b}, {d}) x ({d}, {c}) product in "
          f"bf16: {matmul_ms:.4f} ms", flush=True)
    out = {"fwd_bf16": kernel_entry(
        "flash_ce_fwd_bf16", "hfa_gp_tpu_torch/csrc/flash_ce_bf16.cu",
        "hfa_gp_tpu/parallel/pallas_ce.py:78", tgt_err, ms, plain_ms, None,
        nbytes(ne, w, lab, se, tgt), 2.0 * c * d + 7.0 * b * c,
        2.0 * b * d * c)}
    out["fwd_bf16"]["max_rel_err_se_x"] = se_rel
    ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_backward(
        ne, w, lab, s, bf, ct_se, ct_tgt))
    plain_ms = cuda_time_ms(lambda: flash_ce.flash_ce_stats_backward_plain(
        ne, w, lab, s, bf, ct_se, ct_tgt))
    out["bwd_bf16"] = kernel_entry(
        "flash_ce_bwd_bf16", "hfa_gp_tpu_torch/csrc/flash_ce_bwd_bf16.cu",
        "hfa_gp_tpu/parallel/pallas_ce.py:108", max(e for e, _ in errs), ms,
        plain_ms, None, nbytes(ne, w, lab, ct_se, ct_tgt, *got),
        5.0 * c * d + 14.0 * b * c, 6.0 * b * d * c)
    out["bwd_bf16"]["max_err_over_scale"] = rel
    for e in out.values():
        e["operands"] = "bf16"
        e["matmul_ms"] = matmul_ms
    return out


def phase_flash_ce_general_paths(dev: torch.device, g) -> None:
    """K5 and K6 where the fast path does not reach: more batch rows than a
    block holds at once (384 > 256), a ragged last class tile, a depth that
    is no multiple of 4 (scalar copies) and one that is no multiple of the
    slice depth; with bf16 operands the same, a depth that is no multiple
    of 16 (the tensor cores' step, zero-filled) and one above 512, whose
    backward takes the CUDA-core route. se_x, tgt_raw and d w equal bit for
    bit in two launches."""
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    s, bf = 64.0, torch.bfloat16
    for b, d, c, mm in ((384, 512, 300_001, None), (384, 510, 30_001, None),
                        (8, 72, 1_000, None), (300, 128, 10_007, bf),
                        (384, 510, 30_001, bf), (8, 72, 1_000, bf),
                        (40, 700, 501, bf)):
        ne, w, lab = ce_inputs(dev, g, b, d, c)
        se, tgt = flash_ce.flash_ce_stats(ne, w, lab, s, mm)
        se_p, tgt_p = flash_ce.flash_ce_stats_plain(ne, w, lab, s, mm)
        se2, tgt2 = flash_ce.flash_ce_stats(ne, w, lab, s, mm)
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
        # d w from both routes; se_x and tgt_raw too with bf16 operands
        repeat = torch.equal(got[1], again[1]) and (mm is None or (
            torch.equal(se, se2) and torch.equal(tgt, tgt2)))
        # bf16 operands: the plain version rounds the same operands but sums
        # the gradient products of rounded draw in another order
        bound_ = BWD_RTOL if mm is None else CE_BF16_BWD_RTOL
        print(f"[3] flash-CE kernels vs plain, B {b}, d {d}, C {c}, operands "
              f"{'fp32' if mm is None else 'bf16'}: se_x {se_rel:.3e}, "
              f"tgt_raw {tgt_err:.3e}, gradients {rel:.3e} of their scale "
              f"(bound {bound_:g}); equal in two launches: {repeat}",
              flush=True)
        if not se_rel <= CE_SE_RTOL or not tgt_err <= CE_TGT_ATOL \
                or not rel <= bound_ or not repeat:
            fail(f"flash-CE kernels at B {b}, d {d}, C {c}, "
                 f"{'fp32' if mm is None else 'bf16'}: se_x {se_rel}, "
                 f"tgt_raw {tgt_err}, gradients {rel}, repeat {repeat}")
        del ne, w, lab, got, again, want, se2, tgt2
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


# K9's main-path calls at batch 8: (name, shape, channels-last, up, pad,
# gain): SR block1's FIR after its transposed conv (1, 8·128, 513², one
# grouped plane a channel), the backbone's last 96-channel upsample2d of
# the tri-plane image, and the encoder's first blur (channels-last) before
# its 3x3 stride-2 conv
FIR_CALLS = (("sr_block1_fir", (1, 8 * 128, 513, 513), False, 1, (1, 1), 4.0),
             ("backbone_upsample2d", (8, 96, 128, 128), False, 2, (2, 1),
              4.0),
             ("encoder_blur", (8, 64, 256, 256), True, 1, (2, 2), 1.0))
FIR_RTOL = 1e-6       # of the output's largest magnitude: <= 16 fp32 products


def phase_kernels_fir(dev: torch.device) -> dict:
    """K9 against its plain version and F.conv2d(groups=c) at the main
    path's shapes, forward and backward; its launches are counted on the
    paths that run it ([4], [7], ...)."""
    import torch.nn.functional as F

    from hfa_gp_tpu_torch.core import ops
    taps = ops.make_fir_kernel([1, 3, 3, 1])
    g = torch.Generator().manual_seed(SEED)
    entry = None
    for name, shape, cl, up, pad, gain in FIR_CALLS:
        fmt = torch.channels_last if cl else torch.contiguous_format
        x = torch.randn(shape, generator=g).to(dev).contiguous(
            memory_format=fmt)
        kw = dict(up=up, pad=pad, gain=gain)
        got = ops.upfirdn2d(x, taps, **kw)
        want = ops.upfirdn2d_plain(x, taps, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not rel <= FIR_RTOL or not got.is_contiguous(memory_format=fmt):
            fail(f"K9 disagrees with its plain version at {name}: {rel}")
        # backward: the adjoint (up = 2's is the down = 2 kernel)
        xg = x.clone().requires_grad_(True)
        cot = torch.randn(got.shape, generator=g).to(dev).contiguous(
            memory_format=fmt)
        y = ops.upfirdn2d(xg, taps, **kw)
        (gk,) = torch.autograd.grad(y, xg, cot)
        xg = x.clone().requires_grad_(True)
        (gp,) = torch.autograd.grad(ops.upfirdn2d_plain(xg, taps, **kw), xg,
                                    cot)
        rel_bwd = (gk - gp).abs().max().item() / gp.abs().max().item()
        if not rel_bwd <= FIR_RTOL:
            fail(f"K9's backward disagrees with autograd at {name}: "
                 f"{rel_bwd}")
        del xg, y, gk, gp
        ms = cuda_time_ms(lambda: ops.upfirdn2d(x, taps, **kw))
        plain_ms = cuda_time_ms(lambda: ops.upfirdn2d_plain(x, taps, **kw))
        # the library call: cuDNN's or PyTorch's depthwise convolution on the
        # input already zero-stuffed and padded (the plain version's last op)
        b, c, h, w = shape
        xs = x
        if up == 2:
            xs = F.pad(x.reshape(b, c, h, 1, w, 1), (0, 1, 0, 0, 0, 1)) \
                .reshape(b, c, 2 * h, 2 * w)
        xs = F.pad(xs, (pad[0], pad[1], pad[0], pad[1])).contiguous(
            memory_format=fmt)
        k = ops.fir_taps(taps, gain, torch.float32, dev)[None, None] \
            .expand(c, 1, 4, 4)
        library_ms = cuda_time_ms(lambda: F.conv2d(xs, k, groups=c))
        bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            ops.upfirdn2d(x.requires_grad_(True), taps, **kw), x, cot))
        x.requires_grad_(False)
        # up = 2: 4 products an output (polyphase), else 16
        e = kernel_entry(
            "upfirdn2d", "hfa_gp_tpu_torch/csrc/upfirdn2d.cu", "none "
            "(XLA's convolution in hfa_gp_tpu/core/ops.py::upfirdn2d)", err,
            ms, plain_ms, library_ms, nbytes(x, got),
            got.numel() * 2 * (4 if up == 2 else 16))
        print(f"    {name} {tuple(shape)}{' channels-last' if cl else ''}: "
              f"rel err {rel:.2e}, backward rel err {rel_bwd:.2e}; "
              f"{100 * e['bound_ms'] / ms:.1f} % of the bound; forward + "
              f"backward {bwd_ms:.4f} ms", flush=True)
        e.update(shape=list(shape), channels_last=cl, rel_err=rel,
                 rel_err_bwd=rel_bwd, fwd_bwd_ms=bwd_ms)
        if entry is None:
            entry = e
        else:
            entry.setdefault("also", []).append({name: e})
        del x, got, want, xs, cot
        torch.cuda.empty_cache()
    entry["call"] = FIR_CALLS[0][0]
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
# an arcface step: what [4], [7] and [10] hold the counts to. A render
# with no gradient runs the sampler with the decoder fused, which counts
# as the sampler's launch and as the decoder's
# (`triplane_sampler_decoder`): `decoder(n)`
LAUNCHES_PER_UNIT = {"triplane_sampler": (0, 2, 0),
                     "triplane_sampler_decoder": (2, 0, 0),
                     "triplane_sampler_bwd": (0, 2, 0),
                     "ray_marcher": (2, 2, 0), "ray_marcher_bwd": (0, 1, 0),
                     "flash_ce_fwd": (0, 0, 1), "flash_ce_bwd": (0, 0, 1),
                     "flash_ce_fwd_bf16": (0, 0, 1),
                     "flash_ce_bwd_bf16": (0, 0, 1)}

# K9's launches: an RGB unit (reenactment batch or training step) runs 28
# FIRs (12 encoder blurs, 12 in the backbone, 4 in SR), a synthesis alone
# (3DMM, audio, the bases' display) 16; a training step adds one backward
# launch for each, since every FIR's input needs a gradient
FIR_RGB, FIR_SYNTHESIS = 28, 16


def decoder(n: int) -> dict[str, int]:
    """n renders' passes with the decoder fused: the sampler's forward
    launches and the fused ones, as `read_launches` keys."""
    return {"triplane_sampler": n, "triplane_sampler_decoder": n}


def fir(fwd: int, bwd: int = 0) -> dict[str, int]:
    """K9's forward and backward launch counts, as `read_launches` keys."""
    return {"upfirdn2d": fwd, "upfirdn2d_bwd": bwd}


def reset_launches() -> None:
    from hfa_gp_tpu_torch.core.kernels import counters
    from hfa_gp_tpu_torch.models.arcface import vit
    from hfa_gp_tpu_torch.tools import probe_sampler
    counters.reset_launches()
    probe_sampler.LAUNCHES = 0
    vit.TOKENS = 0


def read_launches() -> dict[str, int]:
    """The port's launch counters (`core/kernels/counters.py`) and the
    sampler probe's."""
    from hfa_gp_tpu_torch.core.kernels import counters
    from hfa_gp_tpu_torch.tools import probe_sampler
    return {**counters.launches(), "triplane_probe": probe_sampler.LAUNCHES}


def no_launches() -> dict[str, int]:
    """`read_launches()`'s names, each with 0 launches."""
    return dict.fromkeys(read_launches(), 0)


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
    expected = {**no_launches(), **decoder(2 * n_batches),
                "ray_marcher": 2 * n_batches, **fir(FIR_RGB * n_batches)}
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
    graphs_before = graph_counts("rgb_loss")
    t0 = time.perf_counter()
    train_rgb.main(train_args("--iter", str(steps), "--display_freq",
                              str(steps), "--save_freq", "2"))
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    replayed = {k: v - graphs_before[k]
                for k, v in graph_counts("rgb_loss").items()}

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
          f"bases PNGs, checkpoints {ckpts}, launches {launches}, the "
          f"loss's graphs {replayed}", flush=True)
    # the first step eager, the second captured, the rest replayed: the
    # launch counts below hold the replayed steps to an eager step's
    if replayed != {"eager": 1, "captures": 1, "replays": steps - 2,
                    "failed": 0}:
        fail(f"[7] the training steps' graphs: {replayed}")
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
    # each batch of 8 basis directions (a synthesis without the encoder),
    # with the decoder fused, since no gradient is wanted there.
    n_fwd = 2 * steps + 2 + 2 * -(-n_bases // 8)
    expected = {**no_launches(), "triplane_sampler": n_fwd,
                "triplane_sampler_decoder": n_fwd - 2 * steps,
                "ray_marcher": n_fwd, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps,
                **fir(FIR_RGB * (steps + 1)
                      + FIR_SYNTHESIS * -(-n_bases // 8), FIR_RGB * steps)}
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
    if resumed != {**no_launches(), "triplane_sampler": 2, "ray_marcher": 2,
                   "triplane_sampler_bwd": 2, "ray_marcher_bwd": 1,
                   **fir(FIR_RGB, FIR_RGB)}:
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


def graph_counts(kind: str) -> dict[str, int]:
    """`core.graphs.stats()`'s counts of `kind`, zeros where none ran."""
    from hfa_gp_tpu_torch.core import graphs
    st = graphs.stats().get(kind, {})
    return {k: st.get(k, 0) for k in ("eager", "captures", "replays",
                                      "failed")}


def phase_train_throughput(cfg=None, tag: str = "[9]") -> dict:
    """[9] steady-state training steps/s at batch 2 (host clock around
    synchronised steps) and peak device memory over every step, the
    warm-up's too, for `cfg` (default: the full-width fp32 config); →
    {"steps_per_s", "gib"}. The warm-up runs the loss eagerly and
    captures its graphs, the timed steps replay them: each step launches
    what an eager step launches (for the fp32 config, `LAUNCHES_PER_UNIT`'s
    step and `FIR_RGB`). The graphs are dropped at the end."""
    from hfa_gp_tpu_torch.core import graphs
    from hfa_gp_tpu_torch.train import rgb
    batch, iters, warmup = 2, 5, 2
    cfg, state, lp, image, label = train_setup("cuda", batch, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, routes = [], [], []
    for i in range(warmup + iters):
        reset_launches()
        before = graph_counts("rgb_loss")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb.train_step(state, lp, cfg, image, label, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(read_launches())
        routes.append([k for k, v in graph_counts("rgb_loss").items()
                       if v != before[k]])
    ms = float(np.median(times[warmup:])) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} training, batch {batch}, {dtype_name(cfg)}, "
          f"generator unfrozen: {ms:.2f} ms per step (median of {iters}), "
          f"{1e3 / ms:.3f} steps/s, {batch * 1e3 / ms:.3f} frames/s, peak "
          f"device memory {peak / 2**30:.3f} GiB (reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.3f}); the loss's route "
          f"a step {routes}, a replayed step's launches {launches[-1]}",
          flush=True)
    if routes[warmup:] != [["replays"]] * iters:
        fail(f"{tag} the timed steps are not all replayed: {routes}")
    if tag == "[9]":
        eager_step = {**no_launches(), "triplane_sampler": 2,
                      "triplane_sampler_bwd": 2, "ray_marcher": 2,
                      "ray_marcher_bwd": 1, **fir(FIR_RGB, FIR_RGB)}
        if launches != [eager_step] * (warmup + iters):
            fail(f"[9] steps launched {launches}, each expected "
                 f"{eager_step}")
    elif any(n != launches[0] for n in launches):
        fail(f"{tag} a replayed step's launches differ from the eager "
             f"step's: {launches}")
    graphs.release_training()           # the pool of the step's activations
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


def phase_arcface_path(tmp: str) -> tuple[dict[str, int], float]:
    """[10] train_arcface.main: dense with checkpoints, resumed, sparse.
    Returns the dense run's launch counts and the samples/s it reported."""
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    out = os.path.join(tmp, "arcface")
    steps = 6
    # -- dense, 1,000,000 classes
    losses, launches, seconds, peak, sps = run_arcface_cli(arc_args(
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
    expected = {**no_launches(), "flash_ce_fwd": steps, "flash_ce_bwd": steps}
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
    if resumed != {**no_launches(), "flash_ce_fwd": 2, "flash_ce_bwd": 2}:
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
    return launches, sps


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


def phase_arcface_throughput() -> float:
    """[12] steady-state samples/s (host clock around synchronised steps)
    and peak device memory at the two configurations of [10]. Returns the
    dense configuration's samples/s."""
    from hfa_gp_tpu_torch.cli import train_arcface
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    from hfa_gp_tpu_torch.train import arcface as arc
    iters, warmup = 5, 2
    sps = {}
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
        sps[name] = ARC_BATCH * 1e3 / ms
        del state, step
    return sps["dense"]


def phase_probe_path() -> dict[str, int]:
    """[13] the sampler probe through its entry point: a time per
    variant."""
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
    # (the decoder fused)
    n_fwd = 2 * steps + 2
    expected = {**no_launches(), "triplane_sampler": n_fwd,
                "triplane_sampler_decoder": 2,
                "ray_marcher": n_fwd, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps,
                **fir(FIR_SYNTHESIS * (steps + 1), FIR_SYNTHESIS * steps)}
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
    reenacted = read_launches()
    check_pngs(f"3DMM reenactment from the checkpoint, --fix_cam, launches "
               f"{reenacted}", os.path.join(demo, "fix", "*.png"), 4)
    # one batch of 4 frames: both passes with the decoder fused
    want = {**no_launches(), **decoder(2), "ray_marcher": 2,
            **fir(FIR_SYNTHESIS)}
    if reenacted != want:
        fail(f"3DMM reenactment launched {reenacted}, expected {want}")
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
    expected = {**no_launches(), "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps,
                **fir(FIR_SYNTHESIS * steps, FIR_SYNTHESIS * steps)}
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
    reenacted = read_launches()
    check_pngs(f"audio reenactment from the checkpoint, --smooth, launches "
               f"{reenacted}", os.path.join(demo, "smo", "*.png"), 4)
    want = {**no_launches(), **decoder(2), "ray_marcher": 2,
            **fir(FIR_SYNTHESIS)}
    if reenacted != want:
        fail(f"audio reenactment launched {reenacted}, expected {want}")
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


# kernel-name substrings of cuDNN's convolutions, its FFT algorithms'
# complex products among them
CONV_NEEDLES = ("cudnn", "implicit_gemm", "dgrad", "wgrad", "fft", "conv",
                "winograd", "cf32", "gemv2N_kernel<int, int, float2")


def phase_facerecon() -> None:
    """[19] the ResNet-50 regressor at batch 16, 224², card against CPU, and
    its device time a batch with cuDNN's share."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
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
        start_ns = time.time_ns()              # the profiler's clock
        with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                card(xc)
            torch.cuda.synchronize()
        end_ns = time.time_ns()
    err, rel = rel_err(got, want)
    flops = conv_flops(cpu, x[:1]) * x.shape[0]
    window = trace.from_profiler(prof, (start_ns, end_ns))
    total = sum(e - s for _, s, e, _ in window.kernels)
    conv, _ = trace.kernel_ns(window, CONV_NEEDLES)
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

    from benchmark import trace
    from hfa_gp_tpu_torch.cli import process_video, train_rgb
    from hfa_gp_tpu_torch.data.dataset import HeadData
    from hfa_gp_tpu_torch.preprocess import pipeline
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
        start_ns = time.time_ns()              # the profiler's clock
        with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            set_tf32(True)
            t0 = time.perf_counter()
            process_video.main(args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        end_ns = time.time_ns()
    finally:
        clock.close()
    launches = read_launches()
    if tf32_left_on():
        fail("cli.process_video left TF32 on")
    busy_us = trace.busy_ns(trace.from_profiler(prof, (start_ns, end_ns))) \
        / 1e3
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
    if launches != no_launches():
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
    expected = {**no_launches(), "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps,
                **fir(FIR_RGB * steps, FIR_RGB * steps)}
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
          f"{1e6 * w_hh / card_peak('hbm_bytes_per_s'):.1f} µs to read at "
          f"the memory rate); peak device memory {peak / 2**30:.3f} GiB",
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
    expected = {**no_launches(), "flash_ce_fwd": steps, "flash_ce_bwd": steps}
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
    if launches != {**no_launches(), "flash_ce_fwd": steps,
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
    expected = {**no_launches(), "triplane_sampler": 2 * n_batches,
                "ray_marcher": 2 * n_batches, **fir(FIR_RGB * n_batches)}
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
    remat_expected = {**no_launches(), "triplane_sampler": 4,
                      "triplane_sampler_bwd": 2, "ray_marcher": 2,
                      "ray_marcher_bwd": 1, **fir(FIR_RGB, FIR_RGB)}
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
    chunk_expected = {**no_launches(), **decoder(2 * n_chunks),
                      "ray_marcher": 2 * n_chunks, **fir(FIR_RGB)}
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
    per_step = {**no_launches(), "triplane_sampler": 2 * steps,
                "ray_marcher": 2 * steps, "triplane_sampler_bwd": 2 * steps,
                "ray_marcher_bwd": steps}
    rgb_steps = {**per_step, **fir(FIR_RGB * steps, FIR_RGB * steps)}
    synthesis_steps = {**per_step, **fir(FIR_SYNTHESIS * steps,
                                         FIR_SYNTHESIS * steps)}
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
    if launches != rgb_steps:
        fail(f"[30] train_rgb launched {launches}, expected {rgb_steps}")
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
        if launches != synthesis_steps:
            fail(f"[30] {name} --bf16 launched {launches}, expected "
                 f"{synthesis_steps}")



# [31]-[32], the ways in: the port's converters of the reference's weight
# files and arcface's --rec record stream. The reference-format sources
# are written here, from JAX-layout trees, by the inverse of each
# converter's map (the JAX package's test helpers for this import JAX):
# NVIDIA's persistence pickle of G_ema, the reference's avatar .pt files,
# and the LPIPS, MTCNN (both layouts), Deep3DFaceRecon and DeepSpeech
# sources. tests/test_torch_convert_tools.py runs the same writers at small
# sizes against the JAX package's converters.
#   a render from the converted npz against the same params rendered
#   directly: the same kernels on the same values. cuDNN's default forward
#   convolutions are not deterministic ([31] prints how far one batch
#   rendered twice lands by default), so both renders run with
#   cudnn.deterministic
CONVERT_RENDER_RTOL = 1e-6
CONVERT_BATCH = 8
REC_RECORDS, REC_STEPS = 2048, 6


def jax_layout(tree) -> dict:
    """A param tree in the port's layout (a `ParamTree` or nested dict of
    tensors) → nested dict of numpy arrays in the JAX package's layout:
    the inverse of `utils/convert.convert_tree` (4-D `weight` OIHW → HWIO,
    3-D `weight` OIW → WIO, `const` CHW → HWC)."""
    if isinstance(tree, torch.nn.Module):
        nested: dict = {}
        for key, t in tree.state_dict().items():
            *path, leaf = key.split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t
        tree = nested
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = jax_layout(v)
            continue
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if k == "weight" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif k == "weight" and a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif k == "const" and a.ndim == 3:
            a = a.transpose(1, 2, 0)
        out[k] = np.array(a, order="C")        # a 0-d leaf stays 0-d
    return out


def _oihw(w, flip: bool = False) -> np.ndarray:
    w = np.asarray(w)
    if flip:
        w = w[::-1, ::-1]
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def eg3d_state_dict(gen: dict) -> dict[str, np.ndarray]:
    """JAX-layout EG3D generator → G_ema's state dict (torch names, NCHW):
    the inverse of convert_pickle.convert_generator, conv0 of every
    up-sampling block flipped back."""
    sd = {}

    def block(prefix: str, blk: dict, up: bool) -> None:
        for conv in ("conv0", "conv1"):
            if conv not in blk:
                continue
            c = blk[conv]
            sd[f"{prefix}.{conv}.weight"] = _oihw(c["weight"],
                                                  up and conv == "conv0")
            sd[f"{prefix}.{conv}.bias"] = c["bias"]
            sd[f"{prefix}.{conv}.affine.weight"] = c["affine"]["weight"]
            sd[f"{prefix}.{conv}.affine.bias"] = c["affine"]["bias"]
            for n in ("noise_strength", "noise_const"):
                if n in c:
                    sd[f"{prefix}.{conv}.{n}"] = c[n]
        if "const" in blk:
            sd[f"{prefix}.const"] = np.ascontiguousarray(
                blk["const"].transpose(2, 0, 1))
        if "torgb" in blk:
            t = blk["torgb"]
            sd[f"{prefix}.torgb.weight"] = _oihw(t["weight"])
            sd[f"{prefix}.torgb.bias"] = t["bias"]
            sd[f"{prefix}.torgb.affine.weight"] = t["affine"]["weight"]
            sd[f"{prefix}.torgb.affine.bias"] = t["affine"]["bias"]

    for name, v in gen["mapping"].items():
        if name == "w_avg":
            sd["backbone.mapping.w_avg"] = v
        else:
            sd[f"backbone.mapping.{name}.weight"] = v["weight"]
            sd[f"backbone.mapping.{name}.bias"] = v["bias"]
    for name, blk in gen["backbone"].items():
        block(f"backbone.synthesis.{name}", blk, up=name != "b4")
    for i, fc in ((0, "fc0"), (2, "fc1")):
        sd[f"decoder.net.{i}.weight"] = gen["decoder"][fc]["weight"]
        sd[f"decoder.net.{i}.bias"] = gen["decoder"][fc]["bias"]
    for name in ("block0", "block1"):
        block(f"superresolution.{name}", gen["superresolution"][name],
              up=True)
    return sd


class _PersistentModule:
    """A module as NVIDIA's `torch_utils.persistence` pickles it:
    `_reconstruct_persistent_obj(meta)`, with the module's `__dict__` (its
    `_parameters`, `_buffers` and `_modules`) as `meta["state"]`."""

    def __init__(self, class_name: str):
        self.class_name = class_name
        self.state = {"training": False, "_parameters": {}, "_buffers": {},
                      "_modules": {}}

    def __reduce__(self):
        from torch_utils.persistence import _reconstruct_persistent_obj
        return (_reconstruct_persistent_obj, (dict(
            type="class", version=6, module_src="# source of the network",
            class_name=self.class_name, state=self.state),))


def write_eg3d_pickle(gen: dict, path: str) -> None:
    """The generator as NVIDIA's network pickle holds G_ema: a tree of
    persistent modules under classes of `torch_utils.persistence`, the
    OSG decoder's `net` a plain torch.nn.Sequential, w_avg and the noise
    constants buffers, beside a `dnnlib.util.EasyDict`. The two packages
    are registered only while pickling, as on a machine that has them."""
    import pickle
    import types
    root = _PersistentModule("TriPlaneGenerator")
    for name, arr in eg3d_state_dict(gen).items():
        *parts, leaf = name.split(".")
        node = root
        for part in parts:
            mods = node.state["_modules"] if isinstance(
                node, _PersistentModule) else node._modules
            if part not in mods:
                # the OSG decoder's `net` is the one plain torch module
                mods[part] = (torch.nn.Sequential() if part == "net"
                              else _PersistentModule(part))
            node = mods[part]
        kind = "_buffers" if leaf in ("w_avg", "noise_const") \
            else "_parameters"
        node.state[kind][leaf] = torch.from_numpy(np.array(arr))
    net = root.state["_modules"]["decoder"].state["_modules"]["net"]
    net._modules["1"] = torch.nn.Softplus()
    net._modules = dict(sorted(net._modules.items()))

    def reconstruct(meta):
        raise AssertionError("only pickled here")

    class EasyDict(dict):
        pass

    pers = types.ModuleType("torch_utils.persistence")
    reconstruct.__module__ = pers.__name__
    reconstruct.__qualname__ = reconstruct.__name__ = \
        "_reconstruct_persistent_obj"
    pers._reconstruct_persistent_obj = reconstruct
    util = types.ModuleType("dnnlib.util")
    EasyDict.__module__, EasyDict.__qualname__ = util.__name__, "EasyDict"
    util.EasyDict = EasyDict
    fake = {"torch_utils": types.ModuleType("torch_utils"),
            "torch_utils.persistence": pers,
            "dnnlib": types.ModuleType("dnnlib"), "dnnlib.util": util}
    saved = {name: sys.modules.get(name) for name in fake}
    sys.modules.update(fake)
    try:
        with open(path, "wb") as f:
            pickle.dump({"G_ema": root, "augment_pipe": None,
                         "training_set_kwargs": EasyDict(resolution=512)}, f)
    finally:
        for name, mod in saved.items():
            if mod is None:
                del sys.modules[name]
            else:
                sys.modules[name] = mod


def _linear_stack_sd(stack: dict, prefix: str) -> dict[str, np.ndarray]:
    return {f"{prefix}{i}.{p}": stack[f"fc{i}"][p]
            for i in range(len(stack)) for p in ("weight", "bias")}


def encoder_state_dict(enc: dict) -> dict[str, np.ndarray]:
    """JAX-layout encoder → the reference Encoder's state dict (ConvLayers
    as nn.Sequential, Blur's constant kernel buffer included)."""
    app = enc["net_app"]
    blur = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
    sd = {"net_app.convs.0.0.weight": _oihw(app["stem"]["weight"]),
          "net_app.convs.0.1.bias": app["stem"]["act_bias"]}
    n = sum(k.startswith("res") for k in app)
    for i in range(n):
        r, b = app[f"res{i}"], f"net_app.convs.{i + 1}"
        sd.update({f"{b}.conv1.0.weight": _oihw(r["conv1"]["weight"]),
                   f"{b}.conv1.1.bias": r["conv1"]["act_bias"],
                   f"{b}.conv2.0.kernel": blur,
                   f"{b}.conv2.1.weight": _oihw(r["conv2"]["weight"]),
                   f"{b}.conv2.2.bias": r["conv2"]["act_bias"],
                   f"{b}.skip.0.kernel": blur,
                   f"{b}.skip.1.weight": _oihw(r["skip"]["weight"])})
    sd[f"net_app.convs.{n + 1}.weight"] = _oihw(app["final"]["weight"])
    sd.update(_linear_stack_sd(enc["fc"], "fc."))
    if "pose" in enc:
        sd.update(_linear_stack_sd(enc["pose"], "pose."))
    return sd


def _conv1d_sd(tree: dict, names, prefix: str) -> dict[str, np.ndarray]:
    return {k: v for j, idx in enumerate(names) for k, v in (
        (f"{prefix}.{idx}.weight", np.ascontiguousarray(
            tree[f"conv{j}"]["weight"].transpose(2, 1, 0))),
        (f"{prefix}.{idx}.bias", tree[f"conv{j}"]["bias"]))}


def write_avatar_pt(tree: dict, head: str, path: str, dim: int = 512
                    ) -> None:
    """A JAX-layout avatar tree (for "audio" {"model", "audnet",
    "audattnet"}) → the reference trainer's checkpoint: {"gen": state
    dict, "g_optim" | "w_optim": an optimizer's state, "args": the
    run's argparse.Namespace}, plus "AudNet" / "AudAttNet" for audio."""
    import argparse
    model = tree["model"] if head == "audio" else tree
    sd = {f"generator.{k}": v
          for k, v in eg3d_state_dict(model["generator"]).items()}
    bases = model["subspace"]["bases"]
    sd["bases"] = bases.reshape(bases.shape[0], -1, dim)
    sd["delta"] = model["subspace"]["delta"].reshape(1, -1, dim)
    if "subspace_2" in model:
        s2 = model["subspace_2"]
        if "bases" in s2:
            sd["bases_2"] = s2["bases"].reshape(s2["bases"].shape[0], -1, dim)
        sd["delta_2"] = s2["delta"].reshape(1, -1, dim)
    if head == "rgb":
        sd.update({f"encoder.{k}": v
                   for k, v in encoder_state_dict(model["encoder"]).items()})
    else:
        sd.update(_linear_stack_sd(model["weights_mlp"], "weights_3dmm.fc."))
    ckpt = {"gen": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
            "g_optim" if head == "rgb" else "w_optim": {
                "state": {}, "param_groups": [{"lr": 3e-4, "params": []}]},
            "args": argparse.Namespace(size=256, latent_dim_style=dim,
                                       person="person_3", iter=800000)}
    if head == "audio":
        aud, att = tree["audnet"], tree["audattnet"]
        ckpt["AudNet"] = {k: torch.from_numpy(v) for k, v in {
            **_conv1d_sd(aud, (0, 2, 4, 6), "encoder_conv"),
            **{f"encoder_fc1.{idx}.{p}": aud[f"fc{j}"][p]
               for j, idx in enumerate((0, 2)) for p in ("weight", "bias")},
        }.items()}
        ckpt["AudAttNet"] = {k: torch.from_numpy(v) for k, v in {
            **_conv1d_sd(att, (0, 2, 4, 6, 8), "attentionConvNet"),
            "attentionNet.0.weight": att["att_fc"]["weight"],
            "attentionNet.0.bias": att["att_fc"]["bias"]}.items()}
    torch.save(ckpt, path)


# the lpips package's AlexNet: the index of each conv in its slice
LPIPS_SLICES = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))


def write_lpips_pt(tree: dict, path: str) -> None:
    """JAX-layout LPIPS → the `lpips` package's state dict, its scaling
    layer's buffers included."""
    sd = {"scaling_layer.shift": torch.tensor([-.030, -.088, -.188])
          .reshape(1, 3, 1, 1),
          "scaling_layer.scale": torch.tensor([.458, .448, .450])
          .reshape(1, 3, 1, 1)}
    for i, (s, idx) in enumerate(LPIPS_SLICES):
        sd[f"net.slice{s}.{idx}.weight"] = torch.from_numpy(
            _oihw(tree[f"conv{i}"]["weight"]))
        sd[f"net.slice{s}.{idx}.bias"] = torch.from_numpy(
            tree[f"conv{i}"]["bias"])
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(
            tree[f"lin{i}"]["weight"].reshape(1, -1, 1, 1))
    torch.save(sd, path)


# MTCNN's FC inputs: R-Net 3 x 3 x 64, O-Net 3 x 3 x 128
MTCNN_FC = {"rnet": ("dense4", 64), "onet": ("dense5", 128)}


def write_mtcnn_facenet(tree: dict, out_dir: str) -> list[str]:
    """JAX-layout MTCNN → facenet-pytorch's pnet.pt / rnet.pt / onet.pt:
    OIHW convs, PReLU slopes, each FC's columns in the (W, H, C) order of
    its `permute(0, 3, 2, 1)` flatten."""
    paths = []
    heads = {"pnet": {"prob": "conv4_1", "reg": "conv4_2"},
             "rnet": {"prob": "dense5_1", "reg": "dense5_2"},
             "onet": {"prob": "dense6_1", "reg": "dense6_2",
                      "lmk": "dense6_3"}}
    for net in ("pnet", "rnet", "onet"):
        p, sd = tree[net], {}
        for i in range(1, 5):
            if f"c{i}" in p:
                sd[f"conv{i}.weight"] = _oihw(p[f"c{i}"]["weight"])
                sd[f"conv{i}.bias"] = p[f"c{i}"]["bias"]
                sd[f"prelu{i}.weight"] = p[f"c{i}"]["prelu"]
        if net in MTCNN_FC:
            name, c = MTCNN_FC[net]
            w = p["fc"]["weight"]
            sd[f"{name}.weight"] = np.ascontiguousarray(
                w.reshape(len(w), 3, 3, c).transpose(0, 2, 1, 3)
                .reshape(len(w), -1))
            sd[f"{name}.bias"] = p["fc"]["bias"]
            sd[f"prelu{int(name[-1])}.weight"] = p["fc"]["prelu"]
        for head, name in heads[net].items():
            w = p[head]["weight"]
            sd[f"{name}.weight"] = _oihw(w) if w.ndim == 4 else w
            sd[f"{name}.bias"] = p[head]["bias"]
        paths.append(os.path.join(out_dir, f"{net}.pt"))
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   paths[-1])
    return paths


def write_mtcnn_sandberg(tree: dict, out_dir: str) -> None:
    """JAX-layout MTCNN (for images the right way up) → Sandberg's
    det1/det2/det3.npy, whose nets take transposed images: every kernel's
    H and W swapped, each FC's spatial order swapped and its matrix
    (in, out), the box pairs and landmark halves swapped; layer names in
    the mixed case some mirrors use."""
    swap_reg, swap_lmk = [1, 0, 3, 2], [5, 6, 7, 8, 9, 0, 1, 2, 3, 4]

    def conv(p, perm=None):
        w = np.transpose(p["weight"], (1, 0, 2, 3))
        b = p["bias"]
        if perm is not None:
            w, b = w[..., perm], b[perm]
        return {"weights": np.ascontiguousarray(w), "biases": b}

    def fc(p, c=None, perm=None):
        w = p["weight"]
        if c is not None:
            w = w.reshape(len(w), 3, 3, c).transpose(0, 2, 1, 3) \
                .reshape(len(w), -1)
        b = p["bias"]
        if perm is not None:
            w, b = w[perm], b[perm]
        return {"weights": np.ascontiguousarray(w.T), "biases": b}

    def prelu(p):
        return {"alpha": p["prelu"]}

    for i, net in enumerate(("pnet", "rnet", "onet"), 1):
        p, d = tree[net], {}
        for j in range(1, 5):
            if f"c{j}" in p:
                d[f"conv{j}"] = conv(p[f"c{j}"])
                d[f"PReLU{j}"] = prelu(p[f"c{j}"])
        if net == "pnet":
            d["conv4-1"] = conv(p["prob"])
            d["conv4-2"] = conv(p["reg"], swap_reg)
        else:
            n = 4 if net == "rnet" else 5
            d[f"conv{n}"] = fc(p["fc"], MTCNN_FC[net][1])
            d[f"prelu{n}"] = prelu(p["fc"])
            d[f"conv{n + 1}-1"] = fc(p["prob"])
            d[f"conv{n + 1}-2"] = fc(p["reg"], perm=swap_reg)
            if net == "onet":
                d["conv6-3"] = fc(p["lmk"], perm=swap_lmk)
        np.save(os.path.join(out_dir, f"det{i}.npy"), d, allow_pickle=True)


def write_facerecon_pth(tree: dict, path: str) -> None:
    """JAX-layout face recon → Deep3DFaceRecon's checkpoint: {"net_recon":
    torchvision ResNet-50 under `backbone.` and the heads under
    `final_layers.`, "epoch": 20}."""
    sd = {}

    def bn(prefix, p):
        sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
                   f"{prefix}.running_mean": p["mean"],
                   f"{prefix}.running_var": p["var"]})
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0)

    sd["backbone.conv1.weight"] = _oihw(tree["stem_conv"])
    bn("backbone.bn1", tree["stem_bn"])
    for name, blk in tree.items():
        m = re.fullmatch(r"s(\d+)_b(\d+)", name)
        if m is None:
            continue
        pre = f"backbone.layer{int(m.group(1)) + 1}.{m.group(2)}"
        for c in (1, 2, 3):
            sd[f"{pre}.conv{c}.weight"] = _oihw(blk[f"conv{c}"])
            bn(f"{pre}.bn{c}", blk[f"bn{c}"])
        if "down_conv" in blk:
            sd[f"{pre}.downsample.0.weight"] = _oihw(blk["down_conv"])
            bn(f"{pre}.downsample.1", blk["down_bn"])
    for i in range(7):
        sd[f"final_layers.{i}.weight"] = _oihw(tree[f"head{i}"]["weight"])
        sd[f"final_layers.{i}.bias"] = tree[f"head{i}"]["bias"]
    torch.save({"net_recon": {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}, "epoch": 20}, path)


def write_deepspeech_vars(tree: dict, path: str) -> None:
    """JAX-layout DeepSpeech → the npz of TF 0.1.0's checkpoint variables
    (`|`-separated names, with the optimizer's slots beside them)."""
    out = {"global_step": np.asarray(1000, np.int64)}
    for i, layer in ((1, "h1"), (2, "h2"), (3, "h3"), (5, "h5"),
                     (6, "logits")):
        out[f"h{i}"] = tree[layer]["weight"]
        out[f"b{i}"] = tree[layer]["bias"]
        out[f"h{i}|Adam"] = np.zeros((1,), np.float32)
    for d in ("fw", "bw"):
        cell = f"bidirectional_rnn|{d}|basic_lstm_cell"
        out[f"{cell}|weights"] = tree[f"lstm_{d}"]["kernel"]
        out[f"{cell}|biases"] = tree[f"lstm_{d}"]["bias"]
    np.savez(path, **out)


def random_tree(shapes: dict, rng) -> dict:
    """Seeded float32 arrays of the given nested shapes."""
    return {k: random_tree(v, rng) if isinstance(v, dict)
            else rng.standard_normal(v).astype(np.float32) * 0.1
            for k, v in shapes.items()}


def mtcnn_shapes() -> dict:
    """The JAX layout of the MTCNN cascade (the Caffe model's widths)."""
    def conv(k, cin, cout, prelu=True):
        p = {"weight": (k, k, cin, cout), "bias": (cout,)}
        return {**p, "prelu": (cout,)} if prelu else p

    def fc(cin, cout, prelu=False):
        p = {"weight": (cout, cin), "bias": (cout,)}
        return {**p, "prelu": (cout,)} if prelu else p

    return {"pnet": {"c1": conv(3, 3, 10), "c2": conv(3, 10, 16),
                     "c3": conv(3, 16, 32), "prob": conv(1, 32, 2, False),
                     "reg": conv(1, 32, 4, False)},
            "rnet": {"c1": conv(3, 3, 28), "c2": conv(3, 28, 48),
                     "c3": conv(2, 48, 64), "fc": fc(576, 128, True),
                     "prob": fc(128, 2), "reg": fc(128, 4)},
            "onet": {"c1": conv(3, 3, 32), "c2": conv(3, 32, 64),
                     "c3": conv(3, 64, 64), "c4": conv(2, 64, 128),
                     "fc": fc(1152, 256, True), "prob": fc(256, 2),
                     "reg": fc(256, 4), "lmk": fc(256, 10)}}


def deepspeech_shapes() -> dict:
    """The JAX layout of DeepSpeech 0.1.0: 494 inputs, 2048 units, 29
    characters."""
    def dense(cin, cout):
        return {"weight": (cin, cout), "bias": (cout,)}

    lstm = {"kernel": (4096, 8192), "bias": (8192,)}
    return {"h1": dense(494, 2048), "h2": dense(2048, 2048),
            "h3": dense(2048, 2048), "lstm_fw": lstm, "lstm_bw": lstm,
            "h5": dense(4096, 2048), "logits": dense(2048, 29)}


def trees_equal(got: dict, want: dict) -> list[str]:
    """The keys at which two nested dicts of arrays differ (other keys,
    shapes, dtypes or any bit)."""
    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        g, w = got[k], want[k]
        if isinstance(w, dict) and isinstance(g, dict):
            bad += [f"{k}/{b}" for b in trees_equal(g, w)]
        elif isinstance(w, dict) or isinstance(g, dict) \
                or np.asarray(g).dtype != np.asarray(w).dtype \
                or not np.array_equal(g, w):
            bad.append(k)
    return bad


# a tool's process: its seconds after torch's import and its peak memory
TOOL_CODE = ("import resource, runpy, sys, time\n"
             "import torch\n"
             "t0 = time.perf_counter()\n"
             "if len(sys.argv) > 1:\n"
             "    sys.argv = sys.argv[1:]\n"
             "    runpy.run_module(sys.argv[0], run_name='__main__',\n"
             "                     alter_sys=True)\n"
             "print('main_s', time.perf_counter() - t0)\n"
             "print('maxrss_kib', "
             "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")


def run_tool(name: str | None, *argv: str) -> dict:
    """`python -m hfa_gp_tpu_torch.tools.<name> argv` in a process of its
    own, as a user runs it (name None: a process that only imports torch):
    {"seconds" of the process, "main_s" of the module after torch's
    import, "rss_gib": its peak resident memory, "said": its first line}.
    The peak is the process's ru_maxrss. A child's maxrss starts from the
    memory of the process it was forked from, so the tool is started
    through a small Python process in between, not from this large one."""
    hop = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"
    mod = [f"hfa_gp_tpu_torch.tools.{name}", *argv] if name else []
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", hop, sys.executable, "-c",
                        TOOL_CODE, *mod], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"[31] {name} {argv} exited {r.returncode}:\n{r.stderr[-3000:]}")
    lines = dict(line.split(" ", 1) for line in r.stdout.splitlines()
                 if line.startswith(("main_s ", "maxrss_kib ")))
    return {"seconds": seconds, "main_s": float(lines["main_s"]),
            "rss_gib": int(lines["maxrss_kib"]) * 1024 / GIB,
            "said": r.stdout.splitlines()[0]}


class _Recorder:
    """Wraps `owner.name` for the length of a `with`: every call's
    arguments and result are kept."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.real = getattr(self.owner, self.name)

        def wrapped(*a, **kw):
            out = self.real(*a, **kw)
            self.calls.append((a, kw, out))
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def render_from_npz(what: str, cli, argv: list[str], owner, fn: str,
                    params, fir_unit: int) -> dict:
    """`cli.main(argv)` (which reads `--model_npz`) with `owner.fn`, its
    render, recorded: the frames, the launches (`fir_unit` of K9's a
    batch), and each batch held against `params` (the tree the npz was
    written from, on the card) rendered directly on the same inputs, both
    under cuDNN's deterministic algorithms."""
    reset_launches()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        with _Recorder(owner, fn) as rec:
            cli.main(cli.build_argparser().parse_args(argv))
            launches = read_launches()
        seconds = time.perf_counter() - t0
        if not rec.calls:
            fail(f"[31] {what}: the CLI rendered nothing")
        errs = []
        with torch.inference_mode():
            for a, kw, out in rec.calls:
                want = rec.real(params, *a[1:], **kw)
                scale = max(1.0, want.abs().max().item())
                errs.append((out - want).abs().max().item() / scale)
                if not torch.isfinite(out).all() or out.shape != want.shape:
                    fail(f"[31] {what}: frames {tuple(out.shape)}, finite "
                         f"{bool(torch.isfinite(out).all())}")
    finally:
        torch.backends.cudnn.deterministic = False
    a, kw, out = rec.calls[0]
    with torch.inference_mode():
        twice = [rec.real(params, *a[1:], **kw) for _ in range(2)]
    default = (twice[0] - twice[1]).abs().max().item() \
        / max(1.0, twice[0].abs().max().item())
    print(f"[31] {what} --model_npz: {len(rec.calls)} batch(es) of "
          f"{tuple(out.shape)}, {seconds:.2f} s, launches {launches}; "
          f"against the same params rendered directly, max abs diff / "
          f"max(1, scale) {max(errs):.3e} (bound {CONVERT_RENDER_RTOL:g}; "
          f"one batch rendered twice with cuDNN's default algorithms: "
          f"{default:.3e})", flush=True)
    if not max(errs) <= CONVERT_RENDER_RTOL:
        fail(f"[31] {what}: the render from the npz differs by {errs}")
    expected = {**no_launches(), **decoder(2 * len(rec.calls)),
                "ray_marcher": 2 * len(rec.calls),
                **fir(fir_unit * len(rec.calls))}
    if launches != expected:
        fail(f"[31] {what} launched {launches}, expected {expected}")
    return launches


def phase_converters(tmp: str) -> dict[str, int]:
    """[31] every converter of the port on a reference-format source at
    full width, in a process of its own as a user runs it: each npz equal
    to the tree its source was written from, bit for bit, and loadable by
    the module that reads it; then a batch of 8 through each reenactment
    CLI from the converted avatar checkpoints, held against the same
    params rendered directly. Returns the three CLIs' launches, summed."""
    import dataclasses

    from hfa_gp_tpu_torch.cli import (run_recon_video_3dmm,
                                      run_recon_video_audio,
                                      run_recon_video_rgb)
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.preprocess import convert as pconvert
    from hfa_gp_tpu_torch.train import audio as audio_train
    from hfa_gp_tpu_torch.utils.convert import ParamTree, from_jax, load_npz
    cfg = heads.AvatarConfig()
    params = {
        "rgb": heads.init_avatar_rgb(torch.Generator().manual_seed(SEED + 7),
                                     dataclasses.replace(cfg, person_2=True)),
        "3dmm": heads.init_avatar_3dmm(
            torch.Generator().manual_seed(SEED + 8), cfg),
        "audio": audio_train.init_audio_params(
            torch.Generator().manual_seed(SEED + 9), cfg)}
    trees = {k: jax_layout(p) for k, p in params.items()}
    rng = np.random.default_rng(SEED + 10)
    trees["eg3d"] = trees["rgb"]["generator"]
    trees["lpips"] = jax_layout(lpips.init_lpips(
        torch.Generator().manual_seed(SEED + 11)))
    trees["mtcnn"] = random_tree(mtcnn_shapes(), rng)
    recon = os.path.join(tmp, "recon_tree.npz")
    write_recon_npz(random_recon_state(
        torch.Generator().manual_seed(SEED + 12)), recon)
    trees["facerecon"] = load_npz(recon)
    trees["deepspeech"] = random_tree(deepspeech_shapes(), rng)

    src = {k: os.path.join(tmp, name) for k, name in (
        ("eg3d", "ffhqrebalanced512-128.pkl"), ("rgb", "rgb_025000.pt"),
        ("3dmm", "3dmm_025000.pt"), ("audio", "audio_025000.pt"),
        ("lpips", "lpips_alex.pt"), ("facerecon", "epoch_20.pth"),
        ("deepspeech", "ds_vars.npz"), ("sandberg", "dets"))}
    t0 = time.perf_counter()
    write_eg3d_pickle(trees["eg3d"], src["eg3d"])
    for head in ("rgb", "3dmm", "audio"):
        write_avatar_pt(trees[head], head, src[head])
    write_lpips_pt(trees["lpips"], src["lpips"])
    facenet = write_mtcnn_facenet(trees["mtcnn"], tmp)
    os.makedirs(src["sandberg"])
    write_mtcnn_sandberg(trees["mtcnn"], src["sandberg"])
    write_facerecon_pth(trees["facerecon"], src["facerecon"])
    write_deepspeech_vars(trees["deepspeech"], src["deepspeech"])
    print(f"[31] reference-format sources written in "
          f"{time.perf_counter() - t0:.2f} s: " + ", ".join(
              f"{os.path.basename(p)} {os.path.getsize(p) / 2**20:.1f} MiB"
              for p in src.values() if os.path.isfile(p)), flush=True)

    out = {k: os.path.join(tmp, f"{k}.npz") for k in (
        "eg3d", "rgb", "3dmm", "audio", "lpips", "mtcnn", "sandberg",
        "facerecon", "deepspeech")}
    runs = {
        "eg3d": ("convert_pickle", src["eg3d"], out["eg3d"]),
        **{h: ("convert_avatar", "--ckpt", src[h], "--head", h, "--out",
               out[h]) for h in ("rgb", "3dmm", "audio")},
        "lpips": ("convert_lpips", src["lpips"], out["lpips"]),
        "mtcnn": ("convert_mtcnn", "--pnet", facenet[0], "--rnet",
                  facenet[1], "--onet", facenet[2], "--out", out["mtcnn"]),
        "sandberg": ("convert_mtcnn", "--det_dir", src["sandberg"], "--out",
                     out["sandberg"]),
        "facerecon": ("convert_facerecon", src["facerecon"],
                      out["facerecon"]),
        "deepspeech": ("convert_deepspeech", src["deepspeech"],
                       out["deepspeech"])}
    base = run_tool(None)
    print(f"[31] a process that only imports torch: {base['seconds']:.2f} "
          f"s, peak host memory {base['rss_gib']:.3f} GiB", flush=True)
    for key, (tool, *argv) in runs.items():
        r = run_tool(tool, *argv)
        want = trees["mtcnn" if key == "sandberg" else key]
        bad = trees_equal(load_npz(out[key]), want)
        print(f"[31] {tool} {key}: {r['seconds']:.2f} s in all, "
              f"{r['main_s']:.2f} s after importing torch, peak host "
              f"memory {r['rss_gib']:.3f} GiB "
              f"({r['rss_gib'] - base['rss_gib']:+.3f} over importing "
              f"torch), npz {os.path.getsize(out[key]) / 2**20:.1f} MiB; "
              f"equal to its source tree bit for bit: {not bad} "
              f"({r['said']})", flush=True)
        if bad:
            fail(f"[31] {key}: the converted tree differs at {bad[:5]}")
    with open(out["rgb"] + ".args.json") as f:
        side = json.load(f)
    if side.get("latent_dim_style") != "512":
        fail(f"[31] rgb.npz.args.json holds {side}")
    # each preprocessing npz loads into the port's module (strict keys and
    # shapes), LPIPS's into a tree of init_lpips's shapes
    pconvert.mtcnn_from_jax(load_npz(out["mtcnn"]))
    pconvert.mtcnn_from_jax(load_npz(out["sandberg"]))
    pconvert.facerecon_from_jax(load_npz(out["facerecon"]))
    pconvert.deepspeech_from_jax(load_npz(out["deepspeech"]))
    got = {k: v.shape for k, v in from_jax(load_npz(out["lpips"]))
           .state_dict().items()}
    want = {k: v.shape for k, v in ParamTree(lpips.init_lpips(
        torch.Generator().manual_seed(0))).state_dict().items()}
    if got != want:
        fail(f"[31] LPIPS npz shapes {got} != {want}")

    write_dataset(tmp, CONVERT_BATCH)
    write_expressions(tmp, CONVERT_BATCH, "test")
    write_audio_dataset(tmp, 1, CONVERT_BATCH)
    flags = ["--dataset_root", tmp, "--size", "256", "--render_batch",
             str(CONVERT_BATCH), "--demo_dir", os.path.join(tmp, "demo"),
             "--fps", "4", "--device", "cuda"]
    launches = [
        render_from_npz("run_recon_video_rgb", run_recon_video_rgb,
                        flags + ["--person", "person_3", "--demo_name",
                                  "rgb", "--model_npz", out["rgb"]],
                        run_recon_video_rgb, "reenact",
                        params["rgb"].to("cuda"), FIR_RGB),
        render_from_npz("run_recon_video_3dmm", run_recon_video_3dmm,
                        flags + ["--person", "person_3", "--demo_name",
                                  "3dmm", "--model_npz", out["3dmm"]],
                        heads, "t3dmm_forward", params["3dmm"].to("cuda"),
                        FIR_SYNTHESIS),
        render_from_npz("run_recon_video_audio --smooth",
                        run_recon_video_audio,
                        flags + ["--dataset", "ad_dataset", "--person",
                                  "obama", "--demo_name", "audio",
                                  "--smooth", "--model_npz", out["audio"]],
                        audio_train, "sample", params["audio"].to("cuda"),
                        FIR_SYNTHESIS)]
    return {k: sum(n[k] for n in launches) for k in launches[0]}


class MemoryReader:
    """An ArrayRecord reader's interface over records held in memory."""

    def __init__(self, records: list[bytes]):
        self.records = records

    def num_records(self) -> int:
        return len(self.records)

    def read(self, indices) -> list[bytes]:
        return [self.records[i] for i in indices]


def phase_rec_path(tmp: str, synthetic_sps: dict) -> dict[str, int]:
    """[32] train_arcface.main --rec (iresnet50, fp32, 1,000,000 classes,
    batch 256) on seeded-noise JPEG records: through an ArrayRecord file
    where `array_record` imports, else through the same dataset and stream
    over an in-memory reader; the batches that reached the card equal the
    CPU decode bit for bit, K5 and K6 once a step, and samples/s beside
    the synthetic-batch figures of [10] and [12]."""
    import io

    from PIL import Image

    from hfa_gp_tpu_torch.cli import train_arcface
    from hfa_gp_tpu_torch.data import record_dataset as rd
    from hfa_gp_tpu_torch.data.dataset import EpochSeededBatches
    rng = np.random.default_rng(SEED + 13)
    images, labels = [], []
    for _ in range(REC_RECORDS):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (112, 112, 3), np.uint8)) \
            .save(buf, format="JPEG", quality=90)
        images.append(buf.getvalue())
        labels.append(int(rng.integers(0, 1_000_000)))
    reader = MemoryReader([rd.encode_record(i, b)
                           for i, b in zip(images, labels)])
    path = os.path.join(tmp, "train.array_record")
    try:
        rd.write_record_dataset(path, images, labels)
        route, opened = "an ArrayRecord file", None
    except ImportError:
        route, opened = "an in-memory reader (no array_record here)", reader
    real_dataset = train_arcface.RecordFaceDataset
    if opened is not None:
        train_arcface.RecordFaceDataset = \
            lambda source, size=112: real_dataset(opened, size)
    batches = []
    real_batches = train_arcface.record_batches

    def recording(*a, **kw):
        get = real_batches(*a, **kw)

        def kept(i):
            batches.append(get(i))
            return batches[-1]
        return kept

    train_arcface.record_batches = recording
    try:
        losses, launches, seconds, peak, sps = run_arcface_cli(arc_args(
            "--num_classes", "1000000", "--num_steps", str(REC_STEPS),
            "--rec", path))
    finally:
        train_arcface.RecordFaceDataset = real_dataset
        train_arcface.record_batches = real_batches
    stream = EpochSeededBatches(rd.RecordFaceDataset(reader), ARC_BATCH,
                                seed=0)
    t0 = time.perf_counter()
    cpu = [stream.load(i) for i in range(REC_STEPS)]
    decode_ms = (time.perf_counter() - t0) * 1e3 / REC_STEPS
    equal = [torch.equal(b[0].cpu(), c[0]) and torch.equal(b[1].cpu(),
                                                           c[1].long())
             for b, c in zip(batches, cpu)]
    print(f"[32] train_arcface --rec through {route}: {ARC_NET}, 1,000,000 "
          f"classes, batch {ARC_BATCH}, {len(losses)} steps in "
          f"{seconds:.2f} s (init and first-use costs included), losses "
          f"{[round(x, 4) for x in losses]}, peak {peak / GIB:.3f} GiB, "
          f"launches {launches}; {REC_RECORDS} JPEG records, host decode "
          f"{decode_ms:.1f} ms a batch; the card's batches equal the CPU "
          f"decode bit for bit: {equal}", flush=True)
    print(f"[32] samples/s: --rec {sps:.1f} (the CLI's figure, steps "
          f"2-{REC_STEPS}), "
          f"synthetic on-device batches: [10] {synthetic_sps['cli']:.1f} "
          f"(the CLI's figure, checkpoints and logging in its clock), [12] "
          f"{synthetic_sps['steady']:.1f} (steady state); --rec / [12] = "
          f"{sps / synthetic_sps['steady']:.3f}", flush=True)
    check_arcface_losses("--rec run", losses, 1_000_000, REC_STEPS)
    if len(equal) != REC_STEPS or not all(equal):
        fail(f"[32] the card's batches differ from the CPU decode: {equal}")
    expected = {**no_launches(), "flash_ce_fwd": REC_STEPS,
                "flash_ce_bwd": REC_STEPS}
    if launches != expected:
        fail(f"[32] the --rec run launched {launches}, expected {expected}")
    return launches


def phase_golden() -> None:
    """[34]: the reference's golden seams on the card, the marcher through
    its kernel (the card's machine has no JAX: these fixtures are the one
    reference there besides the plain versions)."""
    from hfa_gp_tpu_torch.core.kernels import raymarch
    from hfa_gp_tpu_torch.tools import check_golden
    n0 = raymarch.LAUNCHES
    rows = check_golden.check("cuda")
    torch.cuda.synchronize()
    for name, err, excess, ok in rows:
        print(f"[34] golden {name}: max abs err {err:.3e}, worst excess over "
              f"the tolerance {excess:.3e}", flush=True)
    if not all(ok for *_, ok in rows):
        fail(f"the port misses the golden seams: "
             f"{[r[0] for r in rows if not r[-1]]}")
    if raymarch.LAUNCHES - n0 != 1:
        fail(f"the golden ray_march launched the marcher "
             f"{raymarch.LAUNCHES - n0} times, not once")


# [35]-[38], the port over several processes: each multi-rank run is this
# script started as ranks of its own (`--rank_worker <phase>`, with the
# WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT contract), through the CLIs'
# entry points, on the one card: the ranks share it and talk over gloo.
# Each rank writes its result as JSON; the first rank to fail, or a group
# that outlives MP_TIMEOUT, fails the phase. Each rank waits at most
# MP_DIST_TIMEOUT in a collective, so a dead rank fails the others.
MP_TIMEOUT = 600
MP_DIST_TIMEOUT = 300
# an all-reduce of iresnet50's gradient (43.6M fp32 numbers)
MP_ALLREDUCE_BYTES = 175_000_000
MP_ARC_STEPS = 3
MP_ARC_CLASSES = 1_000_000
MP_RGB_STEPS = 2
MP_REENACT_BATCH = 8
# tolerances of [36] and [37] against one rank: this factor times the one
# rank's own run-to-run spread (two runs of one command), and no less than
# a floor: losses and sums 1e-5 (the ranks sum the batch in another
# order); what Adam's first steps moved the avatar's params by 1e-2 in
# relative L2: each moves by about lr·sign(g), and a gradient within
# rounding of 0 may take the other sign, which two ranks' sum in another
# order does more often than one rank's atomics from run to run (1.1e-3
# against a spread of 3.5e-4 on an NVIDIA H100 80GB HBM3 at 700 W; a rank
# stepping on its own half-batch gradient moves a large share of signs)
MP_SPREAD_FACTOR = 10.0
MP_LOSS_FLOOR = 1e-5
MP_PARAMS_FLOOR = 1e-2
# the class rows that [36]'s labels touch, what the steps moved them by, in
# relative L2: a doubled or missing head gradient on them parts by 50-100 %
MP_ROWS_FLOOR = 1e-3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(phase: str, world: int, out: str, *extra: str,
                timeout: float = MP_TIMEOUT, must_pass: bool = True,
                env_extra: dict | None = None):
    """`chip_smoke.py --rank_worker phase` on `world` ranks of the one card.
    Returns (each rank's JSON result or None, exit codes, log tails)."""
    os.makedirs(out, exist_ok=True)
    # the ranks share the card with this process: hand back its cache
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               **(env_extra or {}))
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank_worker", phase,
         "--out", out, *extra],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    tails = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            tails.append(f.read()[-3000:])
    if must_pass and any(codes):
        bad = next(r for r, c in enumerate(codes) if c)
        fail(f"{phase}: rank {bad} of {world} exited {codes[bad]} (codes "
             f"{codes}):\n{tails[bad]}")
    results = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.json")
        results.append(json.load(open(path)) if os.path.exists(path)
                       else None)
    return results, codes, tails


# -- the ranks' side ----------------------------------------------------------


def sha(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def rank_setup(a) -> dict:
    """[35] this rank's backend and device; which collectives gloo runs on
    CUDA tensors; one all-reduce of 175 MB, on the card and from host
    memory."""
    import torch.distributed as dist

    from hfa_gp_tpu_torch.cli import common
    from hfa_gp_tpu_torch.parallel import distributed
    args = argparse_ns(device="cuda")
    device = common.device_from_args(args)
    distributed.maybe_initialize(args, device)
    rank, world = distributed.world()
    out = {"backend": distributed.backend(), "device": str(device),
           "own_card": distributed.own_cards(args), "collectives": {}}

    def probe(name, fn):
        try:
            ok = bool(fn())
            torch.cuda.synchronize()
            out["collectives"][name] = "ran" if ok else "ran, wrong result"
        except Exception as e:        # what gloo refuses on CUDA tensors
            out["collectives"][name] = f"{type(e).__name__}: {str(e)[:160]}"

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=device)
        dist.all_reduce(t)
        return torch.all(t == world * (world + 1) / 2)

    def broadcast():
        t = torch.full((4,), float(rank), device=device)
        dist.broadcast(t, src=0)
        return torch.all(t == 0)

    def all_gather_into_tensor():
        t = torch.full((2,), float(rank), device=device)
        o = torch.empty((2 * world,), device=device)
        dist.all_gather_into_tensor(o, t)
        return torch.equal(o.cpu(), torch.arange(world).float()
                           .repeat_interleave(2))

    def all_gather():
        t = torch.full((2,), float(rank), device=device)
        o = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(o, t)
        return all(torch.all(x == i) for i, x in enumerate(o))

    def reduce_scatter_tensor():
        t = torch.ones((world,), device=device)
        o = torch.empty((1,), device=device)
        dist.reduce_scatter_tensor(o, t)
        return torch.all(o == world)

    for name, fn in (("all_reduce", all_reduce), ("broadcast", broadcast),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_gather", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter_tensor)):
        probe(name, fn)
    n = MP_ALLREDUCE_BYTES // 4
    for where in ("cuda", "cpu"):
        buf = torch.ones((n,), device=device if where == "cuda" else "cpu")
        dist.all_reduce(buf)                  # warm-up
        times = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(buf)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"allreduce_ms_{where}"] = float(np.median(times))
        del buf
    return out


def argparse_ns(**kw):
    import argparse
    base = dict(coordinator_address=None, num_processes=None,
                process_id=None)
    base.update(kw)
    return argparse.Namespace(**base)


def rank_nccl(a) -> dict:
    """[35] two ranks of one NCCL communicator on the one card."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=60))
    t = torch.ones((4,), device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return {"all_reduce": t.tolist()}


@contextlib.contextmanager
def timed_steps(train_arcface):
    """Every step of the `train_arcface.main` runs inside, timed and
    synchronised before and after: yields the list of seconds."""
    real, into = train_arcface.arc.make_train_step, []

    def make(*x, **kw):
        step = real(*x, **kw)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return timed

    train_arcface.arc.make_train_step = make
    try:
        yield into
    finally:
        train_arcface.arc.make_train_step = real


@contextlib.contextmanager
def recorded_labels(train_arcface):
    """Every step of the `train_arcface.main` runs inside: yields the list
    of each step's labels (the rank's rows of the global batch)."""
    real, into = train_arcface.arc.make_train_step, []

    def make(*x, **kw):
        step = real(*x, **kw)

        def recording(state, images, labels, *sa, **skw):
            into.append(labels.tolist())
            return step(state, images, labels, *sa, **skw)
        return recording

    train_arcface.arc.make_train_step = make
    try:
        yield into
    finally:
        train_arcface.arc.make_train_step = real


def rank_arcface(a) -> dict:
    """[36] train_arcface.main on this rank: its losses, launches, the rows
    K5/K6 ran on, its shard's checksum, the bits of its backbone and
    running moments, its peak memory and files."""
    from hfa_gp_tpu_torch.cli import train_arcface
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    rank = int(os.environ["RANK"])
    states, rows = [], []
    real_init, real_stats = train_arcface.arc.init_state, \
        flash_ce.flash_ce_stats

    def init(*x, **kw):
        states.append(real_init(*x, **kw))
        return states[-1]

    def stats(ne, w, *x, **kw):
        rows.append(int(w.shape[0]))
        return real_stats(ne, w, *x, **kw)

    train_arcface.arc.init_state = init
    flash_ce.flash_ce_stats = stats
    # where a step's time goes: the device work queued before each
    # all-reduce (a synchronise), and the all-reduce itself
    import torch.distributed as dist
    real_all_reduce, coll = dist.all_reduce, {"n": 0, "wait": 0.0,
                                              "in": 0.0}

    def all_reduce(*x, **kw):
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = real_all_reduce(*x, **kw)
        coll["n"] += 1
        coll["wait"] += t1 - t0
        coll["in"] += time.perf_counter() - t1
        return r

    dist.all_reduce = all_reduce
    out_dir = os.path.join(a.out, f"run{rank}")
    args = arc_args("--num_classes", str(MP_ARC_CLASSES), "--num_steps",
                    str(MP_ARC_STEPS), "--save_freq", "2", "--n_model", "2",
                    "--output", out_dir)
    with timed_steps(train_arcface) as step_s, \
            recorded_labels(train_arcface) as labels:
        losses, launches, seconds, peak, sps = run_arcface_cli(args)
    st = states[-1]
    return {"losses": losses, "labels": labels,
            "launches": launches, "ce_rows": sorted(
                set(rows)), "seconds": seconds, "peak_gib": peak / GIB,
            "sps": sps, "table_abs_sum": float(st.fc_weight.double().abs()
                                               .sum()),
            "table_rows": int(st.fc_weight.shape[0]),
            "backbone": sha(st.backbone.state_dict().values()),
            "stats": sha(st.batch_stats.state_dict().values()),
            "files": sorted(os.listdir(out_dir))
            if os.path.isdir(out_dir) else None, "all_reduces": coll,
            "step_s": step_s}


class RecordingRows:
    """Wraps a HeadData class: the rows of the train split read."""
    rows: list = []

    @classmethod
    def wrap(cls, real):
        class Recorded(real):
            def __getitem__(self, idx):
                if self.ds_path.rstrip("/").endswith(
                        os.path.join("train", "cropped_images")):
                    cls.rows.append(int(idx))
                return super().__getitem__(idx)
        return Recorded


@contextlib.contextmanager
def recorded_rays():
    """Yields {kernel: [(batch, rays) of each launch]} of the four avatar
    kernels while it is open; the sampler's rays are its points over the
    render's samples a ray in each pass, with the decoder fused or not."""
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    from hfa_gp_tpu_torch.models.eg3d.renderer import RenderConfig
    n = RenderConfig().depth_resolution
    assert n == RenderConfig().depth_resolution_importance
    seen = {"triplane_sampler": [], "triplane_sampler_bwd": [],
            "ray_marcher": [], "ray_marcher_bwd": []}
    real = {"triplane_sampler": (triplane, "_launch_forward"),
            "triplane_sampler_decoder": (triplane, "sample_decode"),
            "triplane_sampler_bwd": (triplane, "sample_mean_backward"),
            "ray_marcher": (raymarch, "_launch_forward"),
            "ray_marcher_bwd": (raymarch, "ray_march_backward")}
    fns = {k: getattr(m, a) for k, (m, a) in real.items()}

    def wrap(name):
        def fn(*a, **kw):
            if name.startswith("triplane"):
                pts = a[2] if name.endswith("bwd") else a[1]
                seen[name.removesuffix("_decoder")].append(
                    (pts.shape[0], pts.shape[1] // n))
            else:
                seen[name].append(tuple(a[0].shape[:2]))
            return fns[name](*a, **kw)
        return fn

    for k, (m, a) in real.items():
        setattr(m, a, wrap(k))
    try:
        yield seen
    finally:
        for k, (m, a) in real.items():
            setattr(m, a, fns[k])


@contextlib.contextmanager
def global_placement():
    """The avatar CLIs' config with the fine samples at the global
    quantiles, which they pick themselves under --n_model > 1: a one-rank
    run to hold a ray-sharded one against."""
    from hfa_gp_tpu_torch.cli import common
    real = common.avatar_config

    def cfg(args, **kw):
        return with_render(real(args, **kw), sampler_fine="global")

    common.avatar_config = cfg
    try:
        yield
    finally:
        common.avatar_config = real


def run_rgb_cli(root: str, exp: str, n_model: int = 1) -> dict:
    """train_rgb.main, MP_RGB_STEPS steps at full width, global batch 2:
    losses, launches, the rows of the train split read, seconds, each
    step's seconds, the rays of each launch, and with a model axis a hash
    of the params after the last step."""
    from hfa_gp_tpu_torch.cli import train_rgb
    from hfa_gp_tpu_torch.train import rgb as rgb_train
    real_ds, real_step = train_rgb.HeadData, rgb_train.train_step
    losses, step_s, states = [], [], []

    def step(*x, **kw):
        t0 = time.perf_counter()
        m = real_step(*x, **kw)
        losses.append({k: float(v) for k, v in m.items()})
        step_s.append(time.perf_counter() - t0)
        states[:] = [x[0]]
        return m

    RecordingRows.rows = []
    train_rgb.HeadData = RecordingRows.wrap(real_ds)
    rgb_train.train_step = step
    args = train_rgb.build_argparser().parse_args([
        "--dataset_root", root, "--person", "person_3", "--size", "256",
        "--batch_size", "2", "--iter", str(MP_RGB_STEPS), "--display_freq",
        "1000", "--save_freq", str(MP_RGB_STEPS), "--tune_iter", "0",
        "--exp_path", exp, "--exp_name", "dp", "--device", "cuda",
        "--n_model", str(n_model)])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with recorded_rays() as rays:
            train_rgb.main(args)
    finally:
        train_rgb.HeadData, rgb_train.train_step = real_ds, real_step
    launches = read_launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"losses": losses, "launches": launches,
            "rows": list(RecordingRows.rows), "seconds": seconds,
            "step_s": step_s, "rays": rays,
            "sha": sha(states[0].params.parameters())
            if n_model > 1 and states else None,
            "peak_gib": torch.cuda.max_memory_allocated() / GIB}


def rank_rgb(a) -> dict:
    rank = int(os.environ["RANK"])
    exp = os.path.join(a.out, f"exps{rank}")
    res = run_rgb_cli(a.data, exp, a.n_model)
    res["files"] = sorted(os.listdir(exp)) if os.path.isdir(exp) else None
    return res


def run_reenact_cli(root: str, demo: str, n_model: int = 1,
                    warm: bool = False) -> dict:
    """run_recon_video_rgb.main at batch MP_REENACT_BATCH: launches,
    seconds, each batch's render seconds (encoder to frames, the card
    synchronised) and the rays of each launch; with `warm`, after one
    run of the same command into {demo}_warm, so that the render's time
    leaves first use out."""
    from hfa_gp_tpu_torch.cli import run_recon_video_rgb

    def args(out):
        return run_recon_video_rgb.build_argparser().parse_args([
            "--dataset_root", root, "--person", "person_3", "--size",
            "256", "--render_batch", str(MP_REENACT_BATCH), "--demo_dir",
            out, "--demo_name", "dp", "--fps", "4", "--device", "cuda",
            "--n_model", str(n_model)])

    if warm:
        run_recon_video_rgb.main(args(demo + "_warm"))
    real = run_recon_video_rgb.reenact
    batch_s = []

    def timed(*x, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*x, **kw)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t)
        return out

    reset_launches()
    t0 = time.perf_counter()
    run_recon_video_rgb.reenact = timed
    try:
        with recorded_rays() as rays:
            run_recon_video_rgb.main(args(demo))
    finally:
        run_recon_video_rgb.reenact = real
    launches = read_launches()
    torch.cuda.synchronize()
    return {"launches": launches, "seconds": time.perf_counter() - t0,
            "batch_s": batch_s, "rays": rays}


def rank_reenact(a) -> dict:
    rank = int(os.environ["RANK"])
    demo = os.path.join(a.out, f"demo{rank}")
    res = run_reenact_cli(a.data, demo, a.n_model, warm=a.n_model > 1)
    res["files"] = sorted(os.listdir(demo)) if os.path.isdir(demo) else None
    return res


RANK_PHASES = {"setup": rank_setup, "nccl": rank_nccl,
               "arcface": rank_arcface, "rgb": rank_rgb,
               "reenact": rank_reenact}


def rank_worker(argv: list[str]) -> None:
    """One rank of a [35]-[38] run: its result to {out}/rank{RANK}.json."""
    import argparse
    import datetime
    import traceback
    p = argparse.ArgumentParser()
    p.add_argument("--rank_worker", choices=sorted(RANK_PHASES))
    p.add_argument("--out")
    p.add_argument("--data", default=None)
    p.add_argument("--n_model", type=int, default=1)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        fail("a rank found no CUDA card")
    sys.path.insert(0, ROOT)
    from hfa_gp_tpu_torch.cli import common
    from hfa_gp_tpu_torch.parallel import distributed
    common.fp32_backends()
    distributed.TIMEOUT = datetime.timedelta(seconds=MP_DIST_TIMEOUT)
    try:
        result = RANK_PHASES[a.rank_worker](a)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)              # no waiting on the others' collectives
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hfa_gp_tpu",
                                            "tools"))
    if foreign:
        fail(f"a rank imported JAX or the JAX package: {foreign[:5]}")
    rank = os.environ["RANK"]
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"rank {rank}: {json.dumps(result)[:2000]}", flush=True)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# -- the phases ---------------------------------------------------------------


def phase_mp_setup(tmp: str) -> dict:
    """[35] the ranks' backend and device, gloo's collectives on CUDA
    tensors, one 175 MB all-reduce, and one attempt at NCCL with two ranks
    on the one card."""
    ranks, _, _ = spawn_ranks("setup", 4, os.path.join(tmp, "setup"))
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        print(f"[35] rank {r}: backend {res['backend']}, device "
              f"{res['device']}, a card of its own: {res['own_card']}",
              flush=True)
    print(f"[35] gloo on CUDA tensors: {r0['collectives']}", flush=True)
    print(f"[35] all-reduce of {MP_ALLREDUCE_BYTES / 1e6:.0f} MB over 4 "
          f"ranks sharing the card (gloo): from device memory "
          f"{r0['allreduce_ms_cuda']:.1f} ms, from host memory "
          f"{r0['allreduce_ms_cpu']:.1f} ms (rank 0, median of 3)",
          flush=True)
    if any(res["backend"] != "gloo" or res["device"] != "cuda:0"
           for res in ranks):
        fail(f"[35] ranks sharing the card should be gloo on cuda:0: "
             f"{[(x['backend'], x['device']) for x in ranks]}")
    for name in ("all_reduce", "broadcast", "all_gather_into_tensor"):
        # what the port's collectives use on the card
        if r0["collectives"][name] != "ran":
            fail(f"[35] gloo's {name} on CUDA tensors: "
                 f"{r0['collectives'][name]}")
    nres, codes, tails = spawn_ranks("nccl", 2, os.path.join(tmp, "nccl"),
                                     timeout=150, must_pass=False,
                                     env_extra={"NCCL_DEBUG": "WARN"})
    said = [re.search(r"(Duplicate GPU[^\n]*|NCCL WARN[^\n]*|"
                      r"NCCL[^\n]*[Ee]rror[^\n]*)", t) for t in tails]
    said = [m.group(0)[:300] if m else t[-300:] for m, t in zip(said, tails)]
    what = (f"ran: {nres}" if not any(codes) else
            f"refused (exit codes {codes}): {said}")
    print(f"[35] NCCL with two ranks on the one card: {what}", flush=True)
    return {"allreduce_ms": r0["allreduce_ms_cuda"],
            "allreduce_host_ms": r0["allreduce_ms_cpu"],
            "collectives": r0["collectives"], "nccl": what}


def spread(a: list[float], b: list[float]) -> float:
    """The largest relative difference between two runs' numbers."""
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def one_rank_arcface(out: str | None, touched: torch.Tensor | None = None
                     ) -> dict:
    """[36]'s command on one rank: losses, each step's labels, the table's
    checksum, the final rows of the classes `touched` (by default those
    of its own labels) and the final backbone; without `out`, also their
    initial values."""
    from hfa_gp_tpu_torch.cli import train_arcface
    states, init_w, init_bb = [], [], []
    real_init = train_arcface.arc.init_state

    def init(*x, **kw):
        states.append(real_init(*x, **kw))
        if out is None:
            init_w.append(states[-1].fc_weight.clone())
            init_bb.append(host_f64(states[-1].backbone.state_dict()))
        return states[-1]

    train_arcface.arc.init_state = init
    extra = ["--output", out, "--resume"] if out else []
    try:
        with timed_steps(train_arcface) as step_s, \
                recorded_labels(train_arcface) as labels:
            losses, launches, seconds, peak, sps = run_arcface_cli(arc_args(
                "--num_classes", str(MP_ARC_CLASSES), "--num_steps",
                str(MP_ARC_STEPS), *extra))
    finally:
        train_arcface.arc.init_state = real_init
    st = states[-1]
    if touched is None:
        touched = torch.tensor(sorted({c for x in labels for c in x}))
    dev = touched.to(st.fc_weight.device)
    res = {"losses": losses, "labels": labels, "launches": launches,
           "sps": sps, "touched": touched,
           "rows": st.fc_weight[dev].double().cpu(),
           "init_rows": init_w[0][dev].double().cpu() if init_w else None,
           "backbone": host_f64(st.backbone.state_dict()),
           "init_backbone": init_bb[0] if init_bb else None,
           "table_abs_sum": float(st.fc_weight.double().abs().sum()),
           "peak_gib": peak / GIB, "step_s": step_s}
    del st, states, init_w
    torch.cuda.empty_cache()
    return res


def host_f64(tree: dict) -> dict:
    """A state dict's floating tensors as float64 on the host."""
    return {k: v.detach().double().cpu() for k, v in tree.items()
            if v.is_floating_point()}


def moved_gap(a, ref, init) -> float:
    """Relative L2 gap of what the steps moved a tensor, or a state dict
    of them, by: |a - ref| / |ref - init|."""
    if not isinstance(ref, dict):
        a, ref, init = {"": a}, {"": ref}, {"": init}
    num = sum(float((a[k].double() - ref[k]).square().sum()) for k in ref)
    den = sum(float((ref[k] - init[k]).square().sum()) for k in ref)
    return (num / den) ** 0.5


def phase_mp_arcface(tmp: str) -> dict:
    """[36] train_arcface.main on 2 x 2 ranks (n_model 2), iresnet50 fp32,
    1,000,000 classes dense, global batch 256, MP_ARC_STEPS steps."""
    out = os.path.join(tmp, "arc")
    t0 = time.perf_counter()
    ranks, _, _ = spawn_ranks("arcface", 4, out)
    wall = time.perf_counter() - t0
    one = [one_rank_arcface(None) for _ in range(2)]
    tol = max(MP_SPREAD_FACTOR * spread(
        one[0]["losses"] + [one[0]["table_abs_sum"]],
        one[1]["losses"] + [one[1]["table_abs_sum"]]), MP_LOSS_FLOOR)
    table = ranks[0]["table_abs_sum"] + ranks[1]["table_abs_sum"]
    gap = spread(ranks[0]["losses"] + [table],
                 one[0]["losses"] + [one[0]["table_abs_sum"]])
    # the rows the labels touch, in the 2 x 2 run's final checkpoint (the
    # whole table, gathered from the shards) against the one rank's
    cdir = os.path.join(out, "run0", "checkpoint")
    touched, init_rows = one[0]["touched"], one[0]["init_rows"]
    saved = torch.load(os.path.join(cdir, f"{MP_ARC_STEPS:06d}"),
                       map_location="cpu", weights_only=True, mmap=True)
    mp_rows = saved["fc_weight"][touched].double()
    # not held to a bound: where the rows' gap comes from
    bb_gap = moved_gap(saved["backbone"], one[0]["backbone"],
                       one[0]["init_backbone"])
    bb_spread = moved_gap(one[1]["backbone"], one[0]["backbone"],
                          one[0]["init_backbone"])
    del saved
    row_tol = max(MP_SPREAD_FACTOR * moved_gap(one[1]["rows"], one[0]["rows"],
                                               init_rows), MP_ROWS_FLOOR)
    row_gap = moved_gap(mp_rows, one[0]["rows"], init_rows)
    # the data indices' labels (ranks 0 and 2) make the one rank's batch
    batches_agree = all(
        ranks[0]["labels"][t] == ranks[1]["labels"][t]
        and ranks[0]["labels"][t] + ranks[2]["labels"][t] == lab
        for t, lab in enumerate(one[0]["labels"]))
    print(f"[36] train_arcface on 2 x 2 ranks (n_model 2, one card, gloo): "
          f"{ARC_NET} fp32, {MP_ARC_CLASSES:,} classes dense, global batch "
          f"{ARC_BATCH}, {MP_ARC_STEPS} steps in {wall:.2f} s (rank "
          f"start-up, init and checkpoints included); losses "
          f"{[round(x, 5) for x in ranks[0]['losses']]}, one rank "
          f"{[round(x, 5) for x in one[0]['losses']]}; relative gap (losses "
          f"and the table's sum of |w|) {gap:.3e} against the tolerance "
          f"{tol:.3e} (x{MP_SPREAD_FACTOR:g} the one rank's run-to-run "
          f"spread, at least {MP_LOSS_FLOOR:g})", flush=True)
    print(f"[36] the {len(touched)} class rows the labels touch: what the "
          f"steps moved them by, 2 x 2 (its checkpoint) against one rank, "
          f"relative L2 gap {row_gap:.3e} against the tolerance "
          f"{row_tol:.3e} (x{MP_SPREAD_FACTOR:g} the one rank's run-to-run "
          f"{moved_gap(one[1]['rows'], one[0]['rows'], init_rows):.3e}, at "
          f"least {MP_ROWS_FLOOR:g}); the ranks' batches make the one "
          f"rank's: {batches_agree}; what the steps moved the backbone by, "
          f"relative L2 gap {bb_gap:.3e} (one rank's run-to-run "
          f"{bb_spread:.3e})", flush=True)
    for r, res in enumerate(ranks):
        print(f"[36] rank {r}: launches {res['launches']}, K5/K6 on "
              f"{res['ce_rows']} rows, samples/s {res['sps']:.1f} (global "
              f"batch), peak {res['peak_gib']:.3f} GiB, backbone "
              f"{res['backbone']}, running moments {res['stats']}, files "
              f"{res['files']}", flush=True)
    c = ranks[0]["all_reduces"]
    print(f"[36] rank 0 over the run ({MP_ARC_STEPS} steps, init and "
          f"checkpoints included): {c['n']} all-reduces, {c['wait']:.2f} s "
          f"waiting for the device before them, {c['in']:.2f} s in them; "
          f"{ranks[0]['seconds']:.2f} s in all", flush=True)
    # a step, synchronised before and after, the first one left out
    mp_ms = 1e3 * float(np.median(ranks[0]["step_s"][1:]))
    one_ms = 1e3 * float(np.median(one[0]["step_s"][1:]))
    print(f"[36] a step: 2 x 2 ranks {mp_ms:.1f} ms = "
          f"{ARC_BATCH / mp_ms * 1e3:.1f} samples/s, one rank {one_ms:.1f} "
          f"ms = {ARC_BATCH / one_ms * 1e3:.1f} samples/s (steps 2-"
          f"{MP_ARC_STEPS}); the CLI's samples/s: one rank "
          f"{one[0]['sps']:.1f}, peak {one[0]['peak_gib']:.3f} GiB",
          flush=True)
    if not gap <= tol:
        fail(f"[36] 2 x 2 ranks part from one rank by {gap:.3e} > {tol:.3e}")
    if not batches_agree:
        fail("[36] the 2 x 2 ranks' labels do not make the one rank's batch")
    if not row_gap <= row_tol:
        fail(f"[36] the touched class rows of 2 x 2 ranks part from one "
             f"rank's by {row_gap:.3e} > {row_tol:.3e}")
    expected = {**no_launches(), "flash_ce_fwd": MP_ARC_STEPS,
                "flash_ce_bwd": MP_ARC_STEPS}
    shard = MP_ARC_CLASSES // 2
    for r, res in enumerate(ranks):
        if res["launches"] != expected or res["ce_rows"] != [shard] \
                or res["table_rows"] != shard:
            fail(f"[36] rank {r} launched {res['launches']} on "
                 f"{res['ce_rows']} rows, expected {expected} on {shard}")
        if res["backbone"] != ranks[0]["backbone"]:
            fail(f"[36] rank {r}'s backbone differs from rank 0's")
        want = ["checkpoint", "training.log"] if r == 0 else None
        if res["files"] != want:
            fail(f"[36] rank {r} wrote {res['files']}, expected {want}")
    if sorted(os.listdir(cdir)) != ["000002", "000003"]:
        fail(f"[36] checkpoints {sorted(os.listdir(cdir))}")
    # one rank resumes the 2 x 2 run's step-2 checkpoint
    os.remove(os.path.join(cdir, "000003"))
    resumed = one_rank_arcface(os.path.join(out, "run0"), touched)
    rgap = spread(resumed["losses"] + [resumed["table_abs_sum"]],
                  ranks[0]["losses"][-1:] + [table])
    rrow_gap = moved_gap(resumed["rows"], mp_rows, init_rows)
    print(f"[36] one rank resumed the 2 x 2 checkpoint of step 2: step 3's "
          f"loss {resumed['losses']}, 2 x 2 {ranks[0]['losses'][-1:]}, "
          f"relative gap (with the table's sum of |w|) {rgap:.3e}; the "
          f"touched rows' moves against the 2 x 2 run's {rrow_gap:.3e}",
          flush=True)
    if len(resumed["losses"]) != 1 or not rgap <= tol \
            or not rrow_gap <= row_tol:
        fail(f"[36] the resumed run does not continue the 2 x 2 one: "
             f"{resumed['losses']}, gap {rgap:.3e} > {tol:.3e} or rows "
             f"{rrow_gap:.3e} > {row_tol:.3e}")
    return {"launches_per_rank": ranks[0]["launches"],
            "sps": ranks[0]["sps"], "step_ms": mp_ms,
            "one_rank_step_ms": one_ms,
            "peak_gib": [r["peak_gib"] for r in ranks]}


def params_moved_gap(paths_a: str, path_b: str, init) -> float:
    """Relative L2 gap of what the updates moved the params by, between
    two checkpoints of the same seeded init."""
    from hfa_gp_tpu_torch.train import checkpoint as ckpt
    a = ckpt.load_params(paths_a).state_dict()
    b = ckpt.load_params(path_b).state_dict()
    num = den = 0.0
    for k, v in init.items():
        da, db = a[k].double() - v.double(), b[k].double() - v.double()
        num += float((da - db).square().sum())
        den += float(db.square().sum())
    return (num / max(den, 1e-300)) ** 0.5


def phase_mp_rgb(tmp: str) -> dict:
    """[37] train_rgb.main on 2 ranks at full width, global batch 2, then
    run_recon_video_rgb.main on 2 ranks at batch 8."""
    from PIL import Image

    from hfa_gp_tpu_torch.cli import train_rgb
    from hfa_gp_tpu_torch.models.avatar import heads
    write_dataset(tmp, 6, split="train")
    write_dataset(tmp, MP_REENACT_BATCH, split="test2")
    ranks, _, _ = spawn_ranks("rgb", 2, os.path.join(tmp, "rgb"), "--data",
                              tmp)
    one = [run_rgb_cli(tmp, os.path.join(tmp, f"one{i}")) for i in range(2)]
    ck = f"{MP_RGB_STEPS - 1:06d}"

    def ckpt_of(exp):
        return os.path.join(exp, "dp", "checkpoint", ck)

    init = heads.init_avatar_rgb(torch.Generator().manual_seed(
        train_rgb.SEED), heads.AvatarConfig()).state_dict()
    loss = [[m[k] for m in run["losses"] for k in ("l2_loss", "lpips_loss")]
            for run in (ranks[0], ranks[1], one[0], one[1])]
    tol_loss = max(MP_SPREAD_FACTOR * spread(loss[2], loss[3]),
                   MP_LOSS_FLOOR)
    spread_p = params_moved_gap(ckpt_of(os.path.join(tmp, "one1")),
                                ckpt_of(os.path.join(tmp, "one0")), init)
    tol_p = max(MP_SPREAD_FACTOR * spread_p, MP_PARAMS_FLOOR)
    gap_loss = max(spread(loss[0], loss[2]), spread(loss[1], loss[2]))
    gap_p = params_moved_gap(ckpt_of(os.path.join(tmp, "rgb", "exps0")),
                             ckpt_of(os.path.join(tmp, "one0")), init)
    rows = [r["rows"] for r in ranks]
    print(f"[37] train_rgb on 2 ranks (one card, gloo), full width, global "
          f"batch 2, {MP_RGB_STEPS} steps: rows read {rows}, one rank "
          f"{one[0]['rows']}; (l2, lpips) {loss[0]}, one rank {loss[2]}: "
          f"gap {gap_loss:.3e} (tolerance {tol_loss:.3e}); what the steps "
          f"moved the params by, relative L2 gap {gap_p:.3e} (tolerance "
          f"{tol_p:.3e}, the one rank's own {spread_p:.3e})", flush=True)
    for r, res in enumerate(ranks):
        print(f"[37] rank {r}: launches {res['launches']}, "
              f"{res['seconds']:.2f} s, peak {res['peak_gib']:.3f} GiB, "
              f"files {res['files']}", flush=True)
    print(f"[37] one rank: launches {one[0]['launches']}, "
          f"{one[0]['seconds']:.2f} s, peak {one[0]['peak_gib']:.3f} GiB",
          flush=True)
    if sorted(rows[0] + rows[1]) != sorted(one[0]["rows"]) \
            or set(rows[0]) & set(rows[1]):
        fail(f"[37] rows {rows} are not a disjoint split of {one[0]['rows']}")
    if not gap_loss <= tol_loss or not gap_p <= tol_p:
        fail(f"[37] 2 ranks part from one: losses {gap_loss:.3e} > "
             f"{tol_loss:.3e} or params {gap_p:.3e} > {tol_p:.3e}")
    for r, res in enumerate(ranks):
        if res["launches"] != one[0]["launches"]:
            fail(f"[37] rank {r} launched {res['launches']}, one rank "
                 f"{one[0]['launches']}")
        want = ["dp"] if r == 0 else None
        if res["files"] != want:
            fail(f"[37] rank {r} wrote {res['files']}, expected {want}")

    # reenactment, batch 8 over 2 ranks
    rranks, _, _ = spawn_ranks("reenact", 2, os.path.join(tmp, "reenact"),
                               "--data", tmp)
    rone = run_reenact_cli(tmp, os.path.join(tmp, "reenact_one"))
    got = sorted(glob.glob(os.path.join(tmp, "reenact", "demo0", "dp",
                                        "*.png")))
    want = sorted(glob.glob(os.path.join(tmp, "reenact_one", "dp", "*.png")))
    diffs = [int(np.abs(np.asarray(Image.open(x), np.int16)
                        - np.asarray(Image.open(y), np.int16)).max())
             for x, y in zip(got, want)]
    print(f"[37] run_recon_video_rgb on 2 ranks at batch "
          f"{MP_REENACT_BATCH}: {len(got)} frames, largest level difference "
          f"from one rank's {diffs}; rank launches "
          f"{[r['launches'] for r in rranks]}, one rank {rone['launches']}; "
          f"files {[r['files'] for r in rranks]}", flush=True)
    if len(got) != len(want) or len(got) != MP_REENACT_BATCH \
            or max(diffs) > 1:
        fail(f"[37] frames {len(got)} of {len(want)}, level differences "
             f"{diffs}")
    per_rank = {**no_launches(), **decoder(2), "ray_marcher": 2,
                **fir(FIR_RGB)}
    for r, res in enumerate(rranks):
        if res["launches"] != per_rank:
            fail(f"[37] reenactment rank {r} launched {res['launches']}")
        if res["files"] != (["dp"] if r == 0 else None):
            fail(f"[37] reenactment rank {r} wrote {res['files']}")
    return {"launches_per_rank": ranks[0]["launches"],
            "reenact_launches_per_rank": rranks[0]["launches"]}


def phase_mp_rays(tmp: str) -> dict:
    """[38] train_rgb.main and run_recon_video_rgb.main with --n_model 2 on
    2 ranks at full width (each image's rays split over the two, which
    share the card over gloo), on [37]'s dataset, against one rank with
    the same (global) placement of the fine samples."""
    from PIL import Image

    from hfa_gp_tpu_torch.cli import train_rgb
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.models.eg3d.renderer import RenderConfig
    rays = RenderConfig().neural_rendering_resolution ** 2
    ranks, _, _ = spawn_ranks("rgb", 2, os.path.join(tmp, "rays"), "--data",
                              tmp, "--n_model", "2")
    with global_placement():
        one = [run_rgb_cli(tmp, os.path.join(tmp, f"rays_one{i}"))
               for i in range(2)]
    ck = f"{MP_RGB_STEPS - 1:06d}"

    def ckpt_of(exp):
        return os.path.join(exp, "dp", "checkpoint", ck)

    init = heads.init_avatar_rgb(torch.Generator().manual_seed(
        train_rgb.SEED), heads.AvatarConfig()).state_dict()
    loss = [[m[k] for m in run["losses"] for k in ("l2_loss", "lpips_loss")]
            for run in (ranks[0], ranks[1], one[0], one[1])]
    tol_loss = max(MP_SPREAD_FACTOR * spread(loss[2], loss[3]),
                   MP_LOSS_FLOOR)
    spread_p = params_moved_gap(ckpt_of(os.path.join(tmp, "rays_one1")),
                                ckpt_of(os.path.join(tmp, "rays_one0")), init)
    tol_p = max(MP_SPREAD_FACTOR * spread_p, MP_PARAMS_FLOOR)
    gap_loss = max(spread(loss[0], loss[2]), spread(loss[1], loss[2]))
    gap_p = params_moved_gap(ckpt_of(os.path.join(tmp, "rays", "exps0")),
                             ckpt_of(os.path.join(tmp, "rays_one0")), init)
    from hfa_gp_tpu_torch.tools.measure import card_line
    card = card_line()
    print(f"[38] train_rgb --n_model 2 on 2 ranks (ray sharding; one card, "
          f"gloo), full width, global batch 2, {MP_RGB_STEPS} steps: "
          f"(l2, lpips) {loss[0]}, one rank with the same placement "
          f"{loss[2]}: gap {gap_loss:.3e} (tolerance {tol_loss:.3e}); what "
          f"the steps moved the params by, relative L2 gap {gap_p:.3e} "
          f"(tolerance {tol_p:.3e}, the one rank's own {spread_p:.3e}); "
          f"the ranks' params after the last step: {ranks[0]['sha']} / "
          f"{ranks[1]['sha']}", flush=True)
    for r, res in enumerate(ranks):
        print(f"[38] step rank {r}: launches {res['launches']}, (batch, "
              f"rays) a launch {summarize_rays(res['rays'])}, step seconds "
              f"{res['step_s']}, peak {res['peak_gib']:.3f} GiB, files "
              f"{res['files']}", flush=True)
    print(f"[38] one rank: launches {one[0]['launches']}, (batch, rays) a "
          f"launch {summarize_rays(one[0]['rays'])}, step seconds "
          f"{one[0]['step_s']}, peak {one[0]['peak_gib']:.3f} GiB",
          flush=True)
    print(f"[38] steps/s of the second step: 2 ranks "
          f"{1 / ranks[0]['step_s'][-1]:.3f}, one rank "
          f"{1 / one[0]['step_s'][-1]:.3f} ({card}); two ranks that share "
          f"one card give no scaling figure: they take turns on it",
          flush=True)
    if not gap_loss <= tol_loss or not gap_p <= tol_p:
        fail(f"[38] 2 ranks part from one: losses {gap_loss:.3e} > "
             f"{tol_loss:.3e} or params {gap_p:.3e} > {tol_p:.3e}")
    if ranks[0]["sha"] != ranks[1]["sha"]:
        fail("[38] the two ranks' params differ after the steps")
    for r, res in enumerate(ranks):
        if res["launches"] != one[0]["launches"]:
            fail(f"[38] rank {r} launched {res['launches']}, one rank "
                 f"{one[0]['launches']}")
        check_rays(f"[38] step rank {r}", res["rays"], 2, rays // 2)
        if res["files"] != (["dp"] if r == 0 else None):
            fail(f"[38] rank {r} wrote {res['files']}")

    rranks, _, _ = spawn_ranks("reenact", 2, os.path.join(tmp, "rays_re"),
                               "--data", tmp, "--n_model", "2")
    with global_placement():
        rone = run_reenact_cli(tmp, os.path.join(tmp, "rays_re_one"),
                               warm=True)
    got = sorted(glob.glob(os.path.join(tmp, "rays_re", "demo0", "dp",
                                        "*.png")))
    want = sorted(glob.glob(os.path.join(tmp, "rays_re_one", "dp",
                                         "*.png")))
    diffs = [int(np.abs(np.asarray(Image.open(x), np.int16)
                        - np.asarray(Image.open(y), np.int16)).max())
             for x, y in zip(got, want)]
    fps = [MP_REENACT_BATCH / r["batch_s"][0] for r in (rranks[0], rone)]
    print(f"[38] run_recon_video_rgb --n_model 2 on 2 ranks at batch "
          f"{MP_REENACT_BATCH}: {len(got)} frames, largest level difference "
          f"from one rank's {diffs}; launches "
          f"{[r['launches'] for r in rranks]}, one rank {rone['launches']}; "
          f"(batch, rays) a launch {summarize_rays(rranks[0]['rays'])}, one "
          f"rank {summarize_rays(rone['rays'])}; frames/s of the batch "
          f"(after a first run) 2 ranks {fps[0]:.3f}, one rank "
          f"{fps[1]:.3f} ({card}); files {[r['files'] for r in rranks]}",
          flush=True)
    if len(got) != len(want) or len(got) != MP_REENACT_BATCH \
            or max(diffs) > 1:
        fail(f"[38] frames {len(got)} of {len(want)}, level differences "
             f"{diffs}")
    per_rank = {**no_launches(), **decoder(2), "ray_marcher": 2,
                **fir(FIR_RGB)}
    for r, res in enumerate(rranks):
        if res["launches"] != per_rank:
            fail(f"[38] reenactment rank {r} launched {res['launches']}")
        check_rays(f"[38] reenactment rank {r}", res["rays"],
                   MP_REENACT_BATCH, rays // 2)
        if res["files"] != (["dp"] if r == 0 else None):
            fail(f"[38] reenactment rank {r} wrote {res['files']}")
    return {"launches_per_rank": ranks[0]["launches"],
            "reenact_launches_per_rank": rranks[0]["launches"]}


def summarize_rays(rays: dict) -> dict:
    """{kernel: the distinct (batch, rays) of its launches}."""
    return {k: sorted({tuple(x) for x in v}) for k, v in rays.items()}


def check_rays(what: str, rays: dict, batch: int, want: int) -> None:
    """Every launch of the four avatar kernels on `batch` images of `want`
    rays each, and each kernel launched."""
    for k, v in rays.items():
        if not v and k in ("triplane_sampler", "ray_marcher"):
            fail(f"{what}: {k} never launched")
        if any(tuple(x) != (batch, want) for x in v):
            fail(f"{what}: {k} launched on (batch, rays) "
                 f"{sorted({tuple(x) for x in v})}, expected "
                 f"{(batch, want)}")


def phase_native_loader(tmp: str) -> None:
    """[39] the native image loader (`data/native_loader.py`, built from
    `csrc/hfaio.cpp` with g++) where the compiler finds libpng's and
    libjpeg's headers: PNGs and a JPEG written by PIL, decoded at 64²,
    against PIL's decode and the same bilinear resize in numpy; then a
    loader of 2 workers, each slot its index's image. Elsewhere one line
    names what is missing."""
    from PIL import Image

    from hfa_gp_tpu_torch.data import native_loader
    missing = native_loader.missing_toolchain()
    if missing:
        print(f"[39] the native image loader: not built on this machine, "
              f"whose g++ finds no {', '.join(missing)} (the build needs "
              f"libpng's and libjpeg's headers; the CPU tests build and "
              f"run it where they are)", flush=True)
        return
    rng = np.random.default_rng(SEED)
    paths = []
    for i, (h, w, mode) in enumerate(((96, 80, "RGB"), (64, 64, "L"),
                                      (50, 70, "RGBA"), (120, 90, "P"),
                                      (64, 48, "JPEG"))):
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        img = Image.fromarray(arr)
        if mode in ("L", "RGBA", "P"):
            img = img.convert(mode)
        path = os.path.join(tmp, f"img{i}" + (".jpg" if mode == "JPEG"
                                               else ".png"))
        img.save(path, **({"quality": 95} if mode == "JPEG" else {}))
        paths.append(path)
    t0 = time.perf_counter()
    native_loader.build_library()
    build_s = time.perf_counter() - t0
    errs = []
    for path in paths:
        got = native_loader.decode_image(path, 64)
        want = bilinear_like_hfaio(np.asarray(Image.open(path)
                                              .convert("RGB")), 64)
        errs.append(float(np.abs(got - want).max()))
    loader = native_loader.NativeImageLoader(paths, 64, 2, workers=2,
                                             seed=SEED, drop_last=False)
    try:
        for _ in range(3):
            imgs, idx = loader.next()
            for img, i in zip(imgs, idx):
                if not np.array_equal(img, native_loader.decode_image(
                        paths[int(i)], 64)):
                    fail(f"[39] the loader's image {int(i)} differs from "
                         "its decode")
    finally:
        loader.close()
    print(f"[39] the native image loader: built in {build_s:.2f} s; "
          f"largest difference from PIL + the same resize, in [-1, 1], "
          f"PNG (RGB, L, RGBA, P) {errs[:4]}, JPEG {errs[4]:.4f}", flush=True)
    # PNG decodes exactly; JPEG through another libjpeg's IDCT: a few levels
    if max(errs[:4]) > 1e-5 or errs[4] > 8 * 2 / 255:
        fail(f"[39] the native decode differs from PIL's: {errs}")


def bilinear_like_hfaio(rgb: np.ndarray, size: int) -> np.ndarray:
    """csrc/hfaio.cpp's resize_normalize in numpy (float32): half-pixel
    centres, edges clamped, then x·2/255 − 1."""
    h, w, _ = rgb.shape
    img = rgb.astype(np.float32)

    def axis(n_in):
        f = (np.arange(size, dtype=np.float32) + np.float32(0.5)) \
            * np.float32(n_in / size) - np.float32(0.5)
        i0 = np.floor(f).astype(np.int64)
        wgt = (f - i0).astype(np.float32)
        return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), wgt)

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    wy, wx = wy[:, None, None], wx[None, :, None]
    one = np.float32(1)
    v = (img[y0][:, x0] * (one - wx) * (one - wy)
         + img[y0][:, x1] * wx * (one - wy)
         + img[y1][:, x0] * (one - wx) * wy + img[y1][:, x1] * wx * wy)
    return v * np.float32(2.0 / 255.0) - one


def main() -> None:
    if "--rank_worker" in sys.argv:
        rank_worker(sys.argv[1:])
        return
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
        arcface_launches, arcface_sps = phase_arcface_path(tmp)
    phase_arcface_card_vs_cpu()
    arcface_steady_sps = phase_arcface_throughput()
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
    with tempfile.TemporaryDirectory() as tmp:
        convert_launches = phase_converters(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        rec_launches = phase_rec_path(tmp, {"cli": arcface_sps,
                                            "steady": arcface_steady_sps})
    phase_golden()
    with tempfile.TemporaryDirectory() as tmp:
        phase_mp_setup(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mp_arc = phase_mp_arcface(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mp_rgb = phase_mp_rgb(tmp)
        mp_rays = phase_mp_rays(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_native_loader(tmp)

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
            k["launches_rec"] = rec_launches[k["name"]]
            # [36]: each rank of 2 x 2, on its 500,000-row shard
            k["launches_2x2_per_rank"] = \
                mp_arc["launches_per_rank"][k["name"]]
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
            k["launches_converted_reenact"] = convert_launches[k["name"]]
            # [37]: each of 2 data-parallel ranks
            k["launches_dp_step_per_rank"] = \
                mp_rgb["launches_per_rank"][k["name"]]
            k["launches_dp_reenact_per_rank"] = \
                mp_rgb["reenact_launches_per_rank"][k["name"]]
            # [38]: each of 2 ranks of the model axis, on half the rays
            k["launches_ray_shard_step_per_rank"] = \
                mp_rays["launches_per_rank"][k["name"]]
            k["launches_ray_shard_reenact_per_rank"] = \
                mp_rays["reenact_launches_per_rank"][k["name"]]
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
                                            "hfa_gp_tpu", "tools"))
    if foreign:
        fail(f"imported JAX, the JAX package or its tools: {foreign[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
