#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`hfa_gp_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure exits non-zero before the
result line:
  1. the card (`nvidia-smi` name and power limit) and the torch/CUDA versions;
  2. the build of the CUDA kernels from `hfa_gp_tpu_torch/csrc`, timed;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, in fp32, with kernel and plain times (CUDA events,
     median of 20);
  4. the main path through its entry point, `hfa_gp_tpu_torch.cli.
     run_recon_video_rgb.main`, at full width on a 4-frame synthetic
     dataset: 4 PNGs of 512², a video, finite frames, and each kernel
     launched exactly twice per batch;
  5. one frame rendered on the card (kernels) and on the CPU (plain
     versions) from the same seeded params;
  6. steady-state frames/s of encoder → subspace → synthesis at batch 8,
     and the peak device memory (printed, not asserted).

The line before the last is a JSON summary of the kernels; the last line
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
#   card vs CPU image: fp32 sums in other orders through ~40 conv layers;
#   relative to the image's scale
E2E_RTOL = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


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
          f"(nvcc {log.get('seconds', 0.0):.2f} s)", flush=True)
    for line in log.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"    {line.strip()}", flush=True)


def main_path_points(dev: torch.device, batch: int) -> torch.Tensor:
    """(batch, 128²·48, 3) points of the coarse pass for the mean camera."""
    from hfa_gp_tpu_torch.core import camera
    from hfa_gp_tpu_torch.models.eg3d.renderer import (RenderConfig,
                                                       sample_stratified)
    rc = RenderConfig()
    label = camera.flip_yz_label(camera.sample_camera_label(None, mode=None))
    c2w, intr = camera.unpack_label(label.repeat(batch, 1).to(dev))
    o, d = camera.generate_rays(c2w, intr, rc.neural_rendering_resolution)
    depths = sample_stratified(o, rc.ray_start, rc.ray_end,
                               rc.depth_resolution)
    return (o[:, :, None] + depths * d[:, :, None]).reshape(batch, -1, 3) \
        .contiguous()


def phase_kernels(dev: torch.device) -> list[dict]:
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    g = torch.Generator().manual_seed(SEED)
    results = []

    # -- sampler: planes (2, 3, 256, 256, 32), coarse-pass points
    planes = torch.randn((2, 3, 256, 256, 32), generator=g).to(dev)
    pts = main_path_points(dev, 2)
    off = ((torch.rand((2, 65536, 3), generator=g) - 0.5) * 3.0).to(dev)
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
    ms = cuda_time_ms(lambda: triplane.sample_mean(planes, pts, 1.0))
    plain_ms = cuda_time_ms(lambda: triplane.sample_mean_plain(planes, pts,
                                                               1.0))
    print(f"    sampler: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    results.append({"name": "triplane_sampler", "route": "cuda",
                    "source": "hfa_gp_tpu_torch/csrc/triplane.cu",
                    "replaces": "hfa_gp_tpu/core/pallas/triplane.py:299",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    del planes, pts, off

    # -- marcher: (2, 16384, 96, 32), the unified pass
    b, r, n, c = 2, 16384, 96, 32
    colors = torch.rand((b, r, n, c), generator=g).to(dev)
    dens = (torch.randn((b, r, n, 1), generator=g) * 3.0).to(dev)
    depths = torch.sort(2.25 + 1.05 * torch.rand((b, r, n, 1), generator=g),
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
                 f"{name}: max abs err {e.max().item()}")
    print(f"[3] marcher kernel vs plain: max abs err {err:.3e} (bound rtol "
          f"{MARCH_RTOL:g} atol {MARCH_ATOL:g}; colors {tuple(colors.shape)})",
          flush=True)
    ms = cuda_time_ms(lambda: raymarch.ray_march(colors, dens, depths))
    plain_ms = cuda_time_ms(lambda: raymarch.ray_march_plain(colors, dens,
                                                             depths))
    print(f"    marcher: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
          flush=True)
    results.append({"name": "ray_marcher", "route": "cuda",
                    "source": "hfa_gp_tpu_torch/csrc/raymarch.cu",
                    "replaces": "hfa_gp_tpu/core/pallas/raymarch.py:27",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return results


def write_dataset(root: str, n: int = 4, size: int = 256) -> None:
    """{root}/nerface_dataset/person_3/test2/cropped_images: n PNGs and
    test.json (the layout of tests/fixtures.py), OpenCV labels of cameras
    around the mean pose."""
    from PIL import Image

    from hfa_gp_tpu_torch.core import camera
    d = os.path.join(root, "nerface_dataset", "person_3", "test2",
                     "cropped_images")
    os.makedirs(d)
    rng = np.random.default_rng(SEED)
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


def phase_main_path(tmp: str) -> dict[str, int]:
    from PIL import Image

    from hfa_gp_tpu_torch.cli import run_recon_video_rgb as cli
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
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
    triplane.LAUNCHES = 0
    raymarch.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        cli.main(args)
    finally:
        cli.reenact = reenact
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"triplane_sampler": triplane.LAUNCHES,
                "ray_marcher": raymarch.LAUNCHES}
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
    for name, count in launches.items():
        if count != 2 * n_batches:
            fail(f"{name} launched {count} times, expected {2 * n_batches}")
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
        launches = phase_main_path(tmp)
    phase_card_vs_cpu()
    phase_throughput()

    for k in kernels:
        k["launches"] = launches[k["name"]]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hfa_gp_tpu"))
    if foreign:
        fail(f"imported JAX or the JAX package: {foreign[:5]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
