"""Two checkouts of the repository on one card, in one process tree: the
hand-written kernels' times and the three paths' steady-state throughputs,
measured in turns (A, B, B, A) so that the card, its power limit and its
neighbours are the same for both.

    python -m hfa_gp_tpu_torch.tools.compare_trees --trees _chip/parent .

Each turn is a subprocess started in the checkout's root, which imports
that checkout's `chip_smoke.py` and package, builds that checkout's
kernels, and prints (the kernels timed in both turns by this file's own
`measure.device_ms`: CUDA events around about 2 ms of back-to-back calls,
median of 20):
  * K1 (the sampler's forward) and K2 (its backward: with the points'
    layout where the checkout's wrapper takes one, without it, and on
    shuffled points) at batch 2 and batch 8, K4 (the marcher) and K4' (its
    backward, under rgb's cotangent alone and under all three) at N 48
    and 96, K5 and K6 (the flash-CE statistics) at C 1,000,000 and
    300,000;
  * `chip_smoke.py`'s phases [6] (reenactment frames/s at batch 8) and
    [12] (arcface samples/s, dense and row-sparse), as they print
    themselves, and [9] (RGB fitting steps/s at batch 2) over 40 steps
    instead of its 5, because that step's time is the host's.
To compare a commit with its parent, unpack the parent with `git archive`
into a directory that `.gitignore` lists (`_chip/parent`).
"""

from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys


def worker() -> None:
    """One turn, in the current directory's checkout."""
    sys.path.insert(0, os.getcwd())
    import importlib.util

    import torch

    # the timer of this file's checkout, whichever checkout is measured
    spec = importlib.util.spec_from_file_location(
        "_measure", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "measure.py"))
    measure = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(measure)

    import chip_smoke as cs
    from hfa_gp_tpu_torch.cli import common
    from hfa_gp_tpu_torch.core.kernels import flash_ce, raymarch, triplane
    common.fp32_backends()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(cs.SEED)
    print(cs.phase_card(), flush=True)
    # a checkout from before the layout argument times K2 without it only
    has_layout = "layout" in inspect.signature(
        triplane.sample_mean_backward).parameters
    for batch in (2, 8):
        planes = torch.randn((batch, 3, 256, 256, 32), generator=g).to(dev)
        pts = cs.main_path_points(dev, batch)
        ms = measure.device_ms(lambda: triplane.sample_mean(planes, pts, 1.0))
        print(f"K1 sampler forward, batch {batch}: {ms:.4f} ms", flush=True)
        cot = torch.randn((batch, pts.shape[1], 32), generator=g).to(dev)
        perm = torch.randperm(pts.shape[1], generator=g).to(dev)
        cases = {"no layout": (cot, pts, {}),
                 "shuffled points": (cot[:, perm].contiguous(),
                                     pts[:, perm].contiguous(), {})}
        if has_layout:
            cases["layout"] = (cot, pts, {"layout": (128, 128, 48)})
        for name, (ct, p, kw) in cases.items():
            ms = measure.device_ms(lambda: triplane.sample_mean_backward(
                ct, planes.shape, p, 1.0, **kw))
            print(f"K2 sampler backward, batch {batch}, {name}: {ms:.4f} ms",
                  flush=True)
        del planes, pts, cot, perm, cases
    b, r, c = 2, 16384, 32
    for n in (48, 96):
        colors = torch.rand((b, r, n, c), generator=g).to(dev)
        dens = (torch.randn((b, r, n, 1), generator=g) * 3.0).to(dev)
        depths = torch.sort(2.25 + 1.05 * torch.rand((b, r, n, 1),
                                                      generator=g),
                            dim=2).values.to(dev)
        ms = measure.device_ms(lambda: raymarch.ray_march(colors, dens, depths))
        print(f"K4 marcher forward, N {n}: {ms:.4f} ms", flush=True)
        out = raymarch.ray_march(colors, dens, depths)
        cots = [torch.randn(x.shape, generator=g).to(dev) for x in out]
        for name, used in (("rgb's cotangent alone", (cots[0], None, None)),
                           ("all three cotangents", cots)):
            ms = measure.device_ms(lambda: raymarch.ray_march_backward(
                colors, dens, depths, *used))
            print(f"K4' marcher backward, N {n}, {name}: {ms:.4f} ms",
                  flush=True)
        del colors, dens, depths, out, cots
    s, b, d = 64.0, 256, 512
    for c in (1_000_000, 300_000):
        ne, w, lab = cs.ce_inputs(dev, g, b, d, c)
        se, _ = flash_ce.flash_ce_stats(ne, w, lab, s)
        ct_se = (torch.randn((b,), generator=g).to(dev) / se).contiguous()
        ct_tgt = torch.randn((b,), generator=g).to(dev)
        k5 = measure.device_ms(lambda: flash_ce.flash_ce_stats(ne, w, lab, s))
        k6 = measure.device_ms(lambda: flash_ce.flash_ce_stats_backward(
            ne, w, lab, s, None, ct_se, ct_tgt))
        print(f"K5 flash-CE forward, C {c}: {k5:.4f} ms; K6 flash-CE "
              f"backward: {k6:.4f} ms", flush=True)
        del ne, w, lab
    torch.cuda.empty_cache()
    cs.phase_throughput()
    rgb_steps(cs)
    cs.phase_arcface_throughput()


def rgb_steps(cs, iters: int = 40, warmup: int = 3) -> None:
    """[9] over more steps than `chip_smoke.py` takes: the RGB step is
    bound by the host's launches, whose time spreads by a few per cent from
    one run of five steps to the next."""
    import time

    import numpy as np
    import torch

    from hfa_gp_tpu_torch.train import rgb
    cfg, state, lp, image, label = cs.train_setup("cuda", 2)
    times = []
    for _ in range(warmup + iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgb.train_step(state, lp, cfg, image, label, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = np.array(times[warmup:]) * 1e3
    print(f"[9] training, batch 2, generator unfrozen, {iters} steps: median "
          f"{np.median(ms):.2f} ms ({1e3 / np.median(ms):.3f} steps/s), mean "
          f"{ms.mean():.2f}, fastest {ms.min():.2f}, slowest {ms.max():.2f}",
          flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--trees", nargs=2, default=["_chip/parent", "."],
                   help="roots of the two checkouts, A then B")
    p.add_argument("--worker", action="store_true")
    args = p.parse_args()
    if args.worker:
        worker()
        return
    a, b = (os.path.abspath(t) for t in args.trees)
    for tree in (a, b, b, a):
        print(f"=== {tree}", flush=True)
        # this file by its path: the other checkout may not have it
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"], cwd=tree)
        if done.returncode != 0:
            raise SystemExit(f"the turn in {tree} failed "
                             f"({done.returncode})")


if __name__ == "__main__":
    main()
