"""Serving: batches of frames rendered and copied to the host, one after
another (a closed loop; each batch's frames are on the host before the
next is sent, as the reenactment CLIs hand them to `save_image`).

The window records each batch's latency, from submission to its frames
on the host. After it closes, a sample of the batches, drawn from the
seed, is rendered again by the plain reference from the same weights and
inputs; the check compares each frame, as the relative L2 distance
‖port − reference‖ / ‖reference‖, worst frame first.
"""

from __future__ import annotations

import random
import time

import torch

from .. import inputs, weights

WEIGHTS_STREAM = 1


def frame_gaps(got: torch.Tensor, want: torch.Tensor) -> list[float]:
    """Relative L2 distance of each frame (B, H, W, 3)."""
    d = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    return d.tolist()


def run(r) -> dict:
    t = r.traffic
    spec = r.adapter.spec(r.config)
    tree, _ = weights.make(spec, r.seed, WEIGHTS_STREAM, r.device)
    params = r.program.wrap(tree)
    batches = inputs.batches(r.adapter.inputs(r.config, t, r.seed, r.device),
                             t["batch"])
    r.mark("weights and inputs")
    for i in range(t["warmup"]):
        r.program.serve(params, batches[i % len(batches)]).cpu()
        r.mark("first batch" if i == 0 else "warm-up")

    # a sample of the window's batches, drawn from the seed as they come
    rng, keep, k = random.Random(r.seed), [], t["check_batches"]
    with r.window():
        i = 0
        while not r.done():
            start = time.perf_counter()
            frames = r.program.serve(params, batches[i % len(batches)]).cpu()
            r.latencies.append(time.perf_counter() - start)
            if len(keep) < k:
                keep.append((i, frames))
            elif (j := rng.randrange(i + 1)) < k:
                keep[j] = (i, frames)
            i += 1
        r.units = i
    r.attribute(lambda j: r.program.serve(
        params, batches[(i + j) % len(batches)]).cpu())
    del params
    r.release()

    ref = r.adapter.reference(r.config)
    gaps = []
    for i, got in keep:
        want = ref.serve(tree, batches[i % len(batches)]).float().cpu()
        gaps += frame_gaps(got.float(), want)
    return {"frame_gap": max(gaps)}
