"""The analytic FLOP and byte counts: against hand sums at full width, and
against `torch.utils.flop_counter` on the port's forward at a tiny one."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs, weights
from benchmark.counts import eg3d, encoder, lpips, marcher, sampler
from benchmark.models import hfagp
from benchmark.tests import tiny

torch.set_num_threads(2)


def config(name):
    with open(os.path.join(harness.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


RGB = config("hfagp_rgb_eg3d512")


def test_hand_sums_at_full_width():
    g = RGB["eg3d"]
    # SR block1 at 512²: conv0 transposed from 256² (256 → 128), conv1 128 →
    # 128, torgb 128 → 3, the 4x4 FIRs on conv0's output and the image,
    # three 512-wide affines
    block1 = (2 * 256 * 128 * 9 * 256 ** 2 + 2 * 128 * 16 * 512 ** 2
              + 2 * 128 * 128 * 9 * 512 ** 2 + 2 * 128 * 3 * 512 ** 2
              + 2 * 3 * 16 * 512 ** 2 + 2 * 512 * (256 + 128 + 128))
    block0 = (2 * 32 * 256 * 9 * 128 ** 2 + 2 * 256 * 16 * 256 ** 2
              + 2 * 256 * 256 * 9 * 256 ** 2 + 2 * 256 * 3 * 256 ** 2
              + 2 * 3 * 16 * 256 ** 2 + 2 * 512 * (32 + 256 + 256))
    assert eg3d.superresolution(g, 1) == block0 + block1
    # the decoder at 128² rays × 96 samples, and the rays' directions
    assert eg3d.render(g, 2) == 2 * 128 ** 2 * 96 * 2 * (32 * 64 + 64 * 33) \
        + 2 * 2 * 128 ** 2 * 9
    # the encoder's 4x4 valid conv and its five linear layers
    enc = RGB["encoder"]
    stem = 2 * 3 * 64 * 256 ** 2
    assert encoder.encoder(enc, 1) > stem + 2 * 512 * 512 * 16
    assert encoder.subspace(enc, 14, 3) == 2 * 3 * 50 * 14 * 512
    # bytes: K1 at batch 2 is 270.5 MB, K4 at N 96 444.6 MB (PERF.md's table)
    assert sampler.forward(2, 128 ** 2 * 48, 256, 256, 32) == 270_532_608
    assert marcher.forward(2 * 128 ** 2, 96, 32) == 444_596_224
    assert lpips.features(1, 64) > 0


@pytest.mark.parametrize("name", ["rgb_reenact_b8", "audio_reenact_b8"])
def test_forward_flops_match_the_flop_counter(name):
    c = tiny.cell(name, batch=2)
    cfg = c["config"]
    tree, _ = weights.make(hfagp.spec(cfg), 1, 1, "cpu")
    prog = hfagp.program(cfg)
    batch = inputs.batches(hfagp.inputs(cfg, c["traffic"], 1, "cpu"), 2)[0]
    with FlopCounterMode(display=False) as fc:
        prog.serve(prog.wrap(tree), batch)
    rc = cfg["eg3d"]["render"]
    points = rc["neural_rendering_resolution"] ** 2 * (
        rc["depth_resolution"] + rc["depth_resolution_importance"])
    # on the CPU the sampler's plain version projects each point onto the
    # three planes with an einsum; the card's kernel does not count there
    plain_projection = 2 * 2 * 3 * points * 3 * 3
    assert fc.get_total_flops() - plain_projection \
        == hfagp.forward_flops(cfg, 2)


def test_lpips_flops_match_the_flop_counter():
    from hfa_gp_tpu_torch.models import lpips as port_lpips
    tree, _ = weights.make(hfagp.aux_spec(RGB), 1, 2, "cpu")
    x = torch.rand(2, 64, 64, 3) * 2 - 1
    with FlopCounterMode(display=False) as fc:
        port_lpips.lpips_distance(tree, x, x.flip(0))
    assert fc.get_total_flops() == 2 * lpips.features(2, 64)


def test_a_units_bytes_are_its_ops_not_its_launches():
    fit, serve = sampler.unit(RGB, "fit", 2), sampler.unit(RGB, "serve", 8)
    # the coarse and the fine lookup, 48 points a ray each, at 128² rays
    assert fit["fwd"] == 2 * 270_532_608
    assert fit["bwd"] == 2 * sampler.backward(2, 128 ** 2 * 48, 256, 256, 32)
    assert set(serve) == {"fwd"}
    m = marcher.unit(RGB, "fit", 2)
    assert m["fwd"] == marcher.forward(2 * 128 ** 2, 48, 32) + 444_596_224
    assert m["bwd"] == marcher.backward_rgb(2 * 128 ** 2, 96, 32)
    assert set(marcher.unit(RGB, "serve", 1)) == {"fwd"}


class _Run:
    """What `metrics.roofline` reads of a run."""

    def __init__(self, kernels, launches, units=3):
        from benchmark import trace
        self.trace = trace.Trace(window=(0, 10 ** 9), kernels=kernels)
        self.launches, self.units = {"sampler": launches}, units
        self.config, self.traffic, self.batch = RGB, {"entry": "fit"}, 2


def test_a_roofline_follows_the_ops_through_split_launches(monkeypatch):
    from benchmark import metrics
    from benchmark.metrics import sampler_roofline
    monkeypatch.setattr(metrics, "peak", lambda key: 1e12)
    k1, k2 = "triplane_sampler_kernel", "triplane_bwd_kernel"
    whole = _Run([(k1, 0, 100, 0)] * 6 + [(k2, 0, 100, 0)] * 6, (6, 6))
    split = _Run([(k1, 0, 50, 0)] * 12 + [(k2, 0, 50, 0)] * 12, (12, 12))
    want = 100 * 3 * sum(sampler.unit(RGB, "fit", 2).values()) \
        / 1e12 / (1200 / 1e9)
    assert sampler_roofline.read(whole) == pytest.approx(want)
    assert sampler_roofline.read(split) == pytest.approx(want)
    # the trace and the port's counters disagree: nothing to read
    assert sampler_roofline.read(_Run([(k1, 0, 100, 0)] * 6, (6, 6))) is None
    # no backward counted: the forward's bytes alone
    fwd = _Run([(k1, 0, 100, 0)] * 6, (6, 0))
    assert sampler_roofline.read(fwd) == pytest.approx(
        100 * 3 * sampler.unit(RGB, "fit", 2)["fwd"] / 1e12
        / (600 / 1e9))
