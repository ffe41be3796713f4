"""The EG3D GAN cell run whole on the CPU at a tiny size (the benchmark's
tiny EG3D, the discriminator at 32² with channel_base cut, batch 4, 16
density points): a sound run is correct, traced or not, and every fault
fails its limits, a fault of the density term among them. The control (TF32) changes nothing on the CPU; it is
held to the limits on the card (`test_bench_control.py`)."""

import copy

import pytest
import torch

from benchmark import faults, harness
from benchmark.models import eg3d_gan
from benchmark.tests import tiny

torch.set_num_threads(2)

NAME = "eg3d_gan_b4"
SEED = 2 ** 31 + 47


def tiny_cell():
    c = copy.deepcopy(harness.cell(NAME))
    c["config"] = tiny._merge(c["config"], {
        "eg3d": tiny.TINY["eg3d"],
        "discriminator": {"img_resolution": 32, "channel_base": 256,
                          "channel_max": 32},
        "loss": {"density_points": 16}})
    c["traffic"] = dict(c["traffic"], pool=12)
    return c


def run(seed=SEED, traced=False, program=None, seconds=0.2):
    return harness.run_cell(NAME, seed, seconds, traced, device="cpu",
                            program=program, cell_override=tiny_cell())


def test_a_sound_run_is_correct():
    out, run_ = run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run_.units > 0
    assert {"train_steps_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("kind", faults.KINDS)
def test_each_fault_is_caught(kind):
    bad = faults.planted(eg3d_gan, tiny_cell()["config"], kind)
    out, _ = run(seed=SEED + 1, program=bad)
    assert out["correct"] is False, out["checks"]


DENSITY_FAULTS = {"no_density_term": {"density_reg": 0.0},
                  "twice_the_distance": {"density_reg_p_dist": 0.008}}


@pytest.mark.parametrize("fault", sorted(DENSITY_FAULTS))
def test_a_density_fault_is_caught(fault):
    """A program trained with the density term left out, or with its
    point pairs twice as far apart, against the sound reference: Greg's
    loss, which the step hands back, fails `loss_gap`."""
    config = tiny_cell()["config"]
    bad = eg3d_gan.program(dict(config, loss=dict(config["loss"],
                                                  **DENSITY_FAULTS[fault])))
    out, _ = run(seed=SEED + 2, program=bad)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["loss_gap"]["value"] \
        > out["checks"]["loss_gap"]["limit"]


def test_a_traced_run_keeps_the_line_whole():
    out, run_ = run(traced=True, seconds=0.1)
    assert out["correct"] is True, out["checks"]
    names = {name for name, *_ in run_.attribution.ops.values()}
    assert {"train_step", "Gmain", "Dmain", "forward", "backward",
            "optimizer", "ema", "discriminator", "backbone", "render",
            "superres"} <= names
