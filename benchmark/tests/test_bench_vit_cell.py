"""The ViT-L arcface cell run whole on the CPU at 2 blocks, 16 classes and
batch 4 (every width of vit_l): a sound run is correct, traced or not,
and every fault and the control fail its limits."""

import copy

import pytest
import torch

from benchmark import faults, harness
from benchmark.models import arcface_vit
from hfa_gp_tpu_torch.models.arcface import vit

torch.set_num_threads(2)

NAME = "vitl_fit_b128"
TINY = "vit_l_2blocks"
SEED = 2 ** 31 + 29


@pytest.fixture(autouse=True)
def two_blocks(monkeypatch):
    monkeypatch.setitem(vit.VIT_CONFIGS, TINY,
                        vit.VIT_CONFIGS["vit_l"][:2] + (2,)
                        + vit.VIT_CONFIGS["vit_l"][3:])


def tiny_cell():
    """The cell at 2 blocks over 16 classes, batch 4, with limits of its
    own: at batch 4 the head's BatchNorm1d and AdamW's ±lr steps on
    round-off gradients carry the loss 1.5e-4–6.3e-4 and the median
    leaf's change 5.3e-5–6.0e-4 from the reference in sound runs, where
    TF32 reads 1.2e-2–1.6e-2 and 1.1e-3–1.3e-3; the first gradients read
    ≤ 8.8e-7 sound and 8.9e-4–1.5e-3 in TF32 (CPU readings, 3 and 2
    seeds)."""
    c = copy.deepcopy(harness.cell(NAME))
    c["config"]["network"].update(name=TINY, depth=2)
    c["config"]["head"]["num_classes"] = 16
    c["traffic"] = dict(c["traffic"], batch=4, pool=16)
    c["limits"] = {"loss_gap": 3e-3, "grad_gap": 3e-5, "change_gap": 3e-3}
    return c


def run(seed=SEED, traced=False, program=None, seconds=0.2):
    return harness.run_cell(NAME, seed, seconds, traced, device="cpu",
                            program=program, cell_override=tiny_cell())


def test_a_sound_run_is_correct():
    out, run_ = run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run_.units > 0
    assert {"train_steps_per_s", "setup_s"} <= set(out["metrics"])
    # head0_bn's shift, whose change head1_bn takes out, and the running
    # moments get no gradient
    assert run_.notes["leaves_left_out"] >= 5


@pytest.mark.parametrize("kind", faults.KINDS)
def test_each_fault_is_caught(kind):
    bad = faults.planted(arcface_vit, tiny_cell()["config"], kind)
    out, _ = run(seed=SEED + 1, program=bad)
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct():
    out, _ = run(seed=SEED + 2,
                 program=arcface_vit.control(tiny_cell()["config"]))
    assert out["correct"] is False, out["checks"]


def test_a_traced_run_keeps_the_line_whole():
    out, run_ = run(traced=True, seconds=0.1)
    assert out["correct"] is True, out["checks"]
    names = {name for name, *_ in run_.attribution.ops.values()}
    assert {"train_step", "forward", "embed", "attention", "mlp",
            "vit_head", "sample", "margin_ce", "backward", "optimizer",
            "head_update"} <= names
