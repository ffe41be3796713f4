"""The control on the card: the plain reference with TF32 on, in the
port's place, at each cell's own size, must come out not correct. Run on
the card with

    python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name):
    c = harness.cell(name)
    adapter = harness.module("models", c["config"]["model"])
    out, _ = harness.run_cell(name, 2 ** 31 + 101, 1.0, False,
                              program=adapter.control(c["config"]))
    assert out["correct"] is False, out["checks"]
