"""A training cell of a model that the benchmark does not ship (`toy.py`:
a classifier with integer labels, SGD with momentum, no second tree)
driven through the `fit` entry on the CPU: the harness, the faults, the
control, `calibrate.py` and the roofline helper assume no avatar."""

import pytest
import torch

from benchmark import calibrate, faults, harness, weights
from benchmark.tests import toy

torch.set_num_threads(2)

SEED = 2 ** 31 + 21


@pytest.fixture
def adapter(monkeypatch):
    toy.install(monkeypatch)
    return toy


def run(seed=SEED, traced=False, program=None):
    return harness.run_cell("toy_fit_b8", seed, 0.2, traced, device="cpu",
                            program=program, cell_override=toy.cell())


def test_a_sound_run_is_correct(adapter):
    out, run_ = run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run_.units > 0
    assert set(out["checks"]) == set(toy.LIMITS)
    assert out["metrics"]["train_steps_per_s"]["value"] > 0
    assert "setup_s" in out["metrics"]
    assert run_.notes["leaves_left_out"] == 0


@pytest.mark.parametrize("kind", faults.KINDS)
def test_each_fault_is_caught(adapter, kind):
    out, _ = run(seed=SEED + 1,
                 program=faults.planted(toy, toy.CONFIG, kind))
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct(adapter):
    out, _ = run(seed=SEED + 2, program=toy.control(toy.CONFIG))
    assert out["correct"] is False, out["checks"]


def test_a_traced_run_keeps_the_line_whole(adapter):
    out, run_ = run(traced=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"] is True, out["checks"]
    assert set(out["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert run_.attribution_units >= 2


def test_calibrate_reads_the_control_and_faults_without_a_second_tree(
        adapter):
    got = [(kind, out["correct"]) for kind, _, out, _ in calibrate.readings(
        toy.cell(), seeds=[SEED + 3], control=[SEED + 4],
        kinds=faults.KINDS, fault_seeds=[SEED + 5], seconds=0.1,
        device="cpu")]
    assert got == [("program", True), ("control", False)] \
        + [(k, False) for k in faults.KINDS]


def test_the_new_kinds_draw_a_scaled_normal_and_a_constant():
    spec = toy.spec(toy.CONFIG)
    tree, bufs = weights.make(spec, SEED, 1, "cpu")
    plain = [(p, s, "randn" if k == "normal" else
              "zeros" if k == "fill" else k, None) for p, s, k, _ in spec]
    base, _ = weights.make(plain, SEED, 1, "cpu")
    assert set(bufs) == {"randn", "rand", "const", "one"}
    # a normal of scale s is the unit normal's draw times s, in its place
    torch.testing.assert_close(tree["fc0"]["weight"],
                               base["fc0"]["weight"] * (2.0 / 32) ** 0.5,
                               rtol=0, atol=0)
    torch.testing.assert_close(tree["fc1"]["weight"],
                               base["fc1"]["weight"] * 0.01, rtol=0, atol=0)
    assert torch.all(tree["act"]["weight"] == 0.25)
    assert torch.all(tree["fc0"]["bias"] == 0)


class _Run:
    """What `metrics.roofline` reads of a run."""

    def __init__(self, kernels, launches, units=3):
        from benchmark import trace
        self.trace = trace.Trace(window=(0, 10 ** 9), kernels=kernels)
        self.launches, self.units = {"toy": launches}, units
        self.config, self.traffic, self.batch = toy.CONFIG, toy.TRAFFIC, 8


def _unit(config, entry, b):
    """A product's count: few bytes, many operations, bounded by them."""
    return {"fwd": 1_000, "fwd_ops": 4e9, "bwd": 2_000, "bwd_ops": 8e9,
            "ops_peak": "fp32_flops"}


def test_a_roofline_over_operations_reads_a_share(monkeypatch):
    from benchmark import metrics
    rates = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}
    monkeypatch.setattr(metrics, "peak", rates.get)
    # 3 units of 4 and 8 GFLOP at 67 TFLOP/s: 0.537 ms; the kernels 0.6 ms
    run_ = _Run([("toy_fwd", 0, 100_000, 0)] * 3
                + [("toy_bwd", 0, 100_000, 0)] * 3, (3, 3))
    share = metrics.roofline(run_, "toy", ("toy_",), _unit)
    assert 0 < share <= 105
    assert share == pytest.approx(100 * 3 * 12e9 / 67e12 / 600e-6)
    # by bytes alone the bound would be a thousandth of a percent
    bytes_only = metrics.roofline(
        run_, "toy", ("toy_",),
        lambda *a: {k: v for k, v in _unit(*a).items()
                    if k in ("fwd", "bwd")})
    assert bytes_only == pytest.approx(100 * 3 * 3_000 / 3.35e12 / 600e-6)
    # a peak the table lacks: nothing to read
    monkeypatch.setattr(metrics, "peak", {"hbm_bytes_per_s": 3.35e12}.get)
    assert metrics.roofline(run_, "toy", ("toy_",), _unit) is None
