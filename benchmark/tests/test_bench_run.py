"""Whole runs of each entry on the CPU at a tiny size: the result line's
keys, `correct` on a sound run, `correct` false with each fault the cell
can have planted in the port, the JAX guard, and the command's refusal
without a card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
from benchmark.models import hfagp
from benchmark.tests import tiny

torch.set_num_threads(2)

CELLS = {"rgb_fit_b2": {}, "rgb_reenact_b8": {"batch": 2},
         "audio_reenact_b8": {"batch": 2}, "rgb_live_b1": {}}


@pytest.mark.parametrize("name", list(CELLS))
def test_a_sound_run_is_correct(name):
    out, run = tiny.run(name, seed=2 ** 31 + 5, **CELLS[name])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run.units > 0
    assert set(out["checks"]) == set(harness.cell(name)["limits"])
    assert "setup_s" in out["metrics"]


def _faults(name):
    kinds = list(faults.KINDS)
    if harness.cell(name)["traffic"]["batch"] == 1:
        kinds.remove("half_batch")         # a batch of one has no half
    return [(name, k) for k in kinds]


@pytest.mark.parametrize("name,kind",
                         [f for n in CELLS for f in _faults(n)])
def test_each_fault_is_caught(name, kind):
    c = tiny.cell(name, **CELLS[name])
    bad = faults.planted(hfagp, c["config"], kind)
    out, _ = tiny.run(name, seed=11, program=bad, **CELLS[name])
    assert out["correct"] is False, out["checks"]


def test_a_traced_run_keeps_the_line_whole():
    out, run = tiny.run("rgb_reenact_b8", traced=True, batch=2)
    assert set(out["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
    # the host's operations are recorded after the window, not in it
    assert run.attribution_units >= 2 and run.attribution.ops


@pytest.mark.parametrize("name", ["rgb_fit_b2", "rgb_live_b1"])
def test_set_up_is_timed_phase_by_phase(name):
    _, run = tiny.run(name, seconds=0.1, **CELLS[name])
    names = [p for p, _ in run.phases]
    assert names[:3] == ["imports", "device and port", "weights and inputs"]
    assert names[-1] == "warm-up"
    ages = [a for _, a in run.phases] + [run.setup_s]
    assert ages == sorted(ages)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hfa_gp_tpu_torch_x", sys)
    assert "hfa_gp_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hfa_gp_tpu.core", sys)
    assert harness.forbidden_modules() == ["hfa_gp_tpu.core"]


def test_no_port_module_loads_jax():
    code = ("import sys; from benchmark import harness; "
            "from benchmark.tests import tiny; "
            "tiny.run('rgb_live_b1', seconds=0.1); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "rgb_live_b1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_the_result_line_is_json_with_checks_last():
    out, _ = tiny.run("rgb_live_b1", seconds=0.1)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
