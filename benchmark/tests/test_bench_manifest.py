"""BENCHMARK.json against the contract's rules, and every file it names
found by name."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank|_size|_channels|_width)$|expansion|per_tok")
BENCH = harness.manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]


def _named():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_named()),
                         ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_names_units_and_keys(group, entry):
    assert NAME.match(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source",
                              "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves", "workloads"}}[group]
    assert set(entry) <= allowed
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for text in ("why", "layer", "source"):
        if text in entry:
            assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    if group == "workloads":
        assert entry["chips"] == 1
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_names_unique_and_bounds():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_its_metrics_need():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]], (m["name"], w)
    for w in cells:
        reports = [n for n, ws in e2e.items() if w in ws]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= perf_layers()


def perf_layers() -> set:
    """The layers that `PERF.md` §3's table names: the first column of the
    table whose header begins "| Layer"."""
    with open(os.path.join(harness.ROOT, "PERF.md")) as f:
        section = f.read().split("\n## 3.", 1)[1].split("\n## ", 1)[0]
    names, inside = set(), False
    for line in section.splitlines():
        if line.startswith("| Layer"):
            inside = True
        elif inside and line.startswith("|"):
            if not line.startswith("|---"):
                names.add(line.split("|")[1].strip())
        elif inside:
            break
    return names


def test_the_layer_table_is_read():
    assert {"device", "kernels"} <= perf_layers()


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(name):
    c = harness.cell(name)
    assert harness.module("models", c["config"]["model"])
    assert harness.module("entries", c["traffic"]["entry"])
    assert set(c["limits"])
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_configs_state_source_changes_assumptions_and_precision():
    for entry in BENCH["configs"]:
        path = os.path.join(harness.ROOT, entry["file"])
        assert entry["file"].startswith("benchmark/configs/")
        with open(path) as f:
            cfg = json.load(f)
        assert {"source", "precision", "changed", "assumed",
                "reduced"} <= set(cfg)
        # a cut of scale is listed alike in both, is never a width, and
        # the file states the deployment that the cut stands for
        reduced = entry["reduced"]
        assert sorted(cfg["reduced"]) == sorted(reduced)
        assert len(reduced) <= 16 and len(set(reduced)) == len(reduced)
        for key in reduced:
            assert NAME.match(key) and not WIDTH.search(key), key
        if reduced:
            deployment = cfg["assumed"].get("deployment")
            assert isinstance(deployment, str) and deployment.strip()
