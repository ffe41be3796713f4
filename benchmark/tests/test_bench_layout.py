"""A configuration, a cell and a metric added as new files in a copy of
the benchmark are found without editing any file that is there."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

PROBE = r"""
import json, sys
from benchmark import harness
c = harness.cell("rgb_live_b8x")
print(json.dumps({"config": c["config"]["note"], "traffic": c["traffic"]["batch"],
                  "limits": c["limits"], "metrics": [m["name"] for m in c["per_layer"]],
                  "reader": harness.reader("launches_seen.live").read(None)}))
"""


def test_new_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "benchmark").rglob("*") if q.is_file())}
    bench = harness.manifest()
    # a new configuration, traffic, cell, limits and metric: new files only
    cfg = json.load(open(root / "benchmark/configs/hfagp_rgb_eg3d512.json"))
    cfg["note"] = "copy"
    json.dump(cfg, open(root / "benchmark/configs/hfagp_rgb_copy.json", "w"))
    traffic = json.load(open(root / "benchmark/traffic/live_b1.json"))
    traffic["batch"] = 8
    json.dump(traffic, open(root / "benchmark/traffic/live_b8.json", "w"))
    json.dump({"frame_gap": 1.0},
              open(root / "benchmark/limits/rgb_live_b8x.json", "w"))
    (root / "benchmark/metrics/launches_seen.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "hfagp_rgb_copy", "source": "x",
                             "file": "benchmark/configs/hfagp_rgb_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "rgb_live_b8x",
                               "config": "hfagp_rgb_copy",
                               "traffic": "live_b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "launches_seen.live", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "kernels", "moves": "frame_p95_ms",
                               "workloads": ["rgb_live_b8x"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(root), os.environ.get("PYTHONPATH", "")])})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"config": "copy", "traffic": 8, "limits": {"frame_gap": 1.0},
                   "metrics": ["launches_seen.live"], "reader": 42.0}
    for p, data in before.items():           # nothing there was edited
        assert open(p, "rb").read() == data
