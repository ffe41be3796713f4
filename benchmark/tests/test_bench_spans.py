"""`spans.py`'s split of a window's idle time by the port's spans, on
synthetic traces; the readers of the port's ranges and `program_idle`
where there is nothing to read; nested ranges under `synthesis`; and a
tiny traced run whose window holds the port's units."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import tiny
from benchmark.trace import Trace, under_ns

torch.set_num_threads(2)

RANGES = ("forward_ms", "optimizer_ms", "backbone_ms", "render_ms",
          "superres_ms", "audio_encoder_ms")

# (name, start, end, parent, unit, thread): a unit straddling the window's
# start, two units inside it with their spans, one after it
RECORD = [("X", -10, 3, None, 0, 1),
          ("U1", 10, 50, None, 1, 1), ("A", 12, 30, 1, 1, 1),
          ("B", 30, 45, 1, 1, 1),
          ("U2", 60, 90, None, 4, 1), ("C", 62, 88, 4, 4, 1),
          ("Y", 120, 130, None, 6, 1)]
BUSY = [(0, 5), (6, 7), (14, 20), (25, 28), (32, 35), (47, 48), (55, 65),
        (70, 75), (95, 100)]


def window_trace(busy=BUSY, window=(0, 100)):
    return Trace(window=window,
                 kernels=[("k", s, e, None) for s, e in busy])


def test_idle_time_is_put_down_to_the_innermost_span():
    split = spans.idle_split(RECORD, window_trace())
    # [5,6] outside; [7,14] outside, U1 before A, A; [20,25] inside A;
    # [28,32] across A and B; [35,47] B, then U1 after it; [48,55] U1's
    # end, then the loop between units; [65,70] in C; [75,95] C, U2's
    # end, the loop to the window's close
    assert split == {spans.OUTSIDE: 1 + 3 + 5 + 5,
                     spans.BETWEEN: 2 + 2 + 2 + 2,
                     "A": 2 + 5 + 2, "B": 2 + 10, "C": 5 + 13}
    assert sum(split.values()) == sum(
        e - s for s, e in spans.idle_intervals(window_trace()))


def test_units_are_the_outermost_spans_wholly_inside_the_window():
    assert spans.units(RECORD, (0, 100)) == [("U1", 10, 50), ("U2", 60, 90)]
    open_unit = RECORD[:1] + [("U3", 20, None, None, 1, 1)]
    assert spans.units(open_unit, (0, 100)) == []


def test_the_deepest_span_of_either_thread_labels_the_gap():
    record = [("U", 0, 100, None, 0, 1), ("A", 10, 90, 0, 0, 1),
              ("V", 20, 80, None, 2, 2), ("W", 30, 40, 2, 2, 2)]
    split = spans.idle_split(record, window_trace(busy=[]))
    assert split == {spans.BETWEEN: 20, "A": 70, "W": 10}


def test_a_record_outside_the_window_splits_nothing():
    assert spans.idle_split(RECORD[-1:], window_trace()) is None
    assert spans.idle_split([], window_trace()) is None


def _run(device, trace, **kw):
    return SimpleNamespace(device=torch.device(device), trace=trace,
                           attribution=kw.get("attribution"),
                           attribution_units=kw.get("units", 2))


def test_program_idle_is_the_idle_time_inside_units(monkeypatch):
    program_idle = harness.reader("program_idle.fit")
    monkeypatch.setattr(spans, "record", lambda: RECORD)
    assert program_idle.read(_run("cuda", window_trace())) \
        == pytest.approx(100.0 * (61 - 14) / 100)
    # off CUDA, without kernels, without a window, without spans in it
    assert program_idle.read(_run("cpu", window_trace())) is None
    assert program_idle.read(_run("cuda", window_trace(busy=[]))) is None
    assert program_idle.read(_run("cuda", None)) is None
    monkeypatch.setattr(spans, "record", lambda: RECORD[-1:])
    assert program_idle.read(_run("cuda", window_trace())) is None


@pytest.mark.parametrize("name", RANGES)
def test_a_range_reader_reads_nothing_in_an_empty_attribution(name):
    read = harness.reader(name).read
    assert read(_run("cuda", None)) is None
    assert read(_run("cuda", None, attribution=Trace(window=(0, 1)))) \
        is None


def _attribution(nested: bool) -> Trace:
    """`synthesis` on thread 1 with three ops, each launching a kernel;
    with `nested`, the three stage ranges around the ops."""
    ops = {1: ("synthesis", 0, 100, 1), 2: ("aten::conv", 5, 10, 1),
           3: ("aten::mul", 40, 45, 1), 4: ("aten::conv", 70, 75, 1),
           5: ("aten::add", 200, 205, 1)}
    if nested:
        ops.update({6: ("backbone", 2, 30, 1), 7: ("render", 35, 60, 1),
                    8: ("superres", 65, 95, 1)})
    kernels = [("k0", 20, 50, 2), ("k1", 45, 60, 3), ("k2", 80, 120, 4),
               ("k3", 210, 220, 5)]
    return Trace(window=(0, 300), kernels=kernels, ops=ops)


def test_nested_stage_ranges_leave_synthesis_as_it_was():
    def synthesis(t):
        return under_ns(t, lambda name: name == "synthesis")

    assert synthesis(_attribution(True)) == synthesis(_attribution(False)) \
        == (30 + 10 + 40, 3)
    run = _run("cuda", None, attribution=_attribution(True), units=2)
    parts = [harness.reader(n).read(run)
             for n in ("backbone_ms", "render_ms", "superres_ms")]
    assert parts == [pytest.approx(v / 1e6 / 2) for v in (30, 15, 40)]


def test_a_traced_run_holds_the_ports_units_in_its_window():
    out, run = tiny.run("rgb_reenact_b8", traced=True, batch=2)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"] is True, out["checks"]
    # on the CPU the device readers find nothing: no card, no kernels
    assert not {"program_idle.reenact", "backbone_ms.reenact",
                "render_ms.reenact", "superres_ms.reenact"} \
        & set(out["metrics"])
    units = spans.units(spans.record(), run.trace.window)
    assert [u[0] for u in units] == ["reenact"] * run.units
    split = spans.idle_split(spans.record(), run.trace)
    assert sum(split.values()) == run.trace.window_ns
    assert set(split) >= {spans.OUTSIDE, "encoder", "backbone", "render",
                          "superres"}
