"""The arcface cell on the CPU: the plain reference against the port's
step, the class sampler's rule against the port's, whole runs of a tiny
copy of the cell with each fault and the control, the counts against
`torch.utils.flop_counter`, the readers' kernel names, and the
reference's independence of the port."""

import copy
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import faults, harness, inputs, weights
from benchmark.counts import flash_ce as ce_counts
from benchmark.counts import iresnet as iresnet_counts
from benchmark.models import arcface
from benchmark.reference import arcface as ref

torch.set_num_threads(2)

NAME = "arcface_fit_b256"
RAND = torch.rand            # before any test plants a draw in its place
FULL = harness.cell(NAME)["config"]
SEED = 2 ** 31 + 31


def config(network="iresnet50", classes=200, size=32):
    """The cell's configuration at a small size: another depth, fewer
    classes, smaller crops; every width as it is."""
    c = copy.deepcopy(FULL)
    c["network"].update(name=network, input_size=size)
    c["head"]["num_classes"] = classes
    return c


def tiny_cell():
    """The cell with iresnet18 over 64 classes at 32² crops, batch 8."""
    c = harness.cell(NAME)
    c["config"] = config("iresnet18", 64)
    c["traffic"] = dict(c["traffic"], batch=8, pool=32)
    return c


def run(seed=SEED, traced=False, program=None, seconds=0.2):
    return harness.run_cell(NAME, seed, seconds, traced, device="cpu",
                            program=program, cell_override=tiny_cell())


def _trainers(cfg, batch, seed=3):
    spec = arcface.spec(cfg)
    paths = [p for p, *_ in spec]
    tree, bufs = weights.make(spec, seed, 1, "cpu")
    ref_tree, _ = weights.clone(spec, bufs)
    traffic = {"entry": "fit", "batch": batch, "pool": 4 * batch}
    batches = inputs.batches(arcface.inputs(cfg, traffic, seed, "cpu"), batch)
    port = arcface.program(cfg).trainer(tree, None, paths)
    plain = arcface.reference(cfg).trainer(ref_tree, None, paths)
    return paths, port, plain, batches


def test_a_step_matches_the_port():
    # batch 8: BatchNorm1d over two rows normalises each column to ±1 and
    # amplifies the trunk's round-off (a loss gap of 4e-6 at batch 2)
    paths, port, plain, batches = _trainers(config(), 8)
    before = [p.detach().clone() for p in plain.leaves]
    got, want = port.step(batches[0]), plain.step(batches[0])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    grads = list(zip(paths, port.first_grads(), plain.first_grads()))
    scale = max(float(h.norm()) for _, _, h in grads)
    for path, g, h in grads:
        # a leaf under a BatchNorm gets a gradient of round-off alone where
        # the normalisation takes its shift out (the FC's bias)
        torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-6 * scale,
                                   msg=path)
    ulp = torch.finfo(torch.float32).eps
    for path, p, q, p0 in zip(paths, port.leaves, plain.leaves, before):
        # each change to within rounding of the leaf's own values
        torch.testing.assert_close(
            p.detach() - p0, q.detach() - p0, rtol=1e-4,
            atol=4 * ulp * float(p0.abs().max()) + 1e-7 * scale, msg=path)
    moved = [not torch.equal(q.detach(), p0)
             for q, p0 in zip(plain.leaves, before)]
    assert all(moved[i] for i, p in enumerate(paths)
               if not p.startswith("fc_weight"))
    # only the sampled rows of the table and their momentum moved
    table = paths.index("fc_weight")
    rows = (plain.leaves[table] != before[table]).any(1).nonzero()[:, 0]
    assert len(rows) == ce_counts.sampled(200, 0.2, 8) == 40
    assert set(batches[0]["label"].tolist()) <= set(rows.tolist())


def test_the_spec_has_the_port_layout():
    from hfa_gp_tpu_torch.models.arcface import iresnet
    cfg = config("iresnet18", 64)
    p, st = iresnet.init_iresnet(torch.Generator().manual_seed(0),
                                 "iresnet18", 512, 32)
    want = {f"backbone/{k.replace('.', '/')}": v
            for k, v in p.named_parameters()}
    want |= {f"batch_stats/{k.replace('.', '/')}": v
             for k, v in st.named_parameters()}
    tree, _ = weights.make(arcface.spec(cfg), 0, 1, "cpu")
    got = dict(weights.leaves(tree))
    assert got.pop("fc_weight").shape == (64, 512)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        for const in (0.0, 1.0, 0.25):      # leaves the port sets
            if torch.all(want[k] == const) and want[k].numel() > 1:
                assert torch.all(v == const), k
        if v.dim() == 4:                     # kaiming normal, fan out
            std = (2.0 / (v.shape[0] * v.shape[2] * v.shape[3])) ** 0.5
            assert float(v.std()) == pytest.approx(std, rel=0.2), k


def _port_sample(labels, draw, k, monkeypatch):
    """The port's `_sample_shard_indices` on a planted draw."""
    from hfa_gp_tpu_torch.parallel import partial_fc
    monkeypatch.setattr(torch, "rand", lambda *a, **kw: draw.clone())
    n = draw.shape[0]
    return partial_fc._sample_shard_indices(labels, None, n, k)


@pytest.mark.parametrize("levels", [None, 8, 3])
def test_the_sampler_follows_the_written_rule(monkeypatch, levels):
    """The same sets from the port and the reference; `levels` draws
    from that many values, so that the k-th draw ties many others."""
    g = torch.Generator().manual_seed(SEED)
    for _ in range(5):
        draw = RAND((5000,), generator=g)
        if levels:
            draw = torch.floor(draw * levels) / levels
        labels = torch.randint(5000, (64,), generator=g)
        want = ref.sample(labels, draw, 1000)
        got = _port_sample(labels, draw, 1000, monkeypatch)
        assert torch.equal(got, want)
        assert len(want) == 1000 and set(labels.tolist()) <= set(
            want.tolist())


def test_a_tie_goes_to_the_lower_class(monkeypatch):
    draw = torch.tensor([0.5, 0.9, 0.5, 0.5, 0.1, 0.5, 0.7])
    labels = torch.tensor([4, 4])
    want = torch.tensor([0, 1, 4, 6])      # 4, then 0.9, 0.7, the first 0.5
    assert torch.equal(ref.sample(labels, draw, 4), want)
    assert torch.equal(_port_sample(labels, draw, 4, monkeypatch), want)


def test_a_sound_run_is_correct():
    out, run_ = run()
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run_.units > 0
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert {"train_steps_per_s", "setup_s"} <= set(out["metrics"])
    # the running moments get no gradient and are left out of change_gap,
    # as are the shifts whose change a later BatchNorm takes out
    assert run_.notes["leaves_left_out"] > sum(
        p.startswith("batch_stats/")
        for p, *_ in arcface.spec(tiny_cell()["config"]))


@pytest.mark.parametrize("kind", faults.KINDS)
def test_each_fault_is_caught(kind):
    bad = faults.planted(arcface, tiny_cell()["config"], kind)
    out, _ = run(seed=SEED + 1, program=bad)
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct():
    out, _ = run(seed=SEED + 2,
                 program=arcface.control(tiny_cell()["config"]))
    assert out["correct"] is False, out["checks"]


def test_a_traced_run_keeps_the_line_whole():
    out, run_ = run(traced=True, seconds=0.1)
    assert out["correct"] is True, out["checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert run_.attribution_units >= 2 and run_.attribution.ops
    names = {name for name, *_ in run_.attribution.ops.values()}
    assert {"train_step", "forward", "embed", "sample", "margin_ce",
            "backward", "optimizer", "head_update"} <= names


def test_the_trunk_flops_match_the_flop_counter():
    from hfa_gp_tpu_torch.models.arcface import iresnet
    for name, size, b in (("iresnet18", 32, 2), ("iresnet50", 112, 1)):
        net = dict(FULL["network"], name=name, input_size=size)
        p, st = iresnet.init_iresnet(torch.Generator().manual_seed(0), name,
                                     512, size)
        x = torch.rand(b, size, size, 3) * 2 - 1
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            iresnet.iresnet_apply(p, st, x, name, train=True)
        assert fc.get_total_flops() == iresnet_counts.forward(net, b), name
    # iresnet50 at 112²: 12.62 GFLOP an image
    assert iresnet_counts.forward(FULL["network"], 1) == 12_618_661_888


def test_a_steps_flops_match_the_flop_counter():
    """The port's step on the CPU, whose CE is the kernels' plain version:
    the trunk's forward and backward but the stem's input gradient, which
    no one asks for, and the cosines' product forward and back."""
    cfg = config("iresnet18", 64)
    _, port, _, batches = _trainers(cfg, 4)
    with FlopCounterMode(display=False) as fc:
        port.step(batches[0])
    assert fc.get_total_flops() + iresnet_counts.stem(cfg["network"], 4) \
        == arcface.flops(cfg, "fit", 4)


def test_the_ce_counts_match_the_flop_counter():
    from hfa_gp_tpu_torch.core.kernels import flash_ce
    b, k, d = 4, 300, 64
    ne = torch.nn.functional.normalize(torch.randn(b, d), dim=1) \
        .requires_grad_(True)
    w = torch.randn(k, d).requires_grad_(True)
    lab = torch.randint(k, (b,), dtype=torch.int32)
    with FlopCounterMode(display=False) as fwd:
        se, tgt = flash_ce.flash_ce_stats(ne, w, lab, 64.0)
    with FlopCounterMode(display=False) as bwd:
        (se.sum() + tgt.sum()).backward()
    cfg = copy.deepcopy(FULL)
    cfg["network"]["embedding_size"] = d
    cfg["head"].update(num_classes=k, sample_rate=1.0)
    unit = ce_counts.unit(cfg, "fit", b)
    assert fwd.get_total_flops() == unit["fwd_ops"]
    # the plain backward's two products (the kernel's recompute of the
    # cosines is not counted)
    assert bwd.get_total_flops() == unit["bwd_ops"]
    assert unit["ops_peak"] == "fp32_flops"
    # at the cell's size: 411,981 rows, 108.0 and 216.0 GFLOP a step
    full = ce_counts.unit(FULL, "fit", 256)
    assert ce_counts.sampled(2_059_906, 0.2, 256) == 411_981
    assert full["fwd_ops"] == 2 * 256 * 411_981 * 512
    assert full["bwd_ops"] == 2 * full["fwd_ops"]
    assert set(ce_counts.unit(FULL, "serve", 8)) == {"fwd", "fwd_ops",
                                                      "ops_peak"}


class _Run:
    """What `metrics.roofline` reads of a run."""

    def __init__(self, kernels, launches, units=2):
        from benchmark import trace
        self.trace = trace.Trace(window=(0, 10 ** 9), kernels=kernels)
        self.launches, self.units = {"flash_ce": launches}, units
        self.config, self.traffic, self.batch = FULL, {"entry": "fit"}, 256


def test_the_ce_roofline_reads_one_kernel_a_launch(monkeypatch):
    from benchmark import metrics
    from benchmark.metrics import ce_roofline
    rates = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12}
    monkeypatch.setattr(metrics, "peak", rates.get)
    fwd = ("hfa_ce::flash_ce_fwd_kernel(float const*, float const*, int "
           "const*, float*, float*, int, int, long, int, float, int)")
    bwd = "void hfa_ce::flash_ce_bwd_kernel<false, 0>(float const*, ...)"
    helpers = ["hfa_ce::flash_ce_reduce_kernel(float const*, ...)",
               "hfa_ce::transpose_embeddings_kernel(float const*, ...)",
               "hfa_ce::tc::flash_ce_bwd_bf16_kernel(...)"]
    step = [(fwd, 0, 3_000_000, 0), (bwd, 0, 9_000_000, 0)] \
        + [(h, 0, 50_000, 0) for h in helpers]
    share = ce_roofline.read(_Run(step * 2, (2, 2)))
    unit = ce_counts.unit(FULL, "fit", 256)
    want = 100 * 2 * (unit["fwd_ops"] + unit["bwd_ops"]) / 67e12 / 24e-3
    assert share == pytest.approx(want) and 0 < share <= 105
    # a count that disagrees with the port's launches: nothing to read
    assert ce_roofline.read(_Run(step * 2, (2, 1))) is None


def test_rows_ms_reads_the_sample_and_head_update_spans():
    from benchmark import trace
    from benchmark.metrics import rows_ms

    class R:
        attribution_units = 2
        attribution = trace.Trace(
            window=(0, 1000),
            kernels=[("gather", 10, 30, 1), ("sgd", 60, 100, 2),
                     ("conv", 110, 200, 3)],
            ops={1: ("aten::index", 5, 6, 7), 2: ("aten::mul", 50, 51, 7),
                 3: ("aten::conv", 105, 106, 7),
                 4: ("sample", 0, 8, 7), 5: ("head_update", 40, 55, 7),
                 6: ("embed", 100, 108, 7)})

    assert rows_ms.read(R) == pytest.approx((20 + 40) / 1e6 / 2)


def test_the_reference_and_counts_load_without_the_port():
    code = ("import sys; import benchmark.reference.arcface, "
            "benchmark.counts.iresnet, benchmark.counts.flash_ce; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('hfa_gp_tpu_torch', 'hfa_gp_tpu', "
            "'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
