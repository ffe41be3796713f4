"""The ViT-L arcface cell of the benchmark (`vitl_fit_b128`'s files under
`benchmark/`) on the CPU, at every width of vit_l (768, 8 heads of 96,
an MLP of 3,072, 144 tokens) but 2 blocks, 16 classes and batch 4: the
port's step against the plain reference over three steps, the order of
the draws, the counts against `torch.utils.flop_counter`, the port's
`TOKENS` counter and its three spans, the span readers, and the
reference's independence of the port."""

import copy
import math
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs, weights
from benchmark.counts import vit as vit_counts
from benchmark.models import arcface_vit
from benchmark.reference import vit as ref
from hfa_gp_tpu_torch.models.arcface import vit
from hfa_gp_tpu_torch.utils import observability

torch.set_num_threads(2)

NAME = "vitl_fit_b128"
FULL = harness.cell(NAME)["config"]
TINY = "vit_l_2blocks"          # vit_l's widths and rates, 2 blocks
SEED = 2 ** 31 + 23
BATCH = 4


@pytest.fixture
def tiny(monkeypatch):
    """The cell's configuration at 2 blocks over 16 classes, its network a
    test-local entry of the port's `VIT_CONFIGS`."""
    monkeypatch.setitem(vit.VIT_CONFIGS, TINY,
                        vit.VIT_CONFIGS["vit_l"][:2] + (2,)
                        + vit.VIT_CONFIGS["vit_l"][3:])
    c = copy.deepcopy(FULL)
    c["network"].update(name=TINY, depth=2)
    c["head"]["num_classes"] = 16
    return c


def _trainers(cfg, seed=3):
    spec = arcface_vit.spec(cfg)
    paths = [p for p, *_ in spec]
    tree, bufs = weights.make(spec, seed, 1, "cpu")
    ref_tree, _ = weights.clone(spec, bufs)
    traffic = {"entry": "fit", "batch": BATCH, "pool": 3 * BATCH}
    batches = inputs.batches(arcface_vit.inputs(cfg, traffic, seed, "cpu"),
                             BATCH)
    port = arcface_vit.program(cfg).trainer(tree, None, paths)
    plain = arcface_vit.reference(cfg).trainer(ref_tree, None, paths)
    return paths, port, plain, batches


def _sync(paths, port, plain):
    """The reference's leaves and AdamW moments set to the port's."""
    st = port.state.optimizer.state
    run = plain.run
    trunk = [p for path, p in zip(paths, port.leaves)
             if path.startswith("backbone/")]
    with torch.no_grad():
        for p, q in zip(port.leaves, plain.leaves):
            q.copy_(p)
        for i, p in enumerate(trunk):
            if p in st:
                run.m[i] = st[p]["exp_avg"].clone()
                run.v[i] = st[p]["exp_avg_sq"].clone()
        run.table_m.copy_(port.state.fc_opt_state["m"])
        run.table_v.copy_(port.state.fc_opt_state["v"])


def test_three_steps_match_the_reference(tiny):
    """Each of three steps from the port's state, the reference set to it
    first: without that, AdamW's first step moves an element whose
    gradient is round-off by ±lr, and the reference run against itself
    from weights perturbed by 1e-7 drifts 2.2e-5 in the second step's loss
    and 6.8e-4 in the third's."""
    paths, port, plain, batches = _trainers(tiny)
    start = [p.detach().clone() for p in plain.leaves]
    for k in range(3):
        if k:
            _sync(paths, port, plain)
        before = [p.detach().clone() for p in port.leaves]
        got, want = port.step(batches[k]), plain.step(batches[k])
        # the same sums in another order: 1.2e-7 to 4.6e-7
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0,
                                   msg=f"step {k}")
        if k == 0:
            grads = list(zip(paths, port.first_grads(), plain.first_grads()))
            scale = max(float(h.norm()) for _, _, h in grads)
            for path, g, h in grads:
                # the first moment, (1 − β1) × the clipped gradient; a leaf
                # whose shift a later norm takes out gets round-off alone
                torch.testing.assert_close(g, h, rtol=1e-4,
                                           atol=1e-6 * scale, msg=path)
            norms = torch.tensor([float(h.norm()) for _, _, h in grads])
            reached = norms >= 1e-3 * norms[norms > 0].median()
        for path, p, q, p0, r in zip(paths, port.leaves, plain.leaves, before,
                                     reached):
            if not r:
                continue
            d_port, d_ref = p.detach() - p0, q.detach() - p0
            # AdamW moves an element whose gradient and moments are
            # round-off by ±lr in either package: up to 4.4e-3 of a leaf's
            # change at 1 and 4 threads; a weight decay left out reads
            # 0.10–0.17 on the norms' scales (weights of 1)
            gap = float((d_port - d_ref).norm() / d_ref.norm())
            assert gap <= 1e-2, (k, path, gap)
    # every trained leaf moved; the table only in the rows sampled
    for i, path in enumerate(paths):
        if path.startswith("backbone/"):
            assert not torch.equal(plain.leaves[i].detach(), start[i]), path
    table = paths.index("fc_weight")
    moved = (plain.leaves[table] != start[table]).any(1)
    assert torch.equal(moved, (port.leaves[table] != start[table]).any(1))
    assert 4 <= int(moved.sum()) < 16


def test_the_draws_come_in_the_ports_order(tiny, monkeypatch):
    """Masking and drop path at rates that always show: the same seed gives
    the reference the port's kept tokens and keep masks (the same
    embeddings, the generator left in the same state), another seed
    does not."""
    rates = vit.VIT_CONFIGS[TINY][:5] + (0.5, 0.5)
    monkeypatch.setitem(vit.VIT_CONFIGS, TINY, rates)
    net = dict(tiny["network"], drop_path_rate=0.5, mask_ratio=0.5)
    spec = arcface_vit.spec(tiny)
    tree, _ = weights.make(spec, SEED, 1, "cpu")
    x = torch.rand(BATCH, 112, 112, 3) * 2 - 1
    kept = []
    real = vit.random_masking

    def masking(tok, len_keep, generator):
        kept.append(len_keep)
        return real(tok, len_keep, generator)

    monkeypatch.setattr(vit, "random_masking", masking)
    with torch.no_grad():
        g_port = torch.Generator().manual_seed(SEED)
        emb, _ = vit.vit_apply(tree["backbone"], x, TINY, train=True,
                               batch_stats=tree["batch_stats"],
                               generator=g_port)
        g_ref = torch.Generator().manual_seed(SEED)
        want, _ = ref.embed(tree["backbone"], tree["batch_stats"], x, net,
                            g_ref)
        other, _ = ref.embed(tree["backbone"], tree["batch_stats"], x, net,
                             torch.Generator().manual_seed(SEED + 1))
    assert kept == [vit_counts.kept(net, True)] == [72]
    torch.testing.assert_close(emb, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(g_port.get_state(), g_ref.get_state())
    assert (emb - other).abs().max() > 0.1


def test_the_trunk_flops_match_the_flop_counter(tiny):
    net = tiny["network"]
    tree, _ = weights.make(arcface_vit.spec(tiny), 0, 1, "cpu")
    x = torch.rand(2, 112, 112, 3) * 2 - 1
    for train in (True, False):
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            vit.vit_apply(tree["backbone"], x, TINY, train=train,
                          batch_stats=tree["batch_stats"],
                          generator=torch.Generator().manual_seed(1))
        assert fc.get_total_flops() == vit_counts.forward(net, 2, train)
    # vit_l at 112²: 47.79 GFLOP a crop in training (136 tokens), 50.68 in
    # eval; a step at batch 128 with 617,971 rows 18.60 TFLOP
    assert vit_counts.forward(FULL["network"], 1) == 47_792_529_408
    assert vit_counts.forward(FULL["network"], 1, False) == 50_675_589_120
    assert arcface_vit.flops(FULL, "fit", 128) == 18_595_327_377_408


def test_the_tokens_counter(tiny):
    tree, _ = weights.make(arcface_vit.spec(tiny), 0, 1, "cpu")
    x = torch.rand(BATCH, 112, 112, 3) * 2 - 1
    vit.TOKENS = 0
    paths, port, _, batches = _trainers(tiny)
    port.step(batches[0])
    assert vit.TOKENS == BATCH * 136 * 2
    with torch.no_grad():
        vit.vit_apply(tree["backbone"], x, TINY,
                      batch_stats=tree["batch_stats"])
    assert vit.TOKENS == BATCH * 136 * 2 + BATCH * 144 * 2


def test_the_spans_of_a_forward(tiny):
    tree, _ = weights.make(arcface_vit.spec(tiny), 0, 1, "cpu")
    x = torch.rand(2, 112, 112, 3) * 2 - 1
    observability.drain()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for train in (True, False):
            vit.vit_apply(tree["backbone"], x, TINY, train=train,
                          batch_stats=tree["batch_stats"],
                          generator=torch.Generator().manual_seed(1))
    names = [s[0] for s in observability.drain()]
    assert names == (["attention", "mlp"] * 2 + ["vit_head"]) * 2


def test_the_spec_has_the_port_layout(monkeypatch):
    """vit_l's whole tree, the port's built on the meta device."""
    monkeypatch.setattr(vit, "_trunc_normal",
                        lambda g, shape, std=0.02: torch.empty(shape))
    with torch.device("meta"):
        p, st = vit.init_vit(torch.Generator(), "vit_l", 512, device="meta")
    want = {f"backbone/{k.replace('.', '/')}": tuple(v.shape)
            for k, v in p.named_parameters()}
    want |= {f"batch_stats/{k.replace('.', '/')}": tuple(v.shape)
             for k, v in st.named_parameters()}
    got = {path: shape for path, shape, *_ in arcface_vit.spec(FULL)}
    assert got.pop("fc_weight") == (2_059_906, 512)
    assert got == want
    # the trunk's 255,684,352 parameters
    assert sum(math.prod(s) for k, s in got.items()
               if k.startswith("backbone/")) == 255_684_352


def test_the_configuration_is_held_to_the_port(tiny):
    arcface_vit._check_constants(FULL)
    for section, key, value in (("network", "ln_eps", 1e-5),
                                ("network", "heads", 12),
                                ("train", "betas", [0.9, 0.99])):
        bad = copy.deepcopy(FULL)
        bad[section][key] = value
        with pytest.raises(ValueError):
            arcface_vit._check_constants(bad)


@pytest.mark.parametrize("metric,span", [("attention_ms", "attention"),
                                         ("mlp_ms", "mlp")])
def test_the_readers_read_the_ports_spans(monkeypatch, metric, span):
    """The kernels whose launching operation lies inside one of the port's
    recorded spans of that name, in the pass after the window: not the
    profiler's ranges, of which the trace here holds none."""
    from benchmark import spans, trace

    class R:
        attribution_units = 2
        attribution = trace.Trace(
            window=(0, 1000),
            kernels=[("gemm", 10, 30, 1), ("ln", 60, 100, 2),
                     ("bmm", 110, 200, 3), ("late", 1005, 1010, 8)],
            ops={1: ("aten::mm", 5, 6, 7),
                 2: ("Command Buffer Full", 50, 51, 9),
                 3: ("aten::bmm", 105, 106, 7), 8: ("aten::mm", 996, 999, 7)})

    record = [(span, 0, 8, None, None, 11), (span, 40, 55, None, None, 11),
              ("vit_head", 100, 108, None, None, 11),
              (span, 990, 1001, None, None, 11),     # past the window
              (span, 2000, None, None, None, 11)]    # still open
    monkeypatch.setattr(spans, "record", lambda: record)
    assert harness.reader(metric).read(R) == pytest.approx(60 / 1e6 / 2)
    monkeypatch.setattr(spans, "record", lambda: record[2:3])
    assert harness.reader(metric).read(R) is None


def test_the_reference_and_counts_load_without_the_port():
    code = ("import sys; import benchmark.reference.vit, "
            "benchmark.counts.vit; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('hfa_gp_tpu_torch', 'hfa_gp_tpu', "
            "'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
