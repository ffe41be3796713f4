"""The EG3D GAN cell of the benchmark (`eg3d_gan_b4`'s files under
`benchmark/`) on the CPU: its manifest entries and their own `source`,
the adapter's spec against the port's param trees at the published
widths, the counts by hand at those widths and against
`torch.utils.flop_counter` at a tiny one, and a tiny run of the `fit`
entry through the adapter."""

import copy
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import discriminator as d_counts
from benchmark.counts import eg3d as eg3d_counts
from benchmark.models import eg3d_gan as adapter
from benchmark.tests import tiny
from benchmark.weights import leaves
from hfa_gp_tpu_torch.models.eg3d import discriminator as disc
from hfa_gp_tpu_torch.models.eg3d import generator as gen
from hfa_gp_tpu_torch.utils.convert import ParamTree

torch.set_num_threads(2)

NAME = "eg3d_gan_b4"
CELL = harness.cell(NAME)
FULL = CELL["config"]


def tiny_cell() -> dict:
    c = copy.deepcopy(CELL)
    c["config"] = tiny._merge(c["config"], {
        "eg3d": tiny.TINY["eg3d"],
        "discriminator": {"img_resolution": 32, "channel_base": 256,
                          "channel_max": 32},
        "loss": {"density_points": 16}})
    c["traffic"] = dict(c["traffic"], pool=12)
    return c


def test_the_manifest_adds_one_configuration_and_one_cell():
    bench = harness.manifest()
    conf = [c for c in bench["configs"] if c["name"] == "eg3d_ffhq512_gan"]
    assert len(conf) == 1
    sources = [c["source"] for c in bench["configs"]]
    assert len(set(sources)) == len(sources)
    assert conf[0]["source"].startswith("https://github.com/NVlabs/eg3d/")
    assert conf[0]["reduced"] == ["batch"]
    w = CELL["workload"]
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("eg3d_ffhq512_gan", "gan_b4", 1)
    assert [m["name"] for m in CELL["end_to_end"]] == ["train_steps_per_s",
                                                       "setup_s"]
    assert {m["name"] for m in CELL["per_layer"]} == {
        "mfu.gan", "device_idle.gan", "program_idle.gan", "forward_ms.gan",
        "backward_ms.gan", "optimizer_ms.gan", "discriminator_ms.gan"}
    assert set(CELL["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    # the configuration states the card's share of the 8 x 4 job
    assert (FULL["batch"], FULL["batch_global"], FULL["world_size"]) == \
        (CELL["traffic"]["batch"], 32, 8)
    with open(os.path.join(harness.BENCH_DIR, "configs",
                           "hfagp_rgb_eg3d512.json")) as f:
        avatar = json.load(f)["eg3d"]
    render = dict(avatar["render"], sampler_fine="global")
    assert FULL["eg3d"] == dict(avatar, render=render)


def test_the_spec_is_the_ports_param_trees():
    """Every leaf of the spec is a leaf of the port's G and D at the
    published widths, with its shape, and no leaf is missing."""
    cfg = adapter.gan_config(FULL)
    with torch.device("meta"):
        g = gen.init_generator(torch.Generator(), cfg.generator)
        d = disc.init_discriminator(torch.Generator(), cfg.discriminator)
    port = {}
    for prefix, tree in (("G", g), ("D", d)):
        port.update({f"{prefix}/{k.replace('.', '/')}": tuple(v.shape)
                     for k, v in ParamTree(tree).named_parameters()})
    spec = {p: tuple(s) for p, s, *_ in adapter.spec(FULL)}
    assert spec == port
    # D's widths: 64 channels at 512², 512 from 64² down
    assert spec["D/b512/conv0/weight"] == (64, 64, 3, 3)
    assert spec["D/b64/conv1/weight"] == (512, 512, 3, 3)
    assert spec["D/b4/conv/weight"] == (512, 513, 3, 3)
    assert spec["D/b4/fc/weight"] == (512, 512 * 16)
    kinds = {p: (k, a) for p, _, k, a in adapter.spec(FULL)}
    assert kinds["D/mapping/fc3/weight"] == ("normal", 100.0)
    assert kinds["G/mapping/fc1/weight"] == ("normal", 100.0)


def test_the_spec_draws_the_mappings_as_the_ports_gan_init():
    """The spec's scale of each mapping weight is the spread of the port's
    `init_networks` (EG3D's init), at a tiny width."""
    from hfa_gp_tpu_torch.train import eg3d_gan
    cfg = tiny_cell()["config"]
    G, D = eg3d_gan.init_networks(torch.Generator().manual_seed(0),
                                  adapter.gan_config(cfg))
    port = {f"{k}/{p}": t for k, tree in (("G", G), ("D", D))
            for p, t in leaves(tree)}
    seen = 0
    for path, _, kind, arg in adapter.spec(cfg):
        if "/mapping/" in path and path.endswith("weight"):
            scale = arg if kind == "normal" else 1.0
            assert kind in ("normal", "randn"), path
            assert float(port[path].std()) == pytest.approx(scale, rel=0.1), \
                path
            seen += 1
    assert seen == (1 + 2) + (1 + 8)      # G: embed, fc0-1; D: embed, fc0-7


def test_counts_at_the_published_widths():
    d = FULL["discriminator"]
    # the 512² block: skip's FIR and 1x1 at 256², conv0 at 512², the FIR
    # at 513² and conv1 (64 → 128) at 256²
    b512 = (2 * 64 * 16 * 256 ** 2 + 2 * 64 * 128 * 256 ** 2
            + 2 * 64 * 64 * 9 * 512 ** 2 + 2 * 64 * 16 * 513 ** 2
            + 2 * 64 * 128 * 9 * 256 ** 2)
    fromrgb = 2 * 6 * 64 * 512 ** 2
    epilogue = (2 * 513 * 512 * 9 * 16 + 2 * 8192 * 512 + 2 * 512 * 512
                + 2 * 25 * 512 + 8 * 2 * 512 * 512)
    rest = d_counts.forward(d, 1) - fromrgb - b512 - epilogue
    assert rest > 0
    assert 120e9 < d_counts.forward(d, 1) < 130e9
    assert d_counts.forward(d, 4) == 4 * d_counts.forward(d, 1)
    per = adapter.phase_flops(FULL, 4)
    syn, dis = eg3d_counts.synthesis(FULL["eg3d"], 4), d_counts.forward(d, 4)
    assert per == {"Gmain": 3 * syn + 2 * dis,
                   "Greg": 3 * eg3d_counts.backbone(FULL["eg3d"], 4),
                   "Dmain": syn + 6 * dis, "Dreg": 6 * dis}
    # the mean step of the 16-step period: Greg 4 times, Dreg once
    want = (16 * (per["Gmain"] + per["Dmain"]) + 4 * per["Greg"]
            + per["Dreg"]) // 16
    assert adapter.flops(FULL, "fit", 4) == want
    assert 9e12 < want < 9.7e12


def test_the_discriminators_count_matches_the_flop_counter():
    cfg = tiny_cell()["config"]
    port = adapter.gan_config(cfg).discriminator
    tree = ParamTree(disc.init_discriminator(torch.Generator()
                                             .manual_seed(0), port))
    image = torch.rand((2, 3, 32, 32))
    raw = torch.rand((2, 3, 8, 8))
    label = torch.randn((2, 25))
    with FlopCounterMode(display=False) as fc:
        disc.discriminator_apply(tree, port, image, raw, label)
    assert fc.get_total_flops() == d_counts.forward(cfg["discriminator"], 2)


def test_a_tiny_run_through_the_adapter_is_correct():
    out, run = harness.run_cell(NAME, 2 ** 31 + 17, 0.2, False, device="cpu",
                                cell_override=tiny_cell())
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == run.units > 0
    assert {"train_steps_per_s", "setup_s"} <= set(out["metrics"])
    # the buffers (w_avg, noise_const) and SR's noise strengths, which no
    # phase reaches, are left out of the change's median
    assert run.notes["leaves_left_out"] >= 10


def test_first_grads_are_gmains_for_g_and_r1s_for_d():
    """The adapter reads G's first moments right after Gmain and D's after
    step 0 (Dreg, R1), in the port and the reference alike."""
    from benchmark import inputs, weights
    from hfa_gp_tpu_torch.train import eg3d_gan
    cfg = tiny_cell()["config"]
    spec = adapter.spec(cfg)
    paths = [p for p, *_ in spec]
    tree, bufs = weights.make(spec, 3, 1, "cpu")
    twin, _ = weights.clone(spec, bufs)
    tree2, _ = weights.clone(spec, bufs)
    traffic = dict(tiny_cell()["traffic"], pool=8)
    batch = inputs.batches(adapter.inputs(cfg, traffic, 3, "cpu"), 4)[0]
    port = adapter.program(cfg).trainer(tree, None, paths)
    plain = adapter.reference(cfg).trainer(twin, None, paths)
    port.step(batch)
    plain.step(batch)
    # Gmain alone from the same weights and draws
    fresh = adapter.program(cfg).trainer(tree2, None, paths)
    g = torch.Generator().manual_seed(adapter.sample_seed(3, 0))
    eg3d_gan.run_phase(fresh.state, fresh.program.cfg, "Gmain",
                       batch["image"], batch["label"],
                       batch["pool_label"][0], g)
    got, want = port.first_grads(), plain.first_grads()
    for path, a, b, leaf in zip(paths, got, want, fresh.leaves):
        if path.startswith("G/") and leaf.grad is not None:
            torch.testing.assert_close(a, leaf.grad, rtol=1e-6, atol=0)
        if float(b.norm()) > 0:
            assert float((a - b).norm() / b.norm()) <= 1e-4, path
    d = paths.index("D/b4/fc/weight")
    assert float(got[d].norm()) > 0


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_the_reference_and_counts_import_nothing_of_the_port(folder):
    path = os.path.join(harness.BENCH_DIR, folder,
                        "eg3d_gan.py" if folder == "reference"
                        else "discriminator.py")
    with open(path) as f:
        src = f.read()
    assert "hfa_gp_tpu" not in src and "jax" not in src
