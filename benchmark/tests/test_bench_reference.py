"""The plain reference against the port's CPU path at a tiny size, the
weights' layout against the port's own init, and the reference's
independence of the port."""

import ast
import os

import pytest
import torch

from benchmark import harness, inputs, weights
from benchmark.models import hfagp
from benchmark.tests import tiny

torch.set_num_threads(2)


def _setup(name, batch=2, seed=3):
    c = tiny.cell(name, batch=batch)
    cfg = c["config"]
    tree, bufs = weights.make(hfagp.spec(cfg), seed, 1, "cpu")
    batch0 = inputs.batches(hfagp.inputs(cfg, c["traffic"], seed, "cpu"),
                            batch)[0]
    return cfg, tree, bufs, batch0


@pytest.mark.parametrize("name", ["rgb_reenact_b8", "audio_reenact_b8"])
def test_frames_match_the_port(name):
    cfg, tree, _, batch = _setup(name)
    prog = hfagp.program(cfg)
    got = prog.serve(prog.wrap(tree), batch)
    want = hfagp.reference(cfg).serve(tree, batch)
    assert want.shape == got.shape == (2, 32, 32, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fitting_steps_match_the_port():
    cfg, tree, bufs, _ = _setup("rgb_fit_b2")
    c = tiny.cell("rgb_fit_b2")
    spec = hfagp.spec(cfg)
    paths = [p for p, *_ in spec]
    ref_tree, _ = weights.clone(spec, bufs)
    flat = dict(weights.leaves(ref_tree))
    before = [flat[p].clone() for p in paths]
    lp, _ = weights.make(hfagp.aux_spec(cfg), 3, 2, "cpu")
    batches = inputs.batches(hfagp.inputs(cfg, c["traffic"], 3, "cpu"), 2)
    port = hfagp.program(cfg).trainer(tree, lp, paths)
    ref = hfagp.reference(cfg).trainer(ref_tree, lp, paths)
    for k in range(3):
        lp_, lr_ = (t.step(batches[k]) for t in (port, ref))
        torch.testing.assert_close(lp_, lr_, rtol=1e-5, atol=1e-6)
        if k == 0:
            for g, h in zip(port.first_grads(), ref.first_grads()):
                torch.testing.assert_close(g, h, rtol=1e-4, atol=1e-6)
    for p, q, p0 in zip(port.leaves, ref.leaves, before):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-5,
                                   atol=1e-6)
    assert sum(not torch.equal(q.detach(), p0)
               for q, p0 in zip(ref.leaves, before)) > len(before) // 2


@pytest.mark.parametrize("driving", ["rgb", "audio"])
def test_spec_has_the_port_layout(driving):
    from hfa_gp_tpu_torch.train import audio
    from hfa_gp_tpu_torch.models.avatar import heads
    name = "rgb_reenact_b8" if driving == "rgb" else "audio_reenact_b8"
    cfg = tiny.cell(name)["config"]
    pc = hfagp.port_config(cfg)
    g = torch.Generator().manual_seed(0)
    port = heads.init_avatar_rgb(g, pc) if driving == "rgb" \
        else audio.init_audio_params(g, pc)
    want = {n.replace(".", "/"): p for n, p in port.named_parameters()}
    tree, _ = weights.make(hfagp.spec(cfg), 0, 1, "cpu")
    got = dict(weights.leaves(tree))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape, k
        for const in (0.0, 1.0):          # leaves the port sets, not draws
            if torch.all(want[k] == const) and want[k].numel() > 1:
                assert torch.all(v == const), k
    sub = "subspace" if driving == "rgb" else "model/subspace"
    torch.testing.assert_close(got[f"{sub}/delta"],
                               got[f"{sub}/bases"].mean(0))


def test_weights_follow_the_seed():
    cfg = tiny.cell("rgb_fit_b2")["config"]
    a, _ = weights.make(hfagp.spec(cfg), 2 ** 31 + 11, 1, "cpu")
    b, _ = weights.make(hfagp.spec(cfg), 2 ** 31 + 11, 1, "cpu")
    c, _ = weights.make(hfagp.spec(cfg), 2 ** 31 + 12, 1, "cpu")
    la, lb, lc = (dict(weights.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not torch.equal(la["subspace/bases"], lc["subspace/bases"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_reference_and_counts_import_nothing_of_the_port(folder):
    root = os.path.join(harness.BENCH_DIR, folder)
    for name in os.listdir(root):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(root, name)):
                assert mod.split(".")[0] not in ("hfa_gp_tpu_torch",
                                                 "hfa_gp_tpu", "jax"), \
                    (name, mod)
