"""EG3D's GAN training (`train/eg3d_gan.py`, `models/eg3d/discriminator.py`)
against the plain reference (`benchmark/reference/eg3d_gan.py`) on the
CPU, on seeded weights drawn by the benchmark's adapter
(`benchmark/models/eg3d_gan.py`): a tiny generator (the benchmark's tiny
EG3D) and the discriminator at 32² with `channel_base` cut. The
discriminator's logits and its param tree's names, each phase's loss and
gradients (R1's included), three steps of the lazy schedule, the draws
of the swap, the noise and the jitter by seed, w_avg and the EMA.

No JAX here: the JAX package has no discriminator and no GAN loss.
"""

import copy

import pytest
import torch

from benchmark import harness, inputs, weights
from benchmark.models import eg3d_gan as adapter
from benchmark.reference import eg3d_gan as ref
from benchmark.tests import tiny
from hfa_gp_tpu_torch.models.eg3d import discriminator as disc
from hfa_gp_tpu_torch.models.eg3d import generator as gen
from hfa_gp_tpu_torch.train import eg3d_gan
from hfa_gp_tpu_torch.utils.convert import ParamTree

torch.set_num_threads(1)

SEED = 2 ** 31 + 41
BATCH = 4


def tiny_config() -> dict:
    c = harness.cell("eg3d_gan_b4")["config"]
    return tiny._merge(c, {
        "eg3d": tiny.TINY["eg3d"],
        "discriminator": {"img_resolution": 32, "channel_base": 256,
                          "channel_max": 32},
        "loss": {"density_points": 16}})


CFG = tiny_config()
PORT_CFG = adapter.gan_config(CFG)


def _setup(seed=SEED):
    """(paths, port trainer, reference trainer, batches) on twin trees."""
    spec = adapter.spec(CFG)
    paths = [p for p, *_ in spec]
    tree, bufs = weights.make(spec, seed, 1, "cpu")
    ref_tree, _ = weights.clone(spec, bufs)
    traffic = {"entry": "fit", "batch": BATCH, "pool": 3 * BATCH,
               "pose": {"yaw_std": 0.3, "pitch_std": 0.155, "radius": 2.7}}
    batches = inputs.batches(adapter.inputs(CFG, traffic, seed, "cpu"),
                             BATCH)
    port = adapter.program(CFG).trainer(tree, None, paths)
    plain = adapter.reference(CFG).trainer(ref_tree, None, paths)
    return paths, port, plain, batches


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_the_discriminators_tree_is_nvidias_and_its_logits_the_references():
    dc = PORT_CFG.discriminator
    tree = disc.init_discriminator(_gen(0), dc)
    names = {k for k, _ in weights.leaves(tree)}
    assert names == {p[2:] for p, *_ in adapter.spec(CFG)
                     if p.startswith("D/")}
    assert {"b32/fromrgb/weight", "b32/skip/weight", "b8/conv1/bias",
            "b4/conv/weight", "b4/fc/weight", "b4/out/bias",
            "mapping/embed/weight", "mapping/fc7/weight"} <= names
    assert "b16/fromrgb/weight" not in names and \
        "b32/skip/bias" not in names
    g = _gen(1)
    image = torch.rand((BATCH, 3, 32, 32), generator=g) * 2 - 1
    raw = torch.rand((BATCH, 3, 8, 8), generator=g) * 2 - 1
    label = inputs.labels(g, BATCH, {"yaw_std": 0.3, "pitch_std": 0.155,
                                     "radius": 2.7}, "cpu")
    got = disc.discriminator_apply(ParamTree(tree), dc, image, raw, label)
    want = ref.discriminator(tree, CFG["discriminator"], image, raw, label)
    assert got.shape == (BATCH, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("phase", eg3d_gan.PHASES)
def test_each_phase_matches_the_reference(phase):
    """One phase from the same weights and the same draws: its loss terms
    and its network's gradients (× its interval), R1's through the
    gradient of the input gradient; every leaf the reference reaches gets
    a gradient in the port and no other."""
    paths, port, plain, batches = _setup()
    b = batches[0]
    pool = b["pool_label"][0]
    terms = eg3d_gan.run_phase(port.state, PORT_CFG, phase, b["image"],
                               b["label"], pool, _gen(7))
    want_terms, grads = plain.run.phase(phase, b["image"], b["label"], pool,
                                        _gen(7))
    assert set(terms) == set(want_terms)
    for k in terms:
        torch.testing.assert_close(terms[k].detach(), want_terms[k],
                                   rtol=2e-5, atol=1e-9)
    on_g = phase.startswith("G")
    net = port.state.G if on_g else port.state.D
    tree = plain.run.G if on_g else plain.run.D
    names = [p for p, _ in ref._flat(tree) if not ref.is_buffer(p)]
    assert len(names) == len(grads)
    want = dict(zip(names, grads))
    worst = 0.0
    for name, p in net.named_parameters():
        if eg3d_gan.is_buffer(name):
            assert p.grad is None
            continue
        g = want[name.replace(".", "/")]
        assert (p.grad is None) == (g is None), name
        if g is not None and float(g.norm()) > 0:
            worst = max(worst, _rel(p.grad, g))
    assert worst <= 1e-4, worst
    assert sum(g is not None for g in grads) > len(grads) // 2


def test_three_steps_follow_the_lazy_schedule_and_the_reference():
    paths, port, plain, batches = _setup()
    before = [p.detach().clone() for p in port.leaves]
    for k in range(3):
        got = port.step(batches[k])
        want = plain.step(batches[k])
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-7)
        ran = set(plain.run.terms)
        assert ran == ({"Gmain", "Greg", "Dgen", "Dreal", "Dr1"} if k == 0
                       else {"Gmain", "Dgen", "Dreal"})
    assert port.state.step == plain.run.count == 3
    # each leaf stepped as often as a phase reached it: 3 Gmain + 1 Greg
    # for the backbone, 3 Gmain for SR, 3 Dmain + 1 Dreg for D
    steps = {p: int(s["step"]) for opt in (port.state.opt_G,
                                           port.state.opt_D)
             for p, s in opt.state.items()}
    ref_steps = dict(zip([id(t) for t in plain.run.g_leaves
                          + plain.run.d_leaves],
                         plain.run.adam_g.t + plain.run.adam_d.t))
    by_path = dict(zip(paths, port.leaves))
    ref_by_path = dict(zip(paths, plain.leaves))
    assert steps[by_path["G/backbone/b16/conv1/weight"]] == 4
    assert steps[by_path["G/superresolution/block1/conv1/weight"]] == 3
    assert steps[by_path["D/b32/fromrgb/weight"]] == 4
    assert by_path["G/superresolution/block1/conv1/noise_strength"] \
        not in steps
    for path, p in by_path.items():
        if p in steps:
            assert steps[p] == ref_steps[id(ref_by_path[path])], path
    # each leaf's change against the reference's, median leaf
    gaps = []
    for p, q, b0 in zip(port.leaves, plain.leaves, before):
        dq = float((q.detach() - b0).norm())
        if dq > 0:
            gaps.append(abs(float((p.detach() - b0).norm()) - dq) / dq)
    assert sorted(gaps)[len(gaps) // 2] <= 1e-3


def test_draws_are_identical_by_seed():
    """The swap, the noise and the jitter: the port's and the reference's
    from one seed are the same numbers; another seed draws others."""
    pool = inputs.labels(_gen(3), 6, {"yaw_std": 0.3, "pitch_std": 0.155,
                                      "radius": 2.7}, "cpu")
    paths, port, plain, _ = _setup()
    z, c, cm = eg3d_gan.draw_conditioning(_gen(9), pool, BATCH, 512, 0.5)
    rz, rc, rcm = plain.run._draw(_gen(9), pool, BATCH)
    assert torch.equal(z, rz) and torch.equal(c, rc) and torch.equal(cm, rcm)
    swapped = (cm != c).any(1)
    assert torch.equal(cm[swapped], c.roll(1, 0)[swapped])
    # Greg's swap, one draw for the whole batch as EG3D's: every row or none
    for seed in range(8):
        z1, c1, cm1 = eg3d_gan.draw_conditioning(_gen(seed), pool, BATCH, 512,
                                                 0.5, per_row=False)
        rz1, rc1, rcm1 = plain.run._draw(_gen(seed), pool, BATCH,
                                         per_row=False)
        assert torch.equal(cm1, rcm1) and torch.equal(z1, rz1)
        assert torch.equal(cm1, c1) or torch.equal(cm1, c1.roll(1, 0))
    # the noise and the jitter: noise strengths of 1, so that they show
    with torch.no_grad():
        for path, p, q in zip(paths, port.leaves, plain.leaves):
            if path.endswith("noise_strength"):
                p.fill_(1.0)
                q.fill_(1.0)
    ec = PORT_CFG.generator
    ws = gen.mapping(port.state.G, ec, z, cm)

    def port_render(seed):
        with torch.no_grad():
            g = _gen(seed)
            return gen.synthesis(port.state.G, ec, ws, c, noise_mode="random",
                                 render_generator=g, noise_generator=g)

    with torch.no_grad():
        want, want_raw = ref.synthesis(plain.run.G, CFG["eg3d"], ws, c,
                                       _gen(11))
    got = port_render(11)
    torch.testing.assert_close(got["image"].permute(0, 3, 1, 2), want,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got["image_raw"].permute(0, 3, 1, 2),
                               want_raw, rtol=1e-4, atol=1e-5)
    assert _rel(port_render(12)["image"], got["image"]) > 1e-2
    # the jitter alone: the same noise, another render generator
    with torch.no_grad():
        other = gen.synthesis(port.state.G, ec, ws, c, noise_mode="random",
                              render_generator=_gen(13),
                              noise_generator=_gen(11))
    assert 0 < _rel(other["image_raw"], got["image_raw"])
    with pytest.raises(ValueError, match="generator"):
        gen.synthesis(port.state.G, ec, ws, c, noise_mode="random")


def test_w_avg_and_the_ema():
    paths, port, plain, batches = _setup()
    G0 = copy.deepcopy(port.state.G_ema.state_dict())
    port.step(batches[0])
    plain.step(batches[0])
    beta = PORT_CFG.ema_beta
    assert beta == pytest.approx(0.5 ** (32 / 10_000))
    w_avg = port.state.G["mapping"]["w_avg"]
    assert float(w_avg.norm()) > 0          # Dmain tracked it
    torch.testing.assert_close(w_avg, plain.run.G["mapping"]["w_avg"],
                               rtol=1e-5, atol=1e-8)
    ema, cur = port.state.G_ema.state_dict(), port.state.G.state_dict()
    for name, e in ema.items():
        if eg3d_gan.is_buffer(name):
            assert torch.equal(e, cur[name]), name
        else:
            torch.testing.assert_close(e, cur[name].lerp(G0[name], beta),
                                       rtol=1e-6, atol=1e-7)
    flat_ref = dict(ref._flat(plain.run.G_ema))
    gaps = [_rel(e, flat_ref[n.replace(".", "/")]) for n, e in ema.items()
            if float(e.norm()) > 0]
    assert sorted(gaps)[len(gaps) // 2] <= 1e-5
