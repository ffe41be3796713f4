"""The RGB fitting step's loss and backward replayed as CUDA graphs
(`core/graphs.loss`, `train.rgb.train_step`) on the card (`gpu`: skips
without one), at the fitting cell's batch 2 and the avatar's full widths.
Run on the card: `python -m pytest -m gpu tests/test_torch_train_graphs.py`.

The eager yardstick is the same step with the training graphs' `engaged`
test answering no, taken from a copy of the state that the replayed step
starts from (parameters and Adam's moments). Two eager steps from one
state differ already: the sampler's backward (K2) sums with atomics, so
the gradients' last bits change from run to run (on an H100, 5.2e-7 to
6.1e-7 of the median leaf's gradient norm, worst leaf, over three seeds
and two runs of this test). Each step's losses, every leaf's gradient
and every leaf's value are held to the eager step's within the larger of
`CAPTURE_RTOL` and `SPREAD` times the gap between two eager steps from
the same state. A step taken with TF32 on must fall outside that bound
(its gradients read 1.0e-2 to 1.4e-2 there): the check tells a replayed
backward run at lower precision from a sound one. Steps are compared one
at a time and not along three steps from one seed: there Adam's
normalisation carries the atomics' last bits into whole steps of either
sign, and two eager runs came 2.6e-4 to 5.8e-4 apart by their third
step.
"""

import copy
from unittest import mock

import pytest
import torch

from hfa_gp_tpu_torch.core import graphs
from hfa_gp_tpu_torch.core.kernels import counters

torch.set_num_threads(1)

BATCH, STEPS = 2, 3
CAPTURE_RTOL = 2e-6
SPREAD = 4.0
# an RGB step's launches (`chip_smoke.py`'s LAUNCHES_PER_UNIT and FIR_RGB)
STEP_LAUNCHES = {"triplane_sampler": 2, "triplane_sampler_bwd": 2,
                 "ray_marcher": 2, "ray_marcher_bwd": 1, "upfirdn2d": 28,
                 "upfirdn2d_bwd": 28}


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off as the CLIs set it and cuDNN deterministic,
    the process's graphs dropped before and after, and the allocator's
    cache handed back first: a capture cannot free cached blocks to make
    room for its pool, and the tests before these may have left most of
    the card cached."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    graphs.reset()
    torch.cuda.empty_cache()
    yield torch.device("cuda")
    graphs.reset()


def _setup(dev, seed=0):
    """A seeded full-width training state, LPIPS params and STEPS + 1
    batches of BATCH on `dev`."""
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models import lpips
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.train.state import init_state
    from hfa_gp_tpu_torch.utils.convert import ParamTree
    cfg = heads.AvatarConfig()
    g = torch.Generator().manual_seed(seed)
    state = init_state(heads.init_avatar_rgb(g, cfg, dev))
    lp = ParamTree(lpips.init_lpips(g)).to(dev)
    batches = [((torch.rand((BATCH, cfg.size, cfg.size, 3), generator=g)
                 * 2 - 1).to(dev),
                cam.flip_yz_label(cam.sample_camera_label(g, n=BATCH)).to(dev))
               for _ in range(STEPS + 1)]
    return cfg, state, lp, batches


def _step(cfg, state, lp, batch, graphed):
    from hfa_gp_tpu_torch.train import rgb
    if graphed:
        return rgb.train_step(state, lp, cfg, *batch, 0)
    with mock.patch.object(graphs.TrainGraphs, "engaged",
                           lambda self, inputs, leaves: False):
        return rgb.train_step(state, lp, cfg, *batch, 0)


def _terms(m):
    return torch.stack([m["loss"], m["l2_loss"], m["lpips_loss"]])


def _fit(dev, graphed, steps=STEPS):
    """`steps` steps from the seeded state → ([(losses (3,), gradients,
    values)] a step, each read after its step; the steps' returned
    metrics)."""
    cfg, state, lp, batches = _setup(dev)
    out, metrics = [], []
    for batch in batches[:steps]:
        metrics.append(_step(cfg, state, lp, batch, graphed))
        leaves = list(state.params.parameters())
        out.append((_terms(metrics[-1]), [t.grad.clone() for t in leaves],
                    [t.detach().clone() for t in leaves]))
    return out, metrics


def _gaps(got, want):
    """Each tensor's ‖got − want‖ / max(‖want‖, the median tensor's)."""
    norms = torch.stack([w.norm() for w in want])
    floor = norms[norms > 0].median()
    return torch.stack([(a - b).norm() for a, b in zip(got, want)]) \
        / torch.maximum(norms, floor)


def _read(state, m):
    """(losses (3,), gradients, values) of a step just taken."""
    leaves = list(state.params.parameters())
    return (_terms(m).clone(), [t.grad.clone() for t in leaves],
            [t.detach().clone() for t in leaves])


@pytest.mark.gpu
def test_replayed_fitting_steps_match_eager_ones(cuda, monkeypatch):
    """Three steps through the graphs (eager, captured, replayed), each
    against eager steps from a copy of the same state and Adam moments:
    two in fp32, whose gap is the bound's spread, and one with TF32 on,
    which the bound must tell apart."""
    cfg, state, lp, batches = _setup(cuda)
    got, metrics = [], []
    for k, batch in enumerate(batches[:STEPS]):
        twins = [copy.deepcopy(state) for _ in range(3)]
        eager = [_read(t, _step(cfg, t, lp, batch, graphed=False))
                 for t in twins[:2]]
        with monkeypatch.context() as m:
            m.setattr(torch.backends.cudnn, "allow_tf32", True)
            m.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
            tf32 = _read(twins[2], _step(cfg, twins[2], lp, batch,
                                         graphed=False))
        del twins
        metrics.append(_step(cfg, state, lp, batch, graphed=True))
        got.append(_read(state, metrics[-1]))
        for i, what in enumerate(("losses", "gradients", "values")):
            g, e, a, t = (list(x[i]) for x in (got[-1], *eager, tf32))
            spread = float(_gaps(a, e).max())
            bound = max(CAPTURE_RTOL, SPREAD * spread)
            gap, off = _gaps(g, e), float(_gaps(t, e).max())
            print(f"step {k} {what}: replayed vs eager worst "
                  f"{float(gap.max()):.3e} (leaf {int(gap.argmax())}), "
                  f"eager vs eager {spread:.3e}, TF32 vs fp32 {off:.3e}, "
                  f"bound {bound:.3e}")
            assert float(gap.max()) <= bound, (k, what, int(gap.argmax()),
                                               float(gap.max()), bound)
            if what == "gradients":
                assert off > bound, (k, off, bound)
    # the graphed steps: eager, captured, then replayed; the twins' steps
    # (three a step) count as eager too
    st = graphs.stats()["rgb_loss"]
    assert (st["eager"] - 3 * STEPS, st["captures"], st["replays"],
            st["failed"]) == (1, 1, STEPS - 2, 0), st
    # each step's losses are tensors of their own: read after all three
    # steps, they are what each step returned
    for m, (gl, _, _) in zip(metrics, got):
        assert torch.equal(_terms(m), gl)
    assert len({m["loss"].data_ptr() for m in metrics}) == STEPS
    assert len({float(m["loss"]) for m in metrics}) == STEPS


@pytest.mark.gpu
def test_a_replayed_step_launches_what_an_eager_step_launches(cuda):
    cfg, state, lp, batches = _setup(cuda)
    expected = dict.fromkeys(counters.launches(), 0) | STEP_LAUNCHES
    got = []
    for i in range(4):                          # eager, captured, replayed ×2
        before = counters.launches()
        _step(cfg, state, lp, batches[i], graphed=True)
        after = counters.launches()
        got.append({k: after[k] - before[k] for k in after})
    assert got == [expected] * 4, got
    assert graphs.stats()["rgb_loss"]["replays"] == 2, graphs.stats()


@pytest.mark.gpu
def test_a_replaced_parameter_gives_a_new_key(cuda):
    cfg, state, lp, batches = _setup(cuda)
    for batch in batches[:3]:
        _step(cfg, state, lp, batch, graphed=True)
    st = graphs.stats()["rgb_loss"]
    assert (st["eager"], st["captures"], st["replays"]) == (1, 1, 1), st
    # a leaf replaced by another tensor: its Adam state goes with it
    sub = state.params["subspace"]
    old = sub.get_parameter("delta")
    new = torch.nn.Parameter(old.detach().clone())
    sub.register_parameter("delta", new)
    state.optimizer = type(state.optimizer)(
        state.params.parameters(), **state.optimizer.defaults)
    _step(cfg, state, lp, batches[3], graphed=True)
    st = graphs.stats()["rgb_loss"]
    assert (st["eager"], st["captures"], st["replays"]) == (2, 1, 1), st
    assert new.grad is not None and not new.grad.eq(0).all()
    _step(cfg, state, lp, batches[0], graphed=True)
    _step(cfg, state, lp, batches[1], graphed=True)
    st = graphs.stats()["rgb_loss"]
    assert (st["eager"], st["captures"], st["replays"], st["failed"]) \
        == (2, 2, 2, 0), st


@pytest.mark.gpu
def test_replayed_peak_memory_within_1_5_of_eager(cuda):
    def peak(graphed):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _fit(cuda, graphed, steps=STEPS + 1)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    eager = peak(False)
    graphs.reset()
    assert peak(True) <= 1.5 * eager
