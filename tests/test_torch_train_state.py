"""The pieces around the port's training step against the JAX package:
Adam with the generator freeze gate on GIVEN gradients (train/state.py vs
optax, across the tune_iter boundary, 1e-6), `BatchIterator` index for
index, the checkpoint round trip and resume (train/checkpoint.py), and the
self-reconstruction fit (`tools/fit_selfrecon.py --small`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hfa_gp_tpu.data.dataset import BatchIterator as JBatchIterator
from hfa_gp_tpu.data.dataset import HeadData as JHeadData
from hfa_gp_tpu.train import state as jstate
from hfa_gp_tpu_torch.data.dataset import BatchIterator, HeadData, \
    infinite_batches
from hfa_gp_tpu_torch.tools import fit_selfrecon
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.train import state as tstate
from hfa_gp_tpu_torch.utils.convert import ParamTree
from tests.fixtures import make_avatar_dataset

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


def _tree(seed):
    """A small tree with the trainer's top-level keys (no 4-D leaf, so
    both packages keep the same layout)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"encoder": {"fc": {"weight": a(5, 7), "bias": a(5)}},
            "subspace": {"bases": a(4, 12), "delta": a(12)},
            "generator": {"backbone": {"weight": a(6, 3), "const": a(3)},
                          "unused": {"weight": a(2, 2)}}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _set_grads(params, grads, skip=()):
    named = dict(params.named_parameters())
    for name, g in _leaves(grads):
        named[name].grad = None if name in skip \
            else torch.from_numpy(np.array(g))


def test_adam_and_freeze_gate_match_optax_across_tune_iter():
    """Steps 0..4 with tune_iter = 2: frozen generator gradients are
    multiplied by zero, not skipped, so Adam's counts and moments advance
    and the first unfrozen update equals optax's. A parameter the loss
    never reaches (no gradient in torch, zeros in JAX) stays put."""
    tune_iter, lr = 2, 3e-2
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    tx = jstate.make_optimizer(lr)
    js = jstate.init_state(jparams, tx)
    ts = tstate.init_state(ParamTree(
        {k: v for k, v in _tree(0).items()}), lr)
    assert all(p.requires_grad for p in ts.params.parameters())
    init = _tree(0)
    for step in range(5):
        grads = _tree(100 + step)
        grads["generator"]["unused"]["weight"][:] = 0.0
        jg = jstate.apply_generator_freeze(
            jax.tree.map(jnp.asarray, grads), js.step, tune_iter)
        updates, opt_state = tx.update(jg, js.opt_state, js.params)
        js = jstate.TrainState(optax.apply_updates(js.params, updates),
                               opt_state, js.step + 1)

        _set_grads(ts.params, grads, skip=("generator.unused.weight",))
        tstate.apply_generator_freeze(ts.params, ts.step, tune_iter)
        ts.optimizer.step()
        ts.step += 1

        got = dict(ts.params.named_parameters())
        for name, want in _leaves(js.params):
            np.testing.assert_allclose(got[name].detach().numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} @ {step}")
        moved = float(np.abs(got["generator.backbone.weight"].detach().numpy()
                             - init["generator"]["backbone"]["weight"]).max())
        assert (moved == 0.0) == (step < tune_iter)
    assert float(np.abs(got["generator.unused.weight"].detach().numpy()
                        - init["generator"]["unused"]["weight"]).max()) == 0.0


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    make_avatar_dataset(os.path.join(root, "nerface_dataset"), n_train=7)
    return os.path.join(root, "nerface_dataset")


@pytest.mark.parametrize("batch_size,shuffle",
                         [(2, True), (3, True), (1, False)])
def test_batch_iterator_matches_jax_index_for_index(dataset_root, batch_size,
                                                    shuffle):
    kw = dict(size=32, root=dataset_root, person="person_3")
    jds, tds = JHeadData("train", **kw), HeadData("train", **kw)
    assert tds.frames == jds.frames and len(tds) == 7
    jit_ = JBatchIterator(jds, batch_size, shuffle=shuffle, seed=3)
    tit = BatchIterator(tds, batch_size, shuffle=shuffle, seed=3)
    assert len(tit) == len(jit_)
    for _ in range(3):                           # three epochs
        jb, tb = list(jit_), list(tit)
        assert len(jb) == len(tb) == len(tit)
        for (jimg, jlab), (timg, tlab) in zip(jb, tb):
            np.testing.assert_array_equal(timg.numpy(), jimg)
            np.testing.assert_array_equal(tlab.numpy(), jlab)
    stream = infinite_batches(BatchIterator(tds, 3, seed=1))
    shapes = [next(stream)[0].shape for _ in range(5)]   # 2 batches an epoch
    assert shapes == [(3, 32, 32, 3)] * 5


def _step(state, seed, tune_iter=1):
    _set_grads(state.params, _tree(seed))
    tstate.apply_generator_freeze(state.params, state.step, tune_iter)
    state.optimizer.step()
    state.step += 1


def test_checkpoint_round_trip_and_resume(tmp_path):
    """save → latest_step → restore into a fresh state: params, Adam's
    moments and counts and the step come back, and one more step from the
    restored state equals the uninterrupted run bit for bit."""
    state = tstate.init_state(ParamTree(_tree(0)), 1e-2)
    _step(state, 200)
    _step(state, 201)
    ckpt_dir = str(tmp_path / "checkpoint")
    assert ckpt.latest_step(ckpt_dir) is None
    path = ckpt.save(state, ckpt_dir, step=1)     # named after the loop index
    ckpt.save(state, ckpt_dir, step=1234567)
    assert os.path.basename(path) == "000001" and os.path.isfile(path)
    assert ckpt.latest_step(ckpt_dir) == 1234567
    _step(state, 202)

    fresh = tstate.init_state(ParamTree(_tree(5)), 1e-2)
    assert ckpt.restore(path, fresh) is fresh
    assert fresh.step == 2                        # from the file, not its name
    _step(fresh, 202)
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              fresh.params.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)

    loaded = ckpt.load_params(path)
    assert not any(p.requires_grad for p in loaded.parameters())
    assert [n for n, _ in loaded.named_parameters()] == \
        [n for n, _ in state.params.named_parameters()]
    with pytest.raises(NotImplementedError):
        ckpt.load_params(str(tmp_path))           # a directory: not ours


def test_fit_selfrecon_small_improves_psnr(capsys):
    out = fit_selfrecon.main(fit_selfrecon.build_argparser().parse_args(
        ["--small", "--device", "cpu", "--steps", "20", "--n_frames", "8"]))
    assert "OK" in capsys.readouterr().out
    assert out["train_after"] > out["train_before"] + 3.0
    assert out["test_after"] > out["test_before"] + 3.0
