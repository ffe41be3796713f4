"""The port's PartialFC (parallel/partial_fc.py) against the JAX package's on
a 1 × 1 mesh: margins, the loss and its gradients with respect to the table
and the embeddings through both JAX paths (the Pallas flash-CE kernel in
interpret mode, and the direct logits), sampling, and the row-sparse loss.

Tolerances: losses rtol 1e-5 (one fp32 product of depth 128, exp, log);
gradients rtol 1e-4 with an atol of 1e-6, the JAX package's own bound for
its flash-CE path against the dense loss. `jax.random` cannot be reproduced,
so sampling is held by its properties, and `loss_sampled` to the JAX result
on the index array JAX produced.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.parallel import mesh as mesh_mod
from hfa_gp_tpu.parallel import partial_fc as jpfc
from hfa_gp_tpu_torch.parallel import partial_fc as tpfc

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)

MARGINS = {"arcface": (1.0, 0.5, 0.0), "cosface": (1.0, 0.0, 0.4),
           "combined": (0.9, 0.4, 0.1)}


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_mesh(n_data=1, n_model=1)


@pytest.mark.parametrize("name", sorted(MARGINS))
def test_combined_margin_matches_jax(name):
    m = MARGINS[name]
    t = np.concatenate([np.linspace(-1.0, 1.0, 41),
                        [-0.9999999, 0.9999999, math.cos(math.pi - 0.5)]]) \
        .astype(np.float32)
    want = jpfc.combined_margin(jnp.asarray(t), *m)
    g_want = jax.grad(lambda x: jnp.sum(jpfc.combined_margin(x, *m)))(
        jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_(True)
    got = tpfc.combined_margin(tt, *m)
    g_got, = torch.autograd.grad(got.sum(), tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # interior points only: at a clip's corner JAX splits the gradient
    inner = np.abs(t) < 1.0 - 2e-6
    np.testing.assert_allclose(g_got.numpy()[inner], np.asarray(g_want)[inner],
                               rtol=1e-5, atol=1e-5)
    assert np.isfinite(g_got.numpy()).all()


def test_named_margins():
    t = torch.linspace(-0.9, 0.9, 7)
    assert torch.equal(tpfc.arcface_margin(t, 0.5),
                       tpfc.combined_margin(t, 1.0, 0.5, 0.0))
    assert torch.equal(tpfc.cosface_margin(t, 0.4), t - 0.4)


def _problem(seed=13, c=256, dim=128, b=128, missing=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, dim)).astype(np.float32)
    emb = rng.standard_normal((b, dim)).astype(np.float32)
    lab = rng.integers(0, c, b).astype(np.int32)
    if missing:
        lab[::5] = -1
    return w, emb, lab


def _jax_loss_and_grads(mesh, pfc, w, emb, lab):
    w_s = jax.device_put(jnp.asarray(w), pfc.weight_sharding())
    emb_s, lab_s = mesh_mod.shard_batch(mesh, (jnp.asarray(emb),
                                               jnp.asarray(lab)))
    fn = jax.jit(jax.value_and_grad(
        lambda W, E: pfc.loss(W, E, lab_s), argnums=(0, 1)))
    loss, (gw, ge) = fn(w_s, emb_s)
    return float(loss), np.asarray(gw), np.asarray(ge)


def _torch_loss_and_grads(pfc, w, emb, lab, direct=False):
    w_t = torch.from_numpy(w).requires_grad_(True)
    e_t = torch.from_numpy(emb).requires_grad_(True)
    if direct:
        loss = tpfc._margin_softmax_ce(
            e_t, w_t, torch.from_numpy(lab), pfc.s, pfc.m1, pfc.m2, pfc.m3,
            direct=True)
    else:
        loss = pfc.loss(w_t, e_t, torch.from_numpy(lab))
    gw, ge = torch.autograd.grad(loss, (w_t, e_t))
    return float(loss.detach()), gw.numpy(), ge.numpy()


@pytest.mark.parametrize("jax_path", ["pallas", "direct"])
@pytest.mark.parametrize("name,missing", [("arcface", False),
                                          ("arcface", True),
                                          ("cosface", False),
                                          ("combined", True)])
def test_loss_and_gradients_match_jax(mesh, name, missing, jax_path):
    m1, m2, m3 = MARGINS[name]
    w, emb, lab = _problem(missing=missing)
    c, dim = w.shape
    kw = dict(ce_pallas=True, pallas_interpret=True) \
        if jax_path == "pallas" else dict(ce_pallas=False,
                                          ce_block_rows=None)
    jp = jpfc.PartialFC(mesh, c, dim, m1=m1, m2=m2, m3=m3, **kw)
    want = _jax_loss_and_grads(mesh, jp, w, emb, lab)
    tp = tpfc.PartialFC(c, dim, m1=m1, m2=m2, m3=m3)
    got = _torch_loss_and_grads(tp, w, emb, lab)
    direct = _torch_loss_and_grads(tp, w, emb, lab, direct=True)
    assert want[0] > 1.0
    for g in (got, direct):
        np.testing.assert_allclose(g[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(g[1], want[1], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(g[2], want[2], rtol=1e-4, atol=1e-6)
    if missing:
        # a row without a positive still feeds the denominator of no loss
        # term: its embedding gets no gradient
        assert (got[2][::5] == 0).all() and (got[2][1] != 0).any()


def test_all_rows_without_a_positive(mesh):
    """Every label −1: no valid row, the loss is 0 and finite (the n_valid
    floor), gradients are zero; and a batch whose every cosine underflows
    the fixed shift keeps a finite log through the denominator floor."""
    w, emb, lab = _problem()
    lab[:] = -1
    c, dim = w.shape
    want = _jax_loss_and_grads(
        mesh, jpfc.PartialFC(mesh, c, dim, ce_pallas=True,
                             pallas_interpret=True), w, emb, lab)
    got = _torch_loss_and_grads(tpfc.PartialFC(c, dim), w, emb, lab)
    assert got[0] == want[0] == 0.0
    assert not got[1].any() and not got[2].any()
    # cosines of −1 against every centre but the row's own: se_x underflows
    # to 0 and the cosface-margined target term exp(64·(−1.4)) too
    e = np.zeros((2, 4), np.float32)
    e[:, 0] = 1.0
    centres = -np.tile(e[:1], (3, 1))
    pfc = tpfc.PartialFC(3, 4, m2=0.0, m3=0.4)
    loss = pfc.loss(torch.from_numpy(centres), torch.from_numpy(e),
                    torch.tensor([0, 1]))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(
        float(loss), math.log(1e-30) - (64.0 * -1.4 - 64.0), rtol=1e-5)


def test_sampling_properties():
    """Every positive kept (also past num_sample, also class 0 beside rows
    without a positive), sorted, unique, of length
    max(num_sample, min(B, num_local)), fresh per generator state."""
    pfc = tpfc.PartialFC(64, 8, sample_rate=0.125)
    assert pfc.num_sample == 8
    rng = np.random.default_rng(7)
    labels = torch.from_numpy(rng.choice(64, size=16, replace=False))
    g = torch.Generator().manual_seed(3)
    index = pfc.sample_indices(labels, g)
    assert index.dtype == torch.int64 and index.shape == (16,)
    assert set(labels.tolist()) <= set(index.tolist())
    assert torch.equal(index, torch.sort(index).values)
    assert len(set(index.tolist())) == 16

    labels = torch.full((8,), -1)
    labels[3] = 0
    seen = set()
    for seed in range(12):
        g = torch.Generator().manual_seed(seed)
        idx = pfc.sample_indices(labels, g)
        assert idx.shape == (8,) and 0 in idx.tolist()
        assert torch.equal(idx, torch.sort(idx).values)
        nxt = pfc.sample_indices(labels, g)         # the generator advanced
        assert not torch.equal(idx, nxt)
        seen.add(tuple(idx.tolist()))
    assert len(seen) == 12

    big = tpfc.PartialFC(40, 8, sample_rate=0.9)    # num_sample 36 > B
    idx = big.sample_indices(torch.tensor([5, 5, 39]),
                             torch.Generator().manual_seed(0))
    assert idx.shape == (36,) and {5, 39} <= set(idx.tolist())


def test_remap_to_sampled_matches_jax():
    index = np.array([0, 3, 4, 9, 17, 30], np.int32)
    lab = np.array([3, -1, 30, 0, 5, 17, 31, 9], np.int32)
    want = np.asarray(jpfc._remap_to_sampled(jnp.asarray(lab),
                                             jnp.asarray(index)))
    got = tpfc._remap_to_sampled(torch.from_numpy(lab),
                                 torch.from_numpy(index).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpfc._shard_local_labels(torch.from_numpy(lab), 0, 31).numpy(),
        np.asarray(jpfc._shard_local_labels(jnp.asarray(lab), 0, 31)))


@pytest.mark.parametrize("jax_path", ["pallas", "direct"])
def test_loss_sampled_matches_jax_on_jax_indices(mesh, jax_path):
    w, emb, lab = _problem(seed=5, missing=True)
    c, dim = w.shape
    kw = dict(ce_pallas=True, pallas_interpret=True) \
        if jax_path == "pallas" else dict(ce_pallas=False)
    jp = jpfc.PartialFC(mesh, c, dim, sample_rate=0.5, **kw)
    w_s = jax.device_put(jnp.asarray(w), jp.weight_sharding())
    emb_s, lab_s = mesh_mod.shard_batch(mesh, (jnp.asarray(emb),
                                               jnp.asarray(lab)))
    index = jp.sample_indices(lab_s, jax.random.PRNGKey(3))
    w_sub = jp.take_rows(w_s, index)
    want, (g_sub, g_emb) = jax.jit(jax.value_and_grad(
        lambda ws, e: jp.loss_sampled(ws, e, lab_s, index),
        argnums=(0, 1)))(w_sub, emb_s)

    tp = tpfc.PartialFC(c, dim, sample_rate=0.5)
    assert tp.num_sample == jp.num_sample == index.shape[0]
    idx_t = torch.from_numpy(np.array(index)).long()
    table = torch.from_numpy(w)
    sub = tp.take_rows(table, idx_t)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(w_sub))
    sub.requires_grad_(True)
    e_t = torch.from_numpy(emb).requires_grad_(True)
    got = tp.loss_sampled(sub, e_t, torch.from_numpy(lab), idx_t)
    gs, ge = torch.autograd.grad(got, (sub, e_t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(g_sub), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(ge.numpy(), np.asarray(g_emb), rtol=1e-4,
                               atol=1e-6)
    assert gs.shape == (tp.num_sample, dim)


def test_take_put_rows_round_trip():
    pfc = tpfc.PartialFC(32, 4, sample_rate=0.25)
    table = pfc.init(torch.Generator().manual_seed(0))
    assert table.shape == (32, 4) and 0.005 < float(table.std()) < 0.02
    before = table.clone()
    index = torch.tensor([1, 4, 30])
    rows = pfc.take_rows(table, index)
    out = pfc.put_rows(table, index, rows + 1.0)
    assert out is table                                   # in place
    assert torch.equal(table[index], before[index] + 1.0)
    keep = torch.ones(32, dtype=torch.bool)
    keep[index] = False
    assert torch.equal(table[keep], before[keep])
    pfc.put_rows(table, index, rows)
    assert torch.equal(table, before)


def test_sampled_loss_runs_and_refusals():
    w, emb, lab = _problem(seed=9, c=64, dim=16, b=8)
    pfc = tpfc.PartialFC(64, 16, sample_rate=0.5)
    w_t = torch.from_numpy(w).requires_grad_(True)
    e_t = torch.from_numpy(emb)
    g = torch.Generator().manual_seed(0)
    l0 = pfc.loss(w_t, e_t, torch.from_numpy(lab), g)
    gw, = torch.autograd.grad(l0, w_t)
    # unsampled rows get exactly no gradient
    assert 8 <= int((gw.abs().sum(1) > 0).sum()) <= pfc.num_sample
    with pytest.raises(ValueError, match="generator"):
        pfc.loss(w_t, e_t, torch.from_numpy(lab))
    # the shards are a mesh's model axis, which must divide the class
    # count (the CLI pads it, as JAX's does)
    from hfa_gp_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(TypeError, match="n_model"):
        tpfc.PartialFC(64, 16, n_model=2)
    with pytest.raises(ValueError, match="pad it"):
        tpfc.PartialFC(65, 16, mesh=Mesh(n_data=1, n_model=2, rank=1))
    sharded = tpfc.PartialFC(64, 16, mesh=Mesh(n_data=1, n_model=2, rank=1))
    assert (sharded.shard, sharded.num_local) == (1, 32)


def test_shard_sampling_follows_the_generator():
    """On a model axis of 2, each shard's negatives come from the step's
    generator as it stands: a generator that advances draws anew every
    call, one in the same state draws the same, and the shards differ."""
    from hfa_gp_tpu_torch.parallel.mesh import Mesh
    shards = [tpfc.PartialFC(4096, 16, sample_rate=0.05,
                             mesh=Mesh(n_data=1, n_model=2, rank=r))
              for r in range(2)]
    lab = torch.from_numpy(
        np.random.default_rng(0).integers(0, 4096, 8).astype(np.int64))
    g = torch.Generator().manual_seed(7)
    first = shards[0].sample_indices(lab, g)
    second = shards[0].sample_indices(lab, g)
    assert first.shape == second.shape == (shards[0].num_sample,)
    assert not torch.equal(first, second)
    # every rank of a shard holds the generator in one state: alike
    again = shards[0].sample_indices(lab, torch.Generator().manual_seed(7))
    assert torch.equal(first, again)
    other = shards[1].sample_indices(lab, torch.Generator().manual_seed(7))
    assert not torch.equal(first, other)
    # each shard keeps the positives of its own classes
    for pfc, idx in ((shards[0], first), (shards[1], other)):
        lo = pfc.shard * pfc.num_local
        mine = lab[(lab >= lo) & (lab < lo + pfc.num_local)] - lo
        assert bool(torch.isin(mine, idx).all())
