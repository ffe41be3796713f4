"""The port's arcface slice against the JAX package: the iresnet backbone
(converted weights), the poly schedule, the optimizers on given gradients,
three whole training steps (dense and row-sparse), checkpoints and the
`train_arcface` CLI.

Sizes: iresnet18 at 32² inputs, batch 4, ≤ 512 classes (the CLI always
runs 112² inputs, there at batch 8 and 64 classes).

Tolerances: activations rtol/atol 1e-4 × the reference's scale (fp32 sums
in another order through 20 conv layers; train-mode BN at batch 4 amplifies
them); optimizer updates on given gradients 1e-6 (the same arithmetic,
another rounding order); three steps' losses rtol 1e-3 (as the avatar
trainer's test).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hfa_gp_tpu.models.arcface import iresnet as jres
from hfa_gp_tpu.models.arcface.scheduler import poly_scheduler as jax_poly
from hfa_gp_tpu.parallel import mesh as mesh_mod
from hfa_gp_tpu.parallel.partial_fc import PartialFC as JaxPartialFC
from hfa_gp_tpu.train import arcface as jarc
from hfa_gp_tpu_torch.cli import train_arcface
from hfa_gp_tpu_torch.models.arcface import convert, iresnet, registry
from hfa_gp_tpu_torch.models.arcface.scheduler import poly_scheduler
from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
from hfa_gp_tpu_torch.train import arcface as arc
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.utils import observability
from tests.test_torch_networks import drop_outputs

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)

NET, SIZE, BATCH = "iresnet18", 32, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(seed=0):
    """JAX iresnet18 for 32² inputs with a random, asymmetric FC weight and
    running moments away from their init."""
    p, st = jres.init_iresnet(jax.random.PRNGKey(seed), NET, input_size=SIZE)
    rng = np.random.default_rng(seed)
    p["fc"]["weight"] = jnp.asarray(
        rng.standard_normal(p["fc"]["weight"].shape).astype(np.float32)
        * 0.05)
    st = jax.tree.map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), st)
    return p, st


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_close(got, want, what, tol=1e-4):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


# -- the backbone -------------------------------------------------------------


def test_iresnet_matches_jax_eval_train_and_running_stats():
    p, st = _jax_model()
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    tp, ts = convert.iresnet_from_jax(_np_tree(p), _np_tree(st))
    xt = torch.from_numpy(x)

    want = jax.jit(lambda a, b, c: jres.iresnet_apply(a, b, c, NET))(
        p, st, jnp.asarray(x))
    got = iresnet.iresnet_apply(tp, ts, xt, NET)
    _assert_close(got.detach(), want, "eval embeddings")

    want_t, want_st = jax.jit(lambda a, b, c: jres.iresnet_apply(
        a, b, c, NET, train=True))(p, st, jnp.asarray(x))
    got_t, got_st = iresnet.iresnet_apply(tp, ts, xt, NET, train=True)
    _assert_close(got_t.detach(), want_t, "train embeddings")
    want_flat = dict(_leaves(_np_tree(want_st)))
    got_flat = dict(_leaves(got_st))
    assert sorted(got_flat) == sorted(want_flat) and len(want_flat) == 62
    for k, v in want_flat.items():
        _assert_close(got_flat[k], v, k)
    # the running moments moved, and the stored ones did not
    assert not np.allclose(want_flat["stem_bn.var"],
                           np.asarray(st["stem_bn"]["var"]), rtol=1e-3)
    np.testing.assert_array_equal(ts["stem_bn"]["var"].numpy(),
                                  np.asarray(st["stem_bn"]["var"]))

    # the traps this case must catch. FC columns: the JAX layout's weight,
    # unpermuted, gives other embeddings
    raw = convert.ParamTree(convert._convert_params(_np_tree(p)))
    wrong = iresnet.iresnet_apply(raw, ts, xt, NET).detach().numpy()
    assert np.abs(wrong - np.asarray(want)).max() \
        > 1e-2 * np.abs(np.asarray(want)).max()
    # running variance: the unbiased batch variance (n = 4 rows at the
    # BN1d head) would be 4/3 of the biased one, far outside the bound
    old = np.asarray(st["features_bn"]["var"])
    batch_var = (want_flat["features_bn.var"] - 0.9 * old) / 0.1
    unbiased = 0.9 * old + 0.1 * batch_var * BATCH / (BATCH - 1)
    assert np.abs(unbiased - want_flat["features_bn.var"]).max() \
        > 10 * 1e-4 * np.abs(want_flat["features_bn.var"]).max()


@pytest.mark.parametrize("name", ["iresnet18", "iresnet34", "iresnet50",
                                  "iresnet100"])
def test_init_iresnet_has_the_jax_tree(name):
    """Same keys and, after the layout change, the same shapes as the JAX
    init; the seeded init's statistics."""
    jp, jst = jax.eval_shape(lambda k: jres.init_iresnet(k, name),
                             jax.random.PRNGKey(0))
    tp, tst = iresnet.init_iresnet(torch.Generator().manual_seed(0), name)
    want = {k: (v.shape if len(v.shape) != 4 else
                (v.shape[3], v.shape[2], v.shape[0], v.shape[1]))
            for k, v in _leaves(jp)}
    got = {k: tuple(v.shape) for k, v in tp.state_dict().items()}
    assert got == want
    assert {k: tuple(v.shape) for k, v in tst.state_dict().items()} \
        == {k: v.shape for k, v in _leaves(jst)}
    assert len([k for k in got if k.endswith("conv1")]) \
        == sum(iresnet.IRESNET_LAYERS[name])
    w = tp["s3_b1"]["conv2"]
    np.testing.assert_allclose(float(w.std()), (2.0 / (9 * 512)) ** 0.5,
                               rtol=0.02)
    assert float(tp["fc"]["weight"].std()) == pytest.approx(0.01, rel=0.02)
    assert not any(q.requires_grad for q in tp.parameters())


def test_registry_names_and_refusals():
    """Every name of the JAX registry resolves in the port (MobileFaceNet
    and the ViTs are ported); only an unknown name is refused."""
    from hfa_gp_tpu.models.arcface import registry as jreg
    assert registry.canonical_name("r50") == "iresnet50"
    assert registry.backbone_names() == jreg.backbone_names()
    g = torch.Generator().manual_seed(0)
    p, st = registry.init_backbone(g, "r18")
    x = torch.zeros((2, 112, 112, 3))
    emb = registry.backbone_apply("r18", p, st, x)
    assert emb.shape == (2, 512)
    emb_t, new_st = registry.backbone_apply("iresnet18", p, st, x, train=True)
    assert emb_t.shape == (2, 512) and "s3_b1" in new_st
    for name in ("mbf", "mobilefacenet", "vit_t"):
        p, st = registry.init_backbone(g, name)
        assert registry.backbone_apply(name, p, st, x).shape == (2, 512)
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.backbone_apply("nope", p, st, x)
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.init_backbone(g, "vit_h")


# -- schedule and optimizers ---------------------------------------------------


def test_poly_scheduler_six_steps():
    want = jax_poly(0.1, 6, 2)
    got = poly_scheduler(0.1, 6, 2)
    for step in range(8):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-9)
    assert [got(i) for i in (0, 1, 2, 6)] == [0.0, 0.05, 0.1, 0.0]
    assert poly_scheduler(0.1, 100, 0)(0) == 0.1


def _given_grads(seed, shapes, steps=3):
    rng = np.random.default_rng(seed)
    # the first step's norm is far above the clip, the last one's below it
    scales = [30.0, 1.0, 0.01][:steps]
    return [{k: (s * rng.standard_normal(shape)).astype(np.float32)
             for k, shape in shapes.items()} for s in scales]


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_backbone_optimizer_matches_optax(kind):
    shapes = {"a": (5, 3), "b": (7,)}
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = _given_grads(1, shapes)
    kw = dict(lr=0.1, warmup_steps=1, optimizer=kind, clip_grad_norm=5.0,
              weight_decay=5e-4 if kind == "sgd" else 0.1)
    jtx, _ = jarc.make_optimizers(6, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tx, _ = arc.make_optimizers(6, **kw)
    tp = convert.ParamTree({k: torch.from_numpy(v.copy())
                            for k, v in params.items()})
    tp.requires_grad_(True)
    opt = tx.build(tp)
    # optax takes AdamW's bias correction 1 − 0.999^t in fp32, 1e-5 off in
    # relative terms at t = 1; torch.optim.AdamW takes it in float64. That
    # is 6e-6 of an update of ~lr = 0.1 a step
    atol = 1e-6 if kind == "sgd" else 3e-6
    for count, g in enumerate(grads):
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in shapes:
            tp[k].grad = torch.from_numpy(g[k].copy())
        tx.step(opt, count)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=atol, err_msg=f"{k} {count}")
    norms = [float(np.sqrt(sum((v ** 2).sum() for v in g.values())))
             for g in grads]
    assert norms[0] > 5.0 > norms[-1]


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_dense_head_optimizer_matches_optax(kind):
    """The dense head on given gradients with one all-zero row: SGD decays
    only rows that got a gradient (`_decay_sampled_rows`), AdamW all."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    grads = [g["w"] for g in _given_grads(3, {"w": (6, 4)})]
    for g in grads:
        g[2] = 0.0
    kw = dict(lr=0.1, warmup_steps=1, optimizer=kind,
              weight_decay=5e-2 if kind == "sgd" else 0.1)
    _, jfc = jarc.make_optimizers(6, **kw)
    jw = jnp.asarray(w)
    jstate = jfc.init(jw)
    _, tfc = arc.make_optimizers(6, **kw)
    tw = torch.from_numpy(w.copy())
    bufs = tfc.init(tw)
    for count, g in enumerate(grads):
        upd, jstate = jfc.update(jnp.asarray(g), jstate, jw)
        jw = optax.apply_updates(jw, upd)
        tfc.update_dense(tw, torch.from_numpy(g), bufs, count)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-6, err_msg=str(count))
    if kind == "sgd":
        np.testing.assert_array_equal(tw.numpy()[2], w[2])   # never decayed
        assert sorted(bufs) == ["mom"]
    else:
        assert not np.array_equal(tw.numpy()[2], w[2])
        assert sorted(bufs) == ["m", "v"]


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_row_sparse_update_matches_the_jax_step_arithmetic(kind):
    """`FCOptimizer.update_rows` against the row-sparse arithmetic of the
    JAX step (train/arcface.py: torch-SGD, and AdamW with the global step
    count in the bias correction), written out with the JAX package's
    schedule and hyper-parameters, over 3 steps on given gradients."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [g["w"] for g in _given_grads(5, {"w": (5, 4)})]
    kw = dict(lr=0.1, warmup_steps=1, optimizer=kind,
              weight_decay=5e-2 if kind == "sgd" else 0.1)
    _, jfc = jarc.make_optimizers(6, **kw)
    _, tfc = arc.make_optimizers(6, **kw)
    assert (tfc.kind, tfc.momentum, tfc.weight_decay, tfc.b1, tfc.b2,
            tfc.eps) == (jfc.kind, jfc.momentum, jfc.weight_decay, jfc.b1,
                         jfc.b2, jfc.eps)
    jw = jnp.asarray(w)
    jb = {k: jnp.zeros_like(jw) for k in (("m", "v") if kind == "adamw"
                                          else ("mom",))}
    tw = torch.from_numpy(w.copy())
    tb = {k: torch.zeros_like(tw) for k in jb}
    for count, g in enumerate(grads):
        lr = jfc.sched(count)
        g_sub = jnp.asarray(g)
        if kind == "adamw":
            m_new = jfc.b1 * jb["m"] + (1.0 - jfc.b1) * g_sub
            v_new = jfc.b2 * jb["v"] + (1.0 - jfc.b2) * g_sub ** 2
            t = jnp.float32(count + 1)
            m_hat = m_new / (1.0 - jfc.b1 ** t)
            v_hat = v_new / (1.0 - jfc.b2 ** t)
            jw = jw - lr * (m_hat / (jnp.sqrt(v_hat) + jfc.eps)
                            + jfc.weight_decay * jw)
            jb = {"m": m_new, "v": v_new}
        else:
            buf = jfc.momentum * jb["mom"] + g_sub + jfc.weight_decay * jw
            jw = jw - lr * buf
            jb = {"mom": buf}
        tw, tb = tfc.update_rows(tw, torch.from_numpy(g), tb, count)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-6, err_msg=str(count))
        for k in jb:
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]),
                                       rtol=1e-6, atol=1e-6)


# -- whole steps ------------------------------------------------------------------


def _both_states(mesh, jpfc_, tpfc_, jtx, jfc, ttx, tfc, sparse, seed=0):
    p, st = _jax_model(seed)
    table = (np.random.default_rng(seed + 1).standard_normal(
        (tpfc_.num_classes, 512)) * 0.01).astype(np.float32)
    jw = jax.device_put(jnp.asarray(table), jpfc_.weight_sharding())
    if sparse:
        names = ("m", "v") if jfc.kind == "adamw" else ("mom",)
        jfc_state = {**{k: jnp.zeros_like(jw) for k in names},
                     "count": jnp.zeros((), jnp.int32)}
    else:
        jfc_state = jfc.init(jw)
    jstate = jarc.ArcFaceState(p, st, jw, jtx.init(p), jfc_state,
                               jnp.zeros((), jnp.int32))
    tp, ts = convert.iresnet_from_jax(_np_tree(p), _np_tree(st))
    tp.requires_grad_(True)
    tw = convert.fc_table_from_jax(table)
    tstate = arc.ArcFaceState(tp, ts, tw, ttx.build(tp), tfc.init(tw), 0)
    return jstate, tstate


@pytest.mark.parametrize("mode", ["dense-sgd", "sparse-sgd", "sparse-adamw",
                                  "dense-sgd-bf16"])
def test_three_train_steps_match_jax(mode):
    """Three steps from one state on the same batches. "bf16": the JAX
    CLI's default, a bf16 trunk and bf16 operands of the head's product in
    both packages; each rounds its own conv outputs to bf16, so the losses
    are held to 1e-2 (1.2e-3 seen; PARITY.md delta 1 puts bf16 at about
    2e-2 of fp32) and the running variance to 2e-2 of its scale. What the
    three updates moved is held in relative L2: the backbone as a whole to
    0.25 and the median tensor to 0.3 (0.098 and 0.111 seen), the table to
    0.08 (0.029 seen). JAX's own bf16 steps lie as far from its fp32 steps
    (0.085, 0.098, 0.024), where the fp32 steps of both packages agree to
    0.0033 and 1.2e-4; a table update off by a fifth fails."""
    sparse, kind = mode.startswith("sparse"), mode.split("-")[1]
    bf16 = mode.endswith("bf16")
    classes, rate = 512, 0.25 if sparse else 1.0
    mesh = mesh_mod.make_mesh(n_data=1, n_model=1)
    kw = dict(lr=0.05 if kind == "sgd" else 1e-3, warmup_steps=1,
              optimizer=kind)
    jpfc_ = JaxPartialFC(mesh, classes, 512, sample_rate=rate,
                         ce_pallas=False,
                         matmul_dtype=jnp.bfloat16 if bf16 else None)
    jtx, jfc = jarc.make_optimizers(4, **kw)
    jstep = jarc.make_train_step(
        jpfc_, jtx, jfc, NET, dtype=jnp.bfloat16 if bf16 else jnp.float32,
        donate=False)
    tpfc_ = PartialFC(classes, 512, sample_rate=rate,
                      matmul_dtype=torch.bfloat16 if bf16 else None)
    ttx, tfc = arc.make_optimizers(4, **kw)
    tstep = arc.make_train_step(
        tpfc_, ttx, tfc, NET, dtype=torch.bfloat16 if bf16 else torch.float32)
    jstate, tstate = _both_states(mesh, jpfc_, tpfc_, jtx, jfc, ttx, tfc,
                                  sparse)
    table0 = tstate.fc_weight.numpy().copy()
    jparams0 = jstate.backbone
    rng = np.random.default_rng(7)
    j_losses, t_losses = [], []
    with jax.sharding.set_mesh(mesh):
        for i in range(3):
            x = rng.standard_normal((BATCH, SIZE, SIZE, 3)) \
                .astype(np.float32)
            lab = rng.integers(0, classes, BATCH).astype(np.int32)
            key = jax.random.PRNGKey(i)
            index = None
            if sparse:
                # the index the JAX step draws from this key
                index = torch.from_numpy(np.array(jpfc_.sample_indices(
                    jnp.asarray(lab), jax.random.split(key)[1]))).long()
            jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(lab), key)
            tm = tstep(tstate, torch.from_numpy(x), torch.from_numpy(lab),
                       None, index=index)
            j_losses.append(float(jm["loss"]))
            t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, j_losses,
                               rtol=1e-2 if bf16 else 1e-3)
    assert tstate.step == int(jstate.step) == 3
    # running moments and the table after three updates
    _assert_close(tstate.batch_stats["s1_b0"]["bn2"]["var"].numpy(),
                  jstate.batch_stats["s1_b0"]["bn2"]["var"], "bn var",
                  2e-2 if bf16 else 1e-3)
    assert not np.array_equal(tstate.fc_weight.numpy(), table0)
    if kind == "sgd" and not bf16:
        _assert_close(tstate.fc_weight.numpy(), jstate.fc_weight, "table",
                      1e-3)
        jmom = jstate.fc_opt_state["mom"] if sparse \
            else jstate.fc_opt_state[1][0].trace
        # a momentum row is three steps' head gradients, which carry what
        # train-mode BN at batch 4 makes of the rounding differences
        _assert_close(tstate.fc_opt_state["mom"].numpy(), jmom, "momentum",
                      5e-3)
    if bf16:
        # what the three updates moved, against what JAX's moved
        tp, _ = convert.backbone_to_jax(NET, tstate.backbone,
                                        tstate.batch_stats)
        assert jax.tree.structure(tp) == jax.tree.structure(jparams0)
        moved = [(t - j0, j - j0) for t, j, j0 in zip(
            jax.tree.leaves(tp), jax.tree.leaves(_np_tree(jstate.backbone)),
            jax.tree.leaves(_np_tree(jparams0)))]
        rel = [np.linalg.norm(t - j) / np.linalg.norm(j) for t, j in moved
               if np.linalg.norm(j) > 0]
        whole = (np.sqrt(sum(np.sum((t - j) ** 2) for t, j in moved))
                 / np.sqrt(sum(np.sum(j ** 2) for _, j in moved)))
        jt = np.asarray(jstate.fc_weight) - table0
        table = (np.linalg.norm(tstate.fc_weight.numpy() - table0 - jt)
                 / np.linalg.norm(jt))
        assert whole <= 0.25 and np.median(rel) <= 0.3, (whole, rel)
        assert table <= 0.08, table
    if sparse:
        touched = (tstate.fc_opt_state["mom" if kind == "sgd" else "m"]
                   .abs().sum(1) > 0).sum()
        assert 0 < int(touched) <= 3 * tpfc_.num_sample < classes


# -- checkpoints and the CLI -----------------------------------------------------


def _args(*extra):
    return train_arcface.build_argparser().parse_args([
        "--device", "cpu", "--network", "iresnet18", "--num_classes", "64",
        "--batch_size", "8", "--fp32", *extra])


def _last_line(capsys):
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"samples/sec: ([0-9.]+)  \(loss ([0-9.]+), classes "
                     r"(\d+), sample_rate ([0-9.]+)\)", line)
    assert m, line
    return float(m.group(1)), m.group(2), int(m.group(3)), float(m.group(4))


@pytest.mark.parametrize("extra", [(), ("--sample_rate", "0.25",
                                        "--optimizer", "adamw")],
                         ids=["dense-sgd", "sparse-adamw"])
def test_cli_resume_continues_bit_for_bit(tmp_path, capsys, extra):
    """4 steps straight, against 4 steps with a save every 2, cut back to
    the step-2 checkpoint and resumed: the same last loss, table, backbone,
    running moments and optimizer buffers, bit for bit."""
    out_a, out_b = str(tmp_path / "straight"), str(tmp_path / "resumed")
    sps = train_arcface.main(_args("--num_steps", "4", "--output", out_a,
                                   *extra))
    line_a = _last_line(capsys)
    assert sps == pytest.approx(line_a[0], abs=0.06) and sps > 0
    assert line_a[2] == 64
    assert os.listdir(os.path.join(out_a, "checkpoint")) == ["000004"]

    train_arcface.main(_args("--num_steps", "4", "--output", out_b,
                             "--save_freq", "2", "--log_freq", "1", *extra))
    capsys.readouterr()
    cdir = os.path.join(out_b, "checkpoint")
    assert sorted(os.listdir(cdir)) == ["000002", "000004"]
    os.remove(os.path.join(cdir, "000004"))
    assert ckpt.latest_step(cdir) == 2
    train_arcface.main(_args("--num_steps", "4", "--output", out_b,
                             "--resume", *extra))
    line_b = _last_line(capsys)
    assert line_b[1:] == line_a[1:]                 # the loss, as printed
    a = torch.load(os.path.join(out_a, "checkpoint", "000004"),
                   weights_only=True)
    b = torch.load(os.path.join(cdir, "000004"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["fc_weight"], b["fc_weight"])
    for part in ("backbone", "batch_stats", "fc_opt_state"):
        assert sorted(a[part]) == sorted(b[part])
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and len(sa) > 50
    for k in sa:
        assert all(torch.equal(torch.as_tensor(sa[k][n]),
                               torch.as_tensor(sb[k][n])) for n in sa[k])
    assert not torch.equal(a["batch_stats"]["stem_bn.mean"],
                           torch.zeros(64))
    drop_outputs(tmp_path)


def test_checkpoint_round_trip_of_an_arcface_state(tmp_path):
    pfc = PartialFC(32, 512, sample_rate=0.5)
    tx, fc_tx = arc.make_optimizers(4, lr=0.05)
    state = arc.init_state(torch.Generator().manual_seed(1), pfc, tx, fc_tx,
                           NET)
    step = arc.make_train_step(pfc, tx, fc_tx, NET)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 112, 112, 3), generator=g)
    step(state, x, torch.tensor([3, 7]), g)
    path = ckpt.save(state, str(tmp_path))
    assert path.endswith("000001") and ckpt.latest_step(str(tmp_path)) == 1
    fresh = arc.init_state(torch.Generator().manual_seed(9), pfc, tx, fc_tx,
                           NET)
    assert not torch.equal(fresh.fc_weight, state.fc_weight)
    ckpt.restore(path, fresh)
    assert fresh.step == 1
    assert torch.equal(fresh.fc_weight, state.fc_weight)
    assert torch.equal(fresh.fc_opt_state["mom"], state.fc_opt_state["mom"])
    for (k, a), (_, b) in zip(fresh.backbone.state_dict().items(),
                              state.backbone.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(fresh.batch_stats["bn2"]["var"],
                       state.batch_stats["bn2"]["var"])
    # the restored state steps exactly as the saved one
    la = step(state, x, torch.tensor([1, 2]),
              torch.Generator().manual_seed(5))["loss"]
    lb = step(fresh, x, torch.tensor([1, 2]),
              torch.Generator().manual_seed(5))["loss"]
    assert torch.equal(la, lb)
    drop_outputs(tmp_path)


@pytest.mark.parametrize("flags,match", [
    (("--fp32", "--rec", "x.rec", "--n_model", "2"), "needs 2 ranks"),
    (("--fp32", "--n_model", "2"), "needs 2 ranks"),
    (("--fp32", "--num_processes", "2"), None)])
def test_cli_refuses_what_is_not_ported(flags, match):
    """--n_model 2 in a world of one rank raises, as JAX's make_mesh
    asserts (before --rec opens its file); --num_processes without a
    coordinator is one process, as in JAX."""
    args = train_arcface.build_argparser().parse_args(
        ["--device", "cpu", "--num_classes", "8", "--batch_size", "2",
         "--num_steps", "1", "--network", "iresnet18", *flags])
    if match is None:
        assert train_arcface.main(args) >= 0.0
        return
    with pytest.raises(ValueError, match=match):
        train_arcface.main(args)


def _free_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_cli_refuses_several_processes(monkeypatch):
    """WORLD_SIZE > 1 joins a process group; with no other rank the
    rendezvous fails within distributed.TIMEOUT instead of waiting."""
    import datetime
    import time

    from hfa_gp_tpu_torch.parallel import distributed
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", _free_port())
    monkeypatch.setattr(distributed, "TIMEOUT",
                        datetime.timedelta(seconds=2))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="clients"):
        train_arcface.main(_args("--num_steps", "1"))
    assert time.perf_counter() - t0 < 60
    assert not torch.distributed.is_initialized()


def test_cli_defaults_are_the_jax_clis():
    from hfa_gp_tpu.cli import train_arcface as jax_cli
    want = vars(jax_cli.build_argparser().parse_args([]))
    got = vars(train_arcface.build_argparser().parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_throughput_logger_and_meter(caplog):
    m = observability.AverageMeter()
    m.update(2.0)
    m.update(4.0, 3)
    assert m.avg == pytest.approx(3.5) and m.count == 4
    logger = observability.init_logging()
    assert logger is observability.init_logging()
    assert len(logger.handlers) >= 1
    tlog = observability.ThroughputLogger(2, 8, 16, logger=logger)
    with caplog.at_level("INFO", logger=observability.LOGGER_NAME):
        for step in range(1, 7):
            tlog(step, 10.0 - step, lr=0.1)
    msgs = [r.getMessage() for r in caplog.records]
    # the first interval only starts the clock
    assert len(msgs) == 2 and msgs[0].startswith("step 4/8 loss 7.5000 ")
    assert "samples/sec eta" in msgs[1] and msgs[1].endswith("lr 0.100000")
