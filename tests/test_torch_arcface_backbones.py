"""The port's MobileFaceNet and ViT backbones and the bf16 route of all
three backbone families, against the JAX package; the ViT's masking and
drop path on their own; the init trees of every backbone name; the
`train_arcface` CLI on each family.

Sizes: the published widths (mbf, vit_t) at 112² inputs; iresnet18 at 32²
(as `test_torch_arcface.py`); batch 2 in eval mode and 4 in train mode. At
batch 2 a train-mode BN1d normalises each column by the difference of two
rows, and a column where that difference is near √eps turns rounding of
1e-7 into errors of 1e-3, so train mode is held at batch 4.

Tolerances:
  * fp32, eval and train mode and the running moments: 1e-4 × the
    reference's scale (fp32 sums in another order through ~50 layers), as
    the iresnet test;
  * bf16, eval mode: 3e-2 × the reference's scale. Both packages round
    every conv and matmul output to bf16 (8 bits of mantissa), the port
    with its own summation order; JAX's own bf16 embedding is 1e-2 of the
    scale from its fp32 one at these sizes (PARITY.md delta 1 puts bf16 at
    about 2e-2 of fp32);
  * bf16, train mode at batch 4: 0.15 relative L2. The last BN1d divides
    by the spread of 4 rows, which amplifies the roundings column by
    column; JAX's bf16 train-mode embedding lies 0.05–0.1 from its own
    fp32 one in the L2 norm at this batch.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.models.arcface import iresnet as jres
from hfa_gp_tpu.models.arcface import registry as jreg
from hfa_gp_tpu.models.arcface import vit as jvit
from hfa_gp_tpu_torch.cli import train_arcface
from hfa_gp_tpu_torch.models.arcface import (convert, mobilefacenet,
                                             registry, vit)

# One intra-op thread, as the other test_torch_*.py files.
torch.set_num_threads(1)

FP32_TOL = 1e-4
BF16_TOL = 3e-2
BF16_TRAIN_L2 = 0.15
NODROP = "vit_t_nodrop"   # vit_t's widths with drop path and masking at 0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_close(got, want, what, tol=FP32_TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


@pytest.fixture(scope="module")
def nodrop():
    """A test-local ViT entry in both packages: vit_t with drop path and
    masking off, so that train mode is deterministic."""
    mp = pytest.MonkeyPatch()
    cfg = (9, 256, 12, 8, 4.0, 0.0, 0.0)
    mp.setitem(jvit.VIT_CONFIGS, NODROP, cfg)
    mp.setitem(vit.VIT_CONFIGS, NODROP, cfg)
    yield NODROP
    mp.undo()


@pytest.fixture(scope="module")
def models():
    """JAX-initialised params with running moments away from their init,
    for mbf, vit_t (112²) and iresnet18 (32²)."""
    out = {}
    rng = np.random.default_rng(0)
    for name in ("mbf", "vit_t", "iresnet18"):
        if name == "iresnet18":
            p, st = jax.jit(lambda k: jres.init_iresnet(
                k, name, input_size=32))(jax.random.PRNGKey(0))
        else:
            p, st = jax.jit(lambda k, n=name: jreg.init_backbone(k, n))(
                jax.random.PRNGKey(0))
        st = jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), st)
        out[name] = (p, st)
    return out


def _images(batch, size=112, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _jax_apply(name, p, st, x, train, dtype=jnp.float32):
    return jax.jit(lambda a, b, c: jreg.backbone_apply(
        name, a, b, c, train=train, dtype=dtype,
        rng=jax.random.PRNGKey(0)))(p, st, jnp.asarray(x))


@pytest.mark.parametrize("name", ["mbf", "vit_t"])
def test_backbone_matches_jax_eval_train_and_running_stats(name, models,
                                                          nodrop):
    p, st = models[name]
    tp, ts = convert.backbone_from_jax(name, _np_tree(p), _np_tree(st))
    x = _images(2)
    want = _jax_apply(name, p, st, x, False)
    got = registry.backbone_apply(name, tp, ts, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    _assert_close(got, want, f"{name} eval embeddings")

    # train mode: the ViT with its random parts off
    tname = nodrop if name.startswith("vit") else name
    x = _images(4, seed=2)
    want_t, want_st = _jax_apply(tname, p, st, x, True)
    got_t, got_st = registry.backbone_apply(tname, tp, ts,
                                            torch.from_numpy(x), train=True)
    _assert_close(got_t.detach(), want_t, f"{name} train embeddings")
    want_flat = dict(_leaves(_np_tree(want_st)))
    got_flat = dict(_leaves(got_st))
    assert sorted(got_flat) == sorted(want_flat)
    # mbf: 50 BNs (stem 2, 15 blocks of 3, head 3); vit_t: the head's 2
    assert len(want_flat) == {"mbf": 100, "vit_t": 4}[name]
    for k, v in want_flat.items():
        _assert_close(got_flat[k], v, k)
    some = sorted(want_flat)[0]
    assert not np.allclose(want_flat[some],
                           dict(_leaves(_np_tree(st)))[some], rtol=1e-3)


def test_mobilefacenet_keeps_the_reference_traps(models):
    """The stem's follower groups 64 at a time (2 channels a group in mbf),
    pw2 and the GDC head have no PReLU, and the GDC conv is 7 × 7 with no
    padding, which leaves a 1 × 1 map."""
    p, st = models["mbf"]
    tp, _ = convert.backbone_from_jax("mbf", _np_tree(p), _np_tree(st))
    assert tuple(tp["stem_dw"]["w"].shape) == (128, 2, 3, 3)
    assert "prelu" not in tp["b0"]["pw2"] and "prelu" in tp["b0"]["pw1"]
    assert "prelu" not in tp["head_gdw"]
    assert tuple(tp["head_gdw"]["w"].shape) == (512, 1, 7, 7)
    assert "bias" not in tp["fc"]
    arch = mobilefacenet._arch(*mobilefacenet.MBF_CONFIGS["mbf"])
    assert [a[4] for a in arch] == [False] + [True] * 4 + [False] \
        + [True] * 6 + [False] + [True] * 2


def test_random_masking_keeps_and_restores_the_tokens():
    b, n, d, ratio = 3, 144, 4, 0.1
    # token t of sample s carries the value 1000·s + t in every feature
    ids = (1000 * torch.arange(b)[:, None] + torch.arange(n)[None]).float()
    tok = ids[..., None].expand(b, n, d).contiguous()
    keep = int(n * (1 - ratio))
    g = torch.Generator().manual_seed(3)
    kept, ids_restore = vit.random_masking(tok, keep, g)
    assert kept.shape == (b, keep, d) == (3, 129, 4)
    for s in range(b):
        values = kept[s, :, 0]
        assert len(set(values.tolist())) == keep
        assert bool(((values >= 1000 * s) & (values < 1000 * s + n)).all())
    mask_token = torch.full((d,), -7.0)
    full = vit.restore_masked(kept, mask_token, ids_restore)
    assert full.shape == (b, n, d)
    masked = full[..., 0] == -7.0
    assert masked.sum(1).tolist() == [n - keep] * b
    # every kept token is back at its own place; the masked places hold
    # the mask token in every feature
    assert torch.equal(full[~masked], tok[~masked])
    assert bool((full[masked] == -7.0).all())
    # per sample, and the same for the same seed
    assert not torch.equal(masked[0], masked[1])
    again = vit.random_masking(tok, keep, torch.Generator().manual_seed(3))
    assert torch.equal(again[0], kept) and torch.equal(again[1],
                                                      ids_restore)


def test_drop_path_is_per_sample_and_rescaled():
    rate, b = 0.25, 4000
    x = torch.ones((b, 5, 3))
    y = vit.drop_path(x, rate, torch.Generator().manual_seed(4))
    rows = y.reshape(b, -1)
    kept = rows[:, 0] > 0
    # a whole sample is kept, at 1 / (1 − rate), or dropped
    assert torch.equal(rows, rows[:, :1].expand_as(rows))
    assert torch.allclose(rows[kept], torch.full_like(rows[kept],
                                                      1 / (1 - rate)))
    assert bool((rows[~kept] == 0).all())
    # keep probability 0.75: 4.4 standard deviations of a binomial of 4000
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert abs(float(y.mean()) - 1.0) < 0.04


def test_vit_train_mode_draws_from_the_generator(models):
    """vit_t (drop path 0.1, masking 0.1) in train mode: a seed gives one
    embedding, another seed another; the JAX schedule of drop-path rates."""
    p, st = models["vit_t"]
    tp, ts = convert.backbone_from_jax("vit_t", _np_tree(p), _np_tree(st))
    x = torch.from_numpy(_images(4, seed=5))

    def run(seed):
        return registry.backbone_apply(
            "vit_t", tp, ts, x, train=True,
            generator=torch.Generator().manual_seed(seed))[0].detach()

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.allclose(a, c, atol=1e-3)
    assert torch.isfinite(a).all()
    # no generator: seed 0, as the JAX package's PRNGKey(0)
    assert torch.equal(registry.backbone_apply(
        "vit_t", tp, ts, x, train=True)[0].detach(), a)


@pytest.mark.parametrize("name", ["iresnet18", "mbf", "vit_t"])
def test_bf16_backbones_match_jax_bf16(name, models, nodrop):
    p, st = models[name]
    size = 32 if name == "iresnet18" else 112
    tp, ts = convert.backbone_from_jax(name, _np_tree(p), _np_tree(st))
    x = _images(2, size)
    want = np.asarray(_jax_apply(name, p, st, x, False, jnp.bfloat16))
    got = registry.backbone_apply(name, tp, ts, torch.from_numpy(x),
                                  dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    _assert_close(got, want, f"{name} bf16 eval", BF16_TOL)
    # the route is bf16: the fp32 embedding lies further off than fp32
    # rounding would put it
    fp32 = registry.backbone_apply(name, tp, ts, torch.from_numpy(x))
    assert float((fp32 - got).abs().max()) > 1e-3 * np.abs(want).max()

    tname = nodrop if name.startswith("vit") else name
    x = _images(4, size, seed=2)
    want_t = np.asarray(_jax_apply(tname, p, st, x, True, jnp.bfloat16)[0])
    got_t = registry.backbone_apply(tname, tp, ts, torch.from_numpy(x),
                                    train=True, dtype=torch.bfloat16)[0]
    l2 = np.linalg.norm(got_t.detach().numpy() - want_t) \
        / np.linalg.norm(want_t)
    assert l2 < BF16_TRAIN_L2, l2


def _port_tree_shapes(name):
    """The port's init tree by shape. The ViTs are built on the meta
    device (vit_l's parameters are a gigabyte)."""
    if name.startswith("vit"):
        mp = pytest.MonkeyPatch()
        mp.setattr(vit, "_trunc_normal",
                   lambda g, shape, std=0.02: torch.empty(shape))
        try:
            with torch.device("meta"):
                p, st = registry.init_backbone(torch.Generator(), name,
                                               device="meta")
        finally:
            mp.undo()
    else:
        p, st = registry.init_backbone(torch.Generator().manual_seed(0),
                                       name)
    return ({k: tuple(v.shape) for k, v in p.state_dict().items()},
            {k: tuple(v.shape) for k, v in st.state_dict().items()})


@pytest.mark.parametrize("name", ["mbf", "mbf_large"]
                         + sorted(jvit.VIT_CONFIGS))
def test_init_tree_has_the_jax_shapes(name):
    jp, jst = jax.eval_shape(lambda k: jreg.init_backbone(k, name),
                             jax.random.PRNGKey(0))
    got_p, got_st = _port_tree_shapes(name)
    want = {k: (v.shape if len(v.shape) != 4 else
                (v.shape[3], v.shape[2], v.shape[0], v.shape[1]))
            for k, v in _leaves(jp)}
    assert got_p == want
    assert got_st == {k: v.shape for k, v in _leaves(jst)}


def test_vit_init_statistics():
    p, _ = registry.init_backbone(torch.Generator().manual_seed(0), "vit_t")
    w = p["blk3"]["fc1"]["weight"]
    # N(0, 0.02²) truncated at ±2σ: std 0.02 · 0.8796, |w| ≤ 0.04
    assert float(w.std()) == pytest.approx(0.02 * 0.8796, rel=0.02)
    assert float(w.abs().max()) <= 0.04
    assert float(p["blk3"]["fc1"]["bias"].abs().max()) == 0.0
    assert not any(q.requires_grad for q in p.parameters())


# -- the CLI on each family -------------------------------------------------


def _last_line(out):
    line = out.strip().splitlines()[-1]
    m = re.fullmatch(r"samples/sec: ([0-9.]+)  \(loss ([0-9.]+), classes "
                     r"(\d+), sample_rate ([0-9.]+)\)", line)
    assert m, line
    return float(m.group(2))


@pytest.mark.parametrize("flags,dtype", [
    (("--network", "mbf", "--fp32"), torch.float32),
    (("--network", "vit_t", "--optimizer", "adamw", "--sample_rate", "0.5"),
     torch.bfloat16),
    (("--network", "r18"), torch.bfloat16)],
    ids=["mbf-fp32", "vit_t-adamw-sparse-bf16", "r18-bf16"])
def test_cli_trains_every_family(flags, dtype, capsys, monkeypatch):
    """Each family through `train_arcface.main`, 2 steps on the CPU; without
    --fp32 the trunk runs in bf16 and the head's products take bf16
    operands, as the JAX CLI's default."""
    seen = {}
    make = train_arcface.arc.make_train_step

    def recording(pfc, tx, fc_tx, network, dtype=torch.float32):
        seen.update(network=network, dtype=dtype, mm=pfc.matmul_dtype)
        return make(pfc, tx, fc_tx, network, dtype=dtype)

    monkeypatch.setattr(train_arcface.arc, "make_train_step", recording)
    args = train_arcface.build_argparser().parse_args([
        "--device", "cpu", "--num_classes", "64", "--batch_size", "4",
        "--num_steps", "2", *flags])
    sps = train_arcface.main(args)
    loss = _last_line(capsys.readouterr().out)
    assert sps > 0 and np.isfinite(loss) and loss > np.log(64)
    assert seen["dtype"] == dtype
    assert seen["mm"] == (None if dtype == torch.float32 else torch.bfloat16)
    assert registry.canonical_name(seen["network"]) in \
        registry.backbone_names()


def test_init_and_apply_resolve_every_name():
    """Every JAX name and alias resolves in the port (a smoke run of the
    smallest of each family on one image at eval)."""
    assert registry.backbone_names() == jreg.backbone_names()
    for alias in ("r18", "r34", "r50", "r100", "r200", "r2060",
                  "mobilefacenet"):
        assert registry.canonical_name(alias) == jreg.canonical_name(alias)
    x = torch.zeros((1, 112, 112, 3))
    for name in ("mobilefacenet", "vit_t_dp005_mask0"):
        p, st = registry.init_backbone(torch.Generator().manual_seed(0),
                                       name)
        assert registry.backbone_apply(name, p, st, x).shape == (1, 512)
    with pytest.raises(ValueError, match="unknown backbone"):
        registry.init_backbone(torch.Generator(), "vit_xl")
