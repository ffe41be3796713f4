"""The port's arcface evaluation and export against the JAX package:
`verification` and `ijb` (numpy, bit for bit on the same embeddings),
`load_bin`, the `eval_verification` and `eval_ijb` CLIs on JAX-npz weights,
the converter's way back to the JAX layout, and `train_arcface --val_bin
--export`.

Sizes: MobileFaceNet ("mbf") at its published widths on 112² crops, 12
synthetic pairs, a 12-pair .bin, `tests/test_ijb.py`'s fixture (3 subjects
× 2 templates × 2 media).

Tolerances: the numpy protocol modules are held bit for bit. The CLIs'
embeddings differ from JAX's by fp32 rounding (1e-6 of their scale, see
`test_torch_arcface_backbones.py`), which moves no pair across a
threshold of the 0.01 grid here: accuracies, thresholds and TAR@FAR are
held equal, template scores to 1e-5 (cosines in [−1, 1]). The exported
program runs the same operations as `backbone_apply`: held to 1e-5 of the
embeddings' scale.
"""

import io
import json
import logging
import os
import pickle
import re
import struct

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hfa_gp_tpu.cli import eval_ijb as jax_ijb_cli
from hfa_gp_tpu.cli import eval_verification as jax_ver_cli
from hfa_gp_tpu.models.arcface import ijb as jijb
from hfa_gp_tpu.models.arcface import registry as jreg
from hfa_gp_tpu.models.arcface import verification as jver
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import eval_ijb, eval_verification, train_arcface
from hfa_gp_tpu_torch.models.arcface import convert, ijb, registry
from hfa_gp_tpu_torch.models.arcface import verification as ver
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.utils import convert as tree_io
from hfa_gp_tpu_torch.utils import export
from hfa_gp_tpu_torch.utils.observability import LOGGER_NAME
from tests.test_ijb import _make_fixture
from tests.test_torch_networks import drop_outputs

# One intra-op thread, as the other test_torch_*.py files.
torch.set_num_threads(1)

NET = "mbf"


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A JAX `init_backbone` of mbf saved by the JAX package's
    `pytree_io.save_npz`, twice: {"moved": with running moments away from
    their init (means in ±0.1, variances in [0.5, 1.5]), "init": with the
    init's (0, 1), under which random weights still tell the IJB fixture's
    near-identical crops of one subject from another's}."""
    p, st = jax.jit(lambda k: jreg.init_backbone(k, NET))(
        jax.random.PRNGKey(0))
    p, st = jax.tree.map(np.asarray, (p, st))
    rng = np.random.default_rng(0)
    moved = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.1, 0.1, a.shape)
                         if path[-1].key == "mean"
                         else rng.uniform(0.5, 1.5, a.shape))
        .astype(np.float32), st)
    out = {}
    for name, stats in (("moved", moved), ("init", st)):
        out[name] = str(tmp_path_factory.mktemp("w") / f"{name}.npz")
        pytree_io.save_npz({"params": p, "batch_stats": stats}, out[name])
    return out


def _embeddings(seed, n=40, d=16):
    rng = np.random.default_rng(seed)
    e1 = rng.standard_normal((n, d)).astype(np.float32)
    same = rng.random(n) < 0.5
    e2 = np.where(same[:, None],
                  e1 + 1.3 * rng.standard_normal((n, d)).astype(np.float32),
                  rng.standard_normal((n, d)).astype(np.float32))
    return e1, e2, same


# -- the numpy protocol modules ------------------------------------------


@pytest.mark.parametrize("pca", [0, 6])
def test_verification_is_the_jax_modules_bit_for_bit(pca):
    e1, e2, same = _embeddings(1)
    got = ver.evaluate_kfold(e1, e2, same, pca=pca)
    want = jver.evaluate_kfold(e1, e2, same, pca=pca)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 0.5 < got["accuracy"] < 1.0
    assert ver.kfold_verification(e1, e2, same, n_folds=5) \
        == jver.kfold_verification(e1, e2, same, n_folds=5)

    # evaluate_pairs, flip included: an embedding that tells a flipped
    # image from the original
    w = np.random.default_rng(2).standard_normal((8 * 8 * 3, 16)) \
        .astype(np.float32)

    def embed(x):
        return x.reshape(len(x), -1) @ w

    rng = np.random.default_rng(3)
    im1 = rng.standard_normal((30, 8, 8, 3)).astype(np.float32)
    im2 = im1 + 0.8 * rng.standard_normal(im1.shape).astype(np.float32)
    im2[::2] = rng.standard_normal(im2[::2].shape)
    issame = np.arange(30) % 2 == 1
    assert ver.evaluate_pairs(embed, im1, im2, issame, batch_size=7,
                              pca=pca) \
        == jver.evaluate_pairs(embed, im1, im2, issame, batch_size=7, pca=pca)
    assert ver.evaluate_pairs(embed, im1, im2, issame, use_flip=False) \
        != ver.evaluate_pairs(embed, im1, im2, issame)


def test_ijb_is_the_jax_modules_bit_for_bit():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((24, 16)).astype(np.float32)
    tids = np.repeat(np.arange(6), 4)
    mids = np.tile([0, 0, 1, 2], 6)
    got = ijb.pool_templates(emb, tids, mids)
    want = jijb.pool_templates(emb, tids, mids)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    pairs = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)])
    scores = ijb.verification_scores(got[0], got[1], pairs)
    np.testing.assert_array_equal(
        scores, jijb.verification_scores(want[0], want[1], pairs))
    labels = (pairs[:, 0] // 2 == pairs[:, 1] // 2).astype(int)
    many = rng.standard_normal(2000).astype(np.float32)
    many_lab = (rng.random(2000) < 0.1).astype(int)
    for s, lab in ((scores, labels), (many, many_lab)):
        assert ijb.tar_at_far(s, lab) == jijb.tar_at_far(s, lab)
    gal, prb = got[0][0::2], got[0][1::2]
    assert ijb.rank_k_identification(prb, gal, np.arange(3), np.arange(3),
                                     ks=(1, 2)) \
        == jijb.rank_k_identification(prb, gal, np.arange(3), np.arange(3),
                                      ks=(1, 2))


# -- load_bin and eval_verification ------------------------------------------


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _pairs_images(n_pairs, size, seed):
    """Pairs of uint8 images: the same base with a little noise (issame),
    or two bases."""
    rng = np.random.default_rng(seed)
    issame = np.arange(n_pairs) % 2 == 0
    imgs = []
    for i in range(n_pairs):
        a = rng.integers(0, 256, (size, size, 3))
        b = a + rng.integers(-6, 7, a.shape) if issame[i] \
            else rng.integers(0, 256, a.shape)
        imgs += [np.clip(a, 0, 255).astype(np.uint8),
                 np.clip(b, 0, 255).astype(np.uint8)]
    return imgs, issame


def _py2_pickle(bins, issame) -> bytes:
    """(bins, issame) as Python 2 pickles it: the image bytes as str
    (BINSTRING), which Python 3 decodes as ASCII unless told otherwise."""
    out = [b"\x80\x02]("]
    for b in bins:
        out.append(b"T" + struct.pack("<i", len(b)) + b)
    out.append(b"e](")
    out.extend(b"\x88" if s else b"\x89" for s in issame)
    out.append(b"e\x86.")
    return b"".join(out)


def write_bin(path, n_pairs=12, size=24, seed=5, py2=False):
    imgs, issame = _pairs_images(n_pairs, size, seed)
    bins = [_png(a) for a in imgs]
    with open(path, "wb") as f:
        if py2:
            f.write(_py2_pickle(bins, issame))
        else:
            pickle.dump((bins, list(issame)), f)
    return path


@pytest.mark.parametrize("py2", [False, True], ids=["py3", "py2-str"])
def test_load_bin_reads_a_pickled_bin(tmp_path, py2):
    path = write_bin(str(tmp_path / "p.bin"), n_pairs=4, size=20, py2=py2)
    if py2:
        with open(path, "rb") as f, pytest.raises(UnicodeDecodeError):
            pickle.load(f)
    got = eval_verification.load_bin(path)
    want = jax_ver_cli.load_bin(path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (4, 112, 112, 3) and got[0].dtype == np.float32
    assert -1.0 <= got[0].min() and got[0].max() <= 1.0
    assert got[2].tolist() == [True, False, True, False]


@pytest.mark.parametrize("ours,theirs,required", [
    (eval_verification, jax_ver_cli, []),
    (eval_ijb, jax_ijb_cli, ["--image_path", "ijb"])],
    ids=["eval_verification", "eval_ijb"])
def test_eval_cli_flags_are_the_jax_clis(ours, theirs, required):
    """The JAX CLI's flags with its defaults, plus --device (cuda)."""
    want = vars(theirs.build_argparser().parse_args(required))
    got = vars(ours.build_argparser().parse_args(required))
    assert got.pop("device") == "cuda"
    assert got == want


def test_synthetic_pairs_are_the_jax_clis():
    for g, w in zip(eval_verification.synthetic_pairs(4, 8, 3),
                    jax_ver_cli.synthetic_pairs(4, 8, 3)):
        np.testing.assert_array_equal(g, w)


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("source", ["synthetic", "bin"])
def test_eval_verification_cli_matches_jax(source, jax_npz, tmp_path,
                                           capsys, monkeypatch):
    """Both CLIs on the same JAX npz: the same accuracy, spread and
    threshold, and the same printed line. --synthetic at 6 identities (12
    pairs) instead of 128, in both packages."""
    for mod in (eval_verification, jax_ver_cli):
        small = mod.synthetic_pairs
        monkeypatch.setattr(mod, "synthetic_pairs",
                            lambda small=small: small(n=6))
    flags = ["--network", NET, "--weights", jax_npz["moved"],
             "--batch_size", "16"]
    flags += ["--synthetic"] if source == "synthetic" else \
        ["--bin", write_bin(str(tmp_path / "p.bin"))]
    want = jax_ver_cli.main(jax_ver_cli.build_argparser().parse_args(flags))
    want_line = _last_line(capsys)
    got = eval_verification.main(eval_verification.build_argparser()
                                 .parse_args(flags + ["--device", "cpu"]))
    assert got == want
    assert _last_line(capsys) == want_line
    assert re.fullmatch(r"accuracy [0-9.]+ ± [0-9.]+ \(threshold [0-9.]+, "
                        rf"12 pairs, {NET}\)", want_line), want_line


# -- eval_ijb ---------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ("--canvas", "160"),
    ("--canvas", "100", "--no_flip", "--no_norm_score",
     "--no_detector_score")],
    ids=["defaults", "downscaled-switches-off"])
def test_eval_ijb_cli_matches_jax(flags, jax_npz, tmp_path):
    """`tests/test_ijb.py`'s fixture through both CLIs on the same npz: the
    same pair scores (1e-5) and metrics, same-subject pairs above the
    rest. The 130 × 120 crops fit a canvas of 160 as they are and are
    scaled down, landmarks with them, onto one of 100."""
    root = _make_fixture(str(tmp_path / "ijb"))
    common = ["--image_path", root, "--network", NET, "--weights",
              jax_npz["init"], "--batch_size", "4", "--job", "t", *flags]
    want = jax_ijb_cli.main(jax_ijb_cli.build_argparser().parse_args(
        common + ["--result_dir", str(tmp_path / "jax")]))
    got = eval_ijb.main(eval_ijb.build_argparser().parse_args(
        common + ["--result_dir", str(tmp_path / "port"), "--device",
                  "cpu"]))
    s_got = np.load(str(tmp_path / "port" / "t_scores.npy"))
    s_want = np.load(str(tmp_path / "jax" / "t_scores.npy"))
    assert s_got.shape == s_want.shape == (15,)
    np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-5)
    assert got == want
    with open(tmp_path / "port" / "t_metrics.json") as f:
        assert json.load(f) == got
    # same-subject templates above every cross-subject pair, as in
    # tests/test_ijb.py
    assert got["tar_at_far"]["1e-01"] == 1.0 and got["rank_k"]["1"] == 1.0


# -- the converter's way back, the export, --val_bin ---------------------


@pytest.mark.parametrize("name", ["iresnet18", "mbf", "vit_t"])
def test_backbone_to_jax_inverts_backbone_from_jax(name):
    """A tree of the JAX init's shapes filled with distinct values → the
    port's layout → back: the same arrays bit for bit (the iresnet FC's
    column order, HWIO, grouped convs)."""
    shapes = jax.eval_shape(lambda k: jreg.init_backbone(k, name),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    p, st = jax.tree.map(lambda s: rng.standard_normal(s.shape)
                         .astype(np.float32), shapes)
    tp, ts = convert.backbone_from_jax(name, p, st)
    back_p, back_st = convert.backbone_to_jax(name, tp, ts)
    for tree, back in ((p, back_p), (st, back_st)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node, leaf, err_msg=str(path))


def test_train_val_bin_and_export(tmp_path, caplog):
    """`train_arcface --val_bin --verbose 1 --export` in bf16 (the default):
    the accuracy line every step; `model.pt2` loads with
    `torch.export.load` and matches `backbone_apply` at two batch sizes;
    `model.npz` holds the trained weights in the JAX layout, and
    `eval_verification` on it gives the last logged accuracy;
    `model_cost.json` holds the FLOPs of one image."""
    out = str(tmp_path / "out")
    vbin = write_bin(str(tmp_path / "val.bin"))
    args = train_arcface.build_argparser().parse_args([
        "--device", "cpu", "--network", NET, "--num_classes", "32",
        "--batch_size", "4", "--num_steps", "2", "--val_bin", vbin,
        "--verbose", "1", "--output", out, "--export"])
    with caplog.at_level(logging.INFO, logger=LOGGER_NAME):
        train_arcface.main(args)
    lines = [r.getMessage() for r in caplog.records
             if "verification" in r.getMessage()]
    assert [ln.split("]")[0] for ln in lines] == ["[step 1", "[step 2"]
    m = re.fullmatch(r"\[step 2\] verification acc ([0-9.]+) ± ([0-9.]+)",
                     lines[-1])
    assert m, lines
    assert {"checkpoint", "model.npz", "model.pt2", "model_cost.json"} \
        <= set(os.listdir(out))

    saved = torch.load(os.path.join(out, "checkpoint", "000002"),
                       weights_only=True)
    params, stats = registry.init_backbone(torch.Generator(), NET)
    params.load_state_dict(saved["backbone"])
    stats.load_state_dict(saved["batch_stats"])
    program = torch.export.load(os.path.join(out, "model.pt2")).module()
    for b in (1, 3):
        x = torch.randn((b, 112, 112, 3), generator=torch.Generator()
                        .manual_seed(b))
        with torch.no_grad():
            want = registry.backbone_apply(NET, params, stats, x)
            got = program(x)
        assert got.shape == (b, 512)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))

    tree = tree_io.load_npz(os.path.join(out, "model.npz"))
    tp, ts = convert.backbone_from_jax(NET, tree["params"],
                                       tree["batch_stats"])
    for mine, theirs in ((tp, params), (ts, stats)):
        a, b = mine.state_dict(), theirs.state_dict()
        assert sorted(a) == sorted(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    acc, std, _ = eval_verification.main(
        eval_verification.build_argparser().parse_args([
            "--device", "cpu", "--network", NET, "--weights",
            os.path.join(out, "model.npz"), "--bin", vbin]))
    assert f"{acc:.4f} ± {std:.4f}" == f"{m.group(1)} ± {m.group(2)}"

    with open(os.path.join(out, "model_cost.json")) as f:
        cost = json.load(f)
    want = export.flops(lambda x: registry.backbone_apply(NET, params, stats,
                                                          x),
                        torch.zeros((1, 112, 112, 3)))
    assert cost == want and cost["flops"] > 5e8
    assert ckpt.latest_step(os.path.join(out, "checkpoint")) == 2
    drop_outputs(tmp_path)
