"""The avatar CLIs' single-card flags on the port against the JAX package:
the second person's subspace (`--person_2`, `--same_bases`, `--init
--run_id_2`), `--bf16` and `--trace_dir` through `cli/common.py`, and
`data/poses.py`, at tests/test_eg3d.py's small_config widths.

Tolerances: the pivots and trees exactly; the W+ latent 1e-5 (a QR of
fp32 bases in another LAPACK call order); the poses 1e-12 (the same numpy
arithmetic).
"""

import dataclasses
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hfa_gp_tpu.cli import common as jcommon
from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.data import poses as jposes
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu.models.avatar import subspace as jsub
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import common, run_recon_video_rgb, train_rgb
from hfa_gp_tpu_torch.data import poses as tposes
from hfa_gp_tpu_torch.models import lpips as tlpips
from hfa_gp_tpu_torch.models.avatar import heads as theads
from hfa_gp_tpu_torch.models.avatar import subspace as tsub
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.train import rgb as trgb
from hfa_gp_tpu_torch.train.state import init_state
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_poses import _random_poses
from tests.test_torch_networks import torch_small_config

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

DIM_SHAPE, NUM_WS, DIM = 5, 4, 8


def _write_pivots(emb_dir, kinds, rows=6, dim=DIM, seed=0):
    """One directory a kind under emb_dir, named so they sort in order:
    "npy" a 0.npy pivot (rows, dim), "pt" a 0.pt tensor (1, rows, dim),
    "both" the two (the npy is read), "none" no pivot. → {dir: pivot}."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, kind in enumerate(kinds):
        d = os.path.join(emb_dir, f"dir{i:02d}")
        os.makedirs(d)
        base = rng.standard_normal((rows, dim)).astype(np.float32)
        if kind in ("npy", "both"):
            np.save(os.path.join(d, "0.npy"), base)
        if kind in ("pt", "both"):
            other = base if kind == "pt" else base + 1
            torch.save(torch.from_numpy(other)[None], os.path.join(d, "0.pt"))
        out[d] = None if kind == "none" else base
    return out


@pytest.mark.parametrize("kinds", [["npy", "none", "both", "npy", "npy",
                                    "npy"],
                                   ["pt", "pt", "none", "pt"]])
def test_load_pti_bases_matches_jax(tmp_path, kinds):
    """The first DIM_SHAPE directories, sorted; pivots cut to NUM_WS rows;
    a direction without one keeps the default_rng(0) draw."""
    pivots = _write_pivots(str(tmp_path), kinds)
    got = tsub.load_pti_bases(str(tmp_path), DIM_SHAPE, NUM_WS, DIM)
    want = np.asarray(jsub.load_pti_bases(str(tmp_path), DIM_SHAPE, NUM_WS,
                                          DIM))
    assert got.dtype == torch.float32 and got.shape == (DIM_SHAPE,
                                                        NUM_WS * DIM)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, base in enumerate(list(pivots.values())[:DIM_SHAPE]):
        if base is not None:
            np.testing.assert_array_equal(got[i].numpy(),
                                          base[:NUM_WS].ravel())


def _small_avatar(person_2, same_bases, cls):
    eg3d = small_config() if cls is jheads.AvatarConfig \
        else torch_small_config("global")
    return cls(size=64, dim_shape=4, person_2=person_2, same_bases=same_bases,
               eg3d=eg3d)


def _flat_shapes(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_shapes(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v.shape)


@pytest.mark.parametrize("same_bases", [False, True])
def test_init_avatar_rgb_person_2_matches_jax(same_bases):
    """The same tree keys as JAX (subspace_2 without bases under
    same_bases), the subspaces' shapes, init_bases_2 taken as given, the
    other params unchanged by person_2, and get_latent(person_2=True)
    equal to JAX's on the same params."""
    jcfg = _small_avatar(True, same_bases, jheads.AvatarConfig)
    tcfg = _small_avatar(True, same_bases, theads.AvatarConfig)
    bases_2 = np.random.default_rng(1).standard_normal(
        (4, jcfg.eg3d.num_ws * 512)).astype(np.float32)
    jtree = jax.eval_shape(lambda k: jheads.init_avatar_rgb(
        k, jcfg, init_bases_2=bases_2), jax.random.PRNGKey(0))
    want = dict(_flat_shapes(jtree))
    tp = theads.init_avatar_rgb(torch.Generator().manual_seed(0), tcfg,
                                init_bases_2=torch.from_numpy(bases_2))
    got = {k.replace(".", "/"): tuple(v.shape)
           for k, v in tp.state_dict().items()}
    assert sorted(got) == sorted(want)
    assert ("subspace_2/bases" in got) == (not same_bases)
    for k in got:
        if k.startswith("subspace"):
            assert got[k] == want[k], k
    if not same_bases:
        np.testing.assert_array_equal(tp["subspace_2"]["bases"].numpy(),
                                      bases_2)
    np.testing.assert_allclose(tp["subspace_2"]["delta"].numpy(),
                               bases_2.mean(0), rtol=1e-6, atol=1e-6)
    one = theads.init_avatar_rgb(torch.Generator().manual_seed(0),
                                 _small_avatar(False, False,
                                               theads.AvatarConfig))
    for k, v in one.state_dict().items():
        torch.testing.assert_close(tp.state_dict()[k], v, rtol=0, atol=0)

    sub = {top: {k: v.numpy() for k, v in tp[top].state_dict().items()}
           for top in ("subspace", "subspace_2")}
    w = np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32)
    for person_2 in (False, True):
        want_lat = np.asarray(jheads.get_latent(sub, w, jcfg, person_2))
        got_lat = theads.get_latent(tp, torch.from_numpy(w), tcfg, person_2)
        np.testing.assert_allclose(got_lat.numpy(), want_lat, rtol=1e-5,
                                   atol=1e-5)
    a = theads.get_latent(tp, torch.from_numpy(w), tcfg, True)
    b = theads.get_latent(tp, torch.from_numpy(w), tcfg, False)
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("same_bases", [False, True])
def test_converter_and_rgb_forward_carry_subspace_2(tmp_path, same_bases):
    """A JAX-layout flat npz with subspace_2/… (with and without its bases)
    loads through `convert`, and rgb_forward(person_2=True) renders through
    the second subspace: the latent of person 2, not person 1."""
    tcfg = _small_avatar(True, same_bases, theads.AvatarConfig)
    tp = theads.init_avatar_rgb(torch.Generator().manual_seed(0), tcfg)
    jtree = {top: {k: v.numpy() for k, v in tp[top].state_dict().items()}
             for top in ("subspace", "subspace_2")}
    path = str(tmp_path / "sub.npz")
    pytree_io.save_npz(jtree, path)
    back = convert.from_jax(convert.load_npz(path))
    assert sorted(back.state_dict()) == sorted(
        k for k in tp.state_dict() if k.startswith("subspace"))
    for k, v in back.state_dict().items():
        torch.testing.assert_close(v, tp.state_dict()[k], rtol=0, atol=0)

    g = torch.Generator().manual_seed(5)
    image = torch.rand((1, 64, 64, 3), generator=g) * 2 - 1
    label = torch.from_numpy(np.array(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=1.5, mode=None))))
    with torch.inference_mode():
        weights = theads.rgb_get_weights(tp, tcfg, image)
        for person_2 in (True, False):
            got = theads.rgb_forward(tp, tcfg, image, label,
                                     person_2=person_2)
            want = theads.get_image(tp, tcfg, theads.get_latent(
                tp, weights, tcfg, person_2), label)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_adam_leaves_subspace_2_alone_and_checkpoints_keep_it(tmp_path):
    """The RGB loss does not reach subspace_2: its gradients are zeros and
    Adam leaves it as it was, bit for bit, while subspace moves (JAX: the
    same, through optax). A checkpoint holds it, with its Adam state, and
    restores it."""
    tcfg = _small_avatar(True, False, theads.AvatarConfig)
    g = torch.Generator().manual_seed(0)
    state = init_state(theads.init_avatar_rgb(g, tcfg))
    lp = convert.ParamTree(tlpips.init_lpips(g))
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    image = torch.rand((2, 64, 64, 3), generator=g) * 2 - 1
    label = torch.from_numpy(np.array(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=1.5, mode=None)))) \
        .repeat(2, 1)
    for _ in range(2):
        trgb.train_step(state, lp, tcfg, image, label, tune_iter=0)
    after = state.params.state_dict()
    for k in ("subspace_2.bases", "subspace_2.delta"):
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
        assert float(state.params.get_parameter(k).grad.abs().max()) == 0.0
    assert not torch.equal(after["subspace.bases"], before["subspace.bases"])

    path = ckpt.save(state, str(tmp_path))
    fresh = init_state(theads.init_avatar_rgb(
        torch.Generator().manual_seed(9), tcfg))
    ckpt.restore(path, fresh)
    assert fresh.step == 2
    for k, v in fresh.params.state_dict().items():
        torch.testing.assert_close(v, after[k], rtol=0, atol=0)
    opt = fresh.optimizer.state[fresh.params.get_parameter(
        "subspace_2.bases")]
    assert int(opt["step"]) == 2 and float(opt["exp_avg"].abs().max()) == 0
    loaded = ckpt.load_params(path)
    torch.testing.assert_close(loaded["subspace_2"]["bases"],
                               before["subspace_2.bases"], rtol=0, atol=0)


# -- the entry points ----------------------------------------------------------


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """tests/fixtures.py dataset with labels of cameras that face the
    head."""
    root = str(tmp_path_factory.mktemp("ds"))
    person = make_avatar_dataset(os.path.join(root, "nerface_dataset"))
    for split in ("train", "test2"):
        path = os.path.join(person, split, "cropped_images", "test.json")
        with open(path) as f:
            labels = json.load(f)["labels"]
        for i, entry in enumerate(labels):
            entry[1] = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
                None, horizontal_mean=1.4 + 0.07 * i, mode=None)))[0].tolist()
        with open(path, "w") as f:
            json.dump({"labels": labels}, f)
    return root


@pytest.fixture
def small_cli_config(monkeypatch):
    """The CLIs build full-width configs; the CPU test runs small ones with
    the flags' dtypes and second-person switches."""
    real = common.avatar_config

    def small(args, **kw):
        cfg = real(args, **kw)
        return dataclasses.replace(cfg, size=64, eg3d=dataclasses.replace(
            torch_small_config("stratified"),
            compute_dtype=cfg.eg3d.compute_dtype,
            render=dataclasses.replace(
                torch_small_config("stratified").render,
                decoder_dtype=cfg.eg3d.render.decoder_dtype)))

    monkeypatch.setattr(common, "avatar_config", small)


def _flags(root, *extra):
    return ["--size", "64", "--dataset_root", root, "--person", "person_3",
            "--latent_dim_shape", "4", "--device", "cpu", *extra]


def test_train_rgb_person_2_init_then_reenact(small_cli_config, dataset_root,
                                             tmp_path):
    """train_rgb --bf16 --person_2 --init --run_id_2 on PTI pivots (.npy
    and .pt): person 2's bases start as load_pti_bases gives them and stay
    so, the checkpoint holds them, and run_recon_video_rgb --model_path
    reads it back."""
    emb = tmp_path / "emb"
    _write_pivots(str(emb / "r" / "PTI"), ["npy", "pt", "none", "npy"],
                  rows=18, dim=512, seed=3)
    exp = str(tmp_path / "exps") + "/"
    args = train_rgb.build_argparser().parse_args(_flags(
        dataset_root, "--batch_size", "2", "--exp_path", exp, "--iter", "2",
        "--tune_iter", "0", "--display_freq", "100", "--save_freq", "2",
        "--bf16", "--person_2", "p", "--init", "--run_id_2", "r",
        "--emb_dir", str(emb)))
    cfg = common.avatar_config(args)
    assert cfg.eg3d.compute_dtype == torch.bfloat16 and cfg.person_2
    train_rgb.main(args)
    path = os.path.join(exp, "v1", "checkpoint", "000001")
    params = ckpt.load_params(path)
    want = tsub.load_pti_bases(os.path.join(str(emb), "r", "PTI"), 4,
                               cfg.eg3d.num_ws, cfg.dim)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jcommon.load_init_bases_2(args, cfg)))
    torch.testing.assert_close(params["subspace_2"]["bases"], want, rtol=0,
                               atol=0)
    with open(os.path.join(exp, "v1", "log", "metrics.jsonl")) as f:
        assert all(np.isfinite(json.loads(line)["l2_loss"]) for line in f)

    demo = str(tmp_path / "demo")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser().parse_args(
        _flags(dataset_root, "--model_path", path, "--demo_dir", demo,
               "--demo_name", "t", "--render_batch", "4", "--fps", "4",
               "--bf16")))
    pngs = sorted(glob.glob(os.path.join(demo, "t", "*.png")))
    assert len(pngs) == 4
    assert {Image.open(p).size for p in pngs} == {(64, 64)}


def test_run_recon_video_rgb_trace_dir_writes_a_trace(small_cli_config,
                                                      dataset_root, tmp_path):
    """A Chrome trace of the render loop, with the named regions of every
    batch and the sampler's plain version (the CPU route) inside."""
    trace_dir = str(tmp_path / "trace")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser().parse_args(
        _flags(dataset_root, "--demo_dir", str(tmp_path / "demo"),
               "--demo_name", "t", "--render_batch", "2", "--fps", "4",
               "--trace_dir", trace_dir)))
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    for region in ("encoder", "subspace", "synthesis"):
        assert names.count(region) == 2, region       # 4 frames, batch 2
    assert any("grid_sampler" in n for n in names)


def test_avatar_config_takes_the_flags():
    """--bf16 sets the JAX CLI's compute and decoder dtypes and nothing
    else (without it nothing is cast): the encoder, the subspace and LPIPS
    take no dtype and stay fp32, and no autocast region is opened."""
    p = train_rgb.build_argparser()
    base = common.avatar_config(p.parse_args([]))
    assert base.eg3d.compute_dtype is None           # the params' dtype
    assert base.eg3d.render.decoder_dtype is None
    assert not base.person_2 and not base.same_bases
    cfg = common.avatar_config(p.parse_args(["--bf16", "--person_2", "p",
                                             "--same_bases"]))
    assert cfg.eg3d.compute_dtype == cfg.eg3d.render.decoder_dtype \
        == torch.bfloat16
    assert cfg.person_2 and cfg.same_bases
    assert dataclasses.replace(cfg, eg3d=base.eg3d, person_2=False,
                               same_bases=False) == base
    small = common.with_dtype(theads.AvatarConfig(
        size=64, dim_shape=4, eg3d=torch_small_config()), torch.bfloat16)
    tp = theads.init_avatar_rgb(torch.Generator().manual_seed(0), small)
    image = torch.zeros((1, 64, 64, 3))
    with torch.inference_mode():
        weights = theads.rgb_get_weights(tp, small, image)
        latent = theads.get_latent(tp, weights, small)
        assert not torch.is_autocast_enabled()
    assert weights.dtype == latent.dtype == torch.float32


@pytest.mark.parametrize("fn", ["average_poses", "center_poses",
                                "create_spiral_poses",
                                "create_spheric_poses"])
def test_poses_match_jax(fn):
    """tests/test_poses.py's inputs through both packages' numpy."""
    args = {"average_poses": (_random_poses(),),
            "center_poses": (_random_poses(7, seed=3),),
            "create_spiral_poses": (np.array([1.0, 1.0, 0.5]), 4.0, 24),
            "create_spheric_poses": (3.0, 12)}[fn]
    got, want = getattr(tposes, fn)(*args), getattr(jposes, fn)(*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
