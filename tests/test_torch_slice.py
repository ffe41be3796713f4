"""The port's whole RGB reenactment slice against the JAX package, at
tests/test_eg3d.py's small_config widths with a 64² encoder:
`heads.rgb_forward` end to end, the `run_recon_video_rgb` entry point on
the tests/fixtures.py dataset, and the port's freedom from JAX.

Params are made by the JAX package's `heads.init_avatar_rgb` and carried
across by `utils.convert` (in memory, and through a flat npz for the CLI).
Tolerance: 1e-4 × max(1, image scale) — encoder, QR, backbone, render and
SR in fp32 with sums taken in other orders; the PNGs written by the CLI
may differ from the JAX frame by one 8-bit level where a value sits on a
rounding edge.
"""

import dataclasses
import glob
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.data.dataset import HeadDataTest
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import common, run_recon_video_rgb
from hfa_gp_tpu_torch.core import camera as tcam
from hfa_gp_tpu_torch.models.avatar import heads as theads
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_torch_networks import drop_outputs, torch_small_avatar

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_avatar_config(fine):
    eg3d = small_config()
    if fine == "stratified":     # the JAX chip path: windowed Pallas sampler
        eg3d = dataclasses.replace(eg3d, render=dataclasses.replace(
            eg3d.render, use_pallas_sampler=True, pallas_interpret=True,
            sampler_dtype=jnp.float32, sampler_tile=8,
            sampler_slab=(32, 40)))
    return jheads.AvatarConfig(size=64, dim_shape=4, eg3d=eg3d)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """tests/fixtures.py dataset with labels of cameras that face the
    head (the fixture's own poses look away from it)."""
    root = str(tmp_path_factory.mktemp("ds"))
    person = make_avatar_dataset(os.path.join(root, "nerface_dataset"))
    label_path = os.path.join(person, "test2", "cropped_images", "test.json")
    with open(label_path) as f:
        labels = json.load(f)["labels"]
    for i, entry in enumerate(labels):
        lab = jcam.flip_yz_label(jcam.sample_camera_label(
            None, horizontal_mean=1.45 + 0.08 * i, mode=None))
        entry[1] = np.asarray(lab)[0].tolist()
    with open(label_path, "w") as f:
        json.dump({"labels": labels}, f)
    return root


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_avatar_config("global")
    return jax.tree.map(np.asarray,
                        jheads.init_avatar_rgb(jax.random.PRNGKey(0), cfg))


def _frames(root, n=4):
    ds = HeadDataTest("test", size=64, root=os.path.join(root,
                                                         "nerface_dataset"),
                      person="person_3")
    items = [ds[i] for i in range(n)]
    return (np.stack([it[0] for it in items]),
            np.stack([it[1] for it in items]))


@pytest.fixture(scope="module")
def jax_frames(jax_params, dataset_root):
    """The 4 test frames and the JAX package's forward of them (exact
    path, global fine placement)."""
    imgs, labels = _frames(dataset_root)
    out = jheads.rgb_forward(jax_params, jax_avatar_config("global"),
                             jnp.asarray(imgs), jnp.asarray(labels))
    return imgs, labels, np.asarray(out)


def _assert_image_close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _port_forward(jax_params, fine, imgs, labels):
    with torch.inference_mode():
        return theads.rgb_forward(convert.from_jax(jax_params),
                                  torch_small_avatar(fine),
                                  torch.from_numpy(imgs),
                                  torch.from_numpy(labels)).numpy()


def test_rgb_forward_matches_jax_exact_path(jax_params, jax_frames):
    imgs, labels, want = jax_frames
    got = _port_forward(jax_params, "global", imgs, labels)
    assert got.shape == want.shape == (4, 64, 64, 3)
    _assert_image_close(got, want)


def test_rgb_forward_matches_jax_chip_path(jax_params, jax_frames):
    imgs, labels = jax_frames[0][:2], jax_frames[1][:2]
    want = np.asarray(jheads.rgb_forward(
        jax_params, jax_avatar_config("stratified"), jnp.asarray(imgs),
        jnp.asarray(labels)))
    got = _port_forward(jax_params, "stratified", imgs, labels)
    assert got.shape == (2, 64, 64, 3)
    _assert_image_close(got, want)


def test_opengl_labels_flip_once(jax_params):
    """A sampled (OpenGL) camera passed with label_convention="opengl"
    renders like its flipped label passed as OpenCV."""
    tp = convert.from_jax(jax_params)
    cfg = torch_small_avatar()
    gl = tcam.sample_camera_label(None, n=1, horizontal_mean=1.5, mode=None)
    latent = torch.zeros(1, cfg.eg3d.num_ws, cfg.dim)
    with torch.inference_mode():
        a = theads.get_image(tp, cfg, latent, gl, label_convention="opengl")
        b = theads.get_image(tp, cfg, latent, tcam.flip_yz_label(gl))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture
def small_cli_config(monkeypatch):
    """The CLI builds full-width configs; the CPU test runs small ones."""
    real = common.avatar_config

    def small(args, **kw):
        real(args, **kw)                 # keep the flag checks
        return torch_small_avatar("global")

    monkeypatch.setattr(common, "avatar_config", small)


def _cli_args(root, out, *extra):
    return run_recon_video_rgb.build_argparser().parse_args([
        "--size", "64", "--dataset_root", root, "--person", "person_3",
        "--latent_dim_shape", "4", "--demo_dir", out, "--demo_name", "t",
        "--render_batch", "3", "--fps", "4", "--device", "cpu", *extra])


def test_cli_renders_the_fixture_dataset(small_cli_config, dataset_root,
                                         jax_params, jax_frames, tmp_path):
    """--model_npz from the JAX package's pytree_io, 4 frames in batches
    of 3: the PNGs match the JAX forward of the same frames."""
    npz = str(tmp_path / "avatar.npz")
    pytree_io.save_npz(jax_params, npz)
    out = str(tmp_path / "demo")
    run_recon_video_rgb.main(_cli_args(dataset_root, out, "--model_npz", npz))
    pngs = sorted(glob.glob(os.path.join(out, "t", "*.png")))
    assert [os.path.basename(p) for p in pngs] == \
        [f"{i:05d}.png" for i in range(4)]
    assert glob.glob(os.path.join(out, "t", "trec.mp4")) \
        or glob.glob(os.path.join(out, "t", "trec.avi"))
    want = jax_frames[2]
    want8 = ((want.clip(-1, 1) + 1) / 2 * 255 + 0.5).clip(0, 255) \
        .astype(np.int16)
    got8 = np.stack([np.asarray(Image.open(p)) for p in pngs]) \
        .astype(np.int16)
    assert got8.shape == (4, 64, 64, 3)
    assert np.abs(got8 - want8).max() <= 1
    drop_outputs(tmp_path)


def test_cli_random_init_and_side_by_side(small_cli_config, dataset_root,
                                          tmp_path, capsys):
    out = str(tmp_path / "demo")
    run_recon_video_rgb.main(_cli_args(dataset_root, out, "--cat_video"))
    assert "random init" in capsys.readouterr().out
    assert len(glob.glob(os.path.join(out, "t", "*.png"))) == 4
    assert glob.glob(os.path.join(out, "t", "tcat.*"))


@pytest.mark.parametrize("flags", [["--n_model", "2"],
                                   ["--no_pallas_sampler"],
                                   ["--model_path", REPO]])
def test_cli_raises_on_what_the_port_does_not_do(small_cli_config,
                                                 dataset_root, tmp_path,
                                                 flags):
    """--n_model 2 splits each frame's rays over 2 ranks: in a world of one
    rank there is no model axis to lay out, and the mesh raises. The last
    case: --model_path reads the files the port's trainer writes; a
    directory (an Orbax checkpoint of the JAX package) raises."""
    if flags[0] == "--n_model":
        with pytest.raises(ValueError, match="needs 2 ranks"):
            run_recon_video_rgb.main(_cli_args(dataset_root,
                                               str(tmp_path / "demo"), *flags))
        assert not os.path.exists(tmp_path / "demo")
        return
    with pytest.raises(NotImplementedError):
        run_recon_video_rgb.main(_cli_args(dataset_root,
                                           str(tmp_path / "demo"), *flags))


@pytest.mark.parametrize("name", ["train_rgb", "train_3dmm", "train_audio",
                                  "run_recon_video_3dmm",
                                  "run_recon_video_audio"])
def test_other_avatar_clis_raise_on_trace_dir(name, tmp_path, monkeypatch):
    """Only run_recon_video_rgb traces, as in the JAX package, which
    ignores --trace_dir in the other five; the port raises rather than
    ignore a flag, before anything is written."""
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"hfa_gp_tpu_torch.cli.{name}")
    args = mod.build_argparser().parse_args(["--trace_dir", "t",
                                             "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="--trace_dir"):
        mod.main(args)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("smooth_sigma", [None, 1.5])
def test_dataset_matches_jax_reader(dataset_root, smooth_sigma):
    from hfa_gp_tpu_torch.data.dataset import HeadDataTest as TorchData
    kw = dict(size=48, root=os.path.join(dataset_root, "nerface_dataset"),
              person="person_3", smooth_sigma=smooth_sigma)
    want, got = HeadDataTest("test", **kw), TorchData("test", **kw)
    assert len(got) == len(want) == 4 and got.ds_path == want.ds_path
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i][0].numpy(), want[i][0])
        np.testing.assert_array_equal(got[i][1].numpy(), want[i][1])


def test_save_image_and_video_match_jax(tmp_path):
    from hfa_gp_tpu.utils.logging import save_image as jax_save
    from hfa_gp_tpu.utils.video import write_mjpeg_avi as jax_avi
    from hfa_gp_tpu_torch.utils.logging import save_image
    from hfa_gp_tpu_torch.utils.video import (write_mjpeg_avi,
                                              write_video_frames)
    img = np.random.default_rng(0).uniform(-1.2, 1.2, (2, 8, 6, 3)) \
        .astype(np.float32)
    jax_save(img, str(tmp_path / "a.png"))
    save_image(torch.from_numpy(img), str(tmp_path / "b.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))
    frames = [np.asarray(Image.open(tmp_path / "a.png"))] * 3
    jax_avi(frames, str(tmp_path / "a.avi"), fps=5)
    write_mjpeg_avi(frames, str(tmp_path / "b.avi"), fps=5)
    assert (tmp_path / "a.avi").read_bytes() == \
        (tmp_path / "b.avi").read_bytes()
    out = write_video_frames(frames, str(tmp_path / "c.mp4"), fps=5)
    assert os.path.getsize(out) > 0


# every entry point with a --device flag, and the flags it needs to parse
DEVICE_CLIS = {
    "cli.train_rgb": [], "cli.train_3dmm": [], "cli.train_audio": [],
    "cli.run_recon_video_rgb": [], "cli.run_recon_video_3dmm": [],
    "cli.run_recon_video_audio": [], "cli.train_arcface": ["--fp32"],
    "cli.process_video": ["--in_root", "frames"],
    "cli.extract_audio": ["--wav", "a.wav", "--out", "aud.npy"],
    "cli.eval_verification": ["--synthetic"],
    "cli.eval_ijb": ["--image_path", "ijb"],
    "cli.train_eg3d": [],
    "tools.fit_selfrecon": [],
}


class _DeviceSetUp(Exception):
    """Raised right after an entry point's device set-up."""


@pytest.mark.parametrize("name", sorted(DEVICE_CLIS))
def test_cli_sets_up_the_card_before_anything_else(name, monkeypatch):
    """`--device cuda` goes through `common.device_from_args` first: without
    a card it raises (no fallback), and with one it turns TF32 off for
    cuDNN's convolutions and the matmuls."""
    mod = importlib.import_module(f"hfa_gp_tpu_torch.{name}")
    args = mod.build_argparser().parse_args(DEVICE_CLIS[name]
                                            + ["--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(args)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    real = common.device_from_args

    def set_up(a):
        real(a)
        raise _DeviceSetUp

    monkeypatch.setattr(common, "device_from_args", set_up)
    with pytest.raises(_DeviceSetUp):
        mod.main(args)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hfa_gp_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 20, names\n"
        "for n in ('core.kernels.flash_ce', 'parallel.partial_fc', "
        "'models.arcface.iresnet', 'models.arcface.registry', "
        "'models.arcface.convert', 'train.arcface', 'cli.train_arcface', "
        "'utils.observability', 'tools.probe_sampler', "
        "'models.avatar.audio', 'train.t3dmm', 'train.audio', "
        "'cli.train_3dmm', 'cli.train_audio', 'cli.run_recon_video_3dmm', "
        "'cli.run_recon_video_audio', 'preprocess.smoothing', "
        "'preprocess.align', 'preprocess.bfm', 'preprocess.pose', "
        "'preprocess.facerecon', 'preprocess.mtcnn', 'preprocess.pipeline', "
        "'preprocess.deepspeech', 'preprocess.warp', 'preprocess.losses', "
        "'preprocess.convert', 'cli.process_video', 'cli.extract_audio', "
        "'models.arcface.mobilefacenet', 'models.arcface.vit', "
        "'models.arcface.norm', 'models.arcface.verification', "
        "'models.arcface.ijb', 'utils.export', 'cli.eval_verification', "
        "'cli.eval_ijb', 'data.poses', 'data.record_dataset', "
        "'tools.convert_pickle', 'tools.convert_avatar', "
        "'tools.convert_lpips', 'tools.convert_facerecon', "
        "'tools.convert_mtcnn', 'tools.convert_deepspeech'):\n"
        "    assert pkg.__name__ + '.' + n in names, n\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'hfa_gp_tpu', 'tools'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
