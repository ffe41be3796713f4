"""The port's converters (`hfa_gp_tpu_torch/tools/convert_*.py`) against the
repository's JAX-side tools (`tools/convert_*.py`) on the same sources,
written in the reference's own file formats by `chip_smoke.py`'s writers:
NVIDIA's persistence pickle of G_ema, the reference trainer's avatar .pt
checkpoints, the `lpips` package's state dict, facenet-pytorch's and
Sandberg's MTCNN weights, Deep3DFaceRecon's checkpoint and a dump of
DeepSpeech 0.1.0's TF variables.

Each source tree is seeded random numbers in the shapes of the JAX
package's init (`jax.eval_shape`, nothing computed), at small widths
where the tree has any. Tolerances: the converters move and reshape
arrays only, so every npz is held to the JAX tool's tree, and to the tree
its source was written from, bit for bit (tolerance 0); a render from a
converted RGB checkpoint is held to JAX's within 1 in 255, as
`test_torch_slice.py` holds its CLI; DeepSpeech features to
`test_torch_deepspeech.py`'s 1e-5 of their scale.
"""

import glob
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

import chip_smoke as writers
from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.data.dataset import HeadDataTest
from hfa_gp_tpu.models import lpips as jlpips
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu.models.eg3d.generator import init_generator
from hfa_gp_tpu.preprocess import deepspeech as jds
from hfa_gp_tpu.preprocess import facerecon as jfacerecon
from hfa_gp_tpu.preprocess import mtcnn as jmtcnn
from hfa_gp_tpu.train import audio as jaudio
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import common, extract_audio, run_recon_video_rgb
from hfa_gp_tpu_torch.tools import (convert_avatar, convert_deepspeech,
                                    convert_facerecon, convert_lpips,
                                    convert_mtcnn, convert_pickle)
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_torch_networks import drop_outputs, torch_small_avatar
from tools import convert_avatar as jtool_avatar
from tools import convert_deepspeech as jtool_deepspeech
from tools import convert_facerecon as jtool_facerecon
from tools import convert_lpips as jtool_lpips
from tools import convert_mtcnn as jtool_mtcnn
from tools import convert_pickle as jtool_pickle

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_like(init, *args, seed=0):
    """Seeded float32 numbers in the shapes of a JAX init's tree."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, *args),
                            jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)


def npz_items(path):
    """The npz's (key, array) pairs in the order they were written."""
    with np.load(path) as f:
        return [(k, f[k]) for k in f.files]


def assert_same_npz(got_path, want_path):
    got, want = npz_items(got_path), npz_items(want_path)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def assert_tree_is(got, want):
    assert writers.trees_equal(got, jax.tree.map(np.asarray, want)) == []


def avatar_cfg(person_2=False):
    return jheads.AvatarConfig(size=64, dim_shape=4, eg3d=small_config(),
                               person_2=person_2)


def run_jax_tool(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    module.main()


# -- the npz layout -----------------------------------------------------------


def test_save_npz_writes_what_pytree_io_writes(tmp_path):
    tree = {"b": {"weight": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "bias": np.float32([1, 2])},
            "a": np.int32(7), "c": {"d": {"e": np.zeros((0, 2))}}}
    convert.save_npz(tree, str(tmp_path / "port.npz"))
    pytree_io.save_npz(tree, str(tmp_path / "jax.npz"))
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert [k for k, _ in npz_items(tmp_path / "port.npz")] == \
        ["b/weight", "b/bias", "a", "c/d/e"]


# -- EG3D ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def eg3d_tree():
    return random_like(init_generator, small_config(), seed=1)


def test_convert_pickle_matches_the_jax_tool_on_a_state_dict_pickle(
        eg3d_tree, tmp_path, capsys):
    """A pickle of {"G_ema": flat state dict}, the layout the JAX tool's
    own test pickles: both tools write the same npz, equal to the tree,
    with conv0 of the up-sampling blocks flipped and const CHW → HWC."""
    import pickle
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in writers.eg3d_state_dict(eg3d_tree).items()}
    with open(tmp_path / "flat.pkl", "wb") as f:
        pickle.dump({"G_ema": sd}, f)
    convert_pickle.main([str(tmp_path / "flat.pkl"),
                         str(tmp_path / "port.npz")])
    assert "parameters" in capsys.readouterr().out
    jtool_pickle.main(str(tmp_path / "flat.pkl"), str(tmp_path / "jax.npz"))
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert_tree_is(convert.load_npz(str(tmp_path / "port.npz")), eg3d_tree)
    # the two traps: an up-sampling conv0 is flipped on top of the
    # transpose, the const is CHW in torch
    b8 = eg3d_tree["backbone"]["b8"]["conv0"]["weight"]
    assert np.array_equal(sd["backbone.synthesis.b8.conv0.weight"].numpy(),
                          b8[::-1, ::-1].transpose(3, 2, 0, 1))
    assert np.array_equal(sd["backbone.synthesis.b4.const"].numpy(),
                          eg3d_tree["backbone"]["b4"]["const"]
                          .transpose(2, 0, 1))
    drop_outputs(tmp_path)


def test_convert_pickle_reads_nvidias_persistent_modules(eg3d_tree,
                                                         tmp_path):
    """The pickle as NVIDIA's `torch_utils.persistence` writes it: every
    module a persistent object whose state is its `__dict__`, the decoder's
    `net` a plain nn.Sequential. The port's walk leaves out the `state`,
    `_modules`, `_parameters` and `_buffers` levels and gives the tree; the
    JAX tool strips only a leading `state.` and finds none of G_ema's names
    (ROADMAP §3, J3)."""
    path = str(tmp_path / "persistent.pkl")
    writers.write_eg3d_pickle(eg3d_tree, path)
    assert "torch_utils.persistence" not in sys.modules
    convert_pickle.main([path, str(tmp_path / "port.npz")])
    assert_tree_is(convert.load_npz(str(tmp_path / "port.npz")), eg3d_tree)
    data = convert_pickle.load_pickle_states(path)
    assert data["training_set_kwargs"] == {"resolution": 512}
    with pytest.raises(KeyError):
        jtool_pickle.convert_generator(jtool_pickle._state_dict(
            jtool_pickle.load_pickle_states(path)["G_ema"]))
    drop_outputs(tmp_path)


# -- avatar checkpoints -------------------------------------------------------


def avatar_tree(head):
    if head == "rgb":
        return random_like(jheads.init_avatar_rgb, avatar_cfg(True), seed=2)
    if head == "3dmm":
        return random_like(jheads.init_avatar_3dmm, avatar_cfg(), seed=3)
    return random_like(jaudio.init_audio_params, avatar_cfg(), seed=4)


@pytest.mark.parametrize("head", ["rgb", "3dmm", "audio"])
def test_convert_avatar_matches_the_jax_tool(head, tmp_path, monkeypatch,
                                             capsys):
    """The reference trainer's {"gen", "g_optim"|"w_optim", "args",
    ["AudNet", "AudAttNet"]} checkpoint: the same npz and `.args.json` as
    the JAX tool, equal to the tree (subspace_2 with the RGB head, the
    audio tree as {"model", "audnet", "audattnet"})."""
    tree = avatar_tree(head)
    src = str(tmp_path / f"{head}.pt")
    writers.write_avatar_pt(tree, head, src)
    port, jnpz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert_avatar.main(["--ckpt", src, "--head", head, "--out", port])
    n = sum(np.size(x) for x in jax.tree.leaves(tree))
    assert f"({n:,} parameters, head={head})" in capsys.readouterr().out
    run_jax_tool(monkeypatch, jtool_avatar,
                 ["--ckpt", src, "--head", head, "--out", jnpz])
    assert_same_npz(port, jnpz)
    assert_tree_is(convert.load_npz(port), tree)
    with open(port + ".args.json") as f, open(jnpz + ".args.json") as g:
        side = json.load(f)
        assert side == json.load(g)
    assert side["latent_dim_style"] == "512"
    if head == "rgb":
        assert "subspace_2" in convert.load_npz(port)
    drop_outputs(tmp_path)


@pytest.mark.parametrize("written,asked,match", [
    ("rgb", "3dmm", "no weights_3dmm"), ("3dmm", "rgb", "no encoder"),
    ("audio", "rgb", "no encoder")])
def test_convert_avatar_refuses_another_head(written, asked, match,
                                             tmp_path, monkeypatch):
    src = str(tmp_path / "a.pt")
    writers.write_avatar_pt(avatar_tree(written), written, src)
    with pytest.raises(SystemExit, match=match) as port:
        convert_avatar.main(["--ckpt", src, "--head", asked, "--out",
                             str(tmp_path / "port.npz")])
    with pytest.raises(SystemExit) as jax_tool:
        run_jax_tool(monkeypatch, jtool_avatar,
                     ["--ckpt", src, "--head", asked, "--out",
                      str(tmp_path / "jax.npz")])
    assert str(port.value) == str(jax_tool.value)
    assert not os.path.exists(tmp_path / "port.npz")
    drop_outputs(tmp_path)


@pytest.fixture
def frames_root(tmp_path):
    """tests/fixtures.py's dataset with cameras that face the head, as in
    test_torch_slice.py."""
    root = str(tmp_path / "ds")
    person = make_avatar_dataset(os.path.join(root, "nerface_dataset"))
    path = os.path.join(person, "test2", "cropped_images", "test.json")
    with open(path) as f:
        labels = json.load(f)["labels"]
    for i, entry in enumerate(labels):
        entry[1] = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
            None, horizontal_mean=1.45 + 0.08 * i, mode=None)))[0].tolist()
    with open(path, "w") as f:
        json.dump({"labels": labels}, f)
    return root


def test_rgb_checkpoint_renders_through_the_port_as_jax_renders_it(
        frames_root, tmp_path, monkeypatch):
    """A reference RGB .pt → the port's converter → `run_recon_video_rgb
    --model_npz --device cpu`, against JAX's forward of the JAX tool's npz
    on the same 4 frames: PNGs within 1 in 255."""
    cfg = avatar_cfg()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda key: jheads.init_avatar_rgb(key, cfg))(jax.random.PRNGKey(0)))
    src = str(tmp_path / "avatar.pt")
    writers.write_avatar_pt(params, "rgb", src)
    npz, jnpz = str(tmp_path / "avatar.npz"), str(tmp_path / "jax.npz")
    convert_avatar.main(["--ckpt", src, "--head", "rgb", "--out", npz])
    run_jax_tool(monkeypatch, jtool_avatar,
                 ["--ckpt", src, "--head", "rgb", "--out", jnpz])
    jtree = pytree_io.load_npz(jnpz)

    ds = HeadDataTest("test", size=64, person="person_3",
                      root=os.path.join(frames_root, "nerface_dataset"))
    imgs, labels = (np.stack(c) for c in zip(*[ds[i] for i in range(4)]))
    want = np.asarray(jax.jit(lambda p, x, c: jheads.rgb_forward(
        p, cfg, x, c))(jtree, jnp.asarray(imgs), jnp.asarray(labels)))

    real = common.avatar_config

    def small(args, **kw):
        real(args, **kw)                 # keep the flag checks
        return torch_small_avatar("global")

    monkeypatch.setattr(common, "avatar_config", small)
    out = str(tmp_path / "demo")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser()
                             .parse_args([
                                 "--size", "64", "--dataset_root",
                                 frames_root, "--person", "person_3",
                                 "--latent_dim_shape", "4", "--demo_dir",
                                 out, "--demo_name", "t", "--render_batch",
                                 "3", "--fps", "4", "--device", "cpu",
                                 "--model_npz", npz]))
    pngs = sorted(glob.glob(os.path.join(out, "t", "*.png")))
    got8 = np.stack([np.asarray(Image.open(p)) for p in pngs]) \
        .astype(np.int16)
    want8 = ((want.clip(-1, 1) + 1) / 2 * 255 + 0.5).clip(0, 255) \
        .astype(np.int16)
    assert got8.shape == (4, 64, 64, 3)
    assert np.abs(got8 - want8).max() <= 1
    drop_outputs(tmp_path)


# -- the preprocessing nets and LPIPS -----------------------------------------


def test_convert_lpips_matches_the_jax_tool(tmp_path):
    tree = random_like(jlpips.init_lpips, seed=5)
    src = str(tmp_path / "lpips.pt")
    writers.write_lpips_pt(tree, src)
    convert_lpips.main([src, str(tmp_path / "port.npz")])
    jtool_lpips.main(src, str(tmp_path / "jax.npz"))
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert_tree_is(convert.load_npz(str(tmp_path / "port.npz")), tree)
    drop_outputs(tmp_path)


def test_convert_lpips_auto_names_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(ImportError, match="`lpips` package"):
        convert_lpips.main(["auto", str(tmp_path / "port.npz")])


def test_convert_facerecon_matches_the_jax_tool(tmp_path):
    tree = random_like(jfacerecon.init_facerecon, seed=6)
    src = str(tmp_path / "epoch_20.pth")
    writers.write_facerecon_pth(tree, src)
    convert_facerecon.main([src, str(tmp_path / "port.npz")])
    jtool_facerecon.main(src, str(tmp_path / "jax.npz"))
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert_tree_is(convert.load_npz(str(tmp_path / "port.npz")), tree)
    drop_outputs(tmp_path)


@pytest.mark.parametrize("layout", ["facenet", "sandberg",
                                    "sandberg-no-transpose"])
def test_convert_mtcnn_matches_the_jax_tool(layout, tmp_path, monkeypatch):
    """facenet-pytorch's three state dicts, and Sandberg's det*.npy with
    the transposed-image protocol baked in (the default) or kept."""
    tree = random_like(jmtcnn.init_mtcnn, seed=7)
    if layout == "facenet":
        paths = writers.write_mtcnn_facenet(tree, str(tmp_path))
        argv = ["--pnet", paths[0], "--rnet", paths[1], "--onet", paths[2]]
        want = tree
    else:
        writers.write_mtcnn_sandberg(tree, str(tmp_path))
        argv = ["--det_dir", str(tmp_path)]
        want = tree
        if layout == "sandberg-no-transpose":
            argv.append("--no-transpose")
            want = jtool_mtcnn.bake_transpose(tree)
    convert_mtcnn.main([*argv, "--out", str(tmp_path / "port.npz")])
    run_jax_tool(monkeypatch, jtool_mtcnn,
                 [*argv, "--out", str(tmp_path / "jax.npz")])
    assert_same_npz(tmp_path / "port.npz", tmp_path / "jax.npz")
    assert_tree_is(convert.load_npz(str(tmp_path / "port.npz")), want)


@pytest.fixture(scope="module")
def deepspeech_tree():
    return random_like(jds.init_deepspeech, seed=8)


def test_convert_deepspeech_matches_the_jax_tool(deepspeech_tree, tmp_path):
    """The JAX tool's `main` cannot write (J2), so its `convert` is the
    reference."""
    src = str(tmp_path / "ds_vars.npz")
    writers.write_deepspeech_vars(deepspeech_tree, src)
    convert_deepspeech.main([src, str(tmp_path / "port.npz")])
    with np.load(src) as f:
        want = jtool_deepspeech.convert(dict(f))
    got = convert.load_npz(str(tmp_path / "port.npz"))
    assert_tree_is(got, want)
    assert_tree_is(got, deepspeech_tree)
    with np.load(src) as f:
        assert [k for k, _ in npz_items(tmp_path / "port.npz")] == \
            [f"{layer}/{part}" for layer, part in (
                convert_deepspeech.NAME_MAP[k] for k in f.files
                if k in convert_deepspeech.NAME_MAP)]
    drop_outputs(tmp_path)


def test_convert_deepspeech_checks_layers_and_shapes(deepspeech_tree):
    with pytest.raises(ValueError, match="missing"):
        convert_deepspeech.convert({"h1": deepspeech_tree["h1"]["weight"]})
    tf_vars = {"h1": np.zeros((10, 2048), np.float32)}
    for tf_name, (layer, part) in convert_deepspeech.NAME_MAP.items():
        tf_vars.setdefault(tf_name, deepspeech_tree[layer][part])
    with pytest.raises(ValueError, match=r"h1/weight.*\(10, 2048\)"):
        convert_deepspeech.convert(tf_vars)


def test_extract_audio_reads_the_converted_deepspeech(tmp_path):
    """`extract_audio --weights` on the port's npz, against the JAX
    package's features of the tree the TF dump was written from."""
    import wave
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.asarray, jax.jit(jds.init_deepspeech)(
        jax.random.PRNGKey(1)))
    for layer in params.values():
        layer["bias"] = (layer["bias"] + rng.normal(
            0, 0.05, layer["bias"].shape)).astype(np.float32)
    writers.write_deepspeech_vars(params, str(tmp_path / "ds_vars.npz"))
    convert_deepspeech.main([str(tmp_path / "ds_vars.npz"),
                             str(tmp_path / "ds.npz")])
    audio = (rng.standard_normal(8000) * 3000).astype(np.int16)
    with wave.open(str(tmp_path / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(audio.tobytes())
    extract_audio.main(extract_audio.build_argparser().parse_args([
        "--wav", str(tmp_path / "a.wav"), "--out", str(tmp_path / "aud.npy"),
        "--weights", str(tmp_path / "ds.npz"), "--n_frames", "12",
        "--device", "cpu"]))
    got = np.load(tmp_path / "aud.npy")
    want = jds.extract_features(params, audio.astype(np.float32),
                                n_frames=12, pad_to=32)
    assert got.shape == (12, 16, 29)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    drop_outputs(tmp_path)


# -- without JAX --------------------------------------------------------------


def test_converters_and_the_record_route_run_without_jax(tmp_path):
    """In a process where `jax`, `hfa_gp_tpu` and the root `tools` cannot
    be imported: every converter, the record dataset and stream and the
    arcface CLI import, `convert_lpips` converts a source, and a record
    pack read through a reader object streams a batch."""
    writers.write_lpips_pt(random_like(jlpips.init_lpips, seed=10),
                           str(tmp_path / "lpips.pt"))
    code = f"""
import io, sys
for name in ("jax", "jaxlib", "hfa_gp_tpu", "tools"):
    sys.modules[name] = None
import numpy as np
from PIL import Image
from hfa_gp_tpu_torch.tools import (convert_avatar, convert_deepspeech,
    convert_facerecon, convert_lpips, convert_mtcnn, convert_pickle)
from hfa_gp_tpu_torch.cli import train_arcface
from hfa_gp_tpu_torch.data import record_dataset as rd
from hfa_gp_tpu_torch.data.dataset import EpochSeededBatches
convert_lpips.main([{str(tmp_path / "lpips.pt")!r},
                    {str(tmp_path / "out.npz")!r}])
buf = io.BytesIO()
Image.fromarray(np.full((20, 20, 3), 9, np.uint8)).save(buf, format="PNG")
recs = [rd.encode_record(buf.getvalue(), i) for i in range(5)]

class Reader:
    def num_records(self):
        return len(recs)
    def read(self, idx):
        return [recs[i] for i in idx]

imgs, labs = EpochSeededBatches(rd.RecordFaceDataset(Reader(), 16), 2).load(3)
assert imgs.shape == (2, 16, 16, 3) and labs.dtype.is_floating_point is False
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("jax", "jaxlib", "hfa_gp_tpu", "tools"))
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "ok"
    assert (tmp_path / "out.npz").exists()
    drop_outputs(tmp_path)
