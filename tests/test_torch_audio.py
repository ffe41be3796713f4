"""The port's audio nets, 3DMM and audio heads and their datasets against
the JAX package, on the CPU.

Params are made by the JAX package's inits and carried across by
`utils.convert` (which turns the conv1d weights from WIO to torch's
(cout, cin, k)); inputs are made with numpy from a seed. Tolerances:
1e-5 of the output's scale for the audio nets (a few fp32 convs and
linears, summed in other orders), 1e-4 of the image's scale for the heads
at tests/test_eg3d.py::small_config widths (the MLP, QR, backbone, two
render passes and SR), exact equality for the datasets.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.data import dataset as jdata
from hfa_gp_tpu.models import lpips as jlpips
from hfa_gp_tpu.models.arcface import iresnet as jres
from hfa_gp_tpu.models.avatar import audio as jaud
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu_torch.data import dataset as tdata
from hfa_gp_tpu_torch.models.avatar import audio as taud
from hfa_gp_tpu_torch.models.avatar import heads as theads
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_torch_networks import numpy_tree, torch_small_config

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

AUD_REL = 1e-5
HEAD_REL = 1e-4

JCFG = jheads.AvatarConfig(size=64, dim_shape=8, eg3d=small_config())
TCFG = theads.AvatarConfig(size=64, dim_shape=8,
                           eg3d=torch_small_config("global"))


def _close(got, want, rel):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("win_size", [16, 8])
def test_audio_net_matches_jax(win_size):
    """The window crop is fixed around frame 8: at win_size 8 both read
    frames 4..11 of the 16."""
    jp = _np(jaud.init_audio_net(jax.random.PRNGKey(0), 64, win_size))
    x = np.random.default_rng(0).standard_normal((5, 16, 29)) \
        .astype(np.float32)
    want = jaud.audio_net_apply(jp, jnp.asarray(x), win_size)
    tp = convert.from_jax(jp)
    assert tuple(tp["conv0"]["weight"].shape) == (32, 29, 3)
    got = taud.audio_net_apply(tp, torch.from_numpy(x), win_size)
    assert got.shape == (5, 64)
    _close(got.detach().numpy(), want, AUD_REL)
    if win_size == 8:           # frames outside 4..11 are never read
        y = x.copy()
        y[:, :4] = 1e3
        y[:, 12:] = -1e3
        torch.testing.assert_close(
            taud.audio_net_apply(tp, torch.from_numpy(y), win_size), got,
            rtol=0, atol=0)


def test_audio_att_net_matches_jax_vmap_and_scores_32_channels():
    jp = _np(jaud.init_audio_att_net(jax.random.PRNGKey(1), seq_len=8))
    x = np.random.default_rng(1).standard_normal((3, 8, 64)) \
        .astype(np.float32)
    want = jax.vmap(lambda c: jaud.audio_att_net_apply(jp, c))(
        jnp.asarray(x))
    tp = convert.from_jax(jp)
    got = taud.audio_att_net_apply(tp, torch.from_numpy(x))
    assert got.shape == (3, 64)
    _close(got.detach().numpy(), want, AUD_REL)
    # the scores read channels 0..31 only: changing 32..63 changes the
    # output there and nowhere else
    y = x.copy()
    y[:, :, 32:] = np.random.default_rng(2).standard_normal((3, 8, 32))
    got_y = taud.audio_att_net_apply(tp, torch.from_numpy(y))
    torch.testing.assert_close(got_y[:, :32], got[:, :32], rtol=0, atol=0)
    assert float((got_y[:, 32:] - got[:, 32:]).abs().max()) > 0


def test_audio_nets_gradients_match_jax():
    jn = _np(jaud.init_audio_net(jax.random.PRNGKey(3)))
    ja = _np(jaud.init_audio_att_net(jax.random.PRNGKey(4), seq_len=8))
    x = np.random.default_rng(3).standard_normal((2, 8, 16, 29)) \
        .astype(np.float32)

    def jloss(pn, pa, w):
        codes = jaud.audio_net_apply(pn, w.reshape(16, 16, 29))
        out = jax.vmap(lambda c: jaud.audio_att_net_apply(pa, c))(
            codes.reshape(2, 8, -1))
        return jnp.sum(out * jnp.arange(64.0) / 64)

    want = jax.grad(jloss, argnums=(0, 1))(jn, ja, jnp.asarray(x))
    tn = convert.from_jax(jn).requires_grad_(True)
    ta = convert.from_jax(ja).requires_grad_(True)
    codes = taud.audio_net_apply(tn, torch.from_numpy(x).reshape(16, 16, 29))
    out = taud.audio_att_net_apply(ta, codes.reshape(2, 8, -1))
    (out * torch.arange(64.0) / 64).sum().backward()
    for tree, wtree in ((tn, want[0]), (ta, want[1])):
        wflat = convert.convert_tree(_np(wtree))
        for name, p in tree.named_parameters():
            w = wflat
            for k in name.split("."):
                w = w[k]
            scale = float(w.abs().max())
            assert scale > 0, name
            np.testing.assert_allclose(p.grad.numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)


def test_conv1d_weights_are_the_only_3d_weights_converted():
    """utils.convert turns every 3-D `weight` WIO → (cout, cin, k): the
    audio nets have them, and no other tree the port converts does (the
    RGB avatar with its EG3D generator, LPIPS, iresnet) at full width."""
    x = np.arange(3 * 5 * 7, dtype=np.float32).reshape(3, 5, 7)
    t = convert.convert_tree({"weight": x})["weight"]
    np.testing.assert_array_equal(t.numpy(), x.transpose(2, 1, 0))

    def weights_3d(tree):
        found = []

        def leaf(path, v):
            if path[-1].key == "weight" and len(v.shape) == 3:
                found.append(jax.tree_util.keystr(path))
        jax.tree_util.tree_map_with_path(leaf, tree)
        return found

    key = jax.random.PRNGKey(0)
    trees = {
        "rgb avatar": jax.eval_shape(
            lambda k: jheads.init_avatar_rgb(k, jheads.AvatarConfig()), key),
        "lpips": jax.eval_shape(jlpips.init_lpips, key),
        "iresnet50": jax.eval_shape(
            lambda k: jres.init_iresnet(k, "iresnet50"), key),
    }
    for name, tree in trees.items():
        assert weights_3d(tree) == [], name
    audio = jax.eval_shape(lambda k: {
        "audnet": jaud.init_audio_net(k),
        "audattnet": jaud.init_audio_att_net(k, seq_len=8)}, key)
    assert len(weights_3d(audio)) == 9


@pytest.fixture(scope="module")
def labels():
    return np.concatenate([np.asarray(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=h, mode=None)))
        for h in (1.45, 1.7)])


def test_t3dmm_forward_matches_jax(labels):
    jp = numpy_tree(jheads.init_avatar_3dmm(jax.random.PRNGKey(13), JCFG),
                    np.random.default_rng(13))
    coeffs = np.random.default_rng(14).standard_normal((2, 76)) \
        .astype(np.float32)
    want = jax.jit(lambda p, c, lab: jheads.t3dmm_forward(p, JCFG, c, lab))(
        jp, coeffs, labels)
    with torch.inference_mode():
        got = theads.t3dmm_forward(convert.from_jax(jp), TCFG,
                                   torch.from_numpy(coeffs),
                                   torch.from_numpy(labels))
    assert got.shape == (2, 64, 64, 3)
    _close(got.numpy(), want, HEAD_REL)


def test_audio_forward_matches_jax(labels):
    jp = numpy_tree(jheads.init_avatar_audio(jax.random.PRNGKey(15), JCFG),
                    np.random.default_rng(15))
    code = np.random.default_rng(16).standard_normal((2, 64)) \
        .astype(np.float32)
    want = jax.jit(lambda p, c, lab: jheads.audio_forward(p, JCFG, c, lab))(
        jp, code, labels)
    with torch.inference_mode():
        got = theads.audio_forward(convert.from_jax(jp), TCFG,
                                   torch.from_numpy(code),
                                   torch.from_numpy(labels))
    assert got.shape == (2, 64, 64, 3)
    _close(got.numpy(), want, HEAD_REL)


def test_inits_have_the_jax_trees():
    """The port's seeded inits build the JAX package's keys and shapes,
    so a checkpoint or a converted npz fits either."""
    from hfa_gp_tpu.train import audio as jtrain_audio
    from hfa_gp_tpu_torch.train import audio as ttrain_audio
    g = torch.Generator().manual_seed(0)
    pairs = [
        (jax.eval_shape(lambda k: jheads.init_avatar_3dmm(k, JCFG),
                        jax.random.PRNGKey(0)),
         theads.init_avatar_3dmm(g, TCFG)),
        (jax.eval_shape(lambda k: jtrain_audio.init_audio_params(k, JCFG),
                        jax.random.PRNGKey(0)),
         ttrain_audio.init_audio_params(g, TCFG))]
    for jtree, tp in pairs:
        flat = {}

        def leaf(path, v):
            flat[".".join(p.key for p in path)] = v.shape
        jax.tree_util.tree_map_with_path(leaf, jtree)
        got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
        assert sorted(got) == sorted(flat)
        for n, shape in flat.items():
            want = tuple(shape)
            if len(want) == 3 and n.endswith("weight"):
                want = want[::-1]
            elif len(want) == 4 and n.endswith("weight"):
                want = (want[3], want[2], want[0], want[1])
            elif n.endswith("const") and len(want) == 3:
                want = (want[2], want[0], want[1])
            assert got[n] == want, n


# -- datasets ------------------------------------------------------------------


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    make_avatar_dataset(os.path.join(root, "nerface_dataset"))
    make_avatar_dataset(os.path.join(root, "ad_dataset"), person="obama",
                        n_train=6, n_test=4, audio=True, seed=1)
    return root


def test_head_data_3dmm_matches_jax(roots):
    kw = dict(size=32, root=os.path.join(roots, "nerface_dataset"),
              person="person_3")
    for split in ("train", "test"):
        want, got = jdata.HeadData3DMM(split, **kw), \
            tdata.HeadData3DMM(split, **kw)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            for g_, w_ in zip(got[i], want[i]):
                np.testing.assert_array_equal(g_.numpy(), w_)
        want.rotate_labels(25.0, 5.0)
        got.rotate_labels(25.0, 5.0)
        for i in range(len(want)):
            np.testing.assert_array_equal(got[i][1].numpy(), want[i][1])


def test_head_data_audio_matches_jax_at_the_edges(roots):
    """get_audio and get_audio_window at the first, a middle and the last
    frame: the window is zero-padded outside [0, min(len, len(aud.npy)))
    and that bound is the split's length, not the features'."""
    kw = dict(size=32, root=os.path.join(roots, "ad_dataset"),
              person="obama", smo_size=8)
    for split in ("train", "val"):
        want, got = jdata.HeadDataAudio(split, **kw), \
            tdata.HeadDataAudio(split, **kw)
        n = len(want)
        assert len(got) == n > 0
        for i in range(n):
            g_item, w_item = got[i], want[i]
            for g_, w_ in zip(g_item[:3], w_item[:3]):
                np.testing.assert_array_equal(g_.numpy(), w_)
            assert int(g_item[3]) == w_item[3] == got.frame_index(i)
            np.testing.assert_array_equal(got.get_audio(i),
                                          want.get_audio(i))
            np.testing.assert_array_equal(got.get_audio_window(i),
                                          want.get_audio_window(i))
        by_frame = {got.frame_index(i): i for i in range(n)}
        first, last = by_frame[0], by_frame[n - 1]
        win = got.get_audio_window(first)
        assert not win[:4].any() and win[4].any()
        win = got.get_audio_window(last)
        # frames n-5 .. n-1 are read, n .. n+2 are past the split's end
        assert win[4].any() and not win[5:].any()
        assert got.aud_features.shape[0] > n   # the bound is not aud.npy's
