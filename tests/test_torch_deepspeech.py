"""The port's DeepSpeech feature extraction (hfa_gp_tpu_torch/preprocess/
deepspeech.py and cli/extract_audio.py) against the JAX package, on the CPU.

Params are made by the JAX package's inits (with seeded nonzero biases, as
any real checkpoint has) and carried across by `preprocess.convert`;
audio is made with numpy from a seed. Clips are at most 1 s: 50 network
steps.

Tolerances:
  * the host feature math (MFCC, context vectors, resampling, windowing,
    the wav reader): exact, since it is the JAX package's numpy code;
  * the TF-cell LSTM mapped onto `nn.LSTM`: 1e-5 of the states' scale;
  * logits and `aud.npy` at full width (2048): 1e-5 of the output's scale
    (fp32 products of depth 2048 and 4096 summed in other orders, and 50
    recurrent steps), against JAX's run padded to a length bucket;
  * card against CPU (card only): 1e-4 of the logits' scale over 10 s, 500
    recurrent steps in cuDNN's order of sums.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.cli import extract_audio as jcli
from hfa_gp_tpu.preprocess import deepspeech as jds
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import extract_audio as tcli
from hfa_gp_tpu_torch.preprocess import convert
from hfa_gp_tpu_torch.preprocess import deepspeech as tds

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

NET_REL = 1e-5


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off as every CLI sets it on the card
    (`cli.common.device_from_args`; cuDNN's convolutions default to TF32,
    about three decimal digits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _close(got, want, rel=NET_REL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _biased(tree, rng):
    return {k: _biased(v, rng) if isinstance(v, dict) else
            (np.asarray(v) + rng.normal(0, 0.05, v.shape).astype(np.float32)
             if np.ndim(v) == 1 else np.asarray(v))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def full_params():
    """JAX `init_deepspeech` at full width with seeded random biases."""
    return _biased(jax.jit(jds.init_deepspeech)(jax.random.PRNGKey(0)),
                   np.random.default_rng(0))


def small_params(seed=0, n_hidden=32):
    """The JAX tree at a narrow width, from the JAX init's own layers."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 7)
    tree = {"h1": jds._dense_init(ks[0], jds.N_INPUT, n_hidden),
            "h2": jds._dense_init(ks[1], n_hidden, n_hidden),
            "h3": jds._dense_init(ks[2], n_hidden, n_hidden),
            "lstm_fw": jds._lstm_init(ks[3], n_hidden, n_hidden),
            "lstm_bw": jds._lstm_init(ks[4], n_hidden, n_hidden),
            "h5": jds._dense_init(ks[5], 2 * n_hidden, n_hidden),
            "logits": jds._dense_init(ks[6], n_hidden, jds.N_CHARS)}
    return _biased(tree, np.random.default_rng(seed))


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
            + rng.normal(0, 0.05, t.shape)) * 8000


# ---------------------------------------------------------------------------
# host feature math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seconds", [0.02, 0.5, 1.0])
def test_mfcc_and_input_vectors_equal_jax(seconds):
    audio = _audio(seconds)
    np.testing.assert_array_equal(tds.mfcc(audio), jds.mfcc(audio))
    np.testing.assert_array_equal(tds.input_vectors(audio),
                                  jds.input_vectors(audio))
    np.testing.assert_array_equal(tds.mel_filterbank(), jds.mel_filterbank())


def test_interpolation_and_windowing_equal_jax():
    feats = np.random.default_rng(1).standard_normal((50, 29)) \
        .astype(np.float32)
    for rate, n in ((25.0, None), (30.0, 37), (25.0, 3)):
        got = tds.interpolate_features(feats, 50.0, rate, n)
        np.testing.assert_array_equal(
            got, jds.interpolate_features(feats, 50.0, rate, n))
        np.testing.assert_array_equal(tds.window_features(got),
                                      jds.window_features(got))


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_load_wav_and_resample_equal_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    frames = rng.integers(0, 256, (300, 2 * width), dtype=np.uint8)
    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(width)
        f.setframerate(22050)
        f.writeframes(frames.tobytes())
    got, sr = tcli.load_wav(path)
    want, wsr = jcli.load_wav(path)
    assert sr == wsr == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcli.resample_linear(got, sr, 16000),
                                  jcli.resample_linear(want, sr, 16000))


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_lstm_matches_jax_scan_in_both_directions():
    units, cin, t = 8, 5, 7
    fw = jax.tree.map(np.asarray, jds._lstm_init(jax.random.PRNGKey(2),
                                                 cin, units))
    bw = jax.tree.map(np.asarray, jds._lstm_init(jax.random.PRNGKey(3),
                                                 cin, units))
    rng = np.random.default_rng(4)
    fw["bias"] = rng.normal(0, 0.3, fw["bias"].shape).astype(np.float32)
    bw["bias"] = rng.normal(0, 0.3, bw["bias"].shape).astype(np.float32)
    xs = rng.standard_normal((t, cin)).astype(np.float32)
    lstm = torch.nn.LSTM(cin, units, bidirectional=True)
    with torch.no_grad():
        for tree, sfx in ((fw, ""), (bw, "_reverse")):
            for name, w in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                                "bias_hh_l0"),
                               tds.lstm_weights_from_tf(tree["kernel"],
                                                        tree["bias"], cin)):
                getattr(lstm, name + sfx).copy_(w)
        out = lstm(torch.from_numpy(xs))[0]
    _close(out[:, :units], jds._lstm_scan(fw, jnp.asarray(xs)))
    _close(out[:, units:], jds._lstm_scan(bw, jnp.asarray(xs),
                                          reverse=True))


def test_net_matches_jax_at_a_narrow_width():
    params = small_params()
    net = convert.deepspeech_from_jax(params)
    x = tds.input_vectors(_audio(0.5))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, jds.deepspeech_apply(params, jnp.asarray(x)))


def test_extract_features_at_full_width_matches_jax_padded_run(full_params):
    net = convert.deepspeech_from_jax(full_params)
    audio = _audio(1.0, seed=5)
    want = jds.extract_features(full_params, audio, fps=25.0, pad_to=64)
    got = tds.extract_features(net, audio, fps=25.0)
    assert got.shape == want.shape == (25, 16, 29)
    assert np.abs(want).max() > 1e-2
    _close(got, want)


def test_init_is_keyed_and_shaped_like_the_converted_jax_tree(full_params):
    ref = convert.deepspeech_from_jax(full_params).state_dict()
    init = tds.init_deepspeech(torch.Generator().manual_seed(0)).state_dict()
    assert {k: v.shape for k, v in init.items()} == \
        {k: v.shape for k, v in ref.items()}
    # zero biases: the forget bias alone stands in b_ih's f slice
    units = tds.N_HIDDEN
    b = init["lstm.bias_ih_l0"]
    assert (b[units:2 * units] == 1.0).all()
    assert (b[:units] == 0).all() and (b[2 * units:] == 0).all()


def test_extract_audio_cli_loads_a_jax_npz(tmp_path):
    """`extract_audio --weights --device cpu` on an npz that the JAX
    package's `save_npz` wrote (the JAX CLI's `--weights` raises on it:
    `load_or_init` calls a `pytree_io.load_pytree` that does not exist)."""
    params = small_params(1)
    pytree_io.save_npz(params, str(tmp_path / "ds.npz"))
    audio = _audio(1.0, seed=6).astype(np.int16)
    with wave.open(str(tmp_path / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(audio.tobytes())
    tcli.main(tcli.build_argparser().parse_args([
        "--wav", str(tmp_path / "a.wav"), "--out", str(tmp_path / "aud.npy"),
        "--weights", str(tmp_path / "ds.npz"), "--n_frames", "30",
        "--device", "cpu"]))
    got = np.load(tmp_path / "aud.npy")
    want = jds.extract_features(params, audio.astype(np.float32),
                                n_frames=30, pad_to=64)
    assert got.shape == (30, 16, 29)
    _close(got, want)
    with pytest.raises(AttributeError):
        jds.load_or_init(str(tmp_path / "ds.npz"))


def test_extract_audio_cli_output_feeds_head_data_audio(tmp_path):
    """The CLI on a tests/fixtures.py audio dataset replaces its aud.npy;
    the port's `HeadDataAudio` reads it."""
    from hfa_gp_tpu_torch.data.dataset import HeadDataAudio
    # imported here: a card's machine may resolve `tests` to another
    # package, and the card-only test of this file must still collect
    from tests.fixtures import make_avatar_dataset
    person = make_avatar_dataset(str(tmp_path), person="obama", n_train=6,
                                 n_test=4, audio=True)
    audio = _audio(0.4, seed=7).astype(np.int16)
    with wave.open(str(tmp_path / "a.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(audio.tobytes())
    small = small_params(2, n_hidden=16)
    pytree_io.save_npz(small, str(tmp_path / "ds.npz"))
    tcli.main(tcli.build_argparser().parse_args([
        "--wav", str(tmp_path / "a.wav"), "--out", person + "/aud.npy",
        "--weights", str(tmp_path / "ds.npz"), "--device", "cpu"]))
    ds = HeadDataAudio("train", size=32, root=str(tmp_path), person="obama")
    assert ds.aud_features.shape == (10, 16, 29)
    img, label, aud, idx = ds[0]
    assert aud.shape == (16, 29) and torch.isfinite(aud).all()


# ---------------------------------------------------------------------------
# card only
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_logits_card_match_cpu_at_full_width(cuda, full_params):
    x = torch.from_numpy(tds.input_vectors(_audio(10.0, seed=8)))
    with torch.no_grad():
        want = convert.deepspeech_from_jax(full_params)(x)
        got = convert.deepspeech_from_jax(full_params, cuda)(x.to(cuda))
    _close(got, want, rel=1e-4)
