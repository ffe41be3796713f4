"""The port's preprocessing chain (hfa_gp_tpu_torch/preprocess and
cli/process_video.py) against the JAX package, on the CPU.

Params are made by the JAX package's inits, with seeded random values put in
where the init leaves a net trivial (the face-recon heads are zero and its
BN statistics the identity), and carried across by `preprocess.convert`;
inputs are made with numpy from a seed.

Tolerances:
  * host code copied from the JAX package (`align`, NMS, JSON, the
    pipeline's crops): exact, pixel for pixel and byte for byte;
  * smoothing: 3e-7 of the landmarks' scale (scipy's float64 filter
    against JAX's float32 convolution: one float32 rounding);
  * the small fp32 nets (MTCNN, the pose and BFM functions, the warp, the
    losses): 1e-5 of the output's scale (sums in other orders); the
    perceptual loss through the port's iresnet18: 1e-4 (18 conv layers);
  * the ResNet-50 regressor: 1e-5 of the coefficients' scale (53 layers of
    fp32 convolutions);
  * `detect_faces` at thresholds no probability lies within 1e-3 of, so
    that rounding cannot flip a decision: boxes and keypoints to 1e-4 px
    times max(1, coordinate scale);
  * labels and cameras written by `process_video`: 1e-5.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hfa_gp_tpu.preprocess import align as jalign
from hfa_gp_tpu.preprocess import bfm as jbfm
from hfa_gp_tpu.preprocess import facerecon as jrecon
from hfa_gp_tpu.preprocess import losses as jlosses
from hfa_gp_tpu.preprocess import mtcnn as jmtcnn
from hfa_gp_tpu.preprocess import pipeline as jpipe
from hfa_gp_tpu.preprocess import pose as jpose
from hfa_gp_tpu.preprocess import smoothing as jsmooth
from hfa_gp_tpu.preprocess import warp as jwarp
from hfa_gp_tpu.utils import pytree_io
from hfa_gp_tpu_torch.cli import process_video as cli
from hfa_gp_tpu_torch.preprocess import align as talign
from hfa_gp_tpu_torch.preprocess import bfm as tbfm
from hfa_gp_tpu_torch.preprocess import convert
from hfa_gp_tpu_torch.preprocess import facerecon as trecon
from hfa_gp_tpu_torch.preprocess import losses as tlosses
from hfa_gp_tpu_torch.preprocess import mtcnn as tmtcnn
from hfa_gp_tpu_torch.preprocess import pipeline as tpipe
from hfa_gp_tpu_torch.preprocess import pose as tpose
from hfa_gp_tpu_torch.preprocess import smoothing as tsmooth
from hfa_gp_tpu_torch.preprocess import warp as twarp

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

NET_REL = 1e-5
SMOOTH_REL = 3e-7
LABEL_ATOL = 1e-5


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=NET_REL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# ---------------------------------------------------------------------------
# smoothing, align, pose, BFM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 3, 8, 9, 40])
def test_smoothing_matches_jax(t):
    seq = np.random.default_rng(t).uniform(0, 1280, (t, 5, 2)) \
        .astype(np.float32)
    want = jsmooth.smooth_landmark_sequence(seq)
    got = tsmooth.smooth_landmark_sequence(seq)
    assert got.shape == seq.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SMOOTH_REL * np.abs(want).max())


def _lm5(rng, cx=200.0, cy=150.0, s=1.0):
    base = np.array([[-30, -20], [30, -20], [0, 10], [-20, 40], [20, 40]],
                    np.float32)
    return base * s + [cx, cy] + rng.normal(0, 1.5, (5, 2)) \
        .astype(np.float32)


def test_align_img_and_crop_final_equal_pixel_for_pixel():
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 255, (300, 400, 3), np.uint8))
    raw = _lm5(rng)
    lm = jalign.flip_landmarks_y(raw, 300)
    np.testing.assert_array_equal(talign.flip_landmarks_y(raw, 300), lm)
    for rescale in (jalign.RESCALE_FACTOR_RECON, jalign.RESCALE_FACTOR_CROP):
        want = jalign.align_img(img, lm, jpipe.DEFAULT_LM3D_STD,
                                rescale_factor=rescale)
        got = talign.align_img(img, lm, tpipe.DEFAULT_LM3D_STD,
                               rescale_factor=rescale)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(talign.crop_final(got[3])),
                                  np.asarray(jalign.crop_final(want[3])))
    lm68 = rng.uniform(0, 200, (68, 2))
    np.testing.assert_array_equal(talign.extract_5p(lm68),
                                  jalign.extract_5p(lm68))


def test_pose_and_labels_match_jax():
    rng = np.random.default_rng(2)
    angle = rng.uniform(-0.4, 0.4, (5, 3)).astype(np.float32)
    trans = rng.uniform(-0.5, 0.5, (5, 3)).astype(np.float32)
    _close(tpose.pose_from_coeffs(_t(angle), _t(trans)),
           jpose.pose_from_coeffs(jnp.asarray(angle), jnp.asarray(trans)))
    _close(tpose.labels_from_coeffs(_t(angle), _t(trans)),
           jpose.labels_from_coeffs(jnp.asarray(angle), jnp.asarray(trans)))
    np.testing.assert_array_equal(tpose.intrinsics_1024(),
                                  jpose.intrinsics_1024())


def _bfm_pair(n_vert=40, n_face=60, seed=0):
    """A synthesized BFMData for each package; point_buf pads with the zero
    face (index F), as BFM_model_front.mat does."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        mean_shape=rng.standard_normal(n_vert * 3).astype(np.float32),
        id_base=rng.standard_normal((n_vert * 3, 80)).astype(np.float32),
        exp_base=rng.standard_normal((n_vert * 3, 64)).astype(np.float32),
        mean_tex=rng.uniform(0, 255, n_vert * 3).astype(np.float32),
        tex_base=rng.standard_normal((n_vert * 3, 80)).astype(np.float32),
        keypoints=rng.integers(0, n_vert, 68),
        face_buf=rng.integers(0, n_vert, (n_face, 3)),
        point_buf=rng.integers(0, n_face + 1, (n_vert, 8)))
    assert (arrays["point_buf"] == n_face).any()
    return (jbfm.BFMData(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tbfm.BFMData(**{k: torch.from_numpy(v)
                            for k, v in arrays.items()}))


def test_bfm_matches_jax():
    jmodel, tmodel = _bfm_pair()
    rng = np.random.default_rng(3)
    coeffs = (rng.standard_normal((2, 257)) * 0.1).astype(np.float32)
    for got, want in zip(tbfm.compute_for_render(tmodel, _t(coeffs)),
                         jax.jit(lambda c: jbfm.compute_for_render(
                             jmodel, c))(jnp.asarray(coeffs))):
        _close(got, want)
    cd = jbfm.split_coeff(jnp.asarray(coeffs))
    for k, v in tbfm.split_coeff(_t(coeffs)).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(cd[k]))
    shape = jbfm.compute_shape(jmodel, cd["id"], cd["exp"])
    jnorm = jbfm.compute_norm(jmodel, shape)
    tnorm = tbfm.compute_norm(tmodel, _t(shape))
    _close(tnorm, jnorm)
    tex = jbfm.compute_texture(jmodel, cd["tex"])
    _close(tbfm.compute_color(_t(tex), tnorm, _t(cd["gamma"])),
           jbfm.compute_color(tex, jnorm, cd["gamma"]))


def test_load_bfm_reads_the_mat_layout(tmp_path):
    from scipy.io import savemat
    rng = np.random.default_rng(4)
    n_vert, n_face = 12, 10
    mat = {"meanshape": rng.standard_normal((1, 3 * n_vert)),
           "idBase": rng.standard_normal((3 * n_vert, 80)),
           "exBase": rng.standard_normal((3 * n_vert, 64)),
           "meantex": rng.uniform(0, 255, (1, 3 * n_vert)),
           "texBase": rng.standard_normal((3 * n_vert, 80)),
           "keypoints": rng.integers(1, n_vert + 1, (1, 68)).astype(float),
           "tri": rng.integers(1, n_vert + 1, (n_face, 3)).astype(float),
           "point_buf": rng.integers(1, n_face + 2, (n_vert, 8))
           .astype(float)}
    savemat(tmp_path / "bfm.mat", mat)
    want = jbfm.load_bfm(str(tmp_path / "bfm.mat"))
    got = tbfm.load_bfm(str(tmp_path / "bfm.mat"))
    for name in want.__dataclass_fields__:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == (np.int64 if w.dtype.kind == "i" else np.float32)
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_recon_init():
    return _np(jax.jit(jrecon.init_facerecon)(jax.random.PRNGKey(0)))


def random_recon_params(seed=0):
    """JAX `init_facerecon` with seeded random BN statistics and heads
    (the init's heads are zero), scaled so the coefficients are O(0.3)."""
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias", "mean",
                                                  "var"}:
                c = v["scale"].shape
                out[k] = {"scale": rng.uniform(0.5, 1.0, c),
                          "bias": rng.normal(0, 0.1, c),
                          "mean": rng.normal(0, 0.1, c),
                          "var": rng.uniform(0.5, 2.0, c)}
            elif k.startswith("head"):
                out[k] = {"weight": rng.normal(0, 1e-3, v["weight"].shape),
                          "bias": rng.normal(0, 0.1, v["bias"].shape)}
            elif isinstance(v, dict):
                out[k] = fill(v)
            else:
                out[k] = v
        return out

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        fill(_jax_recon_init()))


def test_facerecon_matches_jax_with_random_heads_and_statistics():
    params = random_recon_params()
    net = convert.facerecon_from_jax(params)
    x = np.random.default_rng(5).uniform(0, 1, (2, 224, 224, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jrecon.facerecon_apply)(params,
                                                      jnp.asarray(x)))
    with torch.no_grad():
        got = net(_t(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 257) and np.abs(want).max() > 0.1
    _close(got, want)
    net.train()                          # BN keeps its stored statistics
    with torch.no_grad():
        _close(net(_t(x).permute(0, 3, 1, 2)), want)


def test_facerecon_init_is_zero_headed_and_keyed_like_jax():
    net = trecon.init_facerecon(torch.Generator().manual_seed(0))
    flat = pytree_io._flatten(_jax_recon_init())
    want = {k.replace("/", ".") if k.split("/")[-1] in (
        "weight", "bias", "scale", "mean", "var") else
        k.replace("/", ".") + ".weight" for k in flat}
    assert set(net.state_dict()) == want
    with torch.no_grad():
        out = net(torch.rand(1, 3, 224, 224))
    assert out.shape == (1, 257) and (out == 0).all()


@functools.lru_cache(maxsize=None)
def _jax_mtcnn_init(seed):
    return _np(jax.jit(jmtcnn.init_mtcnn)(jax.random.PRNGKey(seed)))


def mtcnn_params(seed=0, prob_scale=1.0):
    """JAX `init_mtcnn`; `prob_scale` spreads the face probabilities, which
    the init keeps near 1/2."""
    p = jax.tree.map(np.copy, _jax_mtcnn_init(seed))
    for net in ("pnet", "rnet", "onet"):
        p[net]["prob"]["weight"] = p[net]["prob"]["weight"] * prob_scale
    return p


@pytest.mark.parametrize("hw", [(31, 40), (32, 41)])
def test_pnet_matches_jax_on_the_windows_seen_whole(hw):
    """An odd side: the ceil-mode pool emits a row (or column) that the
    cascade slices off, as the JAX package's padded stack does."""
    params = mtcnn_params()
    net = convert.mtcnn_from_jax(params)
    h, w = hw
    x = np.random.default_rng(6).uniform(-1, 1, (2, h, w, 3)) \
        .astype(np.float32)
    jprob, jreg = jax.jit(jmtcnn.pnet_apply)(params["pnet"], jnp.asarray(x))
    with torch.no_grad():
        prob, reg = net.pnet(_t(x).permute(0, 3, 1, 2))
    assert prob.shape[2:] == (-(-(h - 4) // 2) - 3, -(-(w - 4) // 2) - 3)
    vh, vw = (h - 12) // 2 + 1, (w - 12) // 2 + 1
    assert prob.shape[2] == vh + h % 2 and prob.shape[3] == vw + w % 2
    _close(prob.permute(0, 2, 3, 1)[:, :vh, :vw],
           np.asarray(jprob)[:, :vh, :vw])
    _close(reg.permute(0, 2, 3, 1)[:, :vh, :vw],
           np.asarray(jreg)[:, :vh, :vw])


def test_rnet_and_onet_match_jax():
    params = mtcnn_params()
    net = convert.mtcnn_from_jax(params)
    rng = np.random.default_rng(7)
    for size, jfn, tnet in ((24, jmtcnn.rnet_apply, net.rnet),
                            (48, jmtcnn.onet_apply, net.onet)):
        x = rng.uniform(-1, 1, (5, size, size, 3)).astype(np.float32)
        want = jax.jit(jfn)(params["rnet" if size == 24 else "onet"],
                            jnp.asarray(x))
        with torch.no_grad():
            got = tnet(_t(x).permute(0, 3, 1, 2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("mode", ["union", "min"])
def test_nms_matches_jax(mode):
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 60, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (40, 2))], axis=1)
    scores = rng.uniform(0, 1, 40)
    for thr in (0.3, 0.5, 0.7):
        np.testing.assert_array_equal(
            tmtcnn._nms_np(boxes, scores, thr, mode),
            jmtcnn._nms_np(boxes, scores, thr, mode))
    assert len(tmtcnn._nms_np(boxes[:0], scores[:0], 0.5)) == 0


def test_select_face_and_write_detection_match_jax(tmp_path):
    results = [{"box": [700, 700, 100, 100], "confidence": 0.95,
                "keypoints": {n: (1.5 * i, 2.25 * i) for i, n in enumerate(
                    ("left_eye", "right_eye", "nose", "mouth_left",
                     "mouth_right"))}},
               {"box": [0, 0, 100, 100], "confidence": 0.99,
                "keypoints": {}}]
    for rs in (results, results[1:], [dict(results[0], confidence=0.5)]):
        assert tmtcnn.select_face(rs) is jmtcnn.select_face(rs)
    tmtcnn.write_detection(results[0], str(tmp_path / "t.txt"))
    jmtcnn.write_detection(results[0], str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()


def _gap_threshold(probs, quantile):
    """A threshold near the probabilities' `quantile` with no probability
    within 1e-3 of it."""
    p = np.sort(np.unique(probs))
    mids = (p[1:] + p[:-1]) / 2
    ok = (p[1:] - p[:-1]) > 2e-3
    assert ok.any(), "no gap of 2e-3 among the probabilities"
    target = np.quantile(probs, quantile)
    return float(mids[ok][np.argmin(np.abs(mids[ok] - target))])


def detector_thresholds(net, img):
    """Thresholds for the random-weight cascade on `img` that let part of
    each stage through, with no probability within 1e-3 of any of them."""
    cand = tmtcnn.stage_pnet(net, img, tmtcnn.MIN_FACE_SIZE, 0.0)
    probs = []
    for scale in tmtcnn.pyramid_scales(*img.shape[:2]):
        hs, ws = int(np.ceil(img.shape[0] * scale)), \
            int(np.ceil(img.shape[1] * scale))
        level = np.asarray(Image.fromarray(img).resize((ws, hs),
                                                       Image.BILINEAR))
        with torch.no_grad():
            prob, _ = net.pnet(tmtcnn._to_device(
                tmtcnn._normalize(level[None]), net.device))
        vh, vw = (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
        probs.append(prob[0, 1, :vh, :vw].flatten().numpy())
    t0 = _gap_threshold(np.concatenate(probs), 0.97)
    cand = tmtcnn.stage_pnet(net, img, tmtcnn.MIN_FACE_SIZE, t0)
    boxes = tmtcnn._square_boxes_np(tmtcnn._apply_regression_np(
        cand[:, :4], cand[:, 5:9]))
    prob_r, reg = tmtcnn.stage_rnet(net, img, boxes)
    t1 = _gap_threshold(prob_r, 0.5)
    keep = prob_r > t1
    boxes, prob_r, reg = boxes[keep], prob_r[keep], reg[keep]
    keep = tmtcnn._nms_np(boxes, prob_r, tmtcnn.NMS_THRESHOLDS[1])
    boxes = tmtcnn._square_boxes_np(tmtcnn._apply_regression_np(
        boxes[keep], reg[keep]))
    prob_o, _, _ = tmtcnn.stage_onet(net, img, boxes)
    t2 = _gap_threshold(prob_o, 0.3)
    return (t0, t1, t2), len(cand), len(boxes)


def test_detect_faces_matches_jax():
    params = mtcnn_params(prob_scale=20.0)
    net = convert.mtcnn_from_jax(params)
    img = np.random.default_rng(9).integers(0, 255, (160, 144, 3), np.uint8)
    thresholds, n_pnet, n_rnet = detector_thresholds(net, img)
    want = jmtcnn.detect_faces(params, img, thresholds=thresholds)
    got = tmtcnn.detect_faces(net, img, thresholds=thresholds)
    assert n_pnet > 10 and n_rnet > 2 and len(want) >= 1, \
        (thresholds, n_pnet, n_rnet, len(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(1.0, np.abs(w["box"]).max())
        np.testing.assert_allclose(g["box"], w["box"], rtol=0,
                                   atol=1e-4 * scale)
        assert abs(g["confidence"] - w["confidence"]) < NET_REL
        for k, v in w["keypoints"].items():
            np.testing.assert_allclose(g["keypoints"][k], v, rtol=0,
                                       atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------


def _frames(root, n, size=(300, 300), seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    lms = {}
    for i in range(n):
        name = f"{i}.png"
        Image.fromarray(rng.integers(0, 255, size + (3,), np.uint8)).save(
            os.path.join(root, name))
        lms[name] = _lm5(rng, size[1] / 2, size[0] / 2)
    return lms


def _assert_same_outputs(got_dir, want_dir):
    names = sorted(f for f in os.listdir(want_dir) if f.endswith(".png"))
    assert names and names == sorted(f for f in os.listdir(got_dir)
                                     if f.endswith(".png"))
    for n in names:
        with open(os.path.join(got_dir, n), "rb") as g, \
                open(os.path.join(want_dir, n), "rb") as w:
            assert g.read() == w.read(), n
    with open(os.path.join(got_dir, "test.json")) as g, \
            open(os.path.join(want_dir, "test.json")) as w:
        got, want = json.load(g)["labels"], json.load(w)["labels"]
    assert [e[0] for e in got] == [e[0] for e in want]
    np.testing.assert_allclose([e[1] for e in got], [e[1] for e in want],
                               rtol=0, atol=LABEL_ATOL)
    with open(os.path.join(got_dir, "cameras.json")) as g, \
            open(os.path.join(want_dir, "cameras.json")) as w:
        got, want = json.load(g), json.load(w)
    assert sorted(got) == sorted(want)
    for k in want:
        for field in ("intrinsics", "pose", "angle"):
            np.testing.assert_allclose(got[k][field], want[k][field],
                                       rtol=0, atol=LABEL_ATOL)
    return names


def test_process_video_with_landmarks_matches_jax(tmp_path):
    lms = _frames(str(tmp_path / "frames"), 3)
    params = random_recon_params(1)
    cfg = jpipe.PipelineConfig(batch_size=2)
    want = jpipe.process_video(str(tmp_path / "frames"),
                               str(tmp_path / "jax"), cfg,
                               recon_params=params, landmarks=lms)
    got = tpipe.process_video(
        str(tmp_path / "frames"), str(tmp_path / "port"),
        tpipe.PipelineConfig(batch_size=2),
        recon_net=convert.facerecon_from_jax(params), landmarks=lms)
    assert len(_assert_same_outputs(got, want)) == 3
    from hfa_gp_tpu_torch.data.dataset import HeadData
    img, label = HeadData("any", size=64, ds_path=got)[0]
    assert img.shape == (64, 64, 3) and label.shape == (25,)


def test_process_video_runs_on_one_device(tmp_path):
    """The chain's device is `device` or the given nets': without either,
    or with two devices among them, it raises rather than making a net on
    a device the caller did not name."""
    recon = trecon.init_facerecon(torch.Generator().manual_seed(0))
    det = tmtcnn.init_mtcnn(torch.Generator().manual_seed(0), "meta")
    for kw in ({}, {"mtcnn_net": det, "recon_net": recon},
               {"recon_net": recon, "device": "meta"}):
        with pytest.raises(ValueError, match="one device"):
            tpipe.process_video(str(tmp_path), **kw)


def test_load_detections_smooths_one_entry_a_frame(tmp_path):
    """Holds the port to `smooth_detection_dir`, the reference smooth.py's
    semantics. The JAX package's CLI path differs: its `load_detections`
    files every detection under both a .png and a .jpg key, so
    `smooth_landmarks` filters a sequence of 2T entries."""
    n = 12
    _frames(str(tmp_path), n, size=(64, 64))
    det = tmp_path / "detections"
    det.mkdir()
    seq = np.random.default_rng(10).uniform(0, 64, (n, 5, 2)) \
        .astype(np.float32)
    for i, lm in enumerate(seq):
        np.savetxt(det / f"{i}.txt", lm)
    loaded = tpipe.load_detections(str(det), str(tmp_path))
    assert sorted(loaded) == sorted(f"{i}.png" for i in range(n))
    got = tpipe.smooth_landmarks(loaded, tpipe.PipelineConfig())
    jdets = jpipe.load_detections(str(det))
    assert len(jdets) == 2 * n
    jsm = jpipe.smooth_landmarks(jdets, jpipe.PipelineConfig())
    jsmooth.smooth_detection_dir(str(det))
    want = np.stack([np.loadtxt(det / f"{i}.txt") for i in range(n)])
    np.testing.assert_allclose(
        np.stack([got[f"{i}.png"] for i in range(n)]), want, rtol=0,
        atol=SMOOTH_REL * 64 + 1e-6)          # savetxt keeps 18 digits
    assert np.abs(np.stack([jsm[f"{i}.png"] for i in range(n)])
                  - want).max() > 1.0


def test_process_video_cli_matches_jax_pipeline(tmp_path):
    """`cli.process_video --use_existing_detections --device cpu` on the
    tests/fixtures.py frames, with face-recon weights from a flat npz that
    the JAX package's `save_npz` wrote, against the JAX pipeline on the
    same once-smoothed landmarks."""
    # imported here: a card's machine may resolve `tests` to another
    # package, and the card-only tests of this file must still collect
    from tests.fixtures import make_avatar_dataset
    frames = os.path.join(make_avatar_dataset(str(tmp_path / "ds")),
                          "test2", "cropped_images")
    det = os.path.join(frames, "detections")
    os.makedirs(det)
    rng = np.random.default_rng(11)
    names = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    for n in names:
        np.savetxt(os.path.join(det, n[:-4] + ".txt"),
                   _lm5(rng, 32, 32, 0.5))
    params = random_recon_params(2)
    pytree_io.save_npz(params, str(tmp_path / "recon.npz"))
    cli.main(cli.build_argparser().parse_args([
        "--in_root", frames, "--out_dir", str(tmp_path / "port"),
        "--recon_weights", str(tmp_path / "recon.npz"), "--batch_size", "3",
        "--use_existing_detections", "--device", "cpu"]))
    jsmooth.smooth_detection_dir(det)
    lms = {n: np.loadtxt(os.path.join(det, n[:-4] + ".txt"))
           .astype(np.float32) for n in names}
    want = jpipe.process_video(frames, str(tmp_path / "jax"),
                               jpipe.PipelineConfig(batch_size=3),
                               recon_params=params, landmarks=lms)
    assert len(_assert_same_outputs(str(tmp_path / "port"), want)) == \
        len(names)


def test_clis_refuse_a_cuda_device_without_a_card(tmp_path, monkeypatch):
    from hfa_gp_tpu_torch.cli import extract_audio
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(cli.build_argparser().parse_args([
            "--in_root", str(tmp_path), "--use_existing_detections"]))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        extract_audio.main(extract_audio.build_argparser().parse_args([
            "--wav", str(tmp_path / "a.wav"), "--out",
            str(tmp_path / "aud.npy")]))


def test_mtcnn_conversion_reads_a_converted_npz(tmp_path):
    params = mtcnn_params(3)
    pytree_io.save_npz(params, str(tmp_path / "mtcnn.npz"))
    from hfa_gp_tpu_torch.utils.convert import load_npz
    net = convert.mtcnn_from_jax(load_npz(str(tmp_path / "mtcnn.npz")))
    ref = convert.mtcnn_from_jax(params)
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=0, atol=0)
    init = tmtcnn.init_mtcnn(torch.Generator().manual_seed(0))
    assert set(init.state_dict()) == set(ref.state_dict())


# ---------------------------------------------------------------------------
# warp and losses
# ---------------------------------------------------------------------------


def _affines(b=2):
    ms = []
    for i in range(b):
        th, s = np.deg2rad(17.0 + 9 * i), 0.8 + 0.3 * i
        a = s * np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
        ms.append(np.concatenate([a, [[2.5 - i], [-1.0 + 0.5 * i]]], 1))
    return np.stack(ms).astype(np.float32)


def test_warp_affine_values_and_gradients_match_jax():
    rng = np.random.default_rng(12)
    img = rng.standard_normal((2, 20, 26, 3)).astype(np.float32)
    m = _affines()
    cot = rng.standard_normal((2, 14, 14, 3)).astype(np.float32)

    def jloss(i, mm):
        return jnp.sum(jwarp.warp_affine(i, mm, 14) * cot)

    want = jwarp.warp_affine(jnp.asarray(img), jnp.asarray(m), 14)
    jgi, jgm = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(img),
                                                        jnp.asarray(m))
    ti, tm = _t(img).requires_grad_(), _t(m).requires_grad_()
    got = twarp.warp_affine(ti, tm, 14)
    (got * _t(cot)).sum().backward()
    _close(got, want)
    _close(ti.grad, jgi)
    _close(tm.grad, jgm)


def test_warp_affine_degenerate_m_is_zero_in_value_and_gradient():
    img = _t(np.random.default_rng(13).standard_normal((1, 8, 8, 3)))
    m = torch.zeros(1, 2, 3)
    m[0, :, 2] = 3.0
    img.requires_grad_()
    m.requires_grad_()
    out = twarp.warp_affine(img, m, 6)
    out.sum().backward()
    assert (out == 0).all()
    assert torch.isfinite(img.grad).all() and (img.grad == 0).all()
    assert torch.isfinite(m.grad).all() and (m.grad == 0).all()
    jout = jax.jit(jwarp.warp_affine, static_argnums=2)(
        jnp.asarray(img.detach().numpy()), jnp.asarray(m.detach().numpy()),
        6)
    np.testing.assert_array_equal(np.asarray(jout), 0.0)


@pytest.mark.parametrize("n_points", [5, 68])
def test_estimate_norm_matches_jax(n_points):
    lm = np.random.default_rng(14).uniform(40, 180, (3, n_points, 2)) \
        .astype(np.float32)
    _close(twarp.estimate_norm(_t(lm), 224),
           jax.jit(jwarp.estimate_norm, static_argnums=1)(jnp.asarray(lm),
                                                          224), rel=1e-4)
    dst = np.roll(lm[:, :5], 1, axis=0)
    _close(twarp.umeyama_similarity(_t(lm[:, :5]), _t(dst)),
           jax.jit(jwarp.umeyama_similarity)(jnp.asarray(lm[:, :5]),
                                             jnp.asarray(dst)), rel=1e-4)


def _recog(w):
    return lambda x: x.reshape(x.shape[0], -1) @ w


def test_perceptual_losses_match_jax_with_gradients():
    rng = np.random.default_rng(15)
    a = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    w = rng.standard_normal((16 * 16 * 3, 8)).astype(np.float32)
    m = np.array([[[0.5, 0.05, 2.0], [-0.05, 0.5, 1.0]]] * 2, np.float32)

    def jfn(x, mm):
        return jlosses.perceptual_loss_from_images(_recog(jnp.asarray(w)),
                                                   x, jnp.asarray(b), mm, 16)

    want, (jga, jgm) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(m))
    ta, tm = _t(a).requires_grad_(), _t(m).requires_grad_()
    got = tlosses.perceptual_loss_from_images(_recog(_t(w)), ta, _t(b), tm,
                                              16)
    got.backward()
    _close(got, want)
    _close(ta.grad, jga)
    _close(tm.grad, jgm)
    fa = rng.standard_normal((3, 8)).astype(np.float32)
    fb = rng.standard_normal((3, 8)).astype(np.float32)
    _close(tlosses.perceptual_loss(_t(fa), _t(fb)),
           jlosses.perceptual_loss(jnp.asarray(fa), jnp.asarray(fb)))


def test_perceptual_id_loss_with_the_ports_iresnet_matches_jax():
    """`recog_fn` is the port's iresnet (iresnet18 for 32² crops here),
    held to the JAX package's on the same converted weights: the loss and
    its gradient with respect to the image."""
    from hfa_gp_tpu.models.arcface import iresnet as jres
    from hfa_gp_tpu_torch.models.arcface import convert as arc_convert
    from hfa_gp_tpu_torch.models.arcface import iresnet as tres
    p, st = jax.jit(lambda k: jres.init_iresnet(k, "iresnet18",
                                                input_size=32))(
        jax.random.PRNGKey(0))
    tp, ts = arc_convert.iresnet_from_jax(_np(p), _np(st))
    rng = np.random.default_rng(19)
    a = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    m = np.array([[[0.9, 0.1, -2.0], [-0.1, 0.9, 1.0]]] * 2, np.float32)

    def jfn(x):
        return jwarp.perceptual_id_loss(
            lambda y: jres.iresnet_apply(p, st, y, "iresnet18"), x,
            jnp.asarray(b), jnp.asarray(m), 32)

    want, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(a))
    ta = _t(a).requires_grad_()
    got = twarp.perceptual_id_loss(
        lambda y: tres.iresnet_apply(tp, ts, y, "iresnet18"), ta, _t(b),
        _t(m), 32)
    got.backward()
    assert float(want) > 1e-3
    _close(got, want, rel=1e-4)
    _close(ta.grad, jg, rel=1e-4)


LOSS_INPUT_SHAPES = {
    "photo": ((2, 16, 16, 3), (2, 16, 16, 3), (2, 16, 16, 1)),
    "landmark": ((2, 68, 2), (2, 68, 2)),
    "gamma": ((2, 27),),
    "reflectance": ((2, 30, 3), (30,)),
}


@pytest.mark.parametrize("name", ["photo", "landmark", "gamma",
                                  "reflectance", "reg"])
def test_losses_match_jax_with_gradients(name):
    rng = np.random.default_rng(16)
    if name == "reg":
        cd = {k: rng.standard_normal((2, n)).astype(np.float32)
              for k, n in (("id", 80), ("exp", 64), ("tex", 80))}
        want, jg = jax.value_and_grad(lambda c: jlosses.reg_loss(
            c, 1.0, 0.8, 1.7e-2))({k: jnp.asarray(v) for k, v in cd.items()})
        tc = {k: _t(v).requires_grad_() for k, v in cd.items()}
        got = tlosses.reg_loss(tc, 1.0, 0.8, 1.7e-2)
        got.backward()
        _close(got, want)
        for k in cd:
            _close(tc[k].grad, jg[k])
        return
    xs = [rng.uniform(0, 1, shape).astype(np.float32)
          for shape in LOSS_INPUT_SHAPES[name]]
    if name in ("photo", "reflectance"):
        xs[-1] = (xs[-1] > 0.4).astype(np.float32)
    jfn = getattr(jlosses, f"{name}_loss")
    tfn = getattr(tlosses, f"{name}_loss")
    want, jg = jax.value_and_grad(jfn)(*map(jnp.asarray, xs))
    tx = [_t(x) for x in xs]
    tx[0].requires_grad_()
    got = tfn(*tx)
    got.backward()
    _close(got, want)
    _close(tx[0].grad, jg)


# ---------------------------------------------------------------------------
# card only: the networks at full size, card against CPU
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_detector_card_matches_cpu_at_full_size(cuda):
    params = mtcnn_params(prob_scale=20.0)
    img = np.random.default_rng(17).integers(0, 255, (720, 1280, 3),
                                             np.uint8)
    cpu = convert.mtcnn_from_jax(params)
    card = convert.mtcnn_from_jax(params, cuda)
    x = tmtcnn._normalize(np.asarray(Image.fromarray(img).resize(
        (768, 432), Image.BILINEAR))[None])
    with torch.no_grad():
        for g, w in zip(card.pnet(tmtcnn._to_device(x, cuda)),
                        cpu.pnet(tmtcnn._to_device(x, torch.device("cpu")))):
            _close(g, w)
    boxes = np.random.default_rng(18).uniform(0, 600, (256, 2))
    boxes = np.concatenate([boxes, boxes + 60], axis=1)
    for stage in (tmtcnn.stage_rnet, tmtcnn.stage_onet):
        for g, w in zip(stage(card, img, boxes), stage(cpu, img, boxes)):
            _close(g, w)


@pytest.mark.gpu
def test_facerecon_card_matches_cpu_at_batch_16(cuda):
    params = random_recon_params()
    x = torch.rand((16, 3, 224, 224), generator=torch.Generator()
                   .manual_seed(0))
    with torch.no_grad():
        want = convert.facerecon_from_jax(params)(x)
        got = convert.facerecon_from_jax(params, cuda)(x.to(cuda))
    _close(got, want)
