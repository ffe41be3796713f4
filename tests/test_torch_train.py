"""The port's RGB-fitting slice against the JAX package, at
tests/test_eg3d.py's small_config widths with a 64² encoder and
dim_shape 8: `train.rgb.loss_fn` (value and every parameter's gradient),
the loss over three training steps across the tune_iter boundary, and
the `train_rgb` → `run_recon_video_rgb --model_path` entry points on the
tests/fixtures.py dataset.

Params are made by the JAX package's inits and carried across by
`utils.convert`. The JAX side runs its exact fp32 path (XLA sampler,
global fine placement, `renderer.ray_march`'s AD), the port its
"global" placement. Gradients, not post-Adam params, are compared: Adam's
g/√v turns rounding noise on a near-zero gradient into ±lr. Tolerance:
1e-4 on the loss terms, 1e-4 × each gradient's scale (max abs) on
gradients (encoder, QR, backbone, two render passes, SR and LPIPS in fp32
with sums taken in other orders), rtol 1e-3 on the losses of later steps
(each follows an Adam update of every parameter).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.core import camera as jcam
from hfa_gp_tpu.models import lpips as jlpips
from hfa_gp_tpu.models.avatar import heads as jheads
from hfa_gp_tpu.train import rgb as jrgb
from hfa_gp_tpu.train import state as jstate
from hfa_gp_tpu_torch.cli import common, run_recon_video_rgb, train_rgb
from hfa_gp_tpu_torch.models.avatar import heads as theads
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.train import rgb as trgb
from hfa_gp_tpu_torch.train import state as tstate
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_torch_networks import numpy_tree, torch_small_config

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)

JCFG = jheads.AvatarConfig(size=64, dim_shape=8, eg3d=small_config())
TCFG = theads.AvatarConfig(size=64, dim_shape=8,
                           eg3d=torch_small_config("global"))


@pytest.fixture(scope="module")
def jax_params():
    """Avatar params with random noise buffers, and LPIPS params."""
    params = numpy_tree(jheads.init_avatar_rgb(jax.random.PRNGKey(0), JCFG),
                        np.random.default_rng(0))
    lp = jax.tree.map(np.asarray, jlpips.init_lpips(jax.random.PRNGKey(1)))
    return params, lp


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(2)
    image = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    label = np.concatenate([np.asarray(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=h, mode=None)))
        for h in (1.45, 1.7)])
    return image, label


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_loss_fn_value_and_gradients_match_jax(jax_params, batch):
    jp, jlp = jax_params
    image, label = batch
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p, lp, x, c: jrgb.loss_fn(p, lp, JCFG, x, c), has_aux=True))(
            jp, jlp, jnp.asarray(image), jnp.asarray(label))
    tp = convert.from_jax(jp).requires_grad_(True)
    loss, aux = trgb.loss_fn(tp, convert.from_jax(jlp), TCFG,
                             torch.from_numpy(image), torch.from_numpy(label))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    for k in ("l2_loss", "lpips_loss"):
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-4)
    assert aux["generated"].shape == (2, 64, 64, 3)
    np.testing.assert_allclose(aux["generated"].detach().numpy(),
                               np.asarray(want_aux["generated"]), rtol=1e-4,
                               atol=1e-4)

    got = dict(tp.named_parameters())
    want = dict(_leaves(convert.convert_tree(
        jax.tree.map(np.asarray, want_grads))))
    assert sorted(got) == sorted(want)
    reached = 0
    for name, w in want.items():
        g = got[name].grad
        scale = float(np.abs(w).max())
        if g is None:                  # the loss never reaches this leaf
            assert scale == 0.0, name
            continue
        reached += 1
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
    assert reached > 50
    for top in ("encoder", "subspace", "generator"):
        assert any(n.startswith(top) and float(np.abs(w).max()) > 0
                   for n, w in want.items())


def test_loss_over_three_steps_matches_jax(jax_params, batch):
    """lr 3e-4, tune_iter 1: step 0 trains encoder and subspace only, steps
    1 and 2 the generator too."""
    jp, jlp = jax_params
    image, label = batch
    tx = jstate.make_optimizer(3e-4)
    step_fn = jrgb.make_train_step(JCFG, tx, 1, donate=False)
    js = jstate.init_state(jax.tree.map(jnp.asarray, jp), tx)
    ts = tstate.init_state(convert.from_jax(jp), 3e-4)
    tlp = convert.from_jax(jlp)
    gen0 = {n: p.detach().clone()
            for n, p in ts.params["generator"].named_parameters()}
    for step in range(3):
        js, want = step_fn(js, jlp, jnp.asarray(image), jnp.asarray(label))
        got = trgb.train_step(ts, tlp, TCFG, torch.from_numpy(image),
                              torch.from_numpy(label), 1)
        for k in ("loss", "l2_loss", "lpips_loss"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-3, err_msg=f"{k} @ {step}")
        moved = max(float((p.detach() - gen0[n]).abs().max()) for n, p in
                    ts.params["generator"].named_parameters())
        assert (moved == 0.0) == (step == 0)
    assert ts.step == int(js.step) == 3


def test_sample_bases_renders_every_direction_in_bounded_batches(jax_params):
    tp = convert.from_jax(jax_params[0])
    a = trgb.sample_bases(tp, TCFG, batch=3)         # 3 + 3 + 2
    b = trgb.sample_bases(tp, TCFG, batch=8)
    assert a.shape == (8, 64, 64, 3) and bool(torch.isfinite(a).all())
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax.jit(lambda p: jrgb.sample_bases(p, JCFG))(
        jax_params[0]))
    np.testing.assert_allclose(a.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


# -- the entry points ----------------------------------------------------------


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    """tests/fixtures.py dataset with labels of cameras that face the
    head (the fixture's own poses look away from it)."""
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
    """The CLIs build full-width configs; the CPU test runs small ones."""
    real = common.avatar_config

    def small(args, **kw):
        real(args, **kw)                 # keep the flag checks
        return theads.AvatarConfig(size=64, dim_shape=args.latent_dim_shape,
                                   eg3d=torch_small_config("stratified"))

    monkeypatch.setattr(common, "avatar_config", small)


def _train_args(root, exp, *extra):
    return train_rgb.build_argparser().parse_args([
        "--size", "64", "--batch_size", "2", "--dataset_root", root,
        "--person", "person_3", "--latent_dim_shape", "4", "--exp_path", exp,
        "--device", "cpu", *extra])


def _generator(path):
    return {k: v for k, v in ckpt.load_params(path).state_dict().items()
            if k.startswith("generator.")}


def test_train_rgb_cli_resume_and_reenact(small_cli_config, dataset_root,
                                          tmp_path, capsys):
    exp = str(tmp_path / "exps") + "/"
    base = os.path.join(exp, "v1")
    train_rgb.main(_train_args(dataset_root, exp, "--iter", "3",
                               "--tune_iter", "2", "--display_freq", "2",
                               "--save_freq", "1"))
    assert "RANDOM AlexNet" in capsys.readouterr().err
    with open(os.path.join(base, "log", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["l2_loss"]) and np.isfinite(r["lpips_loss"])
               for r in recs)
    assert os.path.exists(os.path.join(base, "log", "args.json"))
    assert sorted(os.listdir(os.path.join(base, "display"))) == \
        ["1recon.png", "1source.png"]
    assert sorted(os.listdir(os.path.join(base, "bases"))) == \
        [f"{b}person_1.png" for b in range(4)]
    ckpts = sorted(glob.glob(os.path.join(base, "checkpoint", "*")))
    assert [os.path.basename(c) for c in ckpts] == \
        ["000000", "000001", "000002"]
    # the generator is untouched through step 1 and moves at step 2
    init = theads.init_avatar_rgb(
        torch.Generator().manual_seed(train_rgb.SEED),
        theads.AvatarConfig(size=64, dim_shape=4,
                            eg3d=torch_small_config("stratified")))
    g_init = {k: v for k, v in init.state_dict().items()
              if k.startswith("generator.")}
    g1, g2 = _generator(ckpts[1]), _generator(ckpts[2])
    assert all(torch.equal(g1[k], g_init[k]) for k in g_init)
    assert any(not torch.equal(g2[k], g_init[k]) for k in g_init)
    enc1 = ckpt.load_params(ckpts[1]).state_dict()
    assert any(not torch.equal(enc1[k], v)
               for k, v in init.state_dict().items()
               if k.startswith("encoder."))

    # resume: continues from the saved step
    train_rgb.main(_train_args(dataset_root, exp, "--iter", "1",
                               "--tune_iter", "2", "--display_freq", "100",
                               "--save_freq", "1", "--resume_ckpt",
                               ckpts[2]))
    assert "resume from iteration 3" in capsys.readouterr().out
    assert ckpt.latest_step(os.path.join(base, "checkpoint")) == 3
    resumed = torch.load(os.path.join(base, "checkpoint", "000003"),
                         weights_only=True)
    assert resumed["step"] == 4

    # fit → reenact
    demo = str(tmp_path / "demo")
    run_recon_video_rgb.main(run_recon_video_rgb.build_argparser().parse_args(
        ["--size", "64", "--dataset_root", dataset_root, "--person",
         "person_3", "--latent_dim_shape", "4", "--model_path",
         os.path.join(base, "checkpoint", "000003"), "--demo_dir", demo,
         "--demo_name", "t", "--render_batch", "2", "--fps", "4", "--device",
         "cpu"]))
    assert len(glob.glob(os.path.join(demo, "t", "*.png"))) == 4
    assert glob.glob(os.path.join(demo, "t", "trec.*"))


def test_train_rgb_refuses_more_than_one_process(small_cli_config,
                                                 dataset_root, tmp_path,
                                                 monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError):
        train_rgb.main(_train_args(dataset_root, str(tmp_path), "--iter", "1"))
