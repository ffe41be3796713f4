"""The port's 3DMM- and audio-driven training against the JAX package, at
tests/test_eg3d.py's small_config widths with a 64² image and dim_shape 8:
each `loss_fn` (value and every parameter's gradient) against the jitted
JAX `value_and_grad`, three audio steps across the nosmo → smooth switch
against `make_audio_optimizer` and `reset_audattnet_opt`, and the four
entry points (`train_3dmm`, `train_audio`, `run_recon_video_3dmm`,
`run_recon_video_audio`) on the tests/fixtures.py datasets with
`--device cpu`: train → resume (a checkpoint saved at `--nosmo_iters`
included) → reenact. Also the command-line repair of the six avatar CLIs:
the reference's flags parse, and what the port does not do raises.

Params are made by the JAX package's inits and carried across by
`utils.convert`. The JAX side runs its exact fp32 path, the port its
"global" placement. Tolerances, as in test_torch_train.py: 1e-4 on the
loss terms, 1e-4 × each gradient's scale (max abs) on gradients, rtol
1e-3 on the losses of later steps (each follows an Adam update of every
parameter).
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
from hfa_gp_tpu.train import audio as jaudio
from hfa_gp_tpu.train import state as jstate
from hfa_gp_tpu.train import t3dmm as jt3dmm
from hfa_gp_tpu_torch.cli import (common, run_recon_video_3dmm,
                                  run_recon_video_audio, run_recon_video_rgb,
                                  train_3dmm, train_audio, train_rgb)
from hfa_gp_tpu_torch.models.avatar import heads as theads
from hfa_gp_tpu_torch.train import audio as taudio
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.train import state as tstate
from hfa_gp_tpu_torch.train import t3dmm as tt3dmm
from hfa_gp_tpu_torch.utils import convert
from tests.fixtures import make_avatar_dataset
from tests.test_eg3d import small_config
from tests.test_torch_networks import (drop_outputs, numpy_tree, torch_small_config)

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

JCFG = jheads.AvatarConfig(size=64, dim_shape=8, eg3d=small_config())
TCFG = theads.AvatarConfig(size=64, dim_shape=8,
                           eg3d=torch_small_config("global"))


@pytest.fixture(scope="module")
def lpips_params():
    return jax.tree.map(np.asarray, jlpips.init_lpips(jax.random.PRNGKey(1)))


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


def _assert_grads_match(tp, want_grads, referee=None):
    """Every gradient of `tp` within 1e-4 of its scale of JAX's. With
    `referee` (the port's float64 gradients, by name): an entry where the
    two fp32 gradients part by more must instead match the float64 one at
    that tolerance, and the leaf must stay within 1e-2 of JAX's in the L2
    norm (as `chip_smoke.py` holds PReLU's kink). Such entries come from a
    LeakyReLU input within rounding of 0, which JAX's fp32 sums put on one
    side of the kink and the port's on the other: the slope there is 1 or
    0.2, and that element's share of every gradient upstream of it
    changes by a fifth or fivefold."""
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
        g = g.numpy()
        tol = dict(rtol=1e-4, atol=1e-4 * scale)
        apart = ~np.isclose(g, w, **tol)
        if referee is not None and apart.any():
            assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w), name
            np.testing.assert_allclose(g[apart], referee[name][apart], **tol,
                                       err_msg=name)
            g, w = g[~apart], w[~apart]
        np.testing.assert_allclose(g, w, **tol, err_msg=name)
    return reached


def test_3dmm_loss_fn_value_and_gradients_match_jax(lpips_params, batch):
    jp = numpy_tree(jheads.init_avatar_3dmm(jax.random.PRNGKey(3), JCFG),
                    np.random.default_rng(3))
    image, label = batch
    coeffs = np.random.default_rng(5).standard_normal((2, 76)) \
        .astype(np.float32)
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        lambda p, lp, x, c, e: jt3dmm.loss_fn(p, lp, JCFG, x, c, e),
        has_aux=True))(jp, lpips_params, image, label, coeffs)
    tp = convert.from_jax(jp).requires_grad_(True)
    loss, aux = tt3dmm.loss_fn(tp, convert.from_jax(lpips_params), TCFG,
                               torch.from_numpy(image),
                               torch.from_numpy(label),
                               torch.from_numpy(coeffs))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    for k in ("l2_loss", "lpips_loss"):
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]), rtol=1e-4)
    assert _assert_grads_match(tp, want_grads) > 50
    assert float(tp["weights_mlp"]["fc0"]["weight"].grad.abs().max()) > 0


@pytest.mark.parametrize("smooth", [False, True])
def test_audio_loss_fn_value_and_gradients_match_jax(lpips_params, batch,
                                                     smooth):
    """Before the switch the AudioAttNet gets no gradient (JAX: zeros).
    Held with the port's float64 gradients as referee at LeakyReLU kinks
    (`_assert_grads_match`): in the plain phase 6 of the 256 entries of
    one noise buffer's gradient part from JAX's by 1.7e-3 of its scale,
    where the port's fp32 gradient is within 6e-7 of its float64 one."""
    jp = numpy_tree(jaudio.init_audio_params(jax.random.PRNGKey(6), JCFG),
                    np.random.default_rng(6))
    image, label = batch
    shape = (2, 8, 16, 29) if smooth else (2, 16, 29)
    win = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    (want_loss, _), want_grads = jax.jit(jax.value_and_grad(
        lambda p, lp, x, c, w: jaudio.loss_fn(p, lp, JCFG, x, c, w, smooth),
        has_aux=True))(jp, lpips_params, image, label, win)
    tp = convert.from_jax(jp).requires_grad_(True)
    loss, _ = taudio.loss_fn(tp, convert.from_jax(lpips_params), TCFG,
                             torch.from_numpy(image), torch.from_numpy(label),
                             torch.from_numpy(win), smooth)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-4)
    tp64 = convert.from_jax(jp).double().requires_grad_(True)
    taudio.loss_fn(tp64, convert.from_jax(lpips_params).double(), TCFG,
                   *(torch.from_numpy(a).double() for a in (image, label,
                                                            win)),
                   smooth)[0].backward()
    _assert_grads_match(tp, want_grads, referee={
        n: p.grad.numpy() for n, p in tp64.named_parameters()
        if p.grad is not None})
    att = [p.grad for p in tp["audattnet"].parameters()]
    assert all(g is None for g in att) != smooth
    assert float(tp["audnet"]["conv0"]["weight"].grad.abs().max()) > 0


def _adam_steps(optimizer, params) -> set:
    return {int(optimizer.state[p]["step"]) if p in optimizer.state else 0
            for p in params.parameters()}


def test_audio_three_steps_across_the_switch_match_jax(lpips_params, batch):
    """One plain step, the AudAtt reset, two smooth steps (tune_iter 1):
    losses as the JAX steps with `make_audio_optimizer` and
    `reset_audattnet_opt`; the AudioAttNet does not move in the plain
    step, and its Adam count restarts at the switch."""
    jp = numpy_tree(jaudio.init_audio_params(jax.random.PRNGKey(8), JCFG),
                    np.random.default_rng(8))
    image, label = batch
    rng = np.random.default_rng(9)
    wins = [rng.standard_normal((2, 16, 29)).astype(np.float32)] + \
        [rng.standard_normal((2, 8, 16, 29)).astype(np.float32)
         for _ in range(2)]
    tx = jaudio.make_audio_optimizer(3e-4)
    steps = {s: jaudio.make_train_step(JCFG, tx, 1, smooth=s, donate=False)
             for s in (False, True)}
    js = jstate.init_state(jax.tree.map(jnp.asarray, jp), tx)
    ts = tstate.init_state(convert.from_jax(jp), 3e-4)
    tlp = convert.from_jax(lpips_params)
    att0 = {n: p.detach().clone()
            for n, p in ts.params["audattnet"].named_parameters()}
    for step, win in enumerate(wins):
        smooth = step > 0
        if step == 1:
            js = js._replace(opt_state=jaudio.reset_audattnet_opt(
                js.opt_state, tx, js.params))
            assert _adam_steps(ts.optimizer, ts.params["audattnet"]) == {1}
            taudio.reset_audattnet_opt(ts)
            assert _adam_steps(ts.optimizer, ts.params["audattnet"]) == {0}
        js, want = steps[smooth](js, lpips_params, image, label, win)
        got = taudio.train_step(ts, tlp, TCFG, torch.from_numpy(image),
                                torch.from_numpy(label),
                                torch.from_numpy(win), smooth, 1)
        for k in ("loss", "l2_loss", "lpips_loss", "l2_loss_3dmm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-3, err_msg=f"{k} @ {step}")
        moved = max(float((p.detach() - att0[n]).abs().max()) for n, p in
                    ts.params["audattnet"].named_parameters())
        assert (moved == 0.0) == (step == 0)
    assert _adam_steps(ts.optimizer, ts.params["audattnet"]) == {2}
    assert _adam_steps(ts.optimizer, ts.params["model"]) == {3}
    counts = [int(c) for c in jax.tree_util.tree_leaves(
        js.opt_state.inner_states["audattnet"])
        if getattr(c, "dtype", None) == jnp.int32]
    assert counts and all(c == 2 for c in counts)
    # the params agree after the three updates (Adam's g/√v turns a
    # rounding difference on a near-zero gradient into ±lr: 1e-3 abs)
    want = dict(_leaves(convert.convert_tree(
        jax.tree.map(np.asarray, js.params))))
    for name, p in ts.params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-3, err_msg=name)


# -- the entry points ----------------------------------------------------------


def _face_the_head(person_dir, splits):
    """The fixture's own poses look away from the head: give each frame a
    camera around the mean pose."""
    for split in splits:
        path = os.path.join(person_dir, split, "cropped_images", "test.json")
        with open(path) as f:
            labels = json.load(f)["labels"]
        for i, entry in enumerate(labels):
            entry[1] = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
                None, horizontal_mean=1.4 + 0.07 * i, mode=None)))[0].tolist()
        with open(path, "w") as f:
            json.dump({"labels": labels}, f)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    _face_the_head(make_avatar_dataset(os.path.join(root, "nerface_dataset")),
                   ("train", "test2"))
    _face_the_head(make_avatar_dataset(os.path.join(root, "ad_dataset"),
                                       person="obama", audio=True, seed=1),
                   ("train", "test"))
    return root


@pytest.fixture
def small_cli_config(monkeypatch):
    """The CLIs build full-width configs; the CPU test runs small ones."""
    real = common.avatar_config

    def small(args, **kw):
        cfg = real(args, **kw)           # keep the flag checks
        return theads.AvatarConfig(size=64, dim_shape=args.latent_dim_shape,
                                   person_2=cfg.person_2,
                                   same_bases=cfg.same_bases,
                                   eg3d=torch_small_config("stratified"))

    monkeypatch.setattr(common, "avatar_config", small)


def _params(path, top=""):
    return {k: v for k, v in ckpt.load_params(path).state_dict().items()
            if k.startswith(top)}


def _metrics(base):
    with open(os.path.join(base, "log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_3dmm_cli_resume_and_reenact(small_cli_config, dataset_root,
                                           tmp_path, capsys):
    exp = str(tmp_path / "exps") + "/"
    base = os.path.join(exp, "v1")

    def args(*extra):
        return train_3dmm.build_argparser().parse_args([
            "--size", "64", "--batch_size", "2", "--dataset_root",
            dataset_root, "--person", "person_3", "--latent_dim_shape", "4",
            "--exp_path", exp, "--device", "cpu", "--tune_iter", "2",
            *extra])

    train_3dmm.main(args("--iter", "3", "--display_freq", "2",
                         "--save_freq", "1"))
    recs = _metrics(base)
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["l2_loss"]) and np.isfinite(r["lpips_loss"])
               and r["l2_loss_3dmm"] == 0.0 for r in recs)
    assert sorted(os.listdir(os.path.join(base, "display"))) == \
        ["1recon.png", "1source.png"]
    ckpts = sorted(glob.glob(os.path.join(base, "checkpoint", "*")))
    assert [os.path.basename(c) for c in ckpts] == \
        ["000000", "000001", "000002"]
    init = theads.init_avatar_3dmm(
        torch.Generator().manual_seed(train_3dmm.SEED),
        theads.AvatarConfig(size=64, dim_shape=4,
                            eg3d=torch_small_config("stratified")))
    g_init = {k: v for k, v in init.state_dict().items()
              if k.startswith("generator.")}
    g1, g2 = _params(ckpts[1], "generator."), _params(ckpts[2], "generator.")
    assert all(torch.equal(g1[k], g_init[k]) for k in g_init)
    assert any(not torch.equal(g2[k], g_init[k]) for k in g_init)
    mlp1 = _params(ckpts[1], "weights_mlp.")
    assert any(not torch.equal(mlp1[k], v) for k, v in
               init.state_dict().items() if k.startswith("weights_mlp."))

    capsys.readouterr()
    train_3dmm.main(args("--iter", "1", "--display_freq", "100",
                         "--save_freq", "1", "--resume_ckpt", ckpts[2]))
    assert "resume from iteration 3" in capsys.readouterr().out
    assert torch.load(os.path.join(base, "checkpoint", "000003"),
                      weights_only=True)["step"] == 4

    demo = str(tmp_path / "demo")
    for extra in (["--fix_cam"], ["--cam_angle", "10"]):
        run_recon_video_3dmm.main(run_recon_video_3dmm.build_argparser()
                                  .parse_args([
                                      "--size", "64", "--dataset_root",
                                      dataset_root, "--person", "person_3",
                                      "--latent_dim_shape", "4",
                                      "--demo_dir", demo, "--demo_name",
                                      extra[0][2:], "--render_batch", "3",
                                      "--fps", "4", "--device", "cpu",
                                      "--model_path", ckpts[2], *extra]))
    for name in ("fix_cam", "cam_angle"):
        pngs = sorted(glob.glob(os.path.join(demo, name, "*.png")))
        assert [os.path.basename(p) for p in pngs] == \
            [f"{i:05d}.png" for i in range(4)]
        assert glob.glob(os.path.join(demo, name, "rec.*"))
    drop_outputs(tmp_path)


def test_train_audio_cli_switch_resume_and_reenact(small_cli_config,
                                                   dataset_root, tmp_path,
                                                   capsys):
    """--nosmo_iters 2: steps 0, 1 plain, step 2 smooth after a fresh
    AudAtt optimizer. A resume from the checkpoint saved at the boundary
    (its step is 2 = nosmo_iters) resets it too; one from a later step
    does not."""
    exp = str(tmp_path / "exps") + "/"

    def args(name, *extra):
        return train_audio.build_argparser().parse_args([
            "--size", "64", "--batch_size", "2", "--dataset_root",
            dataset_root, "--dataset", "ad_dataset", "--person", "obama",
            "--latent_dim_shape", "4", "--exp_path", exp, "--exp_name", name,
            "--device", "cpu", "--tune_iter", "1", "--nosmo_iters", "2",
            "--display_freq", "100", "--save_freq", "1", *extra])

    def counts(path):
        """Adam step counts in a checkpoint: AudioAttNet's, the model's."""
        state = torch.load(path, weights_only=True)
        names = list(state["params"])
        steps = {names[i]: int(s["step"])
                 for i, s in state["optimizer"]["state"].items()}
        att = {v for k, v in steps.items() if k.startswith("audattnet.")}
        model = {v for k, v in steps.items() if k.startswith("model.")}
        return att, model

    train_audio.main(args("v1", "--iter", "3"))
    out = capsys.readouterr().out
    assert out.count("a fresh AudAtt optimizer") == 1
    base = os.path.join(exp, "v1", "checkpoint")
    recs = _metrics(os.path.join(exp, "v1"))
    assert len(recs) == 3 and all(np.isfinite(r["l2_loss"]) for r in recs)
    init = taudio.init_audio_params(
        torch.Generator().manual_seed(train_audio.SEED),
        theads.AvatarConfig(size=64, dim_shape=4,
                            eg3d=torch_small_config("stratified")))
    att_init = {k: v for k, v in init.state_dict().items()
                if k.startswith("audattnet.")}
    att1, att2 = (_params(os.path.join(base, c), "audattnet.")
                  for c in ("000001", "000002"))
    assert all(torch.equal(att1[k], v) for k, v in att_init.items())
    assert any(not torch.equal(att2[k], v) for k, v in att_init.items())
    assert counts(os.path.join(base, "000001")) == ({2}, {2})
    assert counts(os.path.join(base, "000002")) == ({1}, {3})

    # the boundary checkpoint (step 2 = nosmo_iters): reset on resume
    train_audio.main(args("v2", "--iter", "1", "--resume_ckpt",
                          os.path.join(base, "000001")))
    out = capsys.readouterr().out
    assert "resume from iteration 2" in out
    assert out.count("a fresh AudAtt optimizer") == 1
    assert counts(os.path.join(exp, "v2", "checkpoint", "000002")) == \
        ({1}, {3})
    # a later checkpoint (step 3): no reset
    train_audio.main(args("v3", "--iter", "1", "--resume_ckpt",
                          os.path.join(base, "000002")))
    assert "a fresh AudAtt optimizer" not in capsys.readouterr().out
    assert counts(os.path.join(exp, "v3", "checkpoint", "000003")) == \
        ({2}, {4})

    demo = str(tmp_path / "demo")
    run_recon_video_audio.main(run_recon_video_audio.build_argparser()
                               .parse_args([
                                   "--size", "64", "--dataset_root",
                                   dataset_root, "--dataset", "ad_dataset",
                                   "--person", "obama",
                                   "--latent_dim_shape", "4", "--demo_dir",
                                   demo, "--demo_name", "a",
                                   "--render_batch", "3", "--fps", "4",
                                   "--device", "cpu", "--smooth",
                                   "--model_path",
                                   os.path.join(base, "000002")]))
    pngs = sorted(glob.glob(os.path.join(demo, "a", "*.png")))
    assert [os.path.basename(p) for p in pngs] == \
        [f"{i:05d}.png" for i in range(4)]
    drop_outputs(tmp_path)


AVATAR_CLIS = [train_rgb, run_recon_video_rgb, train_3dmm, train_audio,
               run_recon_video_3dmm, run_recon_video_audio]
REFERENCE_LINE = ["--addr", "localhost", "--port", "12345", "--run_id", "x",
                  "--run_id_2", "y", "--emb_dir", "e/", "--process_id", "0"]


@pytest.mark.parametrize("cli", AVATAR_CLIS,
                         ids=[m.__name__.split(".")[-1] for m in AVATAR_CLIS])
def test_avatar_clis_take_the_reference_command_line(cli, monkeypatch,
                                                     small_cli_config,
                                                     tmp_path):
    """The reference's flags parse (--addr and --port are ignored); the
    second person's flags reach the config (they raised before the
    subspace was ported); several processes are joined in `main` after the
    device is set up, before anything is written: without a card
    (`--device cuda`, the default) it stops at the device, and without a
    peer the rendezvous fails within distributed.TIMEOUT."""
    import datetime
    import socket

    from hfa_gp_tpu_torch.parallel import distributed
    monkeypatch.chdir(tmp_path)
    args = cli.build_argparser().parse_args(REFERENCE_LINE)
    assert (args.addr, args.port, args.run_id) == ("localhost", "12345", "x")
    assert isinstance(common.avatar_config(args), theads.AvatarConfig)
    cfg = common.avatar_config(cli.build_argparser().parse_args(
        REFERENCE_LINE + ["--person_2", "p", "--same_bases", "--init"]))
    assert cfg.person_2 and cfg.same_bases
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in (["--num_processes", "2"],
                  ["--coordinator_address", "localhost:1234"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(cli.build_argparser().parse_args(REFERENCE_LINE
                                                      + extra))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", port)
    monkeypatch.setattr(distributed, "TIMEOUT",
                        datetime.timedelta(seconds=2))
    with pytest.raises(RuntimeError, match="clients"):
        cli.main(cli.build_argparser().parse_args(REFERENCE_LINE
                                                  + ["--device", "cpu"]))
    assert not torch.distributed.is_initialized()
    assert os.listdir(tmp_path) == []
