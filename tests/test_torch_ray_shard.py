"""Ray sharding over the model axis (`--n_model` > 1 in the avatar CLIs),
on the CPU over gloo: each rank of a model group renders its share of
every image's rays (`models/eg3d/renderer.py`, `parallel/mesh.py`), held
against one rank rendering all of them and against the JAX package's
`RenderConfig.ray_shard_axis` on a (1, 2) mesh of its virtual CPU devices.

The ranks are this file run as a script, through
`tests/test_torch_distributed.py`'s `spawn` and `_worker_main` (the
WORLD_SIZE/RANK contract; each rank asserts that it imported no JAX):

  synth   — EG3D synthesis on 1 x 2 and 2 x 2 ranks, both fine-sample
            placements, with and without depth jitter (1 x 2); the
            gradients of a render through the planes and the decoder; a
            render whose every ray has ~0 weight, whose depth is clipped
            to the range of all ranks' depths;
  steps   — one RGB, 3DMM and audio step on 1 x 2 ranks;
  reenact — `run_recon_video_rgb --n_model 2` on 2 ranks.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_torch_distributed import (_avatar_params,  # noqa: E402
                                          _tiny_avatar_cfg, _worker_main,
                                          avatar_steps)

SYNTH_BATCH, RES = 2, 16


def tiny_cfg(placement: str, dim_shape: int = 8):
    """The tiny config with the fine samples placed by `placement`."""
    cfg = _tiny_avatar_cfg(dim_shape)
    return dataclasses.replace(cfg, eg3d=dataclasses.replace(
        cfg.eg3d, render=dataclasses.replace(cfg.eg3d.render,
                                             sampler_fine=placement)))


def _decoder(gen, bias_shift: float = 0.0) -> dict:
    """The generator's decoder params as leaves of their own that require
    a gradient; `bias_shift` moves the density logit's bias."""
    dec = {k: {n: gen["decoder"][k][n].detach().clone()
               for n in ("weight", "bias")} for k in ("fc0", "fc1")}
    dec["fc1"]["bias"][0] += bias_shift
    for layer in dec.values():
        for t in layer.values():
            t.requires_grad_(True)
    return dec


def synth_outputs(data: str, mesh) -> dict:
    """This rank's view of every check of the `synth` mode: with one data
    index, every output is of the whole batch."""
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models.eg3d import generator as tgen
    from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    prob = np.load(os.path.join(data, "synth.npz"))
    gen = _avatar_params(data, "rgb.npz")["generator"]
    ws, c = mesh_mod.process_local_batch(
        (torch.from_numpy(prob["ws"]), torch.from_numpy(prob["c"])), mesh)
    out = {}
    for placement in ("global", "stratified"):
        cfg = tiny_cfg(placement).eg3d
        for jitter in ((False, True) if mesh.n_data == 1 else (False,)):
            g = torch.Generator().manual_seed(3) if jitter else None
            with torch.no_grad():
                out[f"synth_{placement}_{jitter}"] = tgen.synthesis(
                    gen, cfg, ws, c, render_generator=g, mesh=mesh)
    if mesh.n_data > 1:
        return out

    # a render's gradients through the planes and the decoder
    rng = np.random.default_rng(4)
    planes = torch.from_numpy((rng.standard_normal(
        (SYNTH_BATCH, 3, 32, 32, 32)) * 0.5).astype(np.float32))
    planes.requires_grad_(True)
    cots = [torch.from_numpy(rng.standard_normal(
        (SYNTH_BATCH, RES * RES, w)).astype(np.float32)) for w in (32, 1, 1)]
    cam2world, intrinsics = cam.unpack_label(torch.from_numpy(prob["c"]))
    o, d = cam.generate_rays(cam2world, intrinsics, RES)
    for placement in ("global", "stratified"):
        dec = _decoder(gen)
        outs = trnd.render_rays(
            dec, tiny_cfg(placement).eg3d.render, planes, o, d,
            generator=torch.Generator().manual_seed(5), ray_grid=(RES, RES),
            mesh=mesh)
        loss = sum((x * w).sum() for x, w in zip(outs, cots))
        leaves = [dec[k][n] for k in ("fc0", "fc1") for n in ("weight",
                                                              "bias")]
        grads = torch.autograd.grad(loss, [planes, *leaves])
        out[f"grad_{placement}"] = ([x.detach() for x in outs],
                                    list(grads))

    # every ray ~0 weight: its depth is the clip's lower bound, which one
    # rank's jittered depths set for all
    with torch.no_grad():
        out["clip"] = trnd.render_rays(
            _decoder(gen, -100.0), tiny_cfg("global").eg3d.render,
            planes, o, d, generator=torch.Generator().manual_seed(6),
            ray_grid=(RES, RES), mesh=mesh)[1]
    return out


def _w_synth(a) -> dict:
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    distributed.maybe_initialize(None, "cpu")
    n_data, n_model = (int(x) for x in a.shape.split(","))
    return synth_outputs(a.data, mesh_mod.make_mesh(n_data, n_model))


def _w_steps(a) -> dict:
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    distributed.maybe_initialize(None, "cpu")
    return avatar_steps(a.data, mesh_mod.make_mesh_for_batch(4, 2),
                        tiny_cfg("global"))


def reenact_rgb(data: str, out: str, n_model: int) -> str:
    """run_recon_video_rgb on the tiny config (the placement that
    `avatar_config` picks), random params, one batch of 4 of the 6 test
    frames and a padded one; → that placement."""
    from hfa_gp_tpu_torch.cli import common, run_recon_video_rgb
    real = common.avatar_config
    seen = []

    def tiny(args, **kw):
        placement = real(args, **kw).eg3d.render.sampler_fine
        seen.append(placement)
        return tiny_cfg(placement, dim_shape=args.latent_dim_shape)

    common.avatar_config = tiny
    try:
        run_recon_video_rgb.main(run_recon_video_rgb.build_argparser()
                                 .parse_args([
                                     "--size", "64", "--dataset_root",
                                     os.path.join(data, "ds"),
                                     "--latent_dim_shape", "4",
                                     "--demo_dir", out, "--demo_name", "rgb",
                                     "--render_batch", "4", "--fps", "4",
                                     "--device", "cpu",
                                     "--n_model", str(n_model)]))
    finally:
        common.avatar_config = real
    return seen[0]


def _w_reenact(a) -> dict:
    rank = int(os.environ["RANK"])
    return {"placement": reenact_rgb(a.data, os.path.join(a.out,
                                                          f"demo{rank}"), 2)}


WORKERS = {"synth": _w_synth, "steps": _w_steps, "reenact": _w_reenact}

if __name__ == "__main__":
    _worker_main(sys.argv[1:], WORKERS)
    sys.exit(0)

# -- the tests (the pytest process; JAX is imported here only) ---------------

from concurrent.futures import Future, ThreadPoolExecutor  # noqa: E402

import pytest  # noqa: E402

from tests.test_torch_distributed import _near, avatar_data  # noqa: E402,F401
from tests.test_torch_distributed import spawn as _spawn  # noqa: E402

torch.set_num_threads(1)


def spawn(mode: str, world: int, out: str, *extra: str) -> Future:
    """`mode` on `world` ranks, started in the background: the ranks run
    while this process computes what they are held against."""
    return _POOL.submit(_spawn, mode, world, out, *extra, script=__file__)


_POOL = ThreadPoolExecutor(max_workers=2)


def _one_rank():
    from hfa_gp_tpu_torch.parallel.mesh import Mesh
    return Mesh()


@pytest.fixture(scope="module")
def synth_data(avatar_data):
    """avatar_data with the latents and labels of the synthesis checks."""
    from hfa_gp_tpu.core import camera as jcam
    rng = np.random.default_rng(8)
    ws = rng.standard_normal((SYNTH_BATCH, _tiny_avatar_cfg().eg3d.num_ws,
                              512)).astype(np.float32)
    c = np.concatenate([np.asarray(jcam.flip_yz_label(
        jcam.sample_camera_label(None, horizontal_mean=1.4 + 0.2 * i,
                                 mode=None))) for i in range(SYNTH_BATCH)])
    np.savez(os.path.join(avatar_data, "synth.npz"), ws=ws, c=c)
    return avatar_data


@pytest.fixture(scope="module")
def synth_runs(synth_data, tmp_path_factory):
    """The synth mode's results on 1 x 2 and 2 x 2 ranks, and one rank's."""
    runs = {shape: spawn("synth", shape[0] * shape[1],
                         str(tmp_path_factory.mktemp("synth")), "--data",
                         synth_data, "--shape", "{},{}".format(*shape))
            for shape in ((1, 2), (2, 2))}
    one = synth_outputs(synth_data, _one_rank())
    return {"one": one, **{k: v.result() for k, v in runs.items()}}


@pytest.fixture(scope="module")
def jax_sharded_synthesis(synth_data):
    """JAX's synthesis with its rays sharded over the model axis of a
    (1, 2) mesh, as tests/test_eg3d.py's parity test builds it."""
    import jax

    from hfa_gp_tpu.models.eg3d.generator import synthesis
    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    from hfa_gp_tpu_torch.utils import convert
    from tests.distributed_worker import _tiny_avatar_cfg as jax_tiny
    cfg = jax_tiny(dim_shape=8).eg3d
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, ray_shard_axis=jmesh_mod.MODEL_AXIS))
    params = convert.load_npz(os.path.join(synth_data, "rgb.npz"))["generator"]
    prob = np.load(os.path.join(synth_data, "synth.npz"))
    mesh = jmesh_mod.make_mesh(1, 2, devices=jax.devices()[:2])
    with jax.sharding.set_mesh(mesh):
        p, ws, c = (jmesh_mod.replicate(mesh, x)
                    for x in (params, prob["ws"], prob["c"]))
        out = jax.jit(lambda p, w, c_: synthesis(p, cfg, w, c_))(p, ws, c)
    return {k: np.asarray(v) for k, v in out.items()}


def _rows(x, shape, rank):
    """The one-rank result's rows of `rank`'s data index."""
    n_data, n_model = shape
    per = x.shape[0] // n_data
    di = rank // n_model
    return x[di * per:(di + 1) * per]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_synthesis_matches_one_rank_and_jax(synth_runs,
                                                    jax_sharded_synthesis,
                                                    shape):
    """Both placements, with depth jitter where one data index draws it for
    the whole batch: within 2e-5 of one rank (tests/test_eg3d.py's bound
    for JAX's own sharded render); the global placement, JAX's under ray
    sharding, within the same 2e-5 of JAX's sharded synthesis."""
    one = synth_runs["one"]
    for r, res in enumerate(synth_runs[shape]):
        for key, got in ((k, v) for k, v in res.items()
                         if k.startswith("synth_")):
            for name, x in got.items():
                want = _rows(one[key][name], shape, r)
                assert x.shape == want.shape, (key, name)
                err = float((x - want).abs().max())
                assert err <= 2e-5, (shape, r, key, name, err)
        for name, want in jax_sharded_synthesis.items():
            # absolute, as tests/test_eg3d.py's parity test; the gap seen on
            # the CPU is 2.6e-6 (image), 1.2e-6 (depth), 3.0e-7 (raw)
            _near(res["synth_global_False"][name].numpy(),
                  _rows(want, shape, r), 2e-5, f"{name} vs JAX, rank {r}",
                  1.0)


def test_sharded_render_gradients_match_one_rank(synth_runs):
    """The planes' and the decoder's gradients, summed over the model axis
    at the render's boundary, and the outputs, on both ranks of 1 x 2."""
    one = synth_runs["one"]
    for r, res in enumerate(synth_runs[(1, 2)]):
        for placement in ("global", "stratified"):
            key = f"grad_{placement}"
            for what, got, want in (("out", res[key][0], one[key][0]),
                                    ("grad", res[key][1], one[key][1])):
                for i, (x, y) in enumerate(zip(got, want)):
                    _near(x.numpy(), y.numpy(), 1e-5,
                          f"{placement} {what} {i}, rank {r}")
    # the ranks hold the same gradients, bit for bit
    a, b = synth_runs[(1, 2)]
    for placement in ("global", "stratified"):
        for x, y in zip(a[f"grad_{placement}"][1], b[f"grad_{placement}"][1]):
            assert torch.equal(x, y), placement


def test_depth_clip_spans_the_ranks(synth_runs):
    """Every ray has ~0 weight, so its depth is the clip's lower bound: the
    least depth that the jittered samples of ALL the rays reach. A clip to
    one rank's own depths gives the rank whose shard does not hold that
    least depth another bound."""
    want = synth_runs["one"]["clip"]
    lo = float(want.min())
    assert float(want.max()) == lo      # every ray at the bound
    for r, res in enumerate(synth_runs[(1, 2)]):
        assert torch.equal(res["clip"], want), (r, res["clip"].unique())


def test_avatar_steps_on_1x2_ranks_match_one_rank_and_jax(avatar_data,
                                                          tmp_path):
    """RGB, 3DMM and audio steps with the rays of each image split over 2
    ranks: the loss terms at rel 1e-5 and Σ|w| at rel 1e-6 of one rank,
    the two ranks' params equal bit for bit, and the RGB step against JAX's
    on a (1, 2) mesh with `ray_shard_axis`, at test_torch_distributed's
    bounds."""
    import jax
    import jax.numpy as jnp

    from hfa_gp_tpu.data import BatchIterator
    from hfa_gp_tpu.data import HeadData as JHeadData
    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    from hfa_gp_tpu.train import rgb as jrgb
    from hfa_gp_tpu.train.state import init_state, make_optimizer
    from hfa_gp_tpu_torch.utils import convert
    from tests.distributed_worker import _tiny_avatar_cfg as jax_tiny

    running = spawn("steps", 2, str(tmp_path / "out"), "--data", avatar_data)
    one = avatar_steps(avatar_data, _one_rank(), tiny_cfg("global"))
    cfg = jax_tiny(dim_shape=8)
    cfg = dataclasses.replace(cfg, eg3d=dataclasses.replace(
        cfg.eg3d, render=dataclasses.replace(
            cfg.eg3d.render, ray_shard_axis=jmesh_mod.MODEL_AXIS)))
    mesh = jmesh_mod.make_mesh(1, 2, devices=jax.devices()[:2])
    tx = make_optimizer(1e-3)
    step = jrgb.make_train_step(cfg, tx, 0, donate=False)
    ds = JHeadData("train", size=64, person="person_3",
                   root=os.path.join(avatar_data, "ds", "nerface_dataset"))
    batch = next(iter(BatchIterator(ds, 4)))
    params = convert.load_npz(os.path.join(avatar_data, "rgb.npz"))
    lp = convert.load_npz(os.path.join(avatar_data, "lpips.npz"))
    with jax.sharding.set_mesh(mesh):
        state = init_state(jmesh_mod.replicate(mesh, params), tx)
        state = state._replace(
            opt_state=jmesh_mod.replicate(mesh, state.opt_state))
        state2, m = step(state, jmesh_mod.replicate(mesh, lp),
                         *(jmesh_mod.replicate(mesh, jnp.asarray(x))
                           for x in batch))
        chk = float(sum(np.abs(np.asarray(v, np.float64)).sum()
                        for v in jax.tree.leaves(state2.params)))
    ranks = running.result()
    got = ranks[0]["rgb"]
    for k in ("loss", "l2_loss", "lpips_loss"):
        assert got["metrics"][k] == pytest.approx(float(m[k]), rel=1e-3), k
    assert got["chk"] == pytest.approx(chk, rel=1e-5)
    for name in ("rgb", "3dmm", "audio"):
        assert ranks[0][name]["sha"] == ranks[1][name]["sha"], name
        for r in ranks:
            assert r[name]["rows"] == one[name]["rows"]
            for k in ("loss", "l2_loss", "lpips_loss"):
                assert r[name]["metrics"][k] == pytest.approx(
                    one[name]["metrics"][k], rel=1e-5), (name, k)
            assert r[name]["chk"] == pytest.approx(one[name]["chk"],
                                                   rel=1e-6), name


def test_reenactment_with_n_model_2_matches_one_rank(avatar_data, tmp_path):
    """run_recon_video_rgb --n_model 2 on 2 ranks: the global placement,
    the one-rank frames within 1 level, and only the primary writes."""
    from PIL import Image
    out = str(tmp_path / "out")
    running = spawn("reenact", 2, out, "--data", avatar_data)
    # one rank with the placement that --n_model 2 picked
    from hfa_gp_tpu_torch.cli import common
    real = common.avatar_config
    common.avatar_config = lambda args, **kw: dataclasses.replace(
        real(args, **kw), eg3d=dataclasses.replace(
            real(args, **kw).eg3d, render=dataclasses.replace(
                real(args, **kw).eg3d.render, sampler_fine="global")))
    try:
        assert reenact_rgb(avatar_data, os.path.join(out, "single"), 1) \
            == "global"
    finally:
        common.avatar_config = real
    ranks = running.result()
    assert [r["placement"] for r in ranks] == ["global", "global"]
    assert not os.path.exists(os.path.join(out, "demo1"))
    want = sorted(glob.glob(os.path.join(out, "single", "rgb", "*.png")))
    got = sorted(glob.glob(os.path.join(out, "demo0", "rgb", "*.png")))
    assert len(want) == len(got) == 6, got
    for a, b in zip(got, want):
        a = np.asarray(Image.open(a)).astype(np.int16)
        b = np.asarray(Image.open(b)).astype(np.int16)
        assert np.abs(a - b).max() <= 1


# -- without processes -------------------------------------------------------


def _render_inputs():
    from hfa_gp_tpu_torch.core import camera as cam
    from hfa_gp_tpu_torch.models.eg3d.generator import init_generator
    gen = init_generator(torch.Generator().manual_seed(0),
                         tiny_cfg("global").eg3d)
    c = cam.flip_yz_label(cam.sample_camera_label(None, n=1, mode=None))
    o, d = cam.generate_rays(*cam.unpack_label(c), RES)
    planes = torch.zeros((1, 3, 8, 8, 32))
    return gen["decoder"], planes, o, d


def test_ray_sharding_raises_on_uneven_shards_and_chunks():
    """M must divide the ray count (JAX pads an uneven shard), and
    ray_chunk together with a model axis raises; both before any
    collective."""
    from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
    from hfa_gp_tpu_torch.parallel.mesh import Mesh
    dec, planes, o, d = _render_inputs()
    render = tiny_cfg("global").eg3d.render
    three = Mesh(n_data=1, n_model=3, rank=1, model_group=object())
    with pytest.raises(ValueError, match="do not divide over n_model 3"):
        trnd.render_rays(dec, render, planes, o, d, mesh=three)
    two = Mesh(n_data=1, n_model=2, rank=0, model_group=object())
    with pytest.raises(ValueError, match="ray_chunk"):
        trnd.render_rays(dec, dataclasses.replace(render, ray_chunk=64),
                         planes, o, d, mesh=two)


def test_mesh_raises_on_a_batch_it_cannot_spread(monkeypatch):
    """A batch of 3 with --n_model 2 over 4 ranks: the data axis of 2 does
    not divide it, so JAX would leave ranks idle; with --n_model 2 in a
    world of one, there is no model axis to lay out."""
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    monkeypatch.setattr(distributed, "world", lambda: (0, 4))
    with pytest.raises(ValueError, match="idle"):
        mesh_mod.make_mesh_for_batch(3, 2)
    monkeypatch.setattr(distributed, "world", lambda: (0, 1))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_mod.make_mesh_for_batch(2, 2)


@pytest.mark.parametrize("name", ["train_rgb", "train_3dmm", "train_audio",
                                  "run_recon_video_rgb",
                                  "run_recon_video_3dmm",
                                  "run_recon_video_audio"])
def test_avatar_clis_take_n_model(name):
    """Each avatar CLI's config for --n_model 2: the global placement, as
    the JAX CLI renders under ray sharding; --n_model 1 keeps the
    stratified one, and 0 raises."""
    import importlib

    from hfa_gp_tpu_torch.cli import common
    mod = importlib.import_module(f"hfa_gp_tpu_torch.cli.{name}")
    parse = mod.build_argparser().parse_args
    tracing = name == "run_recon_video_rgb"
    for n, placement in ((1, "stratified"), (2, "global"), (4, "global")):
        cfg = common.avatar_config(parse(["--n_model", str(n)]),
                                   tracing=tracing)
        assert cfg.eg3d.render.sampler_fine == placement
    with pytest.raises(ValueError, match="--n_model 0"):
        common.avatar_config(parse(["--n_model", "0"]), tracing=tracing)
