"""The port over several processes (`hfa_gp_tpu_torch/parallel/`), on the
CPU over gloo: N ranks at a global batch B against one rank at B, and
against the JAX package on a mesh of the same shape (its virtual 8-device
CPU mesh, tests/conftest.py).

The ranks are processes of their own: this file run as a script,
`python tests/test_torch_distributed.py --worker <mode> --out <dir>`, with
the WORLD_SIZE/RANK/MASTER_ADDR/MASTER_PORT contract. They import no JAX
(each asserts it before it writes its result). Each rank waits at most
WORKER_TIMEOUT in the rendezvous and in a collective, and the first rank
to fail brings the others down.

  (a, b) the sharded PartialFC loss and loss_sampled (injected indices) at
         (n_data, n_model) = (1, 2) and (2, 2), fp32 against JAX's mesh
         (loss rel 1e-5, gradients 1e-5 of their largest entry) and
         against the port's one shard, and with bf16 operands against the
         port's one-shard bf16 (bf16 rounds differently in JAX);
  (c) one arcface step (iresnet18, 112², batch 8, 32 classes) on 2 × 2
         ranks against one rank and against JAX's 2 × 2 step from the same
         converted state;
  (d) `train_arcface.main --device cpu` on 2 × 2 ranks then a one-rank
         `--resume`, against 4 straight one-rank steps; only the primary
         writes; the `--rec` reader's rows per rank;
  (e) one RGB, 3DMM and audio step on 2 ranks: disjoint reads, equal to
         one rank and to JAX's 2-device mesh step;
  (f) `run_recon_video_rgb` and `_audio` on 2 ranks against one rank;
  (g) `maybe_initialize`'s precedence, the mesh shapes and the row ranges,
         without processes.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120          # s, a rank's wait in a collective
SPAWN_TIMEOUT = 300           # s, a whole group of ranks

# the arcface problem of (a) and (b)
PFC_CLASSES, PFC_DIM, PFC_BATCH, PFC_RATE = 32, 64, 8, 0.5
# with bf16 operands the plain CE's autograd rounds each gradient that
# reaches a rounded operand to bf16 (2^-9 relative): on n_model = 2 shards
# each shard's part of d emb is rounded before the sum over the model axis,
# on one shard the whole once, so the two part by up to three roundings
BF16_GRAD_TOL = 3 * 2.0 ** -9
# of (c) and (d)
ARC_NET, ARC_CLASSES, ARC_BATCH = "iresnet18", 32, 8


def _tiny_avatar_cfg(dim_shape: int = 4):
    """The port's copy of tests/distributed_worker.py:_tiny_avatar_cfg."""
    from hfa_gp_tpu_torch.models.avatar.heads import AvatarConfig
    from hfa_gp_tpu_torch.models.eg3d import networks as nets
    from hfa_gp_tpu_torch.models.eg3d import renderer as rnd
    from hfa_gp_tpu_torch.models.eg3d.generator import EG3DConfig
    return AvatarConfig(size=64, dim_shape=dim_shape, eg3d=EG3DConfig(
        mapping=nets.MappingConfig(num_layers=2),
        backbone=nets.BackboneConfig(img_resolution=32, channel_base=2048,
                                     channel_max=128),
        sr=nets.SRConfig(input_resolution=16, output_resolution=64,
                         in_channels=32, block_channels=(32, 16)),
        render=rnd.RenderConfig(depth_resolution=8,
                                depth_resolution_importance=8,
                                neural_rendering_resolution=16)))


class _Recording:
    """A dataset that records the rows this rank decodes."""

    def __init__(self, ds):
        self.ds, self.rows = ds, []

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.rows.append(int(i))
        return self.ds[i]

    def __getattr__(self, name):
        return getattr(self.ds, name)


# -- the ranks ---------------------------------------------------------------


def _w_pfc(a) -> dict:
    """Loss and gradients of the sharded PartialFC, dense and sampled, in
    fp32 and with bf16 operands, on this rank's shard and rows."""
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    distributed.maybe_initialize(None, "cpu")
    n_data, n_model = (int(x) for x in a.shape.split(","))
    mesh = mesh_mod.make_mesh(n_data, n_model)
    prob = np.load(a.data)
    # rank 0's values everywhere
    mine = torch.full((3,), float(mesh.rank))
    mesh_mod.replicate([mine])
    emb = torch.from_numpy(mesh_mod.process_local_batch(prob["emb"], mesh))
    lab = torch.from_numpy(mesh_mod.process_local_batch(prob["lab"], mesh))
    out = {"replicated": mine}
    for name, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        pfc = PartialFC(PFC_CLASSES, PFC_DIM, matmul_dtype=dt, mesh=mesh)
        lo = mesh.model_index * pfc.num_local
        w = torch.from_numpy(prob["w"][lo:lo + pfc.num_local].copy())
        w.requires_grad_(True)
        e = emb.clone().requires_grad_(True)
        loss = pfc.loss(w, e, lab)
        gw, ge = torch.autograd.grad(loss, (w, e))
        out[name] = (loss.detach(), gw, ge)
        sp = PartialFC(PFC_CLASSES, PFC_DIM, matmul_dtype=dt, mesh=mesh,
                       sample_rate=PFC_RATE)
        k = prob["index"].shape[0] // n_model
        idx = torch.from_numpy(
            prob["index"][mesh.model_index * k:(mesh.model_index + 1) * k]
        ).long()
        sub = sp.take_rows(w.detach(), idx).requires_grad_(True)
        e = emb.clone().requires_grad_(True)
        loss = sp.loss_sampled(sub, e, lab, idx)
        gs, ge = torch.autograd.grad(loss, (sub, e))
        out[name + "_sampled"] = (loss.detach(), gs, ge)
    return out


def _arc_state(path: str, pfc, tx, fc_tx):
    """The saved one-rank state, this rank's shard of its table."""
    from hfa_gp_tpu_torch.models.arcface import registry
    from hfa_gp_tpu_torch.train import arcface as arc
    saved = torch.load(path, weights_only=True)
    bb, st = registry.init_backbone(torch.Generator().manual_seed(0),
                                    ARC_NET, 512, "cpu")
    bb.load_state_dict(saved["backbone"])
    st.load_state_dict(saved["batch_stats"])
    bb.requires_grad_(True)
    lo = pfc.shard * pfc.num_local
    w = saved["table"][lo:lo + pfc.num_local].clone()
    return arc.ArcFaceState(bb, st, w, tx.build(bb), fc_tx.init(w), 0)


def arc_step(mesh, path: str, x: torch.Tensor, lab: torch.Tensor) -> dict:
    """One fp32 dense arcface step from the saved state: the rank's loss,
    shard of the table, running moments and backbone."""
    from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
    from hfa_gp_tpu_torch.train import arcface as arc
    pfc = PartialFC(ARC_CLASSES, 512, mesh=mesh)
    tx, fc_tx = arc.make_optimizers(4, lr=0.01, clip_grad_norm=None)
    state = _arc_state(path, pfc, tx, fc_tx)
    step = arc.make_train_step(pfc, tx, fc_tx, ARC_NET, dtype=torch.float32)
    m = step(state, x, lab, None)
    return {"loss": m["loss"], "table": state.fc_weight.detach().clone(),
            "stats": state.batch_stats.state_dict(),
            "backbone": state.backbone.state_dict()}


def _w_arcstep(a) -> dict:
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    distributed.maybe_initialize(None, "cpu")
    mesh = mesh_mod.make_mesh(2, 2)
    batch = torch.load(a.data + ".batch", weights_only=True)
    x, lab = mesh_mod.process_local_batch((batch["x"], batch["lab"]), mesh)
    return arc_step(mesh, a.data, x, lab)


def arc_cli_args(*extra):
    from hfa_gp_tpu_torch.cli import train_arcface
    return train_arcface.build_argparser().parse_args([
        "--device", "cpu", "--network", ARC_NET, "--num_classes",
        str(ARC_CLASSES), "--batch_size", str(ARC_BATCH), "--fp32",
        "--num_steps", "4", *extra])


def _w_arccli(a) -> dict:
    """train_arcface.main on 2 × 2 ranks, each with an --output of its
    own: the primary's alone may fill it."""
    from hfa_gp_tpu_torch.cli import train_arcface
    from hfa_gp_tpu_torch.parallel import distributed
    rank = int(os.environ["RANK"])
    out = os.path.join(a.out, f"run{rank}")
    sps = train_arcface.main(arc_cli_args("--n_model", "2", "--output", out,
                                          "--save_freq", "2"))
    assert distributed.world()[1] == 4
    return {"sps": sps}


def _avatar_params(data: str, name: str):
    from hfa_gp_tpu_torch.utils import convert
    return convert.from_jax(convert.load_npz(os.path.join(data, name)))


def avatar_steps(data: str, mesh, cfg=None) -> dict:
    """One RGB, 3DMM and audio step (global batch 4) on this rank's rows
    of the first batch of each loader, on `cfg` (by default the tiny
    config): its loss terms, the params' sum of absolute values after the
    update and a hash of their bytes, and the rows it decoded."""
    import hashlib
    from hfa_gp_tpu_torch.data.dataset import (HeadData, HeadData3DMM,
                                               HeadDataAudio, process_sharded)
    from hfa_gp_tpu_torch.train import audio as taudio
    from hfa_gp_tpu_torch.train import rgb as trgb
    from hfa_gp_tpu_torch.train import t3dmm as tt3dmm
    from hfa_gp_tpu_torch.train.state import init_state
    cfg = _tiny_avatar_cfg(dim_shape=8) if cfg is None else cfg
    lp = _avatar_params(data, "lpips.npz")
    root = os.path.join(data, "ds")
    out = {}

    def done(name, state, m, ds):
        h = hashlib.sha256()
        for p in state.params.parameters():
            h.update(p.detach().numpy().tobytes())
        out[name] = {"metrics": {k: float(v) for k, v in m.items()},
                     "chk": float(sum(p.detach().abs().sum(dtype=torch.float64)
                                      for p in state.params.parameters())),
                     "sha": h.hexdigest(), "rows": sorted(ds.rows)}

    ds = _Recording(HeadData("train", size=64, person="person_3",
                             root=os.path.join(root, "nerface_dataset")))
    real, label = next(iter(process_sharded(ds, 4, mesh)))
    state = init_state(_avatar_params(data, "rgb.npz"), 1e-3)
    done("rgb", state, trgb.train_step(state, lp, cfg, real, label, 0,
                                       mesh=mesh), ds)

    ds = _Recording(HeadData3DMM("train", size=64, person="person_3",
                                 root=os.path.join(root, "nerface_dataset")))
    real, label, coeffs = next(iter(process_sharded(ds, 4, mesh)))
    state = init_state(_avatar_params(data, "t3dmm.npz"), 1e-3)
    done("3dmm", state, tt3dmm.train_step(state, lp, cfg, real, label,
                                          coeffs, 0, mesh=mesh), ds)

    ds = _Recording(HeadDataAudio("train", size=64, person="obama",
                                  root=os.path.join(root, "ad_dataset")))
    ids = next(iter(process_sharded(_Indices(len(ds)), 4, mesh)))[0]
    items = [ds[int(i)] for i in ids]
    wins = torch.from_numpy(np.stack([ds.get_audio_window(int(i))
                                      for i in ids]))
    state = init_state(_avatar_params(data, "audio.npz"), 1e-3)
    done("audio", state, taudio.train_step(
        state, lp, cfg, torch.stack([it[0] for it in items]),
        torch.stack([it[1] for it in items]), wins, True, 0, mesh=mesh), ds)
    return out


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (torch.tensor(i),)


def _w_avatar(a) -> dict:
    from hfa_gp_tpu_torch.parallel import distributed
    from hfa_gp_tpu_torch.parallel import mesh as mesh_mod
    distributed.maybe_initialize(None, "cpu")
    return avatar_steps(a.data, mesh_mod.make_mesh_for_batch(4))


def reenact_clis(data: str, out: str) -> None:
    """run_recon_video_rgb and _audio on the tiny config, random params,
    batches of 4 over 6 frames (the last one padded)."""
    from hfa_gp_tpu_torch.cli import common, run_recon_video_audio
    from hfa_gp_tpu_torch.cli import run_recon_video_rgb
    real = common.avatar_config

    def tiny(args, **kw):
        real(args, **kw)
        return _tiny_avatar_cfg(dim_shape=args.latent_dim_shape)

    common.avatar_config = tiny
    try:
        flags = ["--size", "64", "--dataset_root", os.path.join(data, "ds"),
                 "--latent_dim_shape", "4", "--demo_dir", out,
                 "--render_batch", "4", "--fps", "4", "--device", "cpu"]
        run_recon_video_rgb.main(run_recon_video_rgb.build_argparser()
                                 .parse_args(flags + ["--demo_name", "rgb"]))
        run_recon_video_audio.main(
            run_recon_video_audio.build_argparser().parse_args(
                flags + ["--dataset", "ad_dataset", "--person", "obama",
                         "--demo_name", "audio", "--smooth"]))
    finally:
        common.avatar_config = real


def _w_reenact(a) -> dict:
    rank = int(os.environ["RANK"])
    reenact_clis(a.data, os.path.join(a.out, f"demo{rank}"))
    return {}


WORKERS = {"pfc": _w_pfc, "arcstep": _w_arcstep, "arccli": _w_arccli,
           "avatar": _w_avatar, "reenact": _w_reenact}


def _worker_main(argv, workers: dict | None = None) -> None:
    """A rank: runs `workers[--worker]` (this file's WORKERS by default)
    and saves its result as rank{RANK}.pt under --out."""
    workers = WORKERS if workers is None else workers
    p = argparse.ArgumentParser()
    p.add_argument("--worker", choices=sorted(workers))
    p.add_argument("--out")
    p.add_argument("--data", default=None)
    p.add_argument("--shape", default="2,1")
    a = p.parse_args(argv)
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from hfa_gp_tpu_torch.parallel import distributed
    distributed.TIMEOUT = datetime.timedelta(seconds=WORKER_TIMEOUT)
    result = workers[a.worker](a)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hfa_gp_tpu"))
    assert not foreign, foreign[:5]
    torch.save(result, os.path.join(a.out, f"rank{os.environ['RANK']}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# -- the spawner -------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, world: int, out: str, *extra: str,
          script: str = __file__) -> list:
    """Run `mode` of `script` (this file, or another test file whose ranks
    run `_worker_main` with workers of their own) on `world` ranks; the
    results of rank 0 … world-1. A rank that fails kills the others, and
    the group as a whole has SPAWN_TIMEOUT."""
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1")
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), "--worker", mode,
         "--out", out, *extra],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{r}.log")) as f:
                log = f.read()
            raise AssertionError(f"{mode}: rank {r} of {world} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _near(got, want, tol: float, what: str, scale: float | None = None
          ) -> None:
    """Within tol of `scale`, by default want's largest entry."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
    sys.exit(0)

# -- the tests (the pytest process; JAX is imported here only) ---------------

import pytest  # noqa: E402

torch.set_num_threads(1)

from hfa_gp_tpu_torch.parallel import distributed  # noqa: E402
from hfa_gp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC  # noqa: E402


def _pfc_problem():
    """Seeded table, batch and labels (one row without a positive), and
    the key of JAX's sampling."""
    import jax
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((PFC_CLASSES, PFC_DIM)) * 0.1) \
        .astype(np.float32)
    emb = rng.standard_normal((PFC_BATCH, PFC_DIM)).astype(np.float32)
    lab = rng.integers(0, PFC_CLASSES, PFC_BATCH).astype(np.int64)
    lab[0] = -1                                        # a row with none
    return w, emb, lab, jax.random.PRNGKey(5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_partial_fc_matches_jax_and_one_shard(tmp_path, shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    from hfa_gp_tpu.parallel import partial_fc as jpfc

    n_data, n_model = shape
    w, emb, lab, key = _pfc_problem()
    jmesh = jmesh_mod.make_mesh(n_data, n_model,
                                devices=jax.devices()[:n_data * n_model])
    data_sh = NamedSharding(jmesh, P(jmesh_mod.DATA_AXIS))
    with jax.sharding.set_mesh(jmesh):
        jd = jpfc.PartialFC(jmesh, PFC_CLASSES, PFC_DIM, ce_pallas=False)
        ws = jax.device_put(jnp.asarray(w), jd.weight_sharding())
        es = jax.device_put(jnp.asarray(emb), data_sh)
        ls = jax.device_put(jnp.asarray(lab, jnp.int32), data_sh)
        want = jax.jit(jax.value_and_grad(lambda a, b: jd.loss(a, b, ls),
                                          argnums=(0, 1)))(ws, es)
        js = jpfc.PartialFC(jmesh, PFC_CLASSES, PFC_DIM, ce_pallas=False,
                            sample_rate=PFC_RATE)
        index = js.sample_indices(ls, key)
        sub = js.take_rows(ws, index)
        want_s = jax.jit(jax.value_and_grad(
            lambda a, b: js.loss_sampled(a, b, ls, index),
            argnums=(0, 1)))(sub, es)
    index = np.asarray(index)
    data = str(tmp_path / "problem.npz")
    np.savez(data, w=w, emb=emb, lab=lab, index=index)
    ranks = spawn("pfc", n_data * n_model, str(tmp_path / "out"),
                  "--data", data, "--shape", f"{n_data},{n_model}")

    def one_shard(dt, sampled):
        """The port's one-shard loss on the whole problem."""
        wt = torch.from_numpy(w)
        e = torch.from_numpy(emb).requires_grad_(True)
        lt = torch.from_numpy(lab)
        if not sampled:
            pfc = PartialFC(PFC_CLASSES, PFC_DIM, matmul_dtype=dt)
            wt.requires_grad_(True)
            loss = pfc.loss(wt, e, lt)
            return (loss,) + torch.autograd.grad(loss, (wt, e))
        # the shards' sampled rows side by side: one shard of all of them
        k = index.shape[0] // n_model
        rows = np.concatenate([index[j * k:(j + 1) * k] + j * PFC_CLASSES
                               // n_model for j in range(n_model)])
        pfc = PartialFC(PFC_CLASSES, PFC_DIM, matmul_dtype=dt,
                        sample_rate=PFC_RATE)
        idx = torch.from_numpy(rows).long()
        sub = wt[idx].clone().requires_grad_(True)
        loss = pfc.loss_sampled(sub, e, lt, idx)
        return (loss,) + torch.autograd.grad(loss, (sub, e))

    assert all(torch.equal(r["replicated"], torch.zeros(3)) for r in ranks)
    local = PFC_CLASSES // n_model
    rows_per = PFC_BATCH // n_data
    for name, (jl, (jgw, jge)) in (("fp32", want),
                                   ("fp32_sampled", want_s)):
        jgw, jge = np.asarray(jgw), np.asarray(jge)
        k = jgw.shape[0] // n_model
        for r, res in enumerate(ranks):
            loss, gw, ge = res[name]
            di, mi = r // n_model, r % n_model
            assert float(loss) == pytest.approx(float(jl), rel=1e-5), \
                (name, r)
            shard = jgw[mi * local:(mi + 1) * local] if name == "fp32" \
                else jgw[mi * k:(mi + 1) * k]
            _near(gw.numpy(), shard, 1e-5, f"{name} d table, rank {r}")
            _near(ge.numpy(), jge[di * rows_per:(di + 1) * rows_per], 1e-5,
                  f"{name} d emb, rank {r}")
    # every rank holds the one-shard loss; bf16 against the port's own
    for name, dt, tol in (("fp32", None, 1e-5),
                          ("bf16", torch.bfloat16, BF16_GRAD_TOL)):
        for sampled in (False, True):
            key_ = name + ("_sampled" if sampled else "")
            ol, ogw, oge = (t.detach() for t in one_shard(dt, sampled))
            k = ogw.shape[0] // n_model
            for r, res in enumerate(ranks):
                loss, gw, ge = res[key_]
                di, mi = r // n_model, r % n_model
                assert float(loss) == pytest.approx(float(ol), rel=1e-5)
                _near(gw.numpy(), ogw[mi * k:(mi + 1) * k].numpy(), tol,
                      f"{key_} d table vs one shard, rank {r}")
                _near(ge.numpy(),
                      oge[di * rows_per:(di + 1) * rows_per].numpy(), tol,
                      f"{key_} d emb vs one shard, rank {r}")


# -- (c) one arcface step ----------------------------------------------------


def _jax_arc_model(seed=0):
    import jax
    import jax.numpy as jnp

    from hfa_gp_tpu.models.arcface import iresnet as jres
    p, st = jres.init_iresnet(jax.random.PRNGKey(seed), ARC_NET)
    rng = np.random.default_rng(seed)
    p["fc"]["weight"] = jnp.asarray(
        rng.standard_normal(p["fc"]["weight"].shape).astype(np.float32)
        * 0.05)
    return p, st


def test_arcface_step_on_2x2_ranks_matches_one_rank_and_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    from hfa_gp_tpu.parallel.partial_fc import PartialFC as JaxPartialFC
    from hfa_gp_tpu.train import arcface as jarc
    from hfa_gp_tpu_torch.models.arcface import convert

    p, st = _jax_arc_model()
    table = (np.random.default_rng(1).standard_normal((ARC_CLASSES, 512))
             * 0.01).astype(np.float32)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((ARC_BATCH, 112, 112, 3)).astype(np.float32)
    lab = rng.integers(0, ARC_CLASSES, ARC_BATCH)
    tp, ts = convert.iresnet_from_jax(jax.tree.map(np.asarray, p),
                                      jax.tree.map(np.asarray, st))
    path = str(tmp_path / "state.pt")
    torch.save({"backbone": tp.state_dict(), "batch_stats": ts.state_dict(),
                "table": torch.from_numpy(table)}, path)
    torch.save({"x": torch.from_numpy(x), "lab": torch.from_numpy(lab)},
               path + ".batch")
    ranks = spawn("arcstep", 4, str(tmp_path / "out"), "--data", path)
    one = arc_step(None, path, torch.from_numpy(x), torch.from_numpy(lab))

    # JAX's step on a 2 x 2 mesh from the same state
    jmesh = jmesh_mod.make_mesh(2, 2, devices=jax.devices()[:4])
    jpfc_ = JaxPartialFC(jmesh, ARC_CLASSES, 512, ce_pallas=False)
    jtx, jfc = jarc.make_optimizers(4, lr=0.01, clip_grad_norm=None)
    jstep = jarc.make_train_step(jpfc_, jtx, jfc, ARC_NET,
                                 dtype=jnp.float32, donate=False)
    with jax.sharding.set_mesh(jmesh):
        jw = jax.device_put(jnp.asarray(table), jpfc_.weight_sharding())
        state = jarc.ArcFaceState(
            jmesh_mod.replicate(jmesh, p), jmesh_mod.replicate(jmesh, st),
            jw, jmesh_mod.replicate(jmesh, jtx.init(p)), jfc.init(jw),
            jnp.zeros((), jnp.int32))
        xs, ls = jmesh_mod.shard_batch(
            jmesh, (jnp.asarray(x), jnp.asarray(lab, jnp.int32)))
        jstate, jm = jstep(state, xs, ls, jax.random.PRNGKey(0))
        jtable = np.asarray(jstate.fc_weight)
        jbb, jstats = convert.iresnet_from_jax(
            jax.tree.map(np.asarray, jstate.backbone),
            jax.tree.map(np.asarray, jstate.batch_stats))
    jstats = jstats.state_dict()
    jbb = jbb.state_dict()

    whole = torch.cat([ranks[0]["table"], ranks[1]["table"]])
    assert torch.equal(whole, torch.cat([ranks[2]["table"],
                                         ranks[3]["table"]]))
    for r, res in enumerate(ranks):
        # every rank ends with the same bits of the backbone and moments
        for k, v in res["backbone"].items():
            assert torch.equal(v, ranks[0]["backbone"][k]), (r, k)
        for k, v in res["stats"].items():
            assert torch.equal(v, ranks[0]["stats"][k]), (r, k)
        assert torch.equal(res["loss"], ranks[0]["loss"])
    res = ranks[0]
    for ref, loss, tab, stats, what in (
            (res, one["loss"], one["table"], one["stats"], "one rank"),
            (res, float(jm["loss"]), jtable, jstats, "JAX 2x2")):
        assert float(ref["loss"]) == pytest.approx(float(loss), rel=1e-5), \
            what
        chk = float(torch.as_tensor(tab).abs().sum())
        assert float(whole.abs().sum()) == pytest.approx(chk, rel=1e-5), what
        for k, v in stats.items():
            # a running mean is 0.1 x a batch mean, a sum of ~25,000 terms
            # that nearly cancel: held in units of 0.1 x the batch's
            # standard deviation (the running variance was 1 before it)
            scale = None
            if k.endswith(".mean"):
                var = stats[k[:-5] + ".var"]
                scale = 0.1 * float(torch.as_tensor(
                    (var - 0.9) / 0.1).clamp(min=0).sqrt().max())
            _near(ref["stats"][k].numpy(), torch.as_tensor(v).numpy(), 1e-5,
                  f"{what}: running {k}", scale)
    _near(whole, one["table"], 1e-5, "one rank: table")
    # the backbone's gradient, from its first SGD step (no clip, so that a
    # gradient off by a factor shows): w1 = w0 - lr·(g + wd·w0). A gradient
    # is a sum over the batch, here in another order (each rank's rows,
    # then the ranks), through 20 layers of train-mode BN whose sums nearly
    # cancel, and a bias in front of such a BN has a gradient that is zero
    # but for rounding. So each tensor's gradient is measured against the
    # larger of its own largest entry and 1e-4 of the backbone's largest,
    # and held to 1e-2: the one-rank port and JAX's 2 x 2 step part by
    # 5.6e-3 so (2.7e-3 seen between 2 x 2 ranks and one)
    init = torch.load(path, weights_only=True)["backbone"]
    lr0 = arc_lr0()

    def grads(bb):
        return {k: (init[k] - v) / lr0 - 5e-4 * init[k]
                for k, v in bb.items()}

    want = {"one rank": grads(one["backbone"]), "JAX 2x2": grads(jbb)}
    got = grads(res["backbone"])
    scale = {k: float(g.abs().max()) for k, g in want["one rank"].items()}
    floor = 1e-4 * max(scale.values())
    for what, ref in want.items():
        worst = max((float((got[k] - g).abs().max()) / max(scale[k], floor),
                     k) for k, g in ref.items())
        assert worst[0] <= 1e-2, (what, worst)


def arc_lr0() -> float:
    from hfa_gp_tpu_torch.train import arcface as arc
    return float(arc.make_optimizers(4, lr=0.01)[0].sched(0))


# -- (d) the CLI -------------------------------------------------------------


def test_train_arcface_on_2x2_ranks_resumes_on_one(tmp_path, capsys):
    from hfa_gp_tpu_torch.cli import train_arcface
    out = str(tmp_path / "out")
    spawn("arccli", 4, out)
    run0 = os.path.join(out, "run0")
    # the primary alone writes: the log and the checkpoints of steps 2, 4
    assert sorted(os.listdir(run0)) == ["checkpoint", "training.log"]
    assert sorted(os.listdir(os.path.join(run0, "checkpoint"))) \
        == ["000002", "000004"]
    for r in (1, 2, 3):
        assert not os.path.exists(os.path.join(out, f"run{r}"))
    four = torch.load(os.path.join(run0, "checkpoint", "000004"),
                      weights_only=True)
    # the 2 x 2 checkpoint of step 2, resumed on one rank to step 4
    os.remove(os.path.join(run0, "checkpoint", "000004"))
    train_arcface.main(arc_cli_args("--output", run0, "--resume"))
    resumed = torch.load(os.path.join(run0, "checkpoint", "000004"),
                         weights_only=True)
    straight_dir = str(tmp_path / "straight")
    train_arcface.main(arc_cli_args("--output", straight_dir))
    capsys.readouterr()
    straight = torch.load(os.path.join(straight_dir, "checkpoint", "000004"),
                          weights_only=True)
    from hfa_gp_tpu_torch.models.arcface import registry
    init = registry.init_backbone(torch.Generator().manual_seed(0), ARC_NET,
                                  512, "cpu")[0].state_dict()
    # four steps at lr 0.1 carry each step's rounding differences (a sum
    # over the batch in another order) into the next: the table is held
    # to 1e-4 of its largest entry (4.6e-5 seen), its momentum and the
    # running moments to 1e-3, the bound at which test_torch_arcface holds
    # three steps of the port to JAX's (4.3e-4 seen, the features BN's
    # variance over 8 rows; a running mean in units of its running
    # deviation, as BN makes most means zero but for rounding). What the
    # four updates moved the backbone by is held in relative L2 to 1e-2,
    # where that test's fp32 steps of the two packages agree to 3.3e-3
    for got, what in ((four, "2x2"), (resumed, "2x2 + resume")):
        assert got["step"] == straight["step"] == 4
        assert got["fc_weight"].shape == (ARC_CLASSES, 512)
        _near(got["fc_weight"], straight["fc_weight"], 1e-4, f"{what} table")
        _near(got["fc_opt_state"]["mom"], straight["fc_opt_state"]["mom"],
              1e-3, f"{what} momentum")
        stats = straight["batch_stats"]
        for k, v in stats.items():
            scale = (float(stats[k[:-5] + ".var"].sqrt().max())
                     if k.endswith(".mean") else None)
            _near(got["batch_stats"][k], v, 1e-3, f"{what} running {k}",
                  scale)
        moved = [(got["backbone"][k] - init[k], v - init[k])
                 for k, v in straight["backbone"].items()]
        gap = (sum(float((a - b).square().sum()) for a, b in moved)
               / sum(float(b.square().sum()) for _, b in moved)) ** 0.5
        assert gap <= 1e-2, (what, gap)


class _FaceRecords:
    """Stands in for RecordFaceDataset: 40 seeded items, recording which
    rows are decoded."""

    def __init__(self, path, size=112):
        self.rows = []

    def __len__(self):
        return 40

    def __getitem__(self, i):
        self.rows.append(int(i))
        img = np.full((112, 112, 3), i / 40.0, np.float32)
        return img, np.int32(i % ARC_CLASSES)


def test_rec_ranks_read_disjoint_rows_of_the_global_batch(monkeypatch):
    """--rec on a 2 x 2 mesh: the two data indices decode disjoint halves
    of each global batch, the model axis's peers the same rows."""
    from hfa_gp_tpu_torch.cli import train_arcface
    made = []

    def records(path, size=112):
        made.append(_FaceRecords(path, size))
        return made[-1]

    monkeypatch.setattr(train_arcface, "RecordFaceDataset", records)
    args = arc_cli_args("--rec", "x.array_record")
    whole = train_arcface.record_batches(args, torch.device("cpu"),
                                         tmesh.Mesh())
    for t in (0, 3):
        want = whole(t)
        rows = []
        for r in range(4):
            get = train_arcface.record_batches(
                args, torch.device("cpu"), tmesh.Mesh(2, 2, rank=r))
            imgs, labs = get(t)
            assert imgs.shape[0] == labs.shape[0] == ARC_BATCH // 2
            lo = (r // 2) * (ARC_BATCH // 2)
            assert torch.equal(imgs, want[0][lo:lo + ARC_BATCH // 2])
            assert torch.equal(labs, want[1][lo:lo + ARC_BATCH // 2])
            rows.append(made[-1].rows)
        assert rows[0] == rows[1] and rows[2] == rows[3]
        assert not set(rows[0]) & set(rows[2])
        assert sorted(rows[0] + rows[2]) == sorted(made[0].rows[-ARC_BATCH:])


# -- (e), (f) the avatars ----------------------------------------------------


@pytest.fixture(scope="module")
def avatar_data(tmp_path_factory):
    """Datasets (8 train, 6 test frames), and seeded JAX params in npz for
    the RGB, 3DMM and audio avatars and LPIPS, in JAX's layout."""
    import jax

    from hfa_gp_tpu.models import lpips as jlpips
    from hfa_gp_tpu.models.avatar import heads as jheads
    from hfa_gp_tpu.train import audio as jaudio
    from hfa_gp_tpu_torch.utils import convert
    from tests.distributed_worker import _tiny_avatar_cfg as jax_tiny
    from tests.fixtures import make_avatar_dataset
    from tests.test_torch_train_3dmm_audio import _face_the_head
    root = str(tmp_path_factory.mktemp("dist"))
    ds = os.path.join(root, "ds")
    _face_the_head(make_avatar_dataset(os.path.join(ds, "nerface_dataset"),
                                       n_train=8, n_test=6),
                   ("train", "test2"))
    _face_the_head(make_avatar_dataset(os.path.join(ds, "ad_dataset"),
                                       person="obama", audio=True, seed=1,
                                       n_train=8, n_test=6),
                   ("train", "test"))
    cfg = jax_tiny(dim_shape=8)
    # jitted: one compile each instead of an eager dispatch per leaf
    trees = {"rgb": jax.jit(lambda k: jheads.init_avatar_rgb(k, cfg))(
                 jax.random.PRNGKey(0)),
             "t3dmm": jax.jit(lambda k: jheads.init_avatar_3dmm(k, cfg))(
                 jax.random.PRNGKey(1)),
             "audio": jax.jit(lambda k: jaudio.init_audio_params(k, cfg))(
                 jax.random.PRNGKey(2)),
             "lpips": jax.jit(jlpips.init_lpips)(jax.random.PRNGKey(99))}
    for name, tree in trees.items():
        convert.save_npz(jax.tree.map(np.asarray, tree),
                         os.path.join(root, f"{name}.npz"))
    return root


def _jax_avatar_steps(root: str) -> dict:
    """JAX's RGB, 3DMM and audio steps on a 2-device mesh, batch 4 (the
    first batch of its BatchIterator, the same seed-synced order)."""
    import jax
    import jax.numpy as jnp

    from hfa_gp_tpu.data import BatchIterator
    from hfa_gp_tpu.data import HeadData as JHeadData
    from hfa_gp_tpu.data import HeadData3DMM as JHeadData3DMM
    from hfa_gp_tpu.data import HeadDataAudio as JHeadDataAudio
    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    from hfa_gp_tpu.train import audio as jaudio
    from hfa_gp_tpu.train import rgb as jrgb
    from hfa_gp_tpu.train import t3dmm as jt3dmm
    from hfa_gp_tpu.train.state import init_state, make_optimizer
    from hfa_gp_tpu_torch.utils import convert
    from tests.distributed_worker import _tiny_avatar_cfg as jax_tiny

    cfg = jax_tiny(dim_shape=8)
    mesh = jmesh_mod.make_mesh(2, 1, devices=jax.devices()[:2])
    lp = convert.load_npz(os.path.join(root, "lpips.npz"))
    ds_root = os.path.join(root, "ds")
    out = {}

    def run(name, step, tx, batch):
        params = convert.load_npz(os.path.join(root, f"{name}.npz"))
        with jax.sharding.set_mesh(mesh):
            state = init_state(jmesh_mod.replicate(mesh, params), tx)
            state = state._replace(
                opt_state=jmesh_mod.replicate(mesh, state.opt_state))
            state2, m = step(state, jmesh_mod.replicate(mesh, lp),
                             *jmesh_mod.shard_batch(mesh, batch))
            chk = float(sum(np.abs(np.asarray(v, np.float64)).sum()
                            for v in jax.tree.leaves(state2.params)))
        return {"metrics": {k: float(v) for k, v in m.items()}, "chk": chk}

    tx = make_optimizer(1e-3)
    ds = JHeadData("train", size=64, person="person_3",
                   root=os.path.join(ds_root, "nerface_dataset"))
    out["rgb"] = run("rgb", jrgb.make_train_step(cfg, tx, 0, donate=False),
                     tx, next(iter(BatchIterator(ds, 4))))
    ds = JHeadData3DMM("train", size=64, person="person_3",
                       root=os.path.join(ds_root, "nerface_dataset"))
    out["3dmm"] = run("t3dmm", jt3dmm.make_train_step(cfg, tx, 0,
                                                      donate=False),
                      tx, next(iter(BatchIterator(ds, 4))))
    ds = JHeadDataAudio("train", size=64, person="obama",
                        root=os.path.join(ds_root, "ad_dataset"))
    ids = next(iter(BatchIterator(_Indices(len(ds)), 4)))[0]
    items = [ds[int(i)] for i in ids]
    atx = jaudio.make_audio_optimizer(1e-3)
    out["audio"] = run(
        "audio", jaudio.make_train_step(cfg, atx, 0, smooth=True,
                                        donate=False), atx,
        (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
         np.stack([ds.get_audio_window(int(i)) for i in ids])))
    return out


def test_avatar_steps_on_2_ranks_match_one_rank_and_jax(avatar_data,
                                                        tmp_path):
    ranks = spawn("avatar", 2, str(tmp_path / "out"), "--data", avatar_data)
    one = avatar_steps(avatar_data, tmesh.Mesh())
    jx = _jax_avatar_steps(avatar_data)
    for name in ("rgb", "3dmm", "audio"):
        # disjoint reads that make up the one-rank batch
        rows = [r[name]["rows"] for r in ranks]
        assert len(rows[0]) == len(rows[1]) == 2, rows
        assert not set(rows[0]) & set(rows[1])
        assert sorted(rows[0] + rows[1]) == one[name]["rows"]
        for r in ranks:
            for k in ("loss", "l2_loss", "lpips_loss"):
                got = r[name]["metrics"][k]
                assert got == pytest.approx(one[name]["metrics"][k],
                                            rel=1e-5), (name, k)
                # the port against JAX at test_torch_train's bound
                assert got == pytest.approx(jx[name]["metrics"][k],
                                            rel=1e-3), (name, k)
            assert r[name]["chk"] == pytest.approx(one[name]["chk"],
                                                   rel=1e-6), name
            assert r[name]["chk"] == pytest.approx(jx[name]["chk"],
                                                   rel=1e-5), name


def test_reenactment_on_2_ranks_matches_one_rank(avatar_data, tmp_path):
    from PIL import Image
    out = str(tmp_path / "out")
    spawn("reenact", 2, out, "--data", avatar_data)
    torch.manual_seed(0)
    reenact_clis(avatar_data, os.path.join(out, "single"))
    # the secondary writes nothing
    assert not os.path.exists(os.path.join(out, "demo1"))
    for name in ("rgb", "audio"):
        want = sorted(glob.glob(os.path.join(out, "single", name, "*.png")))
        got = sorted(glob.glob(os.path.join(out, "demo0", name, "*.png")))
        assert len(want) == len(got) == 6, (name, got)
        for a, b in zip(got, want):
            a = np.asarray(Image.open(a)).astype(np.int16)
            b = np.asarray(Image.open(b)).astype(np.int16)
            assert np.abs(a - b).max() <= 1, (name, a)
        assert glob.glob(os.path.join(out, "demo0", name, "*.mp4")) \
            + glob.glob(os.path.join(out, "demo0", name, "*.avi"))


# -- (g) without processes ---------------------------------------------------


def test_maybe_initialize_precedence(monkeypatch):
    calls = []

    def fake(backend, **kw):
        calls.append((backend, kw))

    monkeypatch.setattr(torch.distributed, "init_process_group", fake)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    flags = argparse.Namespace(coordinator_address=None, num_processes=None,
                               process_id=None)
    # neither: one process, nothing joined
    assert distributed.maybe_initialize(flags) is False and not calls
    # the reference's variables
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_PORT", "29555")
    assert distributed.maybe_initialize(flags) is True
    assert calls[-1] == ("gloo", dict(init_method="tcp://127.0.0.1:29555",
                                      world_size=4, rank=3,
                                      timeout=distributed.TIMEOUT))
    # flags before the environment
    flags = argparse.Namespace(coordinator_address="10.0.0.1:1234",
                               num_processes=2, process_id=1)
    assert distributed.maybe_initialize(flags) is True
    assert calls[-1][1]["init_method"] == "tcp://10.0.0.1:1234"
    assert (calls[-1][1]["world_size"], calls[-1][1]["rank"]) == (2, 1)
    # one process by flag; a coordinator without a rank
    assert distributed.maybe_initialize(argparse.Namespace(
        coordinator_address="h:1", num_processes=1, process_id=0)) is False
    with pytest.raises(ValueError, match="process_id"):
        distributed.maybe_initialize(argparse.Namespace(
            coordinator_address="h:1", num_processes=2, process_id=None))
    # each rank's device: its own card where there are enough, else shared
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.rank_device(torch.device("cuda")) \
        == torch.device("cuda", 3)
    assert distributed.backend_for(torch.device("cuda")) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.rank_device(torch.device("cuda")) \
        == torch.device("cuda", 0)
    assert distributed.backend_for(torch.device("cuda")) == "gloo"
    assert distributed.rank_device(torch.device("cpu")) \
        == torch.device("cpu")


def test_mesh_shapes_and_rows_are_the_jax_ones(monkeypatch):
    import jax

    from hfa_gp_tpu.parallel import mesh as jmesh_mod
    for world in (1, 2, 4, 8):
        for n_model in (1, 2, 4):
            if n_model > world:
                continue
            for batch in (1, 2, 3, 6, 8, 12, 16):
                want = jmesh_mod.make_mesh_for_batch(
                    batch, n_model, devices=jax.devices()[:world]).shape
                got = tmesh.mesh_shape_for_batch(batch, n_model, world)
                assert got == (want["data"], want["model"]), \
                    (world, n_model, batch)
                if got[0] * got[1] < world:
                    # where JAX leaves devices idle, the port raises
                    monkeypatch.setattr(distributed, "world",
                                        lambda w=world: (0, w))
                    with pytest.raises(ValueError, match="idle"):
                        tmesh.make_mesh_for_batch(batch, n_model)
    monkeypatch.setattr(distributed, "world", lambda: (0, 1))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_mesh_for_batch(8, 2)
    one = tmesh.make_mesh_for_batch(8)
    assert (one.n_data, one.n_model, one.data_group) == (1, 1, None)
    # the rows of each (rank, world), as JAX's process_local_batch and
    # process_slice give them for (process, process count)
    x = np.arange(24 * 2).reshape(24, 2)
    seq = list(range(24))
    for world in (1, 2, 3, 4, 6):
        for r in range(world):
            monkeypatch.setattr(jax, "process_count", lambda w=world: w)
            monkeypatch.setattr(jax, "process_index", lambda r=r: r)
            mesh = tmesh.Mesh(n_data=world, n_model=1, rank=r)
            got = tmesh.process_local_batch((x, torch.from_numpy(x)), mesh)
            want = jmesh_mod.process_local_batch(x)
            assert np.array_equal(got[0], want)
            assert np.array_equal(got[1].numpy(), want)
            assert tmesh.process_slice(seq, mesh) \
                == jmesh_mod.process_slice(seq)
            # a model axis: the ranks of one data index hold the same rows
            m2 = tmesh.Mesh(n_data=world, n_model=2, rank=2 * r + 1)
            assert np.array_equal(tmesh.process_local_batch(x, m2), want)
