"""`cli/train_eg3d.py` on the CPU at a tiny size: a directory of frames
with EG3D's `test.json` labels written here, three steps saved through
`train/checkpoint.py`, a resume that continues with the step count, both
Adams and G_ema as they were saved, and lands where an unbroken run of
five steps lands."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from hfa_gp_tpu_torch.cli import train_eg3d
from hfa_gp_tpu_torch.core import camera as cam
from hfa_gp_tpu_torch.models.eg3d import discriminator as disc
from hfa_gp_tpu_torch.models.eg3d import generator as gen
from hfa_gp_tpu_torch.models.eg3d import networks, renderer
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from hfa_gp_tpu_torch.train import eg3d_gan
from hfa_gp_tpu_torch.utils.convert import ParamTree

torch.set_num_threads(1)

SIZE = 32


def tiny_gan(_args=None) -> eg3d_gan.GANConfig:
    g = gen.EG3DConfig(
        backbone=networks.BackboneConfig(img_resolution=16, img_channels=24,
                                         channel_base=256, channel_max=32),
        sr=networks.SRConfig(input_resolution=8, output_resolution=SIZE,
                             in_channels=8, block_channels=(16, 8)),
        render=renderer.RenderConfig(
            depth_resolution=4, depth_resolution_importance=4,
            neural_rendering_resolution=8, decoder_hidden=16,
            decoder_output_dim=8, sampler_fine="global"))
    d = disc.DiscriminatorConfig(img_resolution=SIZE, channel_base=256,
                                 channel_max=32)
    return eg3d_gan.GANConfig(generator=g, discriminator=d,
                              density_points=16)


def write_frames(root: str, n: int = 6) -> str:
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    labels = cam.flip_yz_label(cam.sample_camera_label(
        torch.Generator().manual_seed(1), n=n)).numpy()
    entries = []
    for i in range(n):
        name = f"img{i:05d}.png"
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3),
                                     dtype=np.uint8)).save(
            os.path.join(root, name))
        entries.append([name, labels[i].tolist()])
    with open(os.path.join(root, "test.json"), "w") as f:
        json.dump({"labels": entries}, f)
    return root


def _run(tmp_path, monkeypatch, name, iters, resume=None):
    monkeypatch.setattr(train_eg3d, "gan_config", tiny_gan)
    argv = ["--data", str(tmp_path / "frames"), "--device", "cpu",
            "--batch_size", "4", "--iter", str(iters), "--save_freq", "3",
            "--log_freq", "1", "--exp_path", str(tmp_path),
            "--exp_name", name, "--seed", "5"]
    if resume:
        argv += ["--resume_ckpt", resume]
    train_eg3d.main(train_eg3d.build_argparser().parse_args(argv))
    return tmp_path / name


def test_train_save_and_resume(tmp_path, monkeypatch):
    write_frames(str(tmp_path / "frames"))
    whole = _run(tmp_path, monkeypatch, "whole", 5)
    part = _run(tmp_path, monkeypatch, "part", 3)
    saved = str(part / "checkpoint" / "000002")
    assert os.path.exists(saved)
    with open(part / "log" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [0, 1, 2]
    assert {"Gmain", "Greg", "Dgen", "Dreal", "Dr1"} <= set(logged[0])
    assert "Dr1" not in logged[1]

    # the checkpoint holds the step and both Adams' states
    state = train_eg3d.initial_state(tiny_gan(), "cpu")
    ckpt.restore(saved, state)
    assert state.step == 3
    raw = torch.load(saved, weights_only=True)
    for opt, key in ((state.opt_G, "opt_G"), (state.opt_D, "opt_D")):
        st = opt.state_dict()["state"]
        assert st and st.keys() == raw[key]["state"].keys()
        for i, s in st.items():
            assert torch.equal(s["exp_avg_sq"], raw[key]["state"][i]
                               ["exp_avg_sq"])
    # D's leaves: three Dmain steps and step 0's Dreg
    assert {int(s["step"]) for s in state.opt_D.state.values()} == {4}

    # resumed for two more steps, it lands where five unbroken steps land
    _run(tmp_path, monkeypatch, "part", 2, resume=saved)
    resumed, unbroken = (torch.load(str(e / "checkpoint" / "000004"),
                                    weights_only=True) for e in (part, whole))
    assert resumed["step"] == unbroken["step"] == 5
    for k in ("G", "D", "G_ema"):
        for name, t in unbroken[k].items():
            torch.testing.assert_close(resumed[k][name], t, rtol=0, atol=0,
                                       msg=f"{k} {name}")



def test_the_cli_starts_from_eg3ds_initialisation():
    """G's and D's mapping layers at lr_mul 0.01 start N(0, 1/lr_mul²), as
    EG3D draws them and the benchmark's spec does; the embeddings and the
    synthesis N(0, 1); the same draws as `eg3d_gan.init_networks`."""
    cfg = tiny_gan()
    state = train_eg3d.initial_state(cfg, "cpu")
    lr_mul = cfg.generator.mapping.lr_multiplier
    assert lr_mul == cfg.discriminator.mapping_lr_multiplier == 0.01
    for net in (state.G, state.D):
        fc = [p for n, p in net.named_parameters()
              if n.startswith("mapping.fc") and n.endswith("weight")]
        assert fc
        for w in fc:
            assert float(w.detach().std()) * lr_mul == pytest.approx(1.0, rel=0.1)
        embed = net["mapping"]["embed"]["weight"]
        assert float(embed.detach().std()) == pytest.approx(1.0, rel=0.1)
    conv = state.G["backbone"]["b16"]["conv1"]["weight"]
    assert float(conv.detach().std()) == pytest.approx(1.0, rel=0.05)
    G, _ = eg3d_gan.init_networks(
        torch.Generator().manual_seed(train_eg3d.INIT_SEED), cfg)
    for name, p in ParamTree(G).named_parameters():
        assert torch.equal(state.G.get_parameter(name), p), name
