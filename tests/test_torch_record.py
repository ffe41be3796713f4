"""The port's arcface record route (`data/record_dataset.py`,
`data/dataset.EpochSeededBatches`, `cli/train_arcface.py --rec`) against the
JAX package's, on the CPU.

Packs are seeded noise images (PNG and JPEG, some not 112², so the resize
runs) with seeded labels. Tolerances: the decode is the same PIL and numpy
calls in both packages, so items are held bit for bit; the stream's indices
exactly; a resumed run bit for bit against an uninterrupted one; the CLI's
losses against the JAX CLI's from the same initial state at rtol 1e-3, the
step tolerance of `test_torch_arcface.py`.
"""

import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import MemoryReader
from hfa_gp_tpu.data import dataset as jdataset
from hfa_gp_tpu.data import record_dataset as jrec
from hfa_gp_tpu_torch.cli import train_arcface
from hfa_gp_tpu_torch.data import record_dataset as trec
from hfa_gp_tpu_torch.data.dataset import EpochSeededBatches
from hfa_gp_tpu_torch.models.arcface import convert
from hfa_gp_tpu_torch.train import arcface as arc
from hfa_gp_tpu_torch.train import checkpoint as ckpt
from tests.test_torch_networks import drop_outputs

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

CLASSES = 8
CLI_FLAGS = ["--network", "iresnet18", "--num_classes", str(CLASSES),
             "--batch_size", "8", "--warmup_steps", "0", "--lr", "0.01",
             "--clip_grad", "0", "--fp32"]


def encoded_images(n: int, seed: int) -> tuple[list[bytes], list[int]]:
    """n noise images, PNG and JPEG in turn, every third 96×80."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for i in range(n):
        shape = (96, 80, 3) if i % 3 == 0 else (112, 112, 3)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, shape, np.uint8)).save(
            buf, format="PNG" if i % 2 else "JPEG", quality=90)
        images.append(buf.getvalue())
        labels.append(int(rng.integers(0, CLASSES)))
    return images, labels


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """32 records written by the JAX package's writer."""
    pytest.importorskip("array_record")
    path = str(tmp_path_factory.mktemp("rec") / "train.array_record")
    images, labels = encoded_images(32, seed=0)
    jrec.write_record_dataset(path, images, labels)
    return path, images, labels


def test_a_jax_pack_reads_equal_in_both_datasets(pack):
    """Item for item, bit for bit: the JAX dataset, the port's on the file
    and the port's over a reader object holding the same records."""
    path, images, labels = pack
    jax_ds = jrec.RecordFaceDataset(path, size=112)
    ours = trec.RecordFaceDataset(path, size=112)
    held = trec.RecordFaceDataset(MemoryReader(
        [trec.encode_record(i, b) for i, b in zip(images, labels)]), 112)
    assert len(jax_ds) == len(ours) == len(held) == 32
    for i in range(32):
        want_img, want_lab = jax_ds[i]
        for img, lab in (ours[i], held[i]):
            assert img.dtype == np.float32 and img.shape == (112, 112, 3)
            assert np.array_equal(img, want_img), i
            assert lab == want_lab == labels[i] and lab.dtype == np.int32


def test_the_port_writes_packs_the_jax_package_reads(tmp_path):
    pytest.importorskip("array_record")
    images, labels = encoded_images(6, seed=1)
    path = str(tmp_path / "port.array_record")
    trec.write_record_dataset(path, images, labels)
    jax_ds = jrec.RecordFaceDataset(path, size=64)
    ours = trec.RecordFaceDataset(path, size=64)
    for i in range(6):
        assert np.array_equal(ours[i][0], jax_ds[i][0])
        assert ours[i][1] == jax_ds[i][1] == labels[i]


def test_synthetic_face_dataset_is_the_jax_one():
    jax_ds = jrec.SyntheticFaceDataset(size=16, length=10, seed=3)
    ours = trec.SyntheticFaceDataset(size=16, length=10, seed=3)
    assert len(ours) == len(jax_ds) == 10
    for i in range(3):
        assert np.array_equal(ours[i][0], jax_ds[i][0])
        assert ours[i][1] == jax_ds[i][1] == 1


class Items:
    """A dataset whose item i is (i as a float vector, i as a label)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), np.int32(i)


@pytest.mark.parametrize("n,batch,shards", [(37, 8, 1), (37, 8, 4),
                                            (5, 8, 2), (64, 16, 2)])
def test_epoch_seeded_batches_equal_the_jax_stream(n, batch, shards):
    """Across epochs, an epoch shorter than a batch (the np.resize tail)
    and every shard's slice: the same indices and the same loaded rows."""
    data = Items(n)
    for shard in range(shards):
        ours = EpochSeededBatches(data, batch, seed=5, num_shards=shards,
                                  shard_index=shard)
        jax_s = jdataset.EpochSeededBatches(data, batch, seed=5,
                                            num_shards=shards,
                                            shard_index=shard)
        for t in [*range(12), 3, 40, 1]:
            want = jax_s.batch_indices(t)
            assert np.array_equal(ours.batch_indices(t), want), (shard, t)
            x, lab = ours.load(t)
            assert torch.equal(lab, torch.from_numpy(want.astype(np.int32)))
            assert np.array_equal(x.numpy(), jax_s.load(t)[0])
    first = next(iter(EpochSeededBatches(data, batch, seed=5,
                                         start_batch=7)))
    assert torch.equal(first[1], EpochSeededBatches(data, batch,
                                                    seed=5).load(7)[1])
    with pytest.raises(ValueError, match="shard"):
        EpochSeededBatches(data, 8, num_shards=3)


# -- the CLI -----------------------------------------------------------------


def _args(rec, *extra):
    return train_arcface.build_argparser().parse_args(
        ["--device", "cpu", *CLI_FLAGS, "--rec", rec, *extra])


def _last_loss(capsys) -> str:
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return re.search(r"\(loss ([0-9.]+),", line).group(1)


def test_rec_cli_resume_continues_bit_for_bit(pack, tmp_path, capsys):
    """4 steps straight against 4 steps saved every 2, cut back to step 2
    and resumed: batch i is a function of (seed, i), so the resumed run
    reads what the straight one read, and ends bit for bit where it
    ended."""
    path = pack[0]
    out_a, out_b = str(tmp_path / "straight"), str(tmp_path / "resumed")
    train_arcface.main(_args(path, "--num_steps", "4", "--output", out_a))
    loss_a = _last_loss(capsys)
    train_arcface.main(_args(path, "--num_steps", "4", "--output", out_b,
                             "--save_freq", "2"))
    cdir = os.path.join(out_b, "checkpoint")
    os.remove(os.path.join(cdir, "000004"))
    assert ckpt.latest_step(cdir) == 2
    capsys.readouterr()
    train_arcface.main(_args(path, "--num_steps", "4", "--output", out_b,
                             "--resume"))
    assert _last_loss(capsys) == loss_a
    a = torch.load(os.path.join(out_a, "checkpoint", "000004"),
                   weights_only=True)
    b = torch.load(os.path.join(cdir, "000004"), weights_only=True)
    assert a["step"] == b["step"] == 4
    assert torch.equal(a["fc_weight"], b["fc_weight"])
    for part in ("backbone", "batch_stats", "fc_opt_state"):
        assert sorted(a[part]) == sorted(b[part])
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])
    drop_outputs(tmp_path)


def _recorded_losses(module, monkeypatch) -> list:
    """Every step's loss of the CLI whose trainer module is `module`."""
    losses = []
    make = module.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(*sa, **skw):
            out = step(*sa, **skw)
            losses.append(float(out[-1]["loss"] if isinstance(out, tuple)
                                else out["loss"]))
            return out
        return wrapped

    monkeypatch.setattr(module, "make_train_step", recording)
    return losses


def test_rec_cli_loss_matches_the_jax_cli(pack, monkeypatch):
    """Both CLIs on the same pack from the same initial state (the JAX
    CLI's, carried into the port): the same batches, so the same losses
    step by step."""
    from hfa_gp_tpu.cli import train_arcface as jax_cli
    from hfa_gp_tpu.train import arcface as jarc
    path, steps = pack[0], 3
    kept = {}
    real_init = jarc.init_state

    def keep(*a, **kw):
        state = real_init(*a, **kw)
        kept["state"] = jax.device_get(state)     # the step donates it
        return state

    monkeypatch.setattr(jarc, "init_state", keep)
    jax_losses = _recorded_losses(jarc, monkeypatch)
    jax_cli.main(jax_cli.build_argparser().parse_args(
        [*CLI_FLAGS, "--rec", path, "--num_steps", str(steps)]))

    state = kept["state"]

    def from_jax(generator, pfc, tx, fc_tx, network, device):
        params, stats = convert.iresnet_from_jax(
            jax.tree.map(np.asarray, state.backbone),
            jax.tree.map(np.asarray, state.batch_stats))
        params.requires_grad_(True)
        table = convert.fc_table_from_jax(np.asarray(state.fc_weight))
        return arc.ArcFaceState(params, stats, table, tx.build(params),
                                fc_tx.init(table), 0)

    monkeypatch.setattr(train_arcface.arc, "init_state", from_jax)
    port_losses = _recorded_losses(train_arcface.arc, monkeypatch)
    train_arcface.main(_args(path, "--num_steps", str(steps)))
    assert len(port_losses) == len(jax_losses) == steps
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)
    assert len(set(np.round(jax_losses, 4))) == steps


def test_rec_cli_refuses_labels_outside_num_classes(pack):
    """The pack's labels reach the card's kernels as indices: a label at or
    above --num_classes raises before any step."""
    args = train_arcface.build_argparser().parse_args(
        ["--device", "cpu", *CLI_FLAGS[:2], "--num_classes", "3",
         *CLI_FLAGS[4:], "--rec", pack[0], "--num_steps", "1"])
    with pytest.raises(ValueError, match="outside --num_classes 3"):
        train_arcface.main(args)


def test_rec_without_array_record_raises_and_names_it(monkeypatch,
                                                      tmp_path):
    """No fallback to synthetic data: opening or writing a pack, and the
    CLI's --rec, raise ImportError naming the package."""
    for name in ("array_record", "array_record.python",
                 "array_record.python.array_record_module"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="`array_record` package"):
        trec.RecordFaceDataset(str(tmp_path / "x.array_record"))
    with pytest.raises(ImportError, match="`array_record` package"):
        trec.write_record_dataset(str(tmp_path / "y.array_record"), [b""],
                                  [0])
    with pytest.raises(ImportError, match="`array_record` package"):
        train_arcface.main(_args(str(tmp_path / "x.array_record"),
                                 "--num_steps", "1"))
    assert os.listdir(tmp_path) == []
