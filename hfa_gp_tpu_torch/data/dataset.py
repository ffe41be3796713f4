"""Frame readers and batching (port of `HeadData`, `HeadDataTest`,
`HeadData3DMM`, `HeadDataAudio`, `BatchIterator`, `infinite_batches` and
`EpochSeededBatches` of hfa_gp_tpu/data/dataset.py), as
`torch.utils.data.Dataset`s.

On-disk contract (the reference's):
  `{root}/{person}/{train|test2|test}/cropped_images/*.png` and
  `test.json` ({"labels": [[fname, [25 floats]], ...]}, raw OpenCV
  cameras), or any `ds_path` holding the same. Labels are keyed by
  `<stem>.png` whatever the frame suffix. The train split keeps the
  directory's listing order, every other split is sorted by name, as in
  the JAX reader. The 3DMM and audio readers add
  `{root}/{person}/transforms_{split}.json` (per-frame "expression"
  vectors, or "img_id"/"aud_id") and `{root}/{person}/aud.npy`
  ((N, 16, 29) DeepSpeech features; the audio frames are `<int>.jpg`).

Items are (image (size, size, 3) float32 in [-1, 1], label (25,)), plus
the frame's expression (3DMM) or its audio window and frame index
(audio). The port keeps its own readers so that its main paths import
nothing of the JAX package; tests hold them to the JAX readers (identical
arrays, and batches index for index).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator

import numpy as np
import torch
from PIL import Image


def load_image(path: str, size: int | None = None) -> np.ndarray:
    """PNG/JPG → float32 (H, W, 3) in [-1, 1], bilinear resize to size²."""
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return (np.asarray(img, dtype=np.float32) / 255.0 - 0.5) / 0.5


def _label_key(frame_path: str) -> str:
    return os.path.basename(frame_path).rsplit(".", 1)[0] + ".png"


class HeadData(torch.utils.data.Dataset):
    """Frames of one split with their labels."""

    def __init__(self, split: str, size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 suffix: str = ".png", sort: bool | None = None):
        if ds_path is None:
            sub = {"train": "train", "test": "test2",
                   "val": "test"}.get(split, split)
            ds_path = os.path.join(root, person, sub, "cropped_images")
        self.ds_path = ds_path
        self.size = size
        with open(os.path.join(ds_path, "test.json"), "rb") as f:
            self.labels = {k: np.asarray(v, dtype=np.float32)
                           for k, v in dict(json.load(f)["labels"]).items()}
        self.frames = glob.glob(os.path.join(ds_path, "*" + suffix))
        if sort if sort is not None else (split != "train"):
            self.frames = sorted(self.frames)
        if not self.frames:
            raise FileNotFoundError(f"no frames in {ds_path}")

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, idx: int) -> tuple[torch.Tensor, torch.Tensor]:
        frame = self.frames[idx]
        return (torch.from_numpy(load_image(frame, self.size)),
                torch.from_numpy(self.labels[_label_key(frame)]))


    def rotate_labels(self, yaw_deg: float = 30.0,
                      pitch_deg: float = 0.0) -> None:
        """A fixed extra rotation of every camera (the reference's
        rotate_labels, for novel-view demos); intrinsics reset to the
        dataset's."""
        from scipy.spatial.transform import Rotation
        rot = (Rotation.from_rotvec([0, yaw_deg * np.pi / 180.0, 0])
               * Rotation.from_rotvec([pitch_deg * np.pi / 180.0, 0, 0]))
        intr = np.array([4.2647, 0, 0.5, 0, 4.2647, 0.5, 0, 0, 1],
                        dtype=np.float32)
        for k, label in self.labels.items():
            m = label[:-9].reshape(4, 4).copy()
            m[:3, :] = rot.as_matrix() @ m[:3, :]
            self.labels[k] = np.concatenate(
                [m.reshape(-1), intr]).astype(np.float32)


class HeadDataTest(HeadData):
    """Sorted inference frames with their labels, optionally smoothed in
    time by a Gaussian of `smooth_sigma` frames."""

    def __init__(self, split: str = "test", size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 suffix: str = ".png", smooth_sigma: float | None = None):
        super().__init__(split, size, root, person, ds_path, suffix,
                         sort=True)
        if smooth_sigma:
            from scipy.ndimage import gaussian_filter1d
            keys = [_label_key(f) for f in self.frames]
            arr = gaussian_filter1d(np.stack([self.labels[k] for k in keys]),
                                    smooth_sigma, axis=0)
            self.labels = {k: arr[i] for i, k in enumerate(keys)}


class HeadData3DMM(HeadData):
    """Frames with their 3DMM expression vectors: items (image, label,
    expression (params_len,))."""

    def __init__(self, split: str, size: int = 256,
                 root: str = "./datasets/nerface_dataset",
                 person: str = "person_3", ds_path: str | None = None,
                 **kw):
        super().__init__(split, size, root, person, ds_path, **kw)
        with open(os.path.join(root, person,
                               f"transforms_{split}.json")) as f:
            frames = json.load(f)["frames"]
        self.expressions = {
            fr["file_path"].split("/")[-1] + ".png":
                np.asarray(fr["expression"], dtype=np.float32)
            for fr in frames}

    def __getitem__(self, idx: int):
        img, label = super().__getitem__(idx)
        return img, label, torch.from_numpy(
            self.expressions[_label_key(self.frames[idx])])


class HeadDataAudio(HeadData):
    """Frames `<int>.jpg` with their DeepSpeech features: items (image,
    label, audio (16, 29), frame index). Splits other than train are
    sorted by frame index."""

    def __init__(self, split: str, size: int = 256,
                 root: str = "./datasets/ad_dataset",
                 person: str = "obama", ds_path: str | None = None,
                 smo_size: int = 8, **kw):
        kw.setdefault("suffix", ".jpg")
        if ds_path is None:
            sub = {"train": "train", "val": "test"}.get(split, split)
            ds_path = os.path.join(root, person, sub, "cropped_images")
        super().__init__(split, size, root, person, ds_path, **kw)
        if split != "train":
            self.frames = sorted(self.frames, key=lambda x: int(
                os.path.basename(x).split(".")[0]))
        self.smo_size = smo_size
        self.aud_features = np.load(os.path.join(
            os.path.dirname(os.path.dirname(ds_path)),
            "aud.npy")).astype(np.float32)
        with open(os.path.join(root, person,
                               f"transforms_{split}.json")) as f:
            frames = json.load(f)["frames"]
        last = self.aud_features.shape[0] - 1
        self.aud_ids = {f"{fr['img_id']}.jpg": min(fr["aud_id"], last)
                        for fr in frames}

    def frame_index(self, idx: int) -> int:
        return int(os.path.basename(self.frames[idx]).split(".")[0])

    def get_audio(self, idx: int) -> np.ndarray:
        """(16, 29): the features of the frame's own audio id."""
        return self.aud_features[
            self.aud_ids[os.path.basename(self.frames[idx])]]

    def get_audio_window(self, idx: int) -> np.ndarray:
        """(smo_size, 16, 29): the features of frame indices i − smo/2 …
        i + smo/2 − 1 around the frame's index i, zeros where an index
        falls outside [0, min(len(self), len(aud.npy))). Sliced here on the
        host, as the JAX package does."""
        img_i = self.frame_index(idx)
        half = self.smo_size // 2
        end = min(len(self), self.aud_features.shape[0])
        win = np.zeros((self.smo_size, *self.aud_features.shape[1:]),
                       dtype=np.float32)
        for j, i in enumerate(range(img_i - half, img_i + half)):
            if 0 <= i < end:
                win[j] = self.aud_features[i]
        return win

    def __getitem__(self, idx: int):
        img, label = super().__getitem__(idx)
        return (img, label, torch.from_numpy(self.get_audio(idx)),
                torch.tensor(self.frame_index(idx)))


class BatchIterator:
    """Epoch batcher → stacked tensors; a last partial batch is dropped.
    The index permutation comes from numpy's `default_rng(seed)`, one draw
    per epoch, so the batches equal the JAX package's `BatchIterator`
    index for index. With `num_shards` > 1 every rank draws the same global
    order and loads only its `batch_size / num_shards` rows (shard
    `shard_index`) of each global batch: no rank decodes the rows of
    another."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0):
        if batch_size % num_shards or not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards} does not "
                             f"divide a batch of {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        n, bs = len(self.dataset), self.batch_size
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        local = bs // self.num_shards
        for i in range(0, (n // bs) * bs, bs):
            idxs = order[i:i + bs][self.shard_index * local:
                                   (self.shard_index + 1) * local]
            items = [self.dataset[int(j)] for j in idxs]
            yield tuple(torch.stack(col) for col in zip(*items))

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size


def process_sharded(dataset, batch_size: int, mesh, **kw) -> BatchIterator:
    """A BatchIterator that loads only this rank's rows of every global
    batch: the rows of its data index on `mesh` (a `parallel.mesh.Mesh`)."""
    return BatchIterator(dataset, batch_size, num_shards=mesh.n_data,
                         shard_index=mesh.data_index, **kw)


def infinite_batches(loader: BatchIterator) -> Iterator:
    """Epoch after epoch, for ever."""
    while True:
        yield from loader


class EpochSeededBatches:
    """A stateless, resumable batch stream: batch t is a function of
    (seed, t) alone. Each epoch's permutation is numpy's
    `default_rng([seed, epoch])` (the reference's
    DistributedSampler.set_epoch contract), so a run checkpointed at step k
    and restarted at `load(k)` replays the same order and reads no batch
    twice; an epoch shorter than a batch is filled by `np.resize`. Every
    shard sees the same global permutation and loads its own
    batch_size / num_shards rows; one process is shard 0 of 1. The indices
    equal the JAX package's `EpochSeededBatches` batch for batch."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 start_batch: int = 0):
        if batch_size % num_shards or not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards} does not "
                             f"divide a batch of {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.start_batch = start_batch
        self._per_epoch = max(len(dataset) // batch_size, 1)
        self._epoch: int | None = None
        self._order: np.ndarray | None = None

    def batch_indices(self, t: int) -> np.ndarray:
        """The dataset indices of this shard's rows of batch t."""
        epoch, off = divmod(t, self._per_epoch)
        if epoch != self._epoch:
            self._order = np.random.default_rng(
                [self.seed, epoch]).permutation(len(self.dataset))
            self._epoch = epoch
        bs = self.batch_size
        idxs = self._order[off * bs:(off + 1) * bs]
        if len(idxs) < bs:
            idxs = np.resize(idxs, bs)
        local = bs // self.num_shards
        return idxs[self.shard_index * local:(self.shard_index + 1) * local]

    def load(self, t: int) -> tuple[torch.Tensor, ...]:
        """Batch t, each item's fields stacked (on the host)."""
        items = [self.dataset[int(j)] for j in self.batch_indices(t)]
        return tuple(torch.from_numpy(np.stack(col)) for col in zip(*items))

    def __iter__(self) -> Iterator[tuple[torch.Tensor, ...]]:
        t = self.start_batch
        while True:
            yield self.load(t)
            t += 1
