"""The port's native image loader (hfa_gp_tpu_torch/data/native_loader.py
over its own copy of the C++, csrc/hfaio.cpp) against the JAX package's
(hfa_gp_tpu/data/native_loader.py over native/hfaio.cpp), on PNG (RGB,
RGBA, gray, gray + alpha, palette, 16-bit gray) and JPEG (colour, gray)
files written by PIL: the same decode bit for bit, the same batches at
workers=1 for a seed, and J4 (ROADMAP.md §3), where the two part: an
image that does not decode is zeros in the JAX loader and an error naming
its path in the port's.
"""

import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from hfa_gp_tpu.data import native_loader as jnl
from hfa_gp_tpu_torch.data import native_loader as tnl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_library_of_its_own(tmp_path_factory):
    """The JAX loader builds its library into native/libhfaio.so, where
    JAX's own tests (tests/test_native_loader.py) may be building it at
    the same time in another worker: here it builds a copy of its own."""
    with pytest.MonkeyPatch.context() as mp:
        if jnl._LIB is None:
            mp.setattr(jnl, "_SO_PATH", str(
                tmp_path_factory.mktemp("jax_hfaio") / "libhfaio.so"))
        yield


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Eleven files of every kind the decoder reads, in varied sizes."""
    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.default_rng(0)

    def rand(h, w, c=3):
        return rng.integers(0, 256, (h, w, c) if c else (h, w),
                            dtype=np.uint8)

    made = [
        ("rgb.png", Image.fromarray(rand(96, 80))),
        ("rgb_sq.png", Image.fromarray(rand(48, 48))),
        ("rgba.png", Image.fromarray(rand(40, 56, 4), "RGBA")),
        ("gray.png", Image.fromarray(rand(50, 40, 0), "L")),
        ("gray_alpha.png", Image.fromarray(rand(33, 47, 2), "LA")),
        ("palette.png", Image.fromarray(rand(64, 72)).convert(
            "P", palette=Image.ADAPTIVE, colors=37)),
        ("gray16.png", Image.fromarray(rng.integers(
            0, 65536, (30, 36), dtype=np.uint16))),
        ("rgb.jpg", Image.fromarray(rand(64, 64))),
        ("wide.jpg", Image.fromarray(rand(40, 90))),
        ("gray.jpg", Image.fromarray(rand(56, 48, 0), "L")),
        ("tall.png", Image.fromarray(rand(100, 30))),
    ]
    paths = []
    for name, img in made:
        p = str(d / name)
        img.save(p, quality=90) if name.endswith(".jpg") else img.save(p)
        paths.append(p)
    return paths


def _snapshot(path):
    """native/'s files but the JAX loader's own library, which its tests
    may be writing meanwhile."""
    return sorted((n, os.stat(os.path.join(path, n)).st_mtime_ns,
                   os.stat(os.path.join(path, n)).st_size)
                  for n in os.listdir(path) if n != "libhfaio.so")


def test_build_lands_under_the_port_and_leaves_native_untouched():
    native = os.path.join(REPO, "native")
    before = _snapshot(native)
    so = tnl.build_library(force=True)
    assert so == tnl.library_path()
    assert os.path.dirname(os.path.dirname(so)) \
        == os.path.join(REPO, "hfa_gp_tpu_torch", "build")
    assert os.path.exists(so)
    assert _snapshot(native) == before
    assert tnl.missing_toolchain() == []
    assert tnl.native_available()
    # nvcc's build takes the CUDA sources only
    from hfa_gp_tpu_torch.core.kernels import build
    assert all(s.endswith(".cu") for s in build._sources())


@pytest.mark.parametrize("size", [24, 48, 97])
def test_decode_is_bit_equal_to_jax(images, size):
    for p in images:
        got = tnl.decode_image(p, size)
        want = jnl.decode_image(p, size)
        assert want is not None, p
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        assert np.array_equal(got, want), p


def test_decode_matches_pil_at_the_source_size(images):
    """A square RGB image at its own size: no resampling, the bytes /
    127.5 − 1."""
    arr = np.asarray(Image.open(images[1]).convert("RGB"), np.float32)
    got = tnl.decode_image(images[1], 48)
    np.testing.assert_allclose(got, arr * (2.0 / 255.0) - 1.0, atol=1e-6)


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "order"])
@pytest.mark.parametrize("drop_last", [True, False], ids=["drop", "keep"])
def test_one_worker_batches_are_bit_equal_to_jax(images, shuffle, drop_last):
    """workers=1: the batches, in order, over three epochs of 11 images in
    batches of 4 (with drop_last a batch wraps into the next epoch; without
    it each epoch ends with a batch of 3)."""
    kw = dict(size=20, batch_size=4, shuffle=shuffle, workers=1, seed=7,
              drop_last=drop_last)
    got = tnl.NativeImageLoader(images, **kw)
    want = jnl.NativeImageLoader(images, **kw)
    try:
        seen = []
        for _ in range(9):
            gi, gx = got.next()
            wi, wx = want.next()
            assert np.array_equal(gx, wx)
            assert np.array_equal(gi, wi)
            seen.append(gx.tolist())
    finally:
        got.close()
        want.close()
    lens = [len(s) for s in seen]
    assert lens == ([4] * 9 if drop_last else [4, 4, 3] * 3)
    if not drop_last:
        epochs = [sum(seen[3 * e:3 * e + 3], []) for e in range(3)]
        assert all(sorted(e) == list(range(11)) for e in epochs)
        if shuffle:
            assert epochs[0] != epochs[1]
        else:
            assert epochs[0] == list(range(11))


def test_four_workers_give_each_index_its_image(images):
    """With 4 workers the batches come in the order they finish; each slot
    still holds its index's image, and an epoch's batches cover every
    index."""
    loader = tnl.NativeImageLoader(images, 20, 4, workers=4, seed=3,
                                   drop_last=False)
    want = {i: tnl.decode_image(p, 20) for i, p in enumerate(images)}
    try:
        seen = []
        for _ in range(6):
            imgs, idx = loader.next()
            for img, i in zip(imgs, idx):
                assert np.array_equal(img, want[int(i)]), i
            seen.extend(idx.tolist())
    finally:
        loader.close()
    assert set(seen) == set(range(len(images)))
    with pytest.raises(StopIteration):
        loader.next()


def test_j4_a_file_that_does_not_decode_raises_with_its_path(images,
                                                             tmp_path):
    """J4: the JAX loader hands back zeros for a corrupt file and its
    decode_image None; the port raises and names the file."""
    bad = str(tmp_path / "broken.png")
    with open(images[0], "rb") as f:
        head = f.read(200)                 # a PNG cut off mid-stream
    with open(bad, "wb") as f:
        f.write(head)
    paths = [images[1], bad]
    assert jnl.decode_image(bad, 16) is None
    with pytest.raises(RuntimeError, match="broken.png"):
        tnl.decode_image(bad, 16)

    kw = dict(size=16, batch_size=2, shuffle=False, workers=1, seed=0)
    jl = jnl.NativeImageLoader(paths, **kw)
    try:
        imgs, idx = jl.next()
    finally:
        jl.close()
    assert idx.tolist() == [0, 1]
    assert not imgs[1].any() and imgs[0].any()      # the silent zeros
    tl = tnl.NativeImageLoader(paths, **kw)
    try:
        with pytest.raises(RuntimeError, match="broken.png"):
            tl.next()
    finally:
        tl.close()
    with pytest.raises(RuntimeError, match="does-not-exist"):
        tnl.decode_image(str(tmp_path / "does-not-exist.png"), 16)


def test_without_a_compiler_the_build_raises(monkeypatch):
    def no_gxx(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", no_gxx)
    assert tnl.missing_toolchain() == ["g++"]
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnl.build_library(force=True)
    with pytest.raises(ValueError):
        tnl.NativeImageLoader([], 16, 2)
