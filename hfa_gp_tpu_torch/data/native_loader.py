"""The native image loader (port of hfa_gp_tpu/data/native_loader.py).

`csrc/hfaio.cpp`, the port's own copy of the JAX package's
`native/hfaio.cpp`, decodes PNG and JPEG files (libpng, libjpeg), resizes
them bilinearly and normalises them to [-1, 1] on pthread workers, with a
bounded ring of ready batches; this module binds it with ctypes. It runs
on the host: no CUDA kernel, and no CLI of either package calls it.

The library is compiled with g++ at first use, never at import, into
`hfa_gp_tpu_torch/build/hfaio-<hash of the source>/libhfaio.so`
(git-ignored). Without g++, or without the headers `png.h` and
`jpeglib.h`, the build raises `RuntimeError` (`missing_toolchain` says
which is missing); nothing falls back to another decoder.

One deviation from the JAX module (J4 in ROADMAP.md §3): an image that
does not decode makes `NativeImageLoader.next` raise `RuntimeError` with
its path, where the JAX loader hands back zeros (mid-gray after the
normalisation) in its slot; `decode_image` raises likewise where the JAX
function returns None.

With `workers` > 1 the batches come in the order the workers finish them,
so only `workers=1` gives the same batches in the same order from run to
run (and the JAX loader's, for the same seed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..core.kernels.build import BUILD_DIR, CSRC_DIR

SRC_PATH = os.path.join(CSRC_DIR, "hfaio.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-lpng", "-ljpeg", "-lpthread"]
HEADERS = ("png.h", "jpeglib.h")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the build puts the library: keyed by the source and flags."""
    h = hashlib.sha256()
    with open(SRC_PATH, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"hfaio-{h.hexdigest()[:16]}",
                        "libhfaio.so")


def missing_toolchain() -> list[str]:
    """What the build lacks here: "g++", and each header of HEADERS that
    g++ does not find; [] where it has all."""
    missing = []
    for header in HEADERS:
        try:
            r = subprocess.run(["g++", "-x", "c++", "-E", "-o", os.devnull,
                                "-"], input=f"#include <{header}>\n",
                               capture_output=True, text=True, timeout=60)
        except FileNotFoundError:
            return ["g++"]
        if r.returncode:
            missing.append(header)
    return missing


def build_library(force: bool = False) -> str:
    """Compile libhfaio.so (once per source); returns its path. Raises
    RuntimeError when g++ is missing or the compile fails."""
    so = library_path()
    if os.path.exists(so) and not force:
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, SRC_PATH, "-o", tmp, *LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError:
        raise RuntimeError("native loader: g++ not found") from None
    if r.returncode:
        raise RuntimeError(f"native loader: `{' '.join(cmd)}` failed "
                           f"(missing: {missing_toolchain()}):\n"
                           f"{r.stderr[-3000:]}")
    os.replace(tmp, so)                   # never a half-written library
    return so


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build_library())
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.hfaio_decode.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     c_float_p]
        lib.hfaio_decode.restype = ctypes.c_int
        lib.hfaio_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_int]
        lib.hfaio_create.restype = ctypes.c_void_p
        lib.hfaio_next.argtypes = [ctypes.c_void_p, c_float_p, c_int_p,
                                   c_int_p]
        lib.hfaio_next.restype = ctypes.c_int
        lib.hfaio_destroy.argtypes = [ctypes.c_void_p]
        lib.hfaio_destroy.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def decode_image(path: str, size: int) -> np.ndarray:
    """One image → float32 (size, size, 3) in [-1, 1]. Raises RuntimeError
    when the file does not decode (the JAX function returns None)."""
    lib = _load()
    out = np.empty((size, size, 3), np.float32)
    rc = lib.hfaio_decode(
        os.fsencode(path), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"native loader: cannot decode {path}")
    return out


class NativeImageLoader:
    """Prefetching image-batch stream over a list of paths, epoch after
    epoch (shuffled each epoch with `shuffle`; with `drop_last` a batch
    wraps into the next epoch, without it the epoch's last batch is short).

    Yields (images (B, size, size, 3) float32 in [-1, 1], indices (B,)
    into `paths`); labels are joined by index on the caller's side."""

    def __init__(self, paths: list[str], size: int, batch_size: int,
                 *, shuffle: bool = True, workers: int = 4, seed: int = 0,
                 drop_last: bool = True):
        if not paths or batch_size < 1 or size < 1:
            raise ValueError(f"NativeImageLoader: {len(paths)} paths, "
                             f"batch_size {batch_size}, size {size}")
        lib = _load()
        self._lib = lib
        self.paths = list(paths)
        self.size = size
        self.batch_size = batch_size
        self._paths_bytes = [os.fsencode(p) for p in self.paths]
        arr = (ctypes.c_char_p * len(paths))(*self._paths_bytes)
        self._handle = lib.hfaio_create(
            arr, len(paths), size, batch_size, workers, int(shuffle),
            seed, int(drop_last))
        if not self._handle:
            raise RuntimeError("hfaio_create failed")

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """The next ready batch; raises RuntimeError naming the path of an
        image in it that did not decode, StopIteration once closed."""
        if not getattr(self, "_handle", None):
            raise StopIteration
        out = np.empty((self.batch_size, self.size, self.size, 3),
                       np.float32)
        idx = np.empty((self.batch_size,), np.int32)
        failed = ctypes.c_int(-1)
        n = self._lib.hfaio_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(failed))
        if n < 0:
            raise StopIteration
        if failed.value >= 0:
            raise RuntimeError(f"native loader: cannot decode "
                               f"{self.paths[failed.value]}")
        return out[:n], idx[:n]

    def __iter__(self):
        while True:
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hfaio_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
