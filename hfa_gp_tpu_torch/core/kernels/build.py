"""Build and load the package's CUDA kernels.

All sources in `hfa_gp_tpu_torch/csrc/*.cu` are compiled by `nvcc` into
one shared library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<hash>/libhfa_kernels.so csrc/*.cu

The build runs at first use, never at import, from the repository's
sources only. Its directory (`hfa_gp_tpu_torch/build/`, git-ignored) is
keyed by a hash of the sources and flags, so an edited source rebuilds.
A missing `nvcc` or a failed compile raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: ctypes.CDLL | None = None
BUILD_LOG: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of hfa_gp_tpu_torch cannot be built")


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libhfa_kernels.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)      # atomic: concurrent builders agree
        BUILD_LOG.update(seconds=time.perf_counter() - t0,
                         ptxas=proc.stdout + proc.stderr)
    BUILD_LOG["path"] = so
    _LIB = _declare(ctypes.CDLL(so))
    return _LIB


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype of every entry point: pointers and the stream as
    c_void_p (a bare int would be cut to 32 bits), sizes as c_int."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hfa_triplane_mean.argtypes = [p, p, p, i, i, i, i, i, f, p]
    lib.hfa_triplane_mean.restype = ctypes.c_int
    lib.hfa_ray_march.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.hfa_ray_march.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")
