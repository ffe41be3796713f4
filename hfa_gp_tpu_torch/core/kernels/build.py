"""Build and load the package's CUDA kernels.

Every source in `hfa_gp_tpu_torch/csrc/*.cu` is compiled by its own
`nvcc`, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o build/<hash>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/<hash>/libhfa_kernels.so build/<hash>/*.o

The build runs at first use, never at import, from the repository's
sources only. Its directory (`hfa_gp_tpu_torch/build/`, git-ignored) is
keyed by a hash of the sources, headers and flags, so an edited source
rebuilds. A missing `nvcc` or a failed compile raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

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
        t0 = time.perf_counter()
        BUILD_LOG.update(ptxas=_compile_and_link(srcs, so),
                         seconds=time.perf_counter() - t0)
    BUILD_LOG["path"] = so
    _LIB = _declare(ctypes.CDLL(so))
    return _LIB


def _run_all(cmds: list[list[str]], names: list[str]) -> str:
    """Start every command at once, wait for all, raise on the first that
    failed; returns their joined output. BUILD_LOG["each"] gets the seconds
    each command took, by its name."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [""] * len(cmds)
    seconds = BUILD_LOG.setdefault("each", {})

    def wait(i: int) -> None:
        outs[i] = procs[i].communicate()[0]
        seconds[names[i]] = time.perf_counter() - t0

    threads = [threading.Thread(target=wait, args=(i,))
               for i in range(len(cmds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile_and_link(srcs: list[str], so: str) -> str:
    """One nvcc per source, in parallel, then the link; returns the
    compilers' output (ptxas -v: registers, shared memory, spills)."""
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(os.path.dirname(so),
                         f"{os.path.basename(s)[:-3]}.{tag}.o") for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(srcs, objs)],
                   [os.path.basename(s) for s in srcs])
    tmp = f"{so}.{tag}"
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]],
                    ["link"])
    os.replace(tmp, so)          # atomic: concurrent builds agree
    for o in objs:
        os.remove(o)
    return log


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes/restype of every entry point: pointers and the stream as
    c_void_p (a bare int would be cut to 32 bits), sizes as c_int."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_int64
    lib.hfa_triplane_mean.argtypes = [p, p, p, i, i, i, i, i, f, p]
    lib.hfa_triplane_mean.restype = ctypes.c_int
    lib.hfa_triplane_mean_decode.argtypes = [*[p] * 8, *[i] * 5, *[f] * 4, p]
    lib.hfa_triplane_mean_decode.restype = ctypes.c_int
    lib.hfa_ray_march.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.hfa_ray_march.restype = ctypes.c_int
    lib.hfa_triplane_mean_bwd.argtypes = [p, p, p, i, i, i, i, i, f, i, i, i,
                                          p]
    lib.hfa_triplane_mean_bwd.restype = ctypes.c_int
    lib.hfa_ray_march_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i,
                                      p]
    lib.hfa_ray_march_bwd.restype = ctypes.c_int
    lib.hfa_flash_ce_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i64, f, i, p]
    lib.hfa_flash_ce_fwd.restype = ctypes.c_int
    lib.hfa_flash_ce_bwd.argtypes = [p, p, p, p, p, p, p, p, i, i, i64, f, i,
                                     p]
    lib.hfa_flash_ce_bwd.restype = ctypes.c_int
    lib.hfa_triplane_probe.argtypes = [p, p, p, i, i, i, i, i, f, i, p]
    lib.hfa_triplane_probe.restype = ctypes.c_int
    lib.hfa_upfirdn2d.argtypes = [p, p, p, *[i] * 6, *[i64] * 4, *[i] * 8, p]
    lib.hfa_upfirdn2d.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")
