"""Static checks of the port's kernel library interface, and the wrappers'
CPU routes at the ragged shapes the card-side smoke test adds.

The C entry points of `hfa_gp_tpu_torch/csrc/*.cu` are called through
`ctypes` with the argument types `core/kernels/build.py::_declare` gives
them. A signature changed on one side only would otherwise show first on
the card (as a crash or as silently cut pointers), so the two are held
together here, from the sources' text: no compiler is needed.
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

from hfa_gp_tpu_torch.core.kernels import build, flash_ce, triplane

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "float": ctypes.c_float}


def _c_entry_points() -> dict:
    """name -> list of ctypes types, parsed from every `extern "C" int
    hfa_*(...)` in the CUDA sources."""
    found = {}
    for path in sorted(glob.glob(os.path.join(build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for name, args in re.findall(
                r'extern\s+"C"\s+int\s+(hfa_\w+)\s*\(([^)]*)\)', text):
            assert name not in found, f"{name} defined twice"
            types = []
            for arg in args.split(","):
                ctype = " ".join(arg.split()[:-1])       # drop the name
                types.append(C_TYPES[ctype])
            found[name] = types
    return found


class _Recorder:
    """Stands in for a `ctypes.CDLL`: remembers what `_declare` sets."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        return self.functions.setdefault(name, type("F", (), {})())


def _declared() -> dict:
    lib = build._declare(_Recorder())
    return lib.functions


ENTRY_POINTS = sorted(_c_entry_points())


def test_the_sources_define_the_kernels_entry_points():
    assert {"hfa_triplane_mean", "hfa_triplane_mean_bwd", "hfa_ray_march",
            "hfa_ray_march_bwd", "hfa_flash_ce_fwd", "hfa_flash_ce_bwd",
            "hfa_triplane_probe", "hfa_upfirdn2d"} <= set(ENTRY_POINTS)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_c_entry_point_is_declared_with_its_argument_types(name):
    """Every `extern "C" int hfa_*(` has argtypes of the same length and
    kinds (pointers as c_void_p, never a bare int) and an int restype."""
    declared = _declared()
    assert name in declared, f"{name} has no argtypes in build._declare"
    assert declared[name].argtypes == _c_entry_points()[name]
    assert declared[name].restype is ctypes.c_int


def test_every_declared_entry_point_exists_in_the_sources():
    assert sorted(_declared()) == ENTRY_POINTS


def test_the_flash_ce_wrapper_knows_the_kernels_class_tile():
    """`flash_ce.CLASS_TILE` sizes the forward's partial sums: it must be
    the kernels' TILE_C."""
    with open(os.path.join(build.CSRC_DIR, "flash_ce_common.cuh")) as f:
        tile = re.search(r"constexpr int TILE_C = (\d+);", f.read())
    assert int(tile.group(1)) == flash_ce.CLASS_TILE


# -- the CPU routes at the smoke test's ragged shapes --------------------------


@pytest.mark.parametrize("b,d,c,mm", [(384, 510, 3001, None),
                                      (8, 72, 1000, None),
                                      (300, 128, 1007, torch.bfloat16),
                                      (384, 510, 3001, torch.bfloat16),
                                      (8, 72, 1000, torch.bfloat16)])
def test_flash_ce_wrappers_on_cpu_give_the_plain_versions(b, d, c, mm):
    rng = np.random.default_rng(b + d + c)
    ne = rng.standard_normal((b, d)).astype(np.float32)
    ne /= np.linalg.norm(ne, axis=1, keepdims=True)
    w = (rng.standard_normal((c, d)) * 0.01).astype(np.float32)
    lab = rng.integers(0, c, b).astype(np.int32)
    lab[::9] = -1
    ne, w, lab = (torch.from_numpy(a) for a in (ne, w, lab))
    n0, n1 = flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD
    got = flash_ce.flash_ce_stats(ne, w, lab, 64.0, mm)
    want = flash_ce.flash_ce_stats_plain(ne, w, lab, 64.0, mm)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert bool((got[1][lab < 0] == 0).all())
    ct = (torch.from_numpy(rng.standard_normal(b).astype(np.float32))
          / want[0], torch.from_numpy(rng.standard_normal(b)
                                      .astype(np.float32)))
    g_got = flash_ce.flash_ce_stats_backward(ne, w, lab, 64.0, mm, *ct)
    g_want = flash_ce.flash_ce_stats_backward_plain(ne, w, lab, 64.0, mm, *ct)
    assert all(torch.equal(x, y) for x, y in zip(g_got, g_want))
    assert g_got[0].shape == ne.shape and g_got[1].shape == w.shape
    assert all(bool(torch.isfinite(x).all()) for x in g_got)
    assert (flash_ce.LAUNCHES, flash_ce.LAUNCHES_BWD) == (n0, n1)
    scratch = flash_ce.transposed_scratch(ne)
    assert scratch.shape == (d, -(-b // 4) * 4)


@pytest.mark.parametrize("b,d", [(256, 512), (384, 510), (8, 72), (5, 7),
                                 (40, 700)])
def test_flash_ce_scratch_fits_each_route(b, d):
    """fp32 operands: the transposed copy (d, B rounded up to 4). bf16: the
    rounded copy, B rounded up to a group of 256 rows and d to a warp
    tile's 64 columns (csrc/flash_ce_bf16.cuh), for the forward at any d
    and the backward up to d 512; above, the backward's CUDA-core route
    takes the transposed copy."""
    ne = torch.zeros((b, d))
    assert flash_ce.scratch(ne, 0, False).shape == (d, -(-b // 4) * 4)
    assert flash_ce.scratch(ne, 0, True).shape == (d, -(-b // 4) * 4)
    rounded = (-(-b // 256) * 256, -(-d // 64) * 64)
    fwd = flash_ce.scratch(ne, 1, False)
    assert fwd.shape == rounded and fwd.dtype == torch.bfloat16
    bwd = flash_ce.scratch(ne, 1, True)
    if d <= flash_ce.BF16_BWD_MAX_D:
        assert bwd.shape == rounded and bwd.dtype == torch.bfloat16
    else:
        assert bwd.shape == (d, -(-b // 4) * 4) and bwd.dtype == torch.float32


def test_flash_ce_constants_match_the_sources():
    """The wrapper's sizes of the bf16 route are the CUDA sources'."""
    with open(os.path.join(build.CSRC_DIR, "flash_ce_bf16.cuh")) as f:
        cuh = f.read()
    with open(os.path.join(build.CSRC_DIR, "flash_ce_common.cuh")) as f:
        common = f.read()
    assert re.search(r"constexpr int DP_ALIGN = (\d+);", cuh).group(1) == \
        str(flash_ce.BF16_DEPTH)
    assert re.search(r"constexpr int TILE_B = (\d+);", common).group(1) == \
        str(flash_ce.BF16_ROWS)
    assert re.search(r"constexpr int BWD_MAX_D = (\d+);", common).group(1) \
        == str(flash_ce.BF16_BWD_MAX_D)
    assert re.search(r"constexpr int TILE_C = (\d+);", common).group(1) == \
        str(flash_ce.CLASS_TILE)


def _edge_planes_and_points(c: int, h: int = 16, w: int = 16, m: int = 512):
    """Planes whose last row and column are NaN, and points a fraction of a
    texel around the first row and column: some corners fall outside the
    planes, none of the in-plane corners is a NaN texel."""
    rng = np.random.default_rng(c)
    planes = rng.standard_normal((2, 3, h, w, c)).astype(np.float32)
    planes[:, :, -1] = np.nan
    planes[:, :, :, -1] = np.nan
    pts = (-0.5 + rng.uniform(-0.5, 0.5, (2, m, 3)) / max(h, w)) \
        .astype(np.float32)
    return torch.from_numpy(planes), torch.from_numpy(pts)


@pytest.mark.parametrize("c,h,w", [(8, 16, 16), (48, 12, 20), (30, 16, 16)])
def test_sampler_wrapper_on_cpu_gives_the_plain_version(c, h, w):
    rng = np.random.default_rng(c)
    planes = torch.from_numpy(
        rng.standard_normal((2, 3, h, w, c)).astype(np.float32))
    n0 = triplane.LAUNCHES
    for spread in (1.0, 3.0):                      # 3.0: most points off-plane
        pts = torch.from_numpy(
            ((rng.uniform(size=(2, 300, 3)) - 0.5) * spread)
            .astype(np.float32))
        got = triplane.sample_mean(planes, pts, 1.0)
        assert torch.equal(got, triplane.sample_mean_plain(planes, pts, 1.0))
        assert got.shape == (2, 300, c)
    # far outside every plane the lookup is exactly 0
    far = torch.full((2, 7, 3), 5.0)
    assert bool((triplane.sample_mean(planes, far, 1.0) == 0).all())
    assert triplane.LAUNCHES == n0


def test_out_of_plane_corners_contribute_zero_beside_nonfinite_texels():
    planes, pts = _edge_planes_and_points(32)
    got = triplane.sample_mean(planes, pts, 1.0)
    assert bool(torch.isfinite(got).all())
    # the same lookup on planes without the NaN border: those texels were
    # never in reach
    clean = torch.nan_to_num(planes, nan=0.0)
    torch.testing.assert_close(got, triplane.sample_mean(clean, pts, 1.0),
                               rtol=0, atol=0)
