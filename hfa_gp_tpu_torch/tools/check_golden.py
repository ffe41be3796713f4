"""The port against the committed golden fixtures of the reference's seams.

    python -m hfa_gp_tpu_torch.tools.check_golden [--device cuda|cpu]

`tests/golden/seams.npz` holds the outputs of the reference's torch
compositions at four seams of the renderer and the synthesis network,
captured by `tools/capture_golden.py`; `tests/test_golden.py` holds the
JAX package to them. This module holds the port to them, with nothing of
JAX: `renderer.ray_march` (through the marcher's wrapper, so on a CUDA
card through its kernel), `renderer.sample_pdf`,
`networks.bilinear_resize` at 32 (with and without antialiasing) and 64,
and `networks.block_apply` with up=True. The fixtures are in the JAX
package's channels-last layout and parameter tree; the port's functions
take NCHW and `utils.convert`'s tree. The tolerances are
`tests/test_golden.py`'s. `tests/test_torch_golden.py` runs it on the
CPU, `chip_smoke.py` on the card; a mismatch exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..models.eg3d import networks, renderer
from ..utils import convert

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "seams.npz")

# (rtol, atol) of tests/test_golden.py
BLOCK_TOL = (2e-3, 2e-4)
RAY_MARCH_TOL = (1e-4, 1e-5)
SAMPLE_PDF_TOL = (1e-4, 1e-5)
RESIZE_TOL = (1e-4, 1e-4)


def _unflatten(flat: dict, prefix: str) -> dict:
    """The keys of `flat` under `prefix`, split at "." into a nested dict."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def seam_outputs(device: torch.device | str, path: str = GOLDEN) -> list:
    """[(name, got, want, (rtol, atol))] for every seam, `got` computed by
    the port on `device` and brought back as numpy."""
    dev = torch.device(device)
    with np.load(path) as g:
        golden = {k: g[k] for k in g.files}

    def t(name, nchw=False):
        x = torch.from_numpy(golden[name]).to(dev)
        return x.permute(0, 3, 1, 2).contiguous() if nchw else x

    def back(x, nhwc=False):
        x = x.permute(0, 2, 3, 1) if nhwc else x
        return x.detach().cpu().numpy()

    out = []
    rgb, depth, w = renderer.ray_march(t("rm.colors"), t("rm.densities"),
                                       t("rm.depths"), renderer.RenderConfig())
    for name, got in (("rgb", rgb), ("depth", depth), ("w", w)):
        out.append((f"ray_march {name}", back(got), golden[f"rm.want_{name}"],
                    RAY_MARCH_TOL))
    got = renderer.sample_pdf(t("pdf.bins"), t("pdf.weights"),
                              int(golden["pdf.n_imp"]))
    out.append(("sample_pdf", back(got), golden["pdf.want"], SAMPLE_PDF_TOL))
    for size, aa in ((32, True), (32, False), (64, True)):
        got = networks.bilinear_resize(t("rs.x", nchw=True), size, aa)
        out.append((f"bilinear_resize {size} antialias {aa}",
                    back(got, nhwc=True), golden[f"rs.want_{size}_{int(aa)}"],
                    RESIZE_TOL))
    p = convert.from_jax(_unflatten(golden, "block.p."), dev)
    x, img = networks.block_apply(p, t("block.x", nchw=True),
                                  t("block.img", nchw=True), t("block.ws"),
                                  fir=[1, 3, 3, 1], conv_clamp=256.0, up=True)
    out.append(("block_apply x", back(x, nhwc=True), golden["block.want_x"],
                BLOCK_TOL))
    out.append(("block_apply img", back(img, nhwc=True),
                golden["block.want_img"], BLOCK_TOL))
    return out


def check(device: torch.device | str, path: str = GOLDEN) -> list:
    """[(name, max abs error, worst |got − want| − atol − rtol·|want|
    (≤ 0 within tolerance), within)] for every seam."""
    rows = []
    for name, got, want, (rtol, atol) in seam_outputs(device, path):
        excess = np.abs(got - want) - atol - rtol * np.abs(want)
        rows.append((name, float(np.abs(got - want).max()),
                     float(excess.max()),
                     got.shape == want.shape and bool((excess <= 0).all())))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = check(args.device)
    for name, err, excess, ok in rows:
        print(f"{name}: max abs err {err:.3e}, worst excess {excess:.3e} "
              f"{'ok' if ok else 'FAIL'}")
    return 0 if all(r[-1] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
