"""The port alone, without JAX, against tests/golden/seams.npz: the
outputs of the reference's torch compositions at four seams, captured by
tools/capture_golden.py, which tests/test_golden.py holds the JAX package
to. The checks are `hfa_gp_tpu_torch.tools.check_golden`'s, at
test_golden.py's tolerances: ray_march rtol 1e-4 / atol 1e-5 (through the
marcher's wrapper, its plain version on the CPU), sample_pdf 1e-4 / 1e-5,
bilinear_resize 1e-4 / 1e-4, block_apply (up=True) 2e-3 / 2e-4. On the
card `chip_smoke.py` runs the same checks with the kernels on; the `gpu`
case below does too.
"""

import numpy as np
import pytest
import torch

from hfa_gp_tpu_torch.tools import check_golden

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other.
torch.set_num_threads(1)

SEAMS = ("ray_march rgb", "ray_march depth", "ray_march w", "sample_pdf",
         "bilinear_resize 32 antialias True",
         "bilinear_resize 32 antialias False",
         "bilinear_resize 64 antialias True", "block_apply x",
         "block_apply img")


@pytest.fixture(scope="module")
def outputs():
    return {name: (got, want, tol) for name, got, want, tol
            in check_golden.seam_outputs("cpu")}


def test_every_seam_is_checked(outputs):
    assert tuple(outputs) == SEAMS


@pytest.mark.parametrize("name", SEAMS)
def test_seam_matches_the_golden_fixture(outputs, name):
    got, want, (rtol, atol) = outputs[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_check_reports_every_seam_within_tolerance():
    rows = check_golden.check("cpu")
    assert [r[0] for r in rows] == list(SEAMS)
    assert all(ok for *_, ok in rows), rows
    assert check_golden.main(["--device", "cpu"]) == 0


@pytest.mark.gpu
def test_seams_on_the_card_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = check_golden.check("cuda")
    assert all(ok for *_, ok in rows), rows
