"""marcher_roofline: the ray marcher's launches (K4, forward; K4′,
backward), Σ bytes-bound ÷ Σ device time, in %."""

from ..counts import marcher
from . import roofline

KERNELS = ("ray_march_warp_kernel", "ray_march_kernel",
           "ray_march_bwd_warp_kernel", "ray_march_bwd_kernel")


def read(run):
    return roofline(run, "marcher", KERNELS, marcher.unit)
