"""sampler_roofline: the tri-plane sampler's launches (K1, forward; K2,
backward), Σ bytes-bound ÷ Σ device time, in %."""

from ..counts import sampler
from . import roofline

KERNELS = ("triplane_sampler_kernel", "triplane_bwd_kernel")


def read(run):
    return roofline(run, "sampler", KERNELS, sampler.unit)
