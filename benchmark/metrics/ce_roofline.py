"""ce_roofline: the flash-CE kernels of the margin softmax (K5, forward;
K6, backward) on their fp32 route, Σ operations-bound ÷ Σ device time, in
%: one launch of each a step, the reduce and transpose helpers left out."""

from ..counts import flash_ce
from . import roofline

KERNELS = ("flash_ce_fwd_kernel", "flash_ce_bwd_kernel")


def read(run):
    return roofline(run, "flash_ce", KERNELS, flash_ce.unit)
