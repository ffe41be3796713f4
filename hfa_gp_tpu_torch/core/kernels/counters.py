"""The launch counters of the hand-written kernels, in one table.

Each kernel's wrapper module counts its launches in this process in
`LAUNCHES` (forward) and `LAUNCHES_BWD` (backward); the sampler also
counts, in `LAUNCHES_DECODE`, those of its forward launches that ran the
decoder fused. `COUNTERS` names them all; the graph helper
(`core/graphs.py`) advances them at a replay and the card-side smoke test
reads them. A new kernel's module adds its rows here.
"""

from __future__ import annotations

from . import fir, flash_ce, raymarch, triplane

# name → (module, attribute)
COUNTERS = {
    "triplane_sampler": (triplane, "LAUNCHES"),
    "triplane_sampler_bwd": (triplane, "LAUNCHES_BWD"),
    "ray_marcher": (raymarch, "LAUNCHES"),
    "ray_marcher_bwd": (raymarch, "LAUNCHES_BWD"),
    "flash_ce_fwd": (flash_ce, "LAUNCHES"),
    "flash_ce_bwd": (flash_ce, "LAUNCHES_BWD"),
    "upfirdn2d": (fir, "LAUNCHES"),
    "upfirdn2d_bwd": (fir, "LAUNCHES_BWD"),
    "triplane_sampler_decoder": (triplane, "LAUNCHES_DECODE"),
}


def launches() -> dict[str, int]:
    """Every counter's launches so far, by name."""
    return {name: getattr(m, attr) for name, (m, attr) in COUNTERS.items()}


def reset_launches() -> None:
    """Set every counter to 0."""
    for m, attr in COUNTERS.values():
        setattr(m, attr, 0)
