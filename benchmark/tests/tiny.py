"""Tiny cells for the CPU tests: the real configuration and traffic files
with every size cut down, the limits of the real cell."""

from __future__ import annotations

import copy

from benchmark import harness

TINY = {
    "encoder": {"size": 32},
    "eg3d": {
        "backbone": {"img_resolution": 16, "img_channels": 24,
                     "channel_base": 256, "channel_max": 32},
        "sr": {"input_resolution": 8, "output_resolution": 32,
               "in_channels": 8, "block_channels": [16, 8]},
        "render": {"depth_resolution": 4, "depth_resolution_importance": 4,
                   "neural_rendering_resolution": 8, "decoder_hidden": 16,
                   "decoder_output_dim": 8, "sampler_depth_window": 2},
    },
}


def _merge(d: dict, over: dict) -> dict:
    out = copy.deepcopy(d)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def cell(name: str, *, pool: int = 8, batch: int | None = None) -> dict:
    c = harness.cell(name)
    c["config"] = _merge(c["config"], TINY)
    c["traffic"] = dict(c["traffic"], pool=pool,
                        **({"batch": batch} if batch else {}))
    return c


def run(name: str, seed: int = 7, seconds: float = 0.3, traced=False,
        program=None, **kw):
    return harness.run_cell(name, seed, seconds, traced, device="cpu",
                            program=program, cell_override=cell(name, **kw))
