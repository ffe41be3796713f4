"""One reader a metric: `read(run)` returns the metric's value, or None
where the run holds nothing for it to read (the harness then leaves the
metric out of the line). A share of a peak or a roofline is never 0 in
place of nothing."""

from __future__ import annotations

import json
import os

import torch


def peak(key: str) -> float | None:
    """The published peak `key` of the run's card (`peaks.json`), or None
    for a card the table does not hold."""
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "peaks.json")) as f:
        table = json.load(f)["devices"]
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    hits = [v for k, v in table.items() if k in name]
    return hits[0][key] if hits else None


def roofline(run, counter: str, needles, unit) -> float | None:
    """100 × Σ bound ÷ Σ device time over the traced window's kernels whose
    name holds a needle. `unit(config, entry, batch)` of `counts/` gives
    the work of one unit's ops by direction: the bytes they need under
    "fwd" and "bwd", and, where operations can bound them, the operations
    under "fwd_ops" and "bwd_ops" with the key of their peak in
    `peaks.json` under "ops_peak". A direction's bound is the larger of its
    bytes at the card's HBM rate and its operations at that peak. None
    unless the trace holds as many such kernels as the port's `counter`
    counted launches, forward and backward."""
    from ..trace import kernel_ns
    bw = peak("hbm_bytes_per_s")
    if run.trace is None or bw is None or counter not in run.launches:
        return None
    fwd, bwd = run.launches[counter]
    ns, count = kernel_ns(run.trace, needles)
    if not count or count != fwd + bwd or not ns:
        return None
    per_unit = unit(run.config, run.traffic["entry"], run.batch)
    ops_rate = peak(per_unit["ops_peak"]) if "ops_peak" in per_unit else None
    if "ops_peak" in per_unit and ops_rate is None:
        return None
    # each direction's bound as the bytes that HBM moves in that time
    nbytes = 0
    for d, launched in (("fwd", fwd), ("bwd", bwd)):
        if launched:
            b = per_unit.get(d, 0)
            if f"{d}_ops" in per_unit:
                b = max(b, per_unit[f"{d}_ops"] / ops_rate * bw)
            nbytes += b
    nbytes = run.units * nbytes
    return 100.0 * (nbytes / bw) / (ns / 1e9)
