"""Analytic counts of the work, from a configuration's shapes alone.

FLOPs are direct-convolution and product counts, two a multiply-add, in
the convention of `torch.utils.flop_counter` (a transposed convolution
counts its input positions, a grouped one its own groups). Bytes are
what an op's shapes need: each input read once, each output written
once. Nothing here looks at what the program runs.
"""


def conv(b, cin, cout, k, h, w=None):
    """FLOPs of a direct convolution with (h, w) output positions (input
    positions for a transposed one)."""
    return 2 * b * cin * cout * k * k * h * (h if w is None else w)


def fir(b, c, taps, h):
    """FLOPs of a depthwise FIR of taps × taps with h × h outputs."""
    return 2 * b * c * taps * taps * h * h


def linear(rows, fan_in, fan_out):
    return 2 * rows * fan_in * fan_out
