"""The flash-CE kernels of the margin softmax on their fp32 route, for B
embeddings of d against the k sampled class centres: K5 (forward) reads
the embeddings, the rows and the labels and writes two statistics a row;
K6 (backward) reads those with the two cotangents and writes the rows'
and the embeddings' gradients. Their products bound them, not their
bytes: the forward's cosines, 2·B·k·d operations; the backward, the two
gradients' products, two such. K6 computes the cosines again, a third
product, where storing them (B·k fp32) would cost far less time; the
bound counts only the products the gradients need, so a backward that
stores them still reads at most 100 %. `unit` counts one unit from an
arcface configuration."""

F32 = 4


def sampled(num_classes: int, sample_rate: float, b: int) -> int:
    """The rows a step samples: int(rate · classes), at least the batch's
    positives' room, as PartialFC keeps them."""
    n = max(1, int(sample_rate * num_classes))
    return min(num_classes, max(n, min(b, num_classes)))


def forward(b, k, d) -> int:
    return F32 * (b * d + k * d + b + 2 * b)


def backward(b, k, d) -> int:
    return F32 * (2 * b * d + 2 * k * d + b + 2 * b)


def products(b, k, d) -> int:
    return 2 * b * k * d


def unit(config: dict, entry: str, b: int) -> dict:
    """One step's K5 and K6 (a served unit has no K6): their bytes under
    "fwd" and "bwd", their operations under "fwd_ops" and "bwd_ops", at
    the fp32 peak."""
    head, d = config["head"], config["network"]["embedding_size"]
    k = sampled(head["num_classes"], head["sample_rate"], b)
    out = {"fwd": forward(b, k, d), "fwd_ops": products(b, k, d),
           "ops_peak": "fp32_flops"}
    if entry == "fit":
        out["bwd"] = backward(b, k, d)
        out["bwd_ops"] = 2 * products(b, k, d)
    return out
