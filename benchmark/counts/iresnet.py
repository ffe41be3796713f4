"""FLOPs of an iresnet face-embedding trunk's forward, from the
configuration's "network" group: the 3×3 stem at the input's size, the
BN-first basic blocks (3×3, 3×3 with the stage's stride, a 1×1 strided
shortcut where the shape changes), and the FC from the last stage's
(512, size/16, size/16) to the embedding. BatchNorm and PReLU count
nothing, as in `torch.utils.flop_counter`."""

from . import conv, linear

LAYERS = {"iresnet18": (2, 2, 2, 2), "iresnet34": (3, 4, 6, 3),
          "iresnet50": (3, 4, 14, 3), "iresnet100": (3, 13, 30, 5),
          "iresnet200": (6, 26, 60, 6)}
CHANNELS = (64, 128, 256, 512)


def stem(net: dict, b: int) -> int:
    """The 3 → 64 stem: the one convolution whose input needs no
    gradient."""
    return conv(b, 3, CHANNELS[0], 3, net["input_size"])


def forward(net: dict, b: int) -> int:
    h = net["input_size"]
    total, cin = stem(net, b), CHANNELS[0]
    for n, cout in zip(LAYERS[net["name"]], CHANNELS):
        for i in range(n):
            out = h // 2 if i == 0 else h
            total += conv(b, cin, cout, 3, h) + conv(b, cout, cout, 3, out)
            if i == 0:                      # stride 2: the 1×1 shortcut
                total += conv(b, cin, cout, 1, out)
            h, cin = out, cout
    return total + linear(b, cin * h * h, net["embedding_size"])
