"""FLOPs of the ViT face-embedding trunk (arcface_torch's `backbones/vit.py`)
from a `network` dict of a ViT configuration: a stride-`patch` patch
embedding of the `crop`² top-left of the crop, `depth` pre-norm blocks
(a bias-free qkv, `heads` heads over the tokens, proj, a ReLU6 MLP of
`mlp_ratio` × dim), and the flatten-all-tokens head, Linear(tokens · dim
→ dim) and Linear(dim → embedding_size).

In training MAE-style masking keeps int(tokens · (1 − mask_ratio)) tokens,
and only those enter the blocks; in eval every token does. Products count
two a multiply-add, as `torch.utils.flop_counter` does; LayerNorm,
softmax, BatchNorm and the element-wise ops are not counted.
"""

from . import linear


def tokens(net: dict) -> int:
    """The patches a crop is cut into."""
    return (net["crop"] // net["patch"]) ** 2


def kept(net: dict, train: bool) -> int:
    """The tokens that enter the blocks."""
    n = tokens(net)
    return int(n * (1 - net["mask_ratio"])) if train else n


def forward(net: dict, b: int, train: bool = True) -> int:
    """The trunk's forward FLOPs for b crops."""
    n, dim = tokens(net), net["dim"]
    k = kept(net, train)
    hidden = int(dim * net["mlp_ratio"])
    embed = linear(b * n, net["patch"] ** 2 * 3, dim)
    block = (linear(b * k, dim, 3 * dim)         # qkv
             + 2 * 2 * b * k * k * dim           # q·kᵀ and att·v, all heads
             + linear(b * k, dim, dim)           # proj
             + linear(b * k, dim, hidden)        # fc1
             + linear(b * k, hidden, dim))       # fc2
    head = linear(b, n * dim, dim) + linear(b, dim, net["embedding_size"])
    return embed + net["depth"] * block + head
