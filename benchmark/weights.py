"""Weights made on the device from the seed, in a few large draws.

A spec is a list of leaves `(path, shape, kind, arg)`: `path` the
`/`-joined key of the port's param tree, `kind` one of "randn", "normal"
(N(0, arg²)), "zeros", "ones", "fill" (the constant arg), "usym" (uniform
in ±arg), "upos" (uniform in [0, arg)) or "mean" (the mean over dim 0 of
the leaf at path `arg`). Every leaf is a view into one of four flat
buffers, drawn by one call each from a generator on the device, so the
same seed gives the same weights and `clone` copies a whole tree in four
copies. A leaf takes its place in its buffer in the spec's order, so a
spec that uses neither "normal" nor "fill" draws what it drew before
either existed.
"""

from __future__ import annotations

import math

import torch

KINDS = ("randn", "normal", "usym", "upos", "zeros", "ones", "fill",
         "mean")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of the seed (the weights, a
    second tree and the inputs each draw from their own)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % 2 ** 63)
    return g


def _buffer_of(kind: str) -> str:
    return {"randn": "randn", "normal": "randn", "usym": "rand",
            "upos": "rand", "zeros": "const", "ones": "one", "fill": "const",
            "mean": "const"}[kind]


def make(spec, seed: int, stream: int, device):
    """(nested dict of tensors, dict of the flat buffers) for the spec."""
    sizes = {"randn": 0, "rand": 0, "const": 0, "one": 0}
    for _, shape, kind, _ in spec:
        sizes[_buffer_of(kind)] += math.prod(shape)
    g = generator(seed, stream, device)
    bufs = {"randn": torch.randn(sizes["randn"], generator=g, device=device),
            "rand": torch.rand(sizes["rand"], generator=g, device=device),
            "const": torch.zeros(sizes["const"], device=device),
            "one": torch.ones(sizes["one"], device=device)}
    tree = views(spec, bufs)
    flat = dict(leaves(tree))
    with torch.no_grad():
        for path, _, kind, arg in spec:
            if kind == "usym":
                flat[path].mul_(2).sub_(1).mul_(arg)
            elif kind in ("upos", "normal"):
                flat[path].mul_(arg)
            elif kind == "fill":
                flat[path].fill_(arg)
            elif kind == "mean":
                flat[path].copy_(flat[arg].mean(dim=0))
    return tree, bufs


def views(spec, bufs) -> dict:
    """The nested tree of views of the spec's leaves into `bufs`."""
    tree: dict = {}
    offset = {k: 0 for k in bufs}
    for path, shape, kind, _ in spec:
        buf = _buffer_of(kind)
        n = math.prod(shape)
        leaf = bufs[buf][offset[buf]:offset[buf] + n].view(shape)
        offset[buf] += n
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def clone(spec, bufs):
    """A copy of the whole tree: (tree, buffers)."""
    copies = {k: b.clone() for k, b in bufs.items()}
    return views(spec, copies), copies


def leaves(tree: dict, prefix: str = ""):
    """(path, tensor) of every leaf, in the tree's order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v
