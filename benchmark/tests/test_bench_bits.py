"""The avatars' weights, second tree and input pools draw, for a seed, the
bits that commit 2b88ee6bd2e54ba3cd2809659a9b0aab68eb2b15 drew before
the adapter contract, at the tiny size and at full size, on the CPU; and
the sampler's and marcher's counts give that commit's bytes for every
cell. The hashes are SHA-256 of each flat buffer (`weights.make`) and of
each tensor of the pool, recorded from that commit's `weights.make(spec,
seed, 1)`, `weights.make(lpips_spec(), seed, 2)` and `inputs.pool(config,
traffic, seed)` with torch 2.13's CPU generator; another torch may draw
other bits on the CPU."""

import hashlib
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, weights
from benchmark.counts import marcher, sampler
from benchmark.entries import fit
from benchmark.models import hfagp
from benchmark.tests import tiny

torch.set_num_threads(2)

PARENT = "2b88ee6bd2e54ba3cd2809659a9b0aab68eb2b15"
SEED = 2 ** 31 + 5
CELLS = ("rgb_fit_b2", "rgb_reenact_b8", "audio_reenact_b8", "rgb_live_b1")
CONFIGS = {"hfagp_rgb_eg3d512": "rgb_fit_b2",
           "hfagp_audio_eg3d512": "audio_reenact_b8"}

WEIGHTS = {
 "tiny/hfagp_rgb_eg3d512": {
  "randn": "c8fb1ae31a2eae9f500a50e5df70a384be94e11eaf62aba7dc6904a5f6ee7e89",
  "rand": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
  "const": "8ecbe137806712c19da03257a71dfed0590392b771924e3429c57120cd11e300",
  "one": "d84b26982102fc171a8b9f7e88d6c6141df3bf116c224fd90f770351d1d9f848"
 },
 "tiny/hfagp_audio_eg3d512": {
  "randn": "f2b31a3dae96cd98aaf9eeb6936b2adc57c092b6784c6daa42983f78c8ccde26",
  "rand": "c5ecc5cdd81641f25d214f7a7162593bb56abefa415ab9d23f268186a53db383",
  "const": "4c8da14b4c30087d4b86afa5a774ed6287d4e45a4cf7218849c1933fc946661c",
  "one": "d84b26982102fc171a8b9f7e88d6c6141df3bf116c224fd90f770351d1d9f848"
 },
 "full/hfagp_rgb_eg3d512": {
  "randn": "9ad33e6fb835c82f76f2911ef2388519cb83b9a48d210b5522f6ead2a1ca4b58",
  "rand": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
  "const": "9d89b96ad330dc829a3ded21ee0e49a68aef9e3849e9991726dbb51a825b6406",
  "one": "756335be7cf281e22e78847b5fa4cf5a54eb70f19bfc104e8d0d770a9a024ca0"
 },
 "full/hfagp_audio_eg3d512": {
  "randn": "e2c3e8a15cab238cc0a13ea063243c74f6951fee2b15d0447d9326d58a468a43",
  "rand": "d38623d69f1ea9060c12829433c9d5d0649329016f690b7ec8c8f0194be43329",
  "const": "651d941dfce9dd4809c05317716f217510f0a9e761c6f9c69c5d5a12acd9a279",
  "one": "756335be7cf281e22e78847b5fa4cf5a54eb70f19bfc104e8d0d770a9a024ca0"
 }
}

AUX = {
 "randn": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
 "rand": "30959666784c5f0e7674b37b1abe0500bbc5707faaf809d7d4d32993ff4930c5",
 "const": "606f558e014930f9c1669f03c71c28945c4631568e39cd308c6c7f4077c7bfb9",
 "one": "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"
}

INPUTS = {
 "tiny/rgb_fit_b2": {
  "label": "8899ab5bd5471222548978938c7041b4ab06da0186dce80209f4884e7b424e4c",
  "image": "96a8a6171ddc144b39d9742b2134efb8af6ed39f6c4a1f13a917403cd4caf971"
 },
 "tiny/rgb_reenact_b8": {
  "label": "8899ab5bd5471222548978938c7041b4ab06da0186dce80209f4884e7b424e4c",
  "image": "96a8a6171ddc144b39d9742b2134efb8af6ed39f6c4a1f13a917403cd4caf971"
 },
 "tiny/audio_reenact_b8": {
  "label": "8899ab5bd5471222548978938c7041b4ab06da0186dce80209f4884e7b424e4c",
  "window": "6cbcd3d98593af653f673fe61c1d307e2dda2a3febfbfc7f06b3193e4a689eb2"
 },
 "tiny/rgb_live_b1": {
  "label": "8899ab5bd5471222548978938c7041b4ab06da0186dce80209f4884e7b424e4c",
  "image": "96a8a6171ddc144b39d9742b2134efb8af6ed39f6c4a1f13a917403cd4caf971"
 },
 "full/rgb_fit_b2": {
  "label": "6d64a6aa67fa6e4fe7cc9c3d003747d4e0fe424508af1ad7ad00e54b2f6aade9",
  "image": "71d540a97fbe1b3d4074b755a5e8294a91dd7e01175f3b2dfff2b9e0f3217c7a"
 },
 "full/rgb_reenact_b8": {
  "label": "6d64a6aa67fa6e4fe7cc9c3d003747d4e0fe424508af1ad7ad00e54b2f6aade9",
  "image": "71d540a97fbe1b3d4074b755a5e8294a91dd7e01175f3b2dfff2b9e0f3217c7a"
 },
 "full/audio_reenact_b8": {
  "label": "6d64a6aa67fa6e4fe7cc9c3d003747d4e0fe424508af1ad7ad00e54b2f6aade9",
  "window": "49b07c3cbf9892ca9a2107d9f06f89ee241950389a8efeed02f6f155dfeba3be"
 },
 "full/rgb_live_b1": {
  "label": "6d64a6aa67fa6e4fe7cc9c3d003747d4e0fe424508af1ad7ad00e54b2f6aade9",
  "image": "71d540a97fbe1b3d4074b755a5e8294a91dd7e01175f3b2dfff2b9e0f3217c7a"
 }
}

BYTES = {
 "rgb_fit_b2": {
  "sampler": {
   "fwd": 541065216,
   "bwd": 541065216
  },
  "marcher": {
   "fwd": 668991488,
   "bwd": 847249408
  }
 },
 "rgb_reenact_b8": {
  "sampler": {
   "fwd": 2164260864
  },
  "marcher": {
   "fwd": 2675965952
  }
 },
 "audio_reenact_b8": {
  "sampler": {
   "fwd": 2164260864
  },
  "marcher": {
   "fwd": 2675965952
  }
 },
 "rgb_live_b1": {
  "sampler": {
   "fwd": 270532608
  },
  "marcher": {
   "fwd": 334495744
  }
 }
}


def sha(t: torch.Tensor) -> str:
    data = t.detach().contiguous().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()


def _cell(size: str, name: str) -> dict:
    return tiny.cell(name) if size == "tiny" else harness.cell(name)


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_weights_draw_the_parents_bits(size, config):
    cfg = _cell(size, CONFIGS[config])["config"]
    _, bufs = weights.make(hfagp.spec(cfg), SEED, fit.WEIGHTS_STREAM, "cpu")
    assert {k: sha(b) for k, b in bufs.items()} == WEIGHTS[f"{size}/{config}"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_the_second_tree_draws_the_parents_bits(config):
    cfg = harness.cell(CONFIGS[config])["config"]
    run = SimpleNamespace(adapter=hfagp, config=cfg, seed=SEED, device="cpu")
    flat = dict(weights.leaves(fit.aux_tree(run)))
    # each buffer again, from its leaves in the spec's order
    bufs = {}
    for path, _, kind, _ in hfagp.aux_spec(cfg):
        bufs.setdefault(weights._buffer_of(kind), []).append(
            flat[path].flatten())
    got = {k: sha(torch.cat(v)) for k, v in bufs.items()}
    empty = sha(torch.zeros(0))
    assert got == {k: h for k, h in AUX.items() if h != empty}


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("name", CELLS)
def test_inputs_draw_the_parents_bits(size, name):
    c = _cell(size, name)
    pool = hfagp.inputs(c["config"], c["traffic"], SEED, "cpu")
    assert {k: sha(v) for k, v in pool.items()} == INPUTS[f"{size}/{name}"]


@pytest.mark.parametrize("name", CELLS)
def test_counts_give_the_parents_bytes(name):
    c = harness.cell(name)
    entry, b = c["traffic"]["entry"], c["traffic"]["batch"]
    assert sampler.unit(c["config"], entry, b) == BYTES[name]["sampler"]
    assert marcher.unit(c["config"], entry, b) == BYTES[name]["marcher"]
