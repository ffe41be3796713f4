"""The HFA-GP avatars (RGB- and audio-driven) for the benchmark.

The adapter of a configuration dict whose "model" is "hfagp", to the
contract in `harness.py`:

  * `spec(config)`: the weights in the port's param-tree layout, for
    `weights.make`; `aux_spec(config)`: the second tree, AlexNet LPIPS,
    which fitting's loss reads and never trains;
  * `inputs(config, traffic, seed, device)`: `inputs.pool`, the driving
    frames or audio windows and the camera labels;
  * `program(config)`: the port's entries (the system under test);
  * `reference(config)` and `control(config)`: the plain PyTorch
    reference in fp32, and the same with TF32 on (the control that the
    check has to fail);
  * `flops(config, entry, batch)`: the work of one unit (a batch served,
    a step trained), counted from the shapes;
  * `kernel_counters()`: the port's launch counters of its kernels;
  * `ALTERED_LEAF`: the leaf whose gradient `faults.py`'s `altered` scales.

The port is imported inside `program` only, so the reference and the
counts load without it.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..counts import audio as audio_counts
from ..counts import eg3d as eg3d_counts
from ..counts import encoder as encoder_counts
from ..counts import lpips as lpips_counts
from ..inputs import pool as inputs  # the adapter's `inputs`
from ..reference import avatar as ref
from ..reference import eg3d as ref_eg3d

ENCODER_CHANNELS = encoder_counts.CHANNELS
ALTERED_LEAF = "superresolution/block0/conv1/weight"


# -- weights ---------------------------------------------------------------------


def _linear_stack(prefix, dims):
    out = []
    for i in range(len(dims) - 1):
        out += [(f"{prefix}/fc{i}/weight", (dims[i + 1], dims[i]), "randn", None),
                (f"{prefix}/fc{i}/bias", (dims[i + 1],), "zeros", None)]
    return out


def _encoder_spec(enc):
    size, p = enc["size"], "encoder/net_app"
    c = ENCODER_CHANNELS[size]
    out = [(f"{p}/stem/weight", (c, 3, 1, 1), "randn", None),
           (f"{p}/stem/act_bias", (c,), "zeros", None)]
    h, cin = size, c
    for i in range(int(math.log2(size)) - 2):
        cout = ENCODER_CHANNELS[h // 2]
        r = f"{p}/res{i}"
        out += [(f"{r}/conv1/weight", (cin, cin, 3, 3), "randn", None),
                (f"{r}/conv1/act_bias", (cin,), "zeros", None),
                (f"{r}/conv2/weight", (cout, cin, 3, 3), "randn", None),
                (f"{r}/conv2/act_bias", (cout,), "zeros", None),
                (f"{r}/skip/weight", (cout, cin, 1, 1), "randn", None)]
        h, cin = h // 2, cout
    out.append((f"{p}/final/weight", (enc["w_dim"], cin, 4, 4), "randn", None))
    return out + _linear_stack("encoder/fc", [enc["w_dim"]] * 5
                               + [enc["dim_shape"]])


def _subspace_spec(prefix, enc, num_ws):
    bases = f"{prefix}/bases"
    return [(bases, (enc["dim_shape"], num_ws * enc["w_dim"]), "randn", None),
            (f"{prefix}/delta", (num_ws * enc["w_dim"],), "mean", bases)]


def _synth_layer(p, cin, cout, w_dim, res):
    return [(f"{p}/weight", (cout, cin, 3, 3), "randn", None),
            (f"{p}/bias", (cout,), "zeros", None),
            (f"{p}/affine/weight", (cin, w_dim), "randn", None),
            (f"{p}/affine/bias", (cin,), "ones", None),
            (f"{p}/noise_strength", (), "zeros", None),
            (f"{p}/noise_const", (res, res), "zeros", None)]


def _block(p, cin, cout, w_dim, res, out_ch, first):
    out = [(f"{p}/const", (cout, res, res), "randn", None)] if first \
        else _synth_layer(f"{p}/conv0", cin, cout, w_dim, res)
    return out + _synth_layer(f"{p}/conv1", cout, cout, w_dim, res) + [
        (f"{p}/torgb/weight", (out_ch, cout, 1, 1), "randn", None),
        (f"{p}/torgb/bias", (out_ch,), "zeros", None),
        (f"{p}/torgb/affine/weight", (cout, w_dim), "randn", None),
        (f"{p}/torgb/affine/bias", (cout,), "ones", None)]


def _generator_spec(prefix, g):
    m, bb, sr, rc = g["mapping"], g["backbone"], g["sr"], g["render"]
    p = f"{prefix}/mapping"
    out = [(f"{p}/w_avg", (m["w_dim"],), "zeros", None),
           (f"{p}/embed/weight", (m["w_dim"], m["c_dim"]), "randn", None),
           (f"{p}/embed/bias", (m["w_dim"],), "zeros", None)]
    fan_in = m["z_dim"] + m["w_dim"]
    for i in range(m["num_layers"]):
        out += [(f"{p}/fc{i}/weight", (m["w_dim"], fan_in), "randn", None),
                (f"{p}/fc{i}/bias", (m["w_dim"],), "zeros", None)]
        fan_in = m["w_dim"]
    cin = 0
    for res in ref_eg3d.block_resolutions(bb):
        cout = ref_eg3d.channels(bb, res)
        out += _block(f"{prefix}/backbone/b{res}", cin, cout, bb["w_dim"], res,
                      bb["img_channels"], res == 4)
        cin = cout
    d = f"{prefix}/decoder"
    feats = bb["img_channels"] // 3
    out += [(f"{d}/fc0/weight", (rc["decoder_hidden"], feats), "randn", None),
            (f"{d}/fc0/bias", (rc["decoder_hidden"],), "zeros", None),
            (f"{d}/fc1/weight", (1 + rc["decoder_output_dim"],
                                 rc["decoder_hidden"]), "randn", None),
            (f"{d}/fc1/bias", (1 + rc["decoder_output_dim"],), "zeros", None)]
    c0, c1 = sr["block_channels"]
    out += _block(f"{prefix}/superresolution/block0", sr["in_channels"], c0,
                  sr["w_dim"], sr["output_resolution"] // 2, 3, False)
    out += _block(f"{prefix}/superresolution/block1", c0, c1, sr["w_dim"],
                  sr["output_resolution"], 3, False)
    return out


def _uniform_layer(p, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return [(f"{p}/weight", shape, "usym", bound),
            (f"{p}/bias", (shape[0],), "usym", bound)]


def _audio_spec(a, w_dim, dim_shape):
    out = []
    for i, (cin, cout) in enumerate(((29, 32), (32, 32), (32, 64), (64, 64))):
        out += _uniform_layer(f"audnet/conv{i}", (cout, cin, 3), cin * 3)
    out += _uniform_layer("audnet/fc0", (64, 64), 64)
    out += _uniform_layer("audnet/fc1", (a["dim_aud"], 64), 64)
    chans = (32, 16, 8, 4, 2, 1)
    for i in range(5):
        out += _uniform_layer(f"audattnet/conv{i}", (chans[i + 1], chans[i], 3),
                              chans[i] * 3)
    out += _uniform_layer("audattnet/att_fc", (a["smo_size"], a["smo_size"]),
                          a["smo_size"])
    return out + _linear_stack("model/weights_mlp", [a["dim_aud"]]
                               + [w_dim] * 6 + [dim_shape])


def spec(config: dict):
    enc, g = config["encoder"], config["eg3d"]
    num_ws = ref_eg3d.num_ws(g["backbone"])
    if config["driving"] == "rgb":
        return _encoder_spec(enc) + _subspace_spec("subspace", enc, num_ws) \
            + _generator_spec("generator", g)
    return _audio_spec(config["audio"], enc["w_dim"], enc["dim_shape"]) \
        + _subspace_spec("model/subspace", enc, num_ws) \
        + _generator_spec("model/generator", g)


def aux_spec(config: dict):
    """Fitting's second tree: the AlexNet LPIPS network, the same for both
    drivings."""
    out, cin = [], 3
    for i, (cout, k, _, _) in enumerate(ref.LPIPS_CONVS):
        out += [(f"conv{i}/weight", (cout, cin, k, k), "usym",
                 1.0 / math.sqrt(cin * k * k)),
                (f"conv{i}/bias", (cout,), "zeros", None),
                (f"lin{i}/weight", (cout,), "upos", 2.0 / cout)]
        cin = cout
    return out


# -- the port ------------------------------------------------------------------------


def port_config(config: dict):
    """The port's AvatarConfig for the configuration dict."""
    from hfa_gp_tpu_torch.models.avatar import heads
    from hfa_gp_tpu_torch.models.eg3d import generator, networks, renderer
    g, enc = config["eg3d"], config["encoder"]
    tup = {"fir", "block_channels"}

    def dc(cls, d):
        return cls(**{k: tuple(v) if k in tup else v for k, v in d.items()})

    eg3d = generator.EG3DConfig(
        mapping=dc(networks.MappingConfig, g["mapping"]),
        backbone=dc(networks.BackboneConfig, g["backbone"]),
        sr=dc(networks.SRConfig, g["sr"]),
        render=dc(renderer.RenderConfig, g["render"]))
    a = config.get("audio") or {}
    return heads.AvatarConfig(size=enc["size"], dim=enc["w_dim"],
                              dim_shape=enc["dim_shape"], eg3d=eg3d,
                              **{k: a[k] for k in ("dim_aud", "win_size",
                                                   "smo_size") if k in a})


class Program:
    """The port's entries, looked up at each call (so a test can plant a
    fault under them): `serve` renders a batch as the reenactment CLIs do;
    `trainer` builds the fitting state that `train.rgb.train_step` steps."""

    def __init__(self, config: dict):
        self.config = config
        self.cfg = port_config(config)

    def serve(self, params, inputs):
        from hfa_gp_tpu_torch.cli import run_recon_video_rgb
        from hfa_gp_tpu_torch.train import audio
        if self.config["driving"] == "rgb":
            with torch.inference_mode():
                return run_recon_video_rgb.reenact(params, self.cfg,
                                                   inputs["image"],
                                                   inputs["label"])
        return audio.sample(params, self.cfg, inputs["window"],
                            inputs["label"], smooth=True)

    def wrap(self, tree):
        from hfa_gp_tpu_torch.utils.convert import ParamTree
        return ParamTree(tree)

    def trainer(self, tree, lpips_tree, spec_paths):
        return PortTrainer(self, tree, lpips_tree, spec_paths)


class PortTrainer:
    """`train.rgb.train_step` on one state, past tune_iter so that every
    parameter moves."""

    def __init__(self, program: Program, tree, lpips_tree, spec_paths):
        from hfa_gp_tpu_torch.train.state import init_state
        t = program.config["train"]
        self.program, self.tune_iter = program, t["tune_iter"]
        self.beta1 = t["betas"][0]
        self.params = program.wrap(tree)
        self.lpips = program.wrap(lpips_tree)
        self.state = init_state(self.params, t["lr"])
        self.state.step = self.tune_iter
        named = dict(self.params.named_parameters())
        self.leaves = [named[p.replace("/", ".")] for p in spec_paths]

    def step(self, batch):
        from hfa_gp_tpu_torch.train import rgb
        return rgb.train_step(self.state, self.lpips, self.program.cfg,
                              batch["image"], batch["label"],
                              self.tune_iter)["loss"]

    def first_grads(self):
        """The first step's gradients as the optimizer got them, from Adam's
        first moment after one step: m = (1 − β1)·g."""
        st = self.state.optimizer.state
        return [st[p]["exp_avg"] / (1 - self.beta1) if p in st
                else torch.zeros_like(p) for p in self.leaves]


# -- the reference and its control ----------------------------------------------------------


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuDNN's convolutions and cuBLAS's products, or full fp32."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old


class Reference:
    """The plain PyTorch reference, with TF32 on (`lower=True`, the control)
    or off. It takes the weights and inputs the benchmark made, never
    anything the port derived."""

    def __init__(self, config: dict, lower: bool = False):
        self.config, self.lower = config, lower

    def serve(self, params, inputs):
        with torch.no_grad(), tf32(self.lower):
            if self.config["driving"] == "rgb":
                return ref.rgb_frames(params, self.config, inputs["image"],
                                      inputs["label"])
            return ref.audio_frames(params, self.config, inputs["window"],
                                    inputs["label"])

    def wrap(self, tree):
        return tree

    def trainer(self, tree, lpips_tree, spec_paths):
        return RefTrainer(self, tree, lpips_tree, spec_paths)


class RefTrainer:
    """The reference fitting step: the loss's gradients by autograd, every
    missing one zero, Adam written out."""

    def __init__(self, reference: Reference, tree, lpips_tree, spec_paths):
        from ..weights import leaves
        t = reference.config["train"]
        self.reference, self.tree, self.lpips = reference, tree, lpips_tree
        flat = dict(leaves(tree))
        self.leaves = [flat[p].requires_grad_(True) for p in spec_paths]
        self.adam = ref.Adam(self.leaves, t["lr"], tuple(t["betas"]), t["eps"])
        self.grads = None

    def step(self, batch):
        with tf32(self.reference.lower):
            loss = ref.rgb_loss(self.tree, self.lpips, self.reference.config,
                                batch["image"], batch["label"])
            grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.leaves, grads)]
        if self.grads is None:
            self.grads = grads
        self.adam.step(grads)
        return loss.detach()

    def first_grads(self):
        return self.grads


def program(config):
    return Program(config)


def reference(config):
    return Reference(config)


def control(config):
    return Reference(config, lower=True)


# -- counts ---------------------------------------------------------------------------------


def forward_flops(config: dict, b: int) -> int:
    enc, g = config["encoder"], config["eg3d"]
    num_ws = ref_eg3d.num_ws(g["backbone"])
    if config["driving"] == "rgb":
        drive = encoder_counts.encoder(enc, b)
    else:
        drive = audio_counts.driving(config["audio"], enc["w_dim"],
                                     enc["dim_shape"], b)
    return drive + encoder_counts.subspace(enc, num_ws, b) \
        + eg3d_counts.synthesis(g, b)


def flops(config: dict, entry: str, b: int) -> int:
    """FLOPs of one unit: a batch served, or a fitting step (the forward,
    a backward of twice it, LPIPS on both images and back through one)."""
    if entry == "serve":
        return forward_flops(config, b)
    return 3 * forward_flops(config, b) \
        + 3 * lpips_counts.features(b, config["encoder"]["size"])


def kernel_counters():
    """The port's launch counters: {kernel: (forward, backward)}."""
    from hfa_gp_tpu_torch.core.kernels import raymarch, triplane
    return {"sampler": (triplane.LAUNCHES, triplane.LAUNCHES_BWD),
            "marcher": (raymarch.LAUNCHES, raymarch.LAUNCHES_BWD)}
