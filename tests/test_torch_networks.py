"""The port's EG3D networks (models/eg3d/networks.py) and param converter
(utils/convert.py) against the JAX package, at tests/test_eg3d.py's
small_config widths.

Params come from the JAX init, carried across by `convert.from_jax`; the
noise buffers are filled with random values so the const-noise path is
exercised. Tolerance: rtol 1e-4 / atol 1e-4 × output scale — a dozen
conv layers of fp32 sums taken in another order (XLA vs oneDNN) and
the grouped-conv modconv against the JAX prescale/postscale form.
"""

import dataclasses
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hfa_gp_tpu.models.eg3d import networks as jnets
from hfa_gp_tpu.models.eg3d.generator import init_generator as j_init_gen
from hfa_gp_tpu_torch.models.avatar.heads import AvatarConfig
from hfa_gp_tpu_torch.models.eg3d import networks as tnets
from hfa_gp_tpu_torch.models.eg3d import renderer as trnd
from hfa_gp_tpu_torch.models.eg3d.generator import EG3DConfig
from hfa_gp_tpu_torch.utils import convert
from tests.test_eg3d import small_config

# One intra-op thread: the suite runs several worker processes side by
# side, and a thread pool per worker as wide as the machine makes them wait
# on each other (the port's CPU tests: 468 s with the default, 216 s so).
torch.set_num_threads(1)


def torch_small_config(sampler_fine: str = "stratified") -> EG3DConfig:
    """The port's twin of tests/test_eg3d.small_config."""
    return EG3DConfig(
        mapping=tnets.MappingConfig(num_layers=2),
        backbone=tnets.BackboneConfig(img_resolution=32, channel_base=2048,
                                      channel_max=128),
        sr=tnets.SRConfig(input_resolution=16, output_resolution=64,
                          in_channels=32, block_channels=(32, 16)),
        render=trnd.RenderConfig(depth_resolution=8,
                                 depth_resolution_importance=8,
                                 neural_rendering_resolution=16,
                                 sampler_fine=sampler_fine))


def torch_small_avatar(sampler_fine: str = "stratified") -> AvatarConfig:
    return AvatarConfig(size=64, dim_shape=4,
                        eg3d=torch_small_config(sampler_fine))


def numpy_tree(tree, rng=None):
    """JAX param tree → numpy; with `rng`, random noise buffers."""
    def leaf(path, v):
        v = np.asarray(v)
        name = path[-1].key
        if rng is not None and name in ("noise_const", "noise_strength"):
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.3
        return v
    return jax.tree_util.tree_map_with_path(leaf, tree)


def drop_outputs(path) -> None:
    """Delete what a test wrote under its `path` once it has read it back:
    checkpoints and weight files of up to a few hundred MB would otherwise
    stay in pytest's base temporary directory, which keeps its last three
    runs."""
    for p in pathlib.Path(path).iterdir():
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()


def _gen_params(seed=0):
    cfg = small_config()
    jp = numpy_tree(j_init_gen(jax.random.PRNGKey(seed), cfg),
                    np.random.default_rng(seed))
    return cfg, jp, convert.from_jax(jp)


def _close(got, want, rel=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def test_convert_layouts_and_state_dict_keys(tmp_path):
    from hfa_gp_tpu.utils import pytree_io
    _, jp, tp = _gen_params()
    path = str(tmp_path / "gen.npz")
    pytree_io.save_npz(jp, path)
    flat = np.load(path)
    sd = tp.state_dict()
    assert sorted(sd) == sorted(k.replace("/", ".") for k in flat.files)
    for k in flat.files:
        v, t = flat[k], sd[k.replace("/", ".")].numpy()
        if v.ndim == 4:                                  # HWIO → OIHW
            np.testing.assert_array_equal(t, v.transpose(3, 2, 0, 1))
        elif k.endswith("/const"):                       # HWC → CHW
            np.testing.assert_array_equal(t, v.transpose(2, 0, 1))
        else:
            np.testing.assert_array_equal(t, v)
    # the npz loader rebuilds the same tree
    again = convert.from_jax(convert.load_npz(path))
    for k, v in again.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy())


def test_port_init_matches_jax_tree_structure():
    cfg = small_config()
    jp = j_init_gen(jax.random.PRNGKey(0), cfg)
    from hfa_gp_tpu_torch.models.eg3d.generator import init_generator
    tp = convert.ParamTree(init_generator(torch.Generator().manual_seed(0),
                                          torch_small_config()))
    want = {jax.tree_util.keystr(p, simple=True, separator="."):
            np.shape(v) for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = convert.ParamTree(convert.convert_tree(numpy_tree(jp))).state_dict()
    assert sorted(tp.state_dict()) == sorted(want)
    for k, v in tp.state_dict().items():
        assert tuple(v.shape) == tuple(got[k].shape), k


def test_mapping_matches_jax():
    cfg, jp, tp = _gen_params(1)
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, 512)).astype(np.float32)
    c = rng.standard_normal((3, 25)).astype(np.float32)
    for psi in (1.0, 0.7):
        want = jnets.mapping_apply(jp["mapping"], cfg.mapping, cfg.num_ws,
                                   jnp.asarray(z), jnp.asarray(c), psi)
        got = tnets.mapping_apply(tp["mapping"], tnets.MappingConfig(),
                                  cfg.num_ws, torch.from_numpy(z),
                                  torch.from_numpy(c), psi)
        _close(got.numpy(), np.asarray(want), 1e-5)


def test_backbone_planes_match_jax():
    cfg, jp, tp = _gen_params(2)
    rng = np.random.default_rng(2)
    ws = rng.standard_normal((2, cfg.num_ws, 512)).astype(np.float32)
    want = np.asarray(jnets.backbone_apply(jp["backbone"], cfg.backbone,
                                           jnp.asarray(ws)))
    tcfg = torch_small_config()
    with torch.no_grad():
        got = tnets.backbone_apply(tp["backbone"], tcfg.backbone,
                                   torch.from_numpy(ws))
    assert got.shape == (2, 96, 32, 32)
    _close(got.permute(0, 2, 3, 1).numpy(), want)
    # noise_mode="none" drops the const noise in both
    want0 = np.asarray(jnets.backbone_apply(jp["backbone"], cfg.backbone,
                                            jnp.asarray(ws),
                                            noise_mode="none"))
    with torch.no_grad():
        got0 = tnets.backbone_apply(tp["backbone"], tcfg.backbone,
                                    torch.from_numpy(ws), noise_mode="none")
    _close(got0.permute(0, 2, 3, 1).numpy(), want0)
    assert np.abs(want0 - want).max() > 1e-3


def test_superresolution_matches_jax():
    cfg, jp, tp = _gen_params(3)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 16, 16, 32)).astype(np.float32)
    ws = rng.standard_normal((2, cfg.num_ws, 512)).astype(np.float32)
    want = np.asarray(jnets.superresolution_apply(
        jp["superresolution"], cfg.sr, jnp.asarray(feats[..., :3]),
        jnp.asarray(feats), jnp.asarray(ws)))
    x = torch.from_numpy(feats).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tnets.superresolution_apply(tp["superresolution"],
                                          torch_small_config().sr,
                                          x[:, :3], x, torch.from_numpy(ws))
    assert got.shape == (2, 3, 64, 64)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_superresolution_raises_below_input_resolution():
    """It raised while the bilinear pre-resize was not ported; now 16²
    features below a 32² input resolution are resized up first, as in the
    JAX package, and the result matches JAX's."""
    cfg, jp, tp = _gen_params(4)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((1, 16, 16, 32)).astype(np.float32)
    ws = rng.standard_normal((1, cfg.num_ws, 512)).astype(np.float32)
    jsr = dataclasses.replace(cfg.sr, input_resolution=32,
                              output_resolution=128)
    want = np.asarray(jnets.superresolution_apply(
        jp["superresolution"], jsr, jnp.asarray(feats[..., :3]),
        jnp.asarray(feats), jnp.asarray(ws)))
    sr = dataclasses.replace(torch_small_config().sr, input_resolution=32,
                             output_resolution=128)
    x = torch.from_numpy(feats).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tnets.superresolution_apply(tp["superresolution"], sr, x[:, :3],
                                          x, torch.from_numpy(ws))
    assert got.shape == (1, 3, 128, 128)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("out_pose,use_softmax", [(False, False),
                                                  (True, True)])
def test_encoder_matches_jax(out_pose, use_softmax):
    from hfa_gp_tpu.models.avatar import encoder as jenc
    from hfa_gp_tpu_torch.models.avatar import encoder as tenc
    jp = numpy_tree(jenc.init_encoder(jax.random.PRNGKey(5), 32, 512, 6,
                                      out_pose))
    img = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    want = jenc.encoder_apply(jp, jnp.asarray(img), use_softmax=use_softmax)
    with torch.no_grad():
        got = tenc.encoder_apply(convert.from_jax(jp), torch.from_numpy(img),
                                 use_softmax=use_softmax)
    want, got = ((want, got) if out_pose else ((want,), (got,)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def test_pickle_converter_npz_runs_the_port_synthesis(tmp_path):
    """EG3D weights in the layout of the reference pickle, converted by
    tools/convert_pickle.py into the JAX npz, load into the port through
    `convert.load_npz` + `from_jax`; the port's synthesis then matches the
    JAX package's on all three outputs (exact path, global placement)."""
    from hfa_gp_tpu.core import camera as jcam
    from hfa_gp_tpu.models.eg3d.generator import synthesis as j_synthesis
    from hfa_gp_tpu.utils import pytree_io
    from hfa_gp_tpu_torch.models.eg3d.generator import synthesis
    from tests.test_convert import to_torch_sd
    from tools.convert_pickle import convert_generator

    cfg = small_config()
    jp = numpy_tree(j_init_gen(jax.random.PRNGKey(6), cfg),
                    np.random.default_rng(6))
    converted = convert_generator({k: v.numpy()
                                   for k, v in to_torch_sd(jp).items()})
    path = str(tmp_path / "eg3d.npz")
    pytree_io.save_npz(converted, path)
    tp = convert.from_jax(convert.load_npz(path))

    rng = np.random.default_rng(6)
    ws = rng.standard_normal((2, cfg.num_ws, 512)).astype(np.float32)
    label = np.asarray(jcam.flip_yz_label(jcam.sample_camera_label(
        None, n=2, horizontal_mean=1.7, mode=None)))
    want = j_synthesis(converted, cfg, jnp.asarray(ws), jnp.asarray(label))
    with torch.no_grad():
        got = synthesis(tp, torch_small_config("global"),
                        torch.from_numpy(ws), torch.from_numpy(label))
    for key in ("image", "image_raw", "image_depth"):
        assert tuple(got[key].shape) == want[key].shape, key
        _close(got[key].numpy(), np.asarray(want[key]))
