"""The port's span record (`utils/observability.annotate`, `spans`,
`drain`): nothing entered without a recording profile; under one, each
region kept on `time.time_ns` with its parent and unit on its own thread,
inside kineto's event of the same name; and the span trees of the
fitting step, RGB reenactment, audio reenactment and the arcface step
(dense and row-sparse) at a tiny width."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hfa_gp_tpu_torch.cli import run_recon_video_rgb
from hfa_gp_tpu_torch.core import camera
from hfa_gp_tpu_torch.models import lpips as lpips_mod
from hfa_gp_tpu_torch.models.avatar import heads
from hfa_gp_tpu_torch.models.eg3d import generator as gen
from hfa_gp_tpu_torch.models.eg3d import networks as nets
from hfa_gp_tpu_torch.models.eg3d import renderer as rnd
from hfa_gp_tpu_torch.parallel.partial_fc import PartialFC
from hfa_gp_tpu_torch.train import arcface, audio, rgb
from hfa_gp_tpu_torch.train.state import init_state
from hfa_gp_tpu_torch.utils import observability
from hfa_gp_tpu_torch.utils.convert import ParamTree

torch.set_num_threads(1)

CFG = heads.AvatarConfig(size=32, dim_shape=4, eg3d=gen.EG3DConfig(
    backbone=nets.BackboneConfig(img_resolution=16, img_channels=24,
                                 channel_base=256, channel_max=32),
    sr=nets.SRConfig(input_resolution=8, output_resolution=32,
                     in_channels=8, block_channels=(16, 8)),
    render=rnd.RenderConfig(depth_resolution=4, depth_resolution_importance=4,
                            neural_rendering_resolution=8, decoder_hidden=16,
                            decoder_output_dim=8, sampler_depth_window=2)))
SYNTHESIS = ["backbone", "render", "superres"]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def tree(record):
    """(name, parent's name) of each span; every span in one unit."""
    assert {unit for *_, unit, _ in record} == {0}
    return [(name, None if parent is None else record[parent][0])
            for name, _, _, parent, _, _ in record]


@pytest.fixture(autouse=True)
def empty_record():
    observability.drain()
    yield
    observability.drain()


def test_without_a_profile_nothing_is_entered_or_kept(monkeypatch):
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name) or real(name))
    with observability.annotate("outer"):
        with observability.annotate("inner"):
            pass
    assert calls == [] and observability.spans() == []
    with cpu_profile():
        with observability.annotate("outer"):
            pass
    assert calls == ["outer"]
    assert [s[0] for s in observability.spans()] == ["outer"]


def test_the_profiler_state_flips_under_a_profile_and_back():
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with cpu_profile():
        assert flag() is True
    assert flag() is False
    # the benchmark's window records the device alone: no host activity
    if torch.cuda.is_available():
        with profile(activities=[ProfilerActivity.CUDA]):
            assert flag() is True
        assert flag() is False


def test_nested_spans_on_two_threads_keep_their_parents_and_units():
    entered, go_on = threading.Event(), threading.Event()

    def other():
        with observability.annotate("b_unit"):
            with observability.annotate("b_child"):
                entered.set()
                go_on.wait(10)

    with cpu_profile():
        with observability.annotate("a_unit"):
            t = threading.Thread(target=other)
            t.start()
            assert entered.wait(10)
            with observability.annotate("a_child"):
                with observability.annotate("a_grandchild"):
                    pass
            go_on.set()
            t.join(10)
            assert not t.is_alive()
        with observability.annotate("a_next"):
            pass
    rec = observability.spans()
    by = {s[0]: i for i, s in enumerate(rec)}
    assert sorted(by) == ["a_child", "a_grandchild", "a_next", "a_unit",
                          "b_child", "b_unit"]
    want = {"a_unit": (None, "a_unit"), "a_child": ("a_unit", "a_unit"),
            "a_grandchild": ("a_child", "a_unit"),
            "b_unit": (None, "b_unit"), "b_child": ("b_unit", "b_unit"),
            "a_next": (None, "a_next")}
    for name, (parent, unit) in want.items():
        _, start, end, p, u, thread = rec[by[name]]
        assert p == (None if parent is None else by[parent]), name
        assert u == by[unit], name
        assert start <= end
    assert rec[by["a_unit"]][5] == rec[by["a_child"]][5] \
        != rec[by["b_unit"]][5] == rec[by["b_child"]][5]
    assert observability.drain() == rec and observability.spans() == []


def test_each_record_lies_inside_kinetos_event_of_the_same_name():
    with cpu_profile() as prof:
        for _ in range(3):
            with observability.annotate("unit"):
                with observability.annotate("child"):
                    torch.ones(64).sum()
                torch.ones(64).mul(2)
    events: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("unit", "child"):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    rec = observability.spans()
    for name in ("unit", "child"):
        mine = [(s, e) for n, s, e, *_ in rec if n == name]
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 3
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert ks <= s and e <= ke, (name, s - ks, ke - e)
            assert s - ks < 1_000_000


def test_the_record_drops_its_oldest_spans(monkeypatch):
    monkeypatch.setattr(observability, "_RECORD", observability._Record(3))
    with cpu_profile():
        with observability.annotate("u"):
            for i in range(4):
                with observability.annotate(f"c{i}"):
                    pass
    rec = observability.spans()
    assert [s[0] for s in rec] == ["c1", "c2", "c3"]
    assert all(s[3] is None and s[4] is None for s in rec)   # u dropped


def _image_and_label(b):
    g = torch.Generator().manual_seed(3)
    image = torch.rand((b, CFG.size, CFG.size, 3), generator=g) * 2 - 1
    label = camera.flip_yz_label(camera.sample_camera_label(
        None, mode=None)).repeat(b, 1)
    return image, label


def test_the_fitting_step_gives_its_span_tree():
    g = torch.Generator().manual_seed(0)
    state = init_state(heads.init_avatar_rgb(g, CFG))
    lp = ParamTree(lpips_mod.init_lpips(g))
    image, label = _image_and_label(2)
    with cpu_profile():
        rgb.train_step(state, lp, CFG, image, label, 0)
    assert tree(observability.spans()) == [
        ("train_step", None), ("forward", "train_step"),
        *[(s, "forward") for s in SYNTHESIS],
        ("backward", "train_step"), ("optimizer", "train_step")]


def test_rgb_reenactment_gives_its_span_tree():
    params = heads.init_avatar_rgb(torch.Generator().manual_seed(0), CFG)
    image, label = _image_and_label(2)
    with cpu_profile(), torch.inference_mode():
        run_recon_video_rgb.reenact(params, CFG, image, label)
    assert tree(observability.spans()) == [
        ("reenact", None), ("encoder", "reenact"), ("subspace", "reenact"),
        ("synthesis", "reenact"), *[(s, "synthesis") for s in SYNTHESIS]]


def test_audio_reenactment_gives_its_span_tree():
    params = audio.init_audio_params(torch.Generator().manual_seed(0), CFG)
    window = torch.randn((2, CFG.smo_size, CFG.win_size, 29),
                         generator=torch.Generator().manual_seed(1))
    _, label = _image_and_label(2)
    with cpu_profile():
        audio.sample(params, CFG, window, label, smooth=True)
    assert tree(observability.spans()) == [
        ("audio_sample", None), ("audio_encoder", "audio_sample"),
        ("subspace", "audio_sample"), ("synthesis", "audio_sample"),
        *[(s, "synthesis") for s in SYNTHESIS]]


@pytest.mark.parametrize("sample_rate", [1.0, 0.25])
def test_the_arcface_step_gives_its_span_tree(sample_rate):
    pfc = PartialFC(64, 512, m2=0.0, m3=0.4, sample_rate=sample_rate)
    tx, fc_tx = arcface.make_optimizers(10)
    g = torch.Generator().manual_seed(0)
    state = arcface.init_state(g, pfc, tx, fc_tx, "iresnet18")
    step = arcface.make_train_step(pfc, tx, fc_tx, "iresnet18")
    images = torch.rand((4, 112, 112, 3), generator=g) * 2 - 1
    labels = torch.randint(64, (4,), generator=g)
    with cpu_profile():
        step(state, images, labels, g)
    sample = [("sample", "forward")] if sample_rate < 1 else []
    assert tree(observability.spans()) == [
        ("train_step", None), ("forward", "train_step"),
        ("embed", "forward"), *sample, ("margin_ce", "forward"),
        ("backward", "train_step"), ("optimizer", "train_step"),
        ("head_update", "optimizer")]
