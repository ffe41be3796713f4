"""audio_encoder_ms: device ms a batch of the kernels launched under the
port's `audio_encoder` range (`train/audio.sample`: AudioNet and
AudioAttNet), over the units run after the window under the profiler of
host operations (`attribute`)."""

from ..trace import under_ns


def read(run):
    if run.attribution is None:
        return None
    ns, n = under_ns(run.attribution, lambda name: name == "audio_encoder")
    return ns / 1e6 / run.attribution_units if n else None
