"""mlp_ms: device ms a step of the kernels launched under the port's `mlp`
spans (`models/arcface/vit.vit_apply`: each block's ln2, fc1, ReLU6, fc2,
drop path and the residual; the forward alone), over the steps run after
the window under the profiler of host operations, the spans read from the
port's own record as `attention_ms` reads them."""

from .attention_ms import span_ms


def read(run):
    return span_ms(run, "mlp")
