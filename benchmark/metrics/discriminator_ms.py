"""discriminator_ms: device ms a step of the kernels launched under the
port's `discriminator` spans (`train/eg3d_gan.run_D`: every forward of
the dual discriminator, on fakes in Gmain and Dmain, on reals in Dmain
and Dreg; the forward alone, since autograd launches the backward from
its own thread and R1's input gradient is taken outside the span), over
the steps run after the window under the profiler of host operations,
the spans read from the port's own record as `attention_ms` reads
them."""

from .attention_ms import span_ms


def read(run):
    return span_ms(run, "discriminator")
