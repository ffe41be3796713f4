"""setup_s: seconds from the start of the process to the start of the
window (imports, the kernels' build or load, weights, inputs, warm-up)."""


def read(run):
    return run.setup_s
