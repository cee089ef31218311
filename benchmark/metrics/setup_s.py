"""Seconds from the process's start to the first timed call: imports, the
CUDA context, loading (and in a fresh checkout building) the kernels,
making the inputs and warming every batch of the pool."""


def read(run):
    return run.setup_s
