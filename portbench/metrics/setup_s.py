"""Seconds from the start of the process to the window's start: imports,
CUDA context, kernels and libraries from the checkout's cache, inputs, and
the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
