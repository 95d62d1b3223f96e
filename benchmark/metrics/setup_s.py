"""Seconds from the process's start to the window's start: imports, kernels,
the frames rendered, the pipeline built and warmed up."""


def read(w):
    return w.setup_s
