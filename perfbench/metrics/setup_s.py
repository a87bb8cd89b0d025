"""Seconds from the start of the process to the end of set-up: imports,
CUDA start, X, the POD, the model, the kernel library's build or load, the
first epochs and one checkpoint written."""


def read(run):
    return run.setup_s
