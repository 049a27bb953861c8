"""Seconds from the process's start to the window's start: the imports,
the kernels' load (or build), the inputs, the warm-up."""


def read(run):
    return run.setup_s
