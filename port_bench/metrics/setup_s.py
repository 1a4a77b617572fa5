"""Seconds from the process's start to the window's first frame or step:
imports, the kernels' build or load, inputs, warm-up."""


def read(run):
    return run.setup_s
