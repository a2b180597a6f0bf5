"""Seconds from the process's start to the measured window: imports, the
CUDA context, the kernels' build or load, the state from the seed and the
warm-up of every shape the cell's traffic uses (host clock)."""


def read(run):
    return run.setup_s
