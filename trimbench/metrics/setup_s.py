"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernel library, the pools, the warm files."""


def read(run):
    return run.setup_s
