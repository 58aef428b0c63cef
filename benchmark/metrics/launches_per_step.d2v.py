"""CUDA kernels a d2v step in the traced steps of the window."""

from benchmark.lib.readers import launches_per_step


def read(ctx):
    return launches_per_step(ctx)
