"""Seconds from the process's start to the window's first call:
imports, CUDA contexts, the build of the kernels where none is cached,
``Session.open``, the benchmark's lattice and one warm-up call."""


def read(ctx):
    return ctx.setup_s
