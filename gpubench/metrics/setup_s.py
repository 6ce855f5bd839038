"""Seconds from the start of the process to the window: imports, the
genome and the stages made from the seed, the engine, the kernels'
build on a checkout's first run and their load, and the warm-up."""


def read(run):
    return run.setup_s
