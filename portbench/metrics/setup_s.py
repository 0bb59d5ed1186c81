"""Seconds from the process's start to the window's: imports, the kernel
build or load, weights from the seed, the runtime and its programs, and
the warm-up."""


def read(run):
    return run.setup_s
