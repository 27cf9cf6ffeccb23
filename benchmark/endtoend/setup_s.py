"""Seconds from the process's start to the window's first step: imports,
the kernels' load (or build, on a checkout's first run), weights, data on
the card, the check steps and the warm-up."""


def read(run):
    return run.setup_s
