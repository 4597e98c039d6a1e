"""CUDA graphs the program captured during the window (its
``tracker.compiled.CAPTURES``): each one a key the warm-up missed, work
redone inside the measured time."""


def read(r):
    return r.captures
