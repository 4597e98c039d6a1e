"""The window's seconds over the optimizer steps completed in it, every
step's work finished."""


def read(r):
    return r.window_s / r.units * 1e3
