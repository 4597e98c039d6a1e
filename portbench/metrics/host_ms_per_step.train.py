"""Median host milliseconds of a training step's submission: the window
draw and the train step's call, to its return."""


def read(r):
    return r.median_ms("step")
