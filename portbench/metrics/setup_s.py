"""Set-up seconds: process start to the first timed call (import, CUDA
initialisation, traffic, weights, the warm-up and capture of the cell's
own shapes)."""


def read(r):
    return r.setup_s
