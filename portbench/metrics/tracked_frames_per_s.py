"""Four-camera frames (two hands each) tracked in the window, over the
window's seconds on the host clock, every call's work finished."""


def read(r):
    return r.units / r.window_s
