"""The share of the traced window's wall time in which no operation ran on
the device: one less the union of the trace's operation intervals over the
window."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return (1.0 - r.trace.busy_s / r.trace.window_s) * 100.0
