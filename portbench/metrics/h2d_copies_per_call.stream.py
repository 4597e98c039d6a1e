"""Host tensors the program's entry copied to the card per call (its
``tracker.HOST_COPIES``): copies over calls over the whole process, not
the measured window's delta, so the set-up's, warm-up's and capture's
calls count too (each known.stream call copies the same five leaves);
read in a traced run."""
from portbench import inside


def read(r):
    if r.trace is None:
        return None
    return inside.h2d_copies_per_call()
