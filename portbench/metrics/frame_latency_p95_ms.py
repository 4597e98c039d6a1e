"""95th percentile, over every frame of the window, of the host-clock time
from handing a frame's images to the entry to its pose being readable on
the host."""
import numpy as np


def read(r):
    return float(np.percentile(r.latencies_s, 95)) * 1e3 if r.latencies_s else None
