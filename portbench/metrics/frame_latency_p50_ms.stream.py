"""Median of the same per-frame latencies as ``frame_latency_p95_ms``."""
import numpy as np


def read(r):
    return float(np.percentile(r.latencies_s, 50)) * 1e3 if r.latencies_s else None
