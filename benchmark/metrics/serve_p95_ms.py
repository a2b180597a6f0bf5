"""The 95th percentile of the window's request latencies, each from the
call of ``generate`` to its images in host memory (host clock; every
request of the window)."""

import numpy as np


def read(run):
    latency = run.window.get("latency_ms")
    if not latency:
        return None
    return float(np.percentile(latency, 95))
