"""Server layer: the median host milliseconds a request spends in
``generate``, from its call to its return, before the images are copied
to the host (host clock, every request of the window)."""

import numpy as np


def read(run):
    host = run.window.get("host_ms")
    if not host:
        return None
    return float(np.median(host))
