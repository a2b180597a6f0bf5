"""Device layer, training: the share of the traced window in which no
kernel, copy or set ran on the card (the union of the device trace's
intervals)."""


def read(run):
    if run.trace is None or "steps" not in run.traced:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
