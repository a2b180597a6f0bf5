"""Device layer, serving: the share of the traced window of requests in
which no kernel, copy or set ran on the card."""


def read(run):
    if run.trace is None or "requests" not in run.traced:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
