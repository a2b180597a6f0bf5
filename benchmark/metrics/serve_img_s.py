"""Images delivered to host memory per second over the window (host
clock)."""


def read(run):
    if "requests" not in run.window:
        return None
    return run.window["images"] / run.window["seconds"]
