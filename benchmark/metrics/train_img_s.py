"""Images trained per second over the window: every step's batch, over
the seconds from the window's start to the synchronisation that ends it
(host clock)."""


def read(run):
    if "steps" not in run.window:
        return None
    return run.window["images"] / run.window["seconds"]
