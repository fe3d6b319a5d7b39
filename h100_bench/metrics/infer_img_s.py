"""Images of all completed requests over the window's time."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 and run.kind == "serve" else None
