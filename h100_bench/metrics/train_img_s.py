"""Training images of all steps in the window over the window's time (the
window ends after a final synchronize)."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 and run.kind == "train" else None
