"""Process start to the window's start: imports, the kernel library's build
(in a checkout's first run), the model, the seeded inputs, the checked and
warm-up steps or requests."""


def read(run):
    return run.setup_s
