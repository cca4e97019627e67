"""setup_s: the host clock from the process's launch to the window's
opening (imports, weights, kernel builds on a checkout's first run,
warm-up)."""


def read(run):
    return run.setup_s
