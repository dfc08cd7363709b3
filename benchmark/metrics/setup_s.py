"""setup_s: process start to the window's start: data set, the port's
configuration and prepare, and the untimed warm-up phase."""


def read(run):
    return run.setup_s
