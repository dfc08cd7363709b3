"""read_gib_s: every byte that reached device memory in the window, over
the window's whole time (host clock), in GiB/s."""


def read(run):
    return run.landed_bytes / run.window_s / float(1 << 30)
