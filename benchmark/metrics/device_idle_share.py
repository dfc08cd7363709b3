"""device_idle_share (device): the share of the traced window in which no
copy or kernel ran on the card (torch.profiler), mean over the cards."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
