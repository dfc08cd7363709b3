"""verify_roofline (kernels): the verify kernel's share of its roofline
over the traced window: the least time the bytes it checked need at the
card's memory bandwidth (peaks.py) over its device time in the trace."""

from benchmark import peaks


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.seconds_of("verify_u32_kernel")
    if kernel_s <= 0:
        return None
    return 100.0 * peaks.verify_min_s(run.landed_bytes) / kernel_s
