"""reg_call_share (device path): the readers' time inside the registration
cache's window requests (span reg.window: lookup, evictions, and the pin the
driver may refuse), in % of the readers' time (portspans.py)."""

from benchmark import portspans


def read(run):
    return portspans.share(run, "reg.window")
