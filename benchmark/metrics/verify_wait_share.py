"""verify_wait_share (kernels): the readers' time from the verify kernel's
launch to its result on the host (span verify.wait: the launch, the result's
fetch, the copies' completions and the stream sync), in % of the readers'
time (portspans.py)."""

from benchmark import portspans


def read(run):
    return portspans.share(run, "verify.wait")
