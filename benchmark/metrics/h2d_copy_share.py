"""h2d_copy_share (device path): the readers' time inside the device
copies' chunk loop (span h2d.copy: the cuMemcpyHtoDAsync calls of a block,
in which the driver stages a pageable source on the host), in % of the
readers' time (portspans.py)."""

from benchmark import portspans


def read(run):
    return portspans.share(run, "h2d.copy")
