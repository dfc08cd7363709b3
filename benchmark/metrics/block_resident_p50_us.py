"""block_resident_p50_us (device path): the exact median time of one block
in the device path (span h2d.block: a direction-0 copy from its call to its
return; on the verified path the block copied, verified and resident), in
microseconds. The inside reading of io_lat_p50_us, which also counts each
block's wait in the engine's queue of outstanding blocks."""

import statistics

from benchmark import portspans


def read(run):
    got = portspans.window_spans(run)
    blocks = [s.t1_ns - s.t0_ns for s in got or () if s.name == "h2d.block"]
    if not blocks:
        return None
    return statistics.median(blocks) / 1e3
