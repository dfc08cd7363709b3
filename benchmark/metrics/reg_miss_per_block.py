"""reg_miss_per_block (device path): registration-cache misses per device
copy in the window (CudaPath's counters)."""


def read(run):
    copies = sum(p.submits for p in run.phases)
    if not copies:
        return None
    return sum(p.reg_misses for p in run.phases) / copies
