"""staged_fallback_per_block (device path): registration windows that fell
back to pageable (staged) copies, per device copy in the window."""


def read(run):
    copies = sum(p.submits for p in run.phases)
    if not copies:
        return None
    return sum(p.staged_fallbacks for p in run.phases) / copies
