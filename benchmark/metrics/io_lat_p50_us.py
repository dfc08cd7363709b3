"""io_lat_p50_us (native engine): the median of the engine's IO latency
histogram over the window (log2 buckets, four to an octave: the value
moves in steps of 12.5-25%)."""


def read(run):
    hist = None
    for p in run.phases:
        if hist is None:
            hist = type(p.histo)()
        hist += p.histo
    if hist is None or not hist.count:
        return None
    return float(hist.percentile_us(50))
