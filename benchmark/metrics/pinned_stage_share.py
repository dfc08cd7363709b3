"""pinned_stage_share (device path): of the bytes the h2d.copy spans of the
traced window moved, the share that went through the readers' own pinned
chunk slots (tier `staged`: a verified block whose source is not
registered is copied into the slots on the reader's thread, and the DMA
reads the slot), in %. A port whose span log has no such tier gives
nothing, as does a log that dropped records (portspans.py)."""

from benchmark import portspans


def read(run):
    got = portspans.window_spans(run)
    if not got:
        return None
    from elbencho_tpu_torch.spans import COPY_TIERS

    if "staged" not in COPY_TIERS:
        return None
    staged = COPY_TIERS.index("staged")
    copies = [s for s in got if s.name == "h2d.copy"]
    total = sum(s.arg for s in copies)
    if not total:
        return None
    return 100.0 * sum(s.arg for s in copies if s.code == staged) / total
