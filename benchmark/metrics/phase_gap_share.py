"""phase_gap_share (coordinator and workers): the share of the window
outside the engine's phases, each phase taken on the engine's own clock
(the slowest worker's phase time)."""


def read(run):
    engine = sum(p.engine_s for p in run.phases)
    return 100.0 * max(0.0, run.window_s - engine) / run.window_s
