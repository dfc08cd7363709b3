"""The port's spans of a --trace 1 window, for the readers of the metrics
that time a layer from inside (metrics/h2d_copy_share.py,
reg_call_share.py, verify_wait_share.py, block_resident_p50_us.py).

The port records its span log (elbencho_tpu_torch/spans.py) for the phases
its coordinator starts while torch.profiler records, which in a run of the
harness is the traced window alone. The first reader of a run drains the log
once and prints its size and drops on standard error; every reader of that
run shares what it got. A port without the log gives nothing, and the
readers return nothing. So does a log that dropped records (a full ring, or
more recording threads than rings): the lost spans would make every share
read low, and a faster path, which fills the rings sooner, read better.

A share divides by the readers' time: in each window phase, the threads
that recorded a span of the device path, each counted for the phase's
engine time (the slowest worker's), summed over the window's phases.
"""

from __future__ import annotations

import bisect
import sys

_CACHE: dict = {}  # id(run) -> (run, spans or None)


def _drain():
    """(spans, state) of the port's log, or None where the port has none."""
    try:
        from elbencho_tpu_torch import spans
    except ImportError:
        return None
    got = spans.drain()
    return got, spans.state()


def window_spans(run) -> list | None:
    """The spans the port recorded in the traced window of `run`, drained
    once per run; None off a traced run, where nothing was recorded, or
    where the log dropped records."""
    if run.trace is None:
        return None
    hit = _CACHE.get(id(run))
    if hit is not None and hit[0] is run:
        return hit[1]
    drained = _drain()
    got = None
    if drained is not None and drained[0]:
        got, st = drained
        print(f"portbench: span log: {len(got)} spans from "
              f"{len({s.tid for s in got})} threads, {st['dropped']} "
              f"dropped", file=sys.stderr)
        if st["dropped"]:
            got = None
    _CACHE.clear()
    _CACHE[id(run)] = (run, got)
    return got


def readers_s(run, got: list) -> float | None:
    """The readers' time of the window (module docstring), or None when
    the coordinator's phase spans do not match the window's phases."""
    phases = sorted((s for s in got if s.name == "coord.phase"),
                    key=lambda s: s.t0_ns)
    if len(phases) != len(run.phases):
        return None
    dev = sorted((s for s in got if not s.name.startswith("coord.")),
                 key=lambda s: s.t0_ns)
    starts = [s.t0_ns for s in dev]
    total = 0.0
    for ph, rec in zip(phases, run.phases):
        lo = bisect.bisect_left(starts, ph.t0_ns)
        hi = bisect.bisect_left(starts, ph.t1_ns)
        total += len({s.tid for s in dev[lo:hi]}) * rec.engine_s
    return total or None


def share(run, name: str) -> float | None:
    """Spans called `name` over the readers' time, in %."""
    got = window_spans(run)
    if not got:
        return None
    readers = readers_s(run, got)
    if readers is None:
        return None
    busy = sum(s.t1_ns - s.t0_ns for s in got if s.name == name)
    return 100.0 * busy / 1e9 / readers
