"""The port's span log: where a reader thread's time goes, span by span.

The native log (csrc/span_log.h, in the engine library) keeps one ring per
recording thread. The device path records, per calling thread:

  h2d.block      a direction-0 CudaPath::copy, entry to return; on the
                 verified path the block copied, verified and resident
  h2d.copy       the cuMemcpyHtoDAsync chunk loop of one block (code: the
                 source's tier, COPY_TIERS): from pageable memory the
                 driver stages each chunk on the host inside these calls;
                 a registered source is read in place by the DMA; a
                 verified block from an unregistered source is staged:
                 each chunk is copied into the worker's own pinned slots
                 inside the loop, and the DMA reads the slot
  verify.wait    the verify launch through the result's fetch, the copies'
                 completions and the stream sync (code: 0 or 1 on failure)
  reg.window     CudaPath::registerWindow (code: REG_OUTCOMES)
  reg.pin        the cuMemHostRegister call (code: 0 ok, 1 refused)
  reg.unpin      the cuMemHostUnregister call (code: 0 ok, 1 failed)
  barrier.reuse  direction 2: a buffer's copies settled before its reuse

and the coordinator (coordinator.py) records coord.phase (a whole phase),
coord.wait (its live-stats wait) and coord.results (phase results,
aggregation and printing), with the phase as `arg`. `arg` is otherwise the
bytes the span moved, pinned or asked for.

Times are CLOCK_MONOTONIC nanoseconds (time.monotonic_ns()). The anchor,
read when the log is enabled, maps them onto CLOCK_REALTIME, the clock
torch.profiler stamps its host events with (to_realtime_ns).

Off (the default) a native span site costs one relaxed atomic load and a
Python span one test of a module flag. The log is on after enable(), for a
--spanfile run (SpanFile), and for the phases the coordinator starts while a
torch.profiler session records in the process (follow_profiler), so that a
profiled phase's spans can be read beside its trace.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import sys
import threading
import time
from typing import NamedTuple

import numpy as np

NAMES = ("", "h2d.block", "h2d.copy", "verify.wait", "reg.window",
         "reg.pin", "reg.unpin", "barrier.reuse", "coord.phase",
         "coord.wait", "coord.results")
NAME_IDS = {n: i for i, n in enumerate(NAMES) if n}
# reg.window's code (span_log.h RegOutcome)
REG_OUTCOMES = ("hit", "registered", "fallback_overlap",
                "fallback_in_transit", "fallback_budget",
                "fallback_no_victim", "fallback_refused", "unavailable")
# h2d.copy's code (span_log.h CopyTier)
COPY_TIERS = ("pageable", "registered", "staged")
# records per recording thread (8 MiB each, in virtual memory, of which a
# ring's pages are touched as it fills): a 51 s window of 8 MiB verified
# blocks records about 6 per block, some 35,000 per reader at 3 GiB/s over
# four readers, and would fill a ring at about 23 GiB/s
DEFAULT_CAPACITY = 1 << 18

RECORD = np.dtype([("name", "<u2"), ("code", "<u2"), ("tid", "<u4"),
                   ("t0_ns", "<u8"), ("t1_ns", "<u8"), ("arg", "<u8")])
_DRAIN_BATCH = 1 << 16


class Span(NamedTuple):
    name: str
    tid: int
    t0_ns: int  # CLOCK_MONOTONIC
    t1_ns: int
    arg: int
    code: int

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


_lock = threading.Lock()  # serialises enable, disable and drain
_on = False  # the log is on (Python's own view, read by span())
_following = False  # follow_profiler() turned it on


def _lib():
    from .engine import load_lib

    return load_lib()


def enable(capacity: int = DEFAULT_CAPACITY) -> None:
    """Start a new log of `capacity` records per thread: every record not
    drained so far is gone, the drop count restarts, the anchor is read
    anew. The rings of the last enable are reused where `capacity` is
    theirs."""
    global _on, _following
    with _lock:
        if _lib().ebt_cuda_span_enable(capacity) != 0:
            raise MemoryError(f"span log: cannot allocate {capacity} "
                              f"records per thread")
        _on, _following = True, False


def disable() -> None:
    """Stop recording; what was recorded stays drainable."""
    global _on, _following
    with _lock:
        _lib().ebt_cuda_span_disable()
        _on, _following = False, False


def is_enabled() -> bool:
    return _on


def drain() -> list[Span]:
    """Every record not drained yet, per thread in recording order."""
    out: list[Span] = []
    with _lock:
        lib = _lib()
        buf = np.empty(_DRAIN_BATCH, dtype=RECORD)
        while True:
            n = lib.ebt_cuda_span_drain(buf.ctypes.data, _DRAIN_BATCH)
            out += [Span(NAMES[r[0]], r[2], r[3], r[4], r[5], r[1])
                    for r in buf[:n].tolist()]
            if n < _DRAIN_BATCH:
                return out


def state() -> dict:
    """The log's state: on or off, capacity, records dropped since the last
    enable (full ring, or more threads than rings), the anchor pair and the
    live threads that hold a ring."""
    out = (ctypes.c_uint64 * 6)()
    _lib().ebt_cuda_span_state(out)
    return {"enabled": bool(out[0]), "capacity": out[1], "dropped": out[2],
            "anchor_realtime_ns": out[3], "anchor_monotonic_ns": out[4],
            "threads": out[5]}


def to_realtime_ns(t_ns: int, st: dict) -> int:
    """A CLOCK_MONOTONIC stamp of the log on CLOCK_REALTIME, by the anchor
    of `st` (state())."""
    return t_ns + st["anchor_realtime_ns"] - st["anchor_monotonic_ns"]


@contextlib.contextmanager
def span(name: str, arg: int = 0):
    """One span of the calling thread around the block (recorded only when
    the log was on as it opened)."""
    if not _on:
        yield
        return
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        _lib().ebt_cuda_span_record(NAME_IDS[name], 0, t0,
                                    time.monotonic_ns(), arg)


def _profiler_on() -> bool:
    torch = sys.modules.get("torch")  # no profiler without torch loaded
    if torch is None:
        return False
    try:
        return bool(torch._C._autograd._profiler_enabled())
    except AttributeError:
        return False


def follow_profiler() -> None:
    """At a phase's start: turn the log on while a torch.profiler session
    records in this process, and off again at the first phase after it
    (the records stay drainable). A log turned on by enable() is left as
    it is.

    Temporary: it stands in for the benchmark harness enabling and draining
    the log itself, and goes, with `_following`, once the harness does."""
    global _following
    profiling = _profiler_on()
    if profiling and not _on:
        enable()
        _following = True
    elif not profiling and _following:
        disable()


# ----------------------------------------------------------- --spanfile

def _event_args(s: Span) -> dict:
    if s.name == "reg.window":
        return {"bytes": s.arg, "outcome": REG_OUTCOMES[s.code]}
    if s.name == "h2d.copy":
        return {"bytes": s.arg, "tier": COPY_TIERS[s.code]}
    if s.name in ("reg.pin", "reg.unpin"):
        return {"bytes": s.arg, "ok": s.code == 0}
    if s.name.startswith("coord."):
        from .common import BenchPhase

        return {"phase": BenchPhase(s.arg).name}
    if s.name == "verify.wait":
        return {"bytes": s.arg, "ok": s.code == 0}
    return {"bytes": s.arg}


def chrome_trace(spans: list[Span], st: dict) -> dict:
    """Chrome trace-event JSON of `spans` (complete events, microseconds on
    CLOCK_REALTIME), which Perfetto opens beside a torch.profiler or Nsight
    trace of the same run."""
    pid = os.getpid()
    events = [{"name": s.name, "cat": s.name.split(".")[0], "ph": "X",
               "ts": to_realtime_ns(s.t0_ns, st) / 1e3,
               "dur": s.dur_ns / 1e3, "pid": pid, "tid": s.tid,
               "args": _event_args(s)}
              for s in sorted(spans, key=lambda s: (s.t0_ns, s.tid))]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "CLOCK_REALTIME",
                          "dropped_spans": st["dropped"]}}


class SpanFile:
    """--spanfile: the log on for the whole run, drained after each phase
    (so a ring holds one phase at most), written once at the end."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._spans: list[Span] = []
        enable()

    def collect(self) -> None:
        self._spans += drain()

    def write(self) -> None:
        self.collect()
        st = state()
        disable()
        with open(self.path, "w") as f:
            json.dump(chrome_trace(self._spans, st), f)
