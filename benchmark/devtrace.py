"""The device trace of a --trace 1 window: torch.profiler over the card,
reduced to busy time, the window's length, the operations that took most
time and the longest idle gaps.

The harness marks each phase with a host span (`portbench.phase`), so the
window is the first span's start to the last span's end on the trace's own
clock, and an idle gap is named by whether the host was inside a phase or
between two. The reduction works on plain tuples, so the tests feed it
events of their own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN = "portbench.phase"
TOP = 10


@dataclass
class Event:
    name: str
    device: int  # -1 for a host event
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float  # mean over the cards used
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[what, seconds]]
    op_s: dict = field(default_factory=dict)  # device seconds by name

    def seconds_of(self, needle: str) -> float:
        return sum(s for n, s in self.op_s.items() if needle in n)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: list[Event], devices: int) -> TraceSummary | None:
    """None when no phase span was traced."""
    spans = _union([(e.start_ns, e.end_ns) for e in events
                    if e.device < 0 and e.name == SPAN])
    if not spans:
        return None
    w0, w1 = spans[0][0], spans[-1][1]
    op_s: dict[str, float] = {}
    per_dev: dict[int, list[tuple[int, int]]] = {}
    for e in events:
        if e.device < 0:
            continue
        a, b = max(e.start_ns, w0), min(e.end_ns, w1)
        if b <= a:
            continue
        op_s[e.name] = op_s.get(e.name, 0.0) + (b - a) / 1e9
        per_dev.setdefault(e.device, []).append((a, b))
    busy = 0.0
    gaps: list[tuple[float, str]] = []
    for dev in range(max(devices, 1)):
        merged = _union(per_dev.get(dev, []))
        busy += sum(b - a for a, b in merged) / 1e9
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                mid = (a + b) // 2
                inside = any(s <= mid < t for s, t in spans)
                what = "in_phase" if inside else "between_phases"
                gaps.append(((b - a) / 1e9, f"{what}@dev{dev}"))
    gaps.sort(reverse=True)
    ops = sorted(op_s.items(), key=lambda kv: -kv[1])
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy / max(devices, 1),
        device_ops=[[n[:96], s] for n, s in ops[:TOP]],
        idle_gaps=[[w, s] for s, w in gaps[:TOP]], op_s=op_s)


def _events(prof) -> list[Event]:
    from torch.autograd import DeviceType

    out = []
    for k in prof.profiler.kineto_results.events():
        try:
            start, dur = k.start_ns(), k.duration_ns()
        except AttributeError:  # older builds count in microseconds
            start, dur = k.start_us() * 1000, k.duration_us() * 1000
        on_dev = k.device_type() == DeviceType.CUDA
        out.append(Event(k.name(), k.device_index() if on_dev else -1,
                         int(start), int(start + dur)))
    return out


class DeviceTrace:
    """torch.profiler over CPU and CUDA activity for the window."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def __enter__(self) -> "DeviceTrace":
        self._prof.start()
        return self

    def __exit__(self, *exc) -> None:
        self._prof.stop()

    @staticmethod
    def phase():
        from torch.profiler import record_function

        return record_function(SPAN)

    def summary(self, devices: int) -> TraceSummary | None:
        return summarize(_events(self._prof), devices)
