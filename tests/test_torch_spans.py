"""The port's span log (csrc/span_log.h, elbencho_tpu_torch/spans.py) on the
CPU, behind the mock CUDA driver.

- Off, a verified read records nothing and drops nothing.
- On, a verified read of N blocks records N h2d.block spans, each with one
  h2d.copy and one verify.wait inside it on its thread, and one reg.window
  per block whose outcome says how the window request ended (a hit, a new
  pin, or the driver's refusal under EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER).
- A ring too small for its thread counts what it drops and never blocks.
- A second enable of the same capacity reuses the rings, and a thread that
  exits gives its ring back.
- The anchor puts the log's spans onto torch.profiler's clock.
- --spanfile writes the run's spans as Chrome trace-event JSON.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import time

import pytest

from elbencho_tpu_torch import cli, engine, spans
from elbencho_tpu_torch.common import BenchPhase

BLOCKS = 4
SALT = 5


@pytest.fixture
def mock(monkeypatch, tmp_path):
    """The port on the CPU behind its mock driver, no mock seam set, a file
    of BLOCKS verified 1 MiB blocks, and the span log off afterwards."""
    for k in list(os.environ):
        if k.startswith("EBT_MOCK_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", engine.build_mock())
    path = str(tmp_path / "f")
    assert cli.main(["-w", *_args(path)]) == 0
    ctypes.CDLL(engine.build_mock()).ebt_mock_reset()  # the seams' counts
    yield path
    spans.disable()
    spans.drain()


def _args(path: str, *extra: str) -> list[str]:
    return ["-t", "1", "-s", f"{BLOCKS}M", "-b", "1M", "--verify", str(SALT),
            "--tpubackend", "pjrt", "--nolive", *extra, path]


def _read(path: str, *extra: str) -> list[spans.Span]:
    assert cli.main(["-r", *_args(path, *extra)]) == 0
    return spans.drain()


def _inside(outer: spans.Span, got: list[spans.Span], name: str):
    return [s for s in got if s.name == name and s.tid == outer.tid
            and outer.t0_ns <= s.t0_ns <= s.t1_ns <= outer.t1_ns]


def test_off_records_nothing(mock):
    spans.enable(64)
    spans.disable()
    spans.drain()
    assert _read(mock) == []
    st = spans.state()
    assert not st["enabled"] and st["dropped"] == 0


def test_verified_read_spans_nest_per_block(mock):
    spans.enable()
    got = _read(mock)
    assert spans.state()["dropped"] == 0
    blocks = [s for s in got if s.name == "h2d.block"]
    assert len(blocks) == BLOCKS
    assert all(b.arg == 1 << 20 for b in blocks)
    for b in blocks:
        copies = _inside(b, got, "h2d.copy")
        waits = _inside(b, got, "verify.wait")
        assert len(copies) == 1 and len(waits) == 1
        assert copies[0].arg == waits[0].arg == 1 << 20
        # the verify waits behind the copies it checks
        assert copies[0].t1_ns <= waits[0].t0_ns
    windows = [s for s in got if s.name == "reg.window"]
    assert len(windows) == BLOCKS
    assert {w.tid for w in windows} == {b.tid for b in blocks}
    outcomes = [spans.REG_OUTCOMES[w.code] for w in windows]
    # the first block pins the file's window, the others are inside it
    assert outcomes == ["registered"] + ["hit"] * (BLOCKS - 1)
    pins = _inside(windows[0], got, "reg.pin")
    assert [(p.code, p.arg) for p in pins] == [(0, BLOCKS << 20)]
    assert all(not _inside(w, got, "reg.pin") for w in windows[1:])
    assert all(c.code == spans.COPY_TIERS.index("registered")
               for b in blocks for c in _inside(b, got, "h2d.copy"))
    phases = [s for s in got if s.name == "coord.phase"]
    assert len(phases) == 1 and phases[0].arg == int(BenchPhase.READFILES)
    for name in ("coord.wait", "coord.results"):
        assert len(_inside(phases[0], got, name)) == 1


def test_refused_pin_is_named(mock, monkeypatch):
    # the init probe's pin succeeds (the registered tier is engaged), every
    # pin after it is refused
    monkeypatch.setenv("EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER", "1")
    spans.enable()
    got = _read(mock)
    windows = [s for s in got if s.name == "reg.window"]
    assert [spans.REG_OUTCOMES[w.code] for w in windows] == \
        ["fallback_refused"] * BLOCKS
    tid = windows[0].tid
    for w in windows:  # each refusal is the pin inside its window request
        assert [p.code for p in _inside(w, got, "reg.pin")] == [1]
    # the unregistered blocks go through the worker's pinned slots
    copies = [s for s in got if s.name == "h2d.copy" and s.tid == tid]
    assert [c.code for c in copies] == \
        [spans.COPY_TIERS.index("staged")] * BLOCKS


def test_small_ring_drops_and_does_not_block(mock):
    spans.enable(4)
    for i in range(20):
        with spans.span("coord.wait", i):
            pass
    kept = spans.drain()
    assert [s.arg for s in kept] == [0, 1, 2, 3]
    assert spans.state()["dropped"] == 16
    # a reader thread over its ring: the read completes, drops are counted
    spans.enable(4)
    t0 = time.monotonic()
    got = _read(mock)
    assert time.monotonic() - t0 < 60
    per_tid: dict[int, int] = {}
    for s in got:
        per_tid[s.tid] = per_tid.get(s.tid, 0) + 1
    assert max(per_tid.values()) <= 4
    assert spans.state()["dropped"] > 0


def test_reenable_reuses_rings_and_threads_give_them_back(mock):
    """An enable of the same capacity empties the log and restarts its drop
    count; a thread's ring is free again once the thread exits, so short
    threads, more of them than there are rings, drop nothing."""
    import threading

    spans.enable(8)
    for i in range(12):
        with spans.span("coord.wait", i):
            pass
    assert spans.state()["dropped"] == 4
    spans.enable(8)
    st = spans.state()
    assert st["dropped"] == 0 and st["capacity"] == 8
    assert spans.drain() == []

    def one(i):
        with spans.span("coord.results", i):
            pass

    got = []
    for i in range(100):  # one ring serves them in turn, drained as it goes
        t = threading.Thread(target=one, args=(i,))
        t.start()
        t.join()
        if i % 4 == 3:
            got += spans.drain()
    assert sorted(s.arg for s in got) == list(range(100))
    assert spans.state()["dropped"] == 0


def test_anchor_meets_the_profiler_clock():
    """Nine record_function/span pairs opened back to back: their starts,
    the span's converted by the anchor, lie within 2 ms at the median (a
    session's first record_function takes longer to open than the others,
    and a loaded host may preempt between the two of one pair)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.enable(64)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(9):
                with record_function(f"span_probe{i}"):
                    with spans.span("coord.phase", i):
                        pass
        st = spans.state()
        mine = {s.arg: s for s in spans.drain() if s.name == "coord.phase"}
    finally:
        spans.disable()
    theirs = {}
    for k in prof.profiler.kineto_results.events():
        if k.name().startswith("span_probe"):
            try:
                theirs[int(k.name()[10:])] = k.start_ns()
            except AttributeError:  # older builds count in microseconds
                theirs[int(k.name()[10:])] = k.start_us() * 1000
    assert sorted(mine) == sorted(theirs) == list(range(9))
    gaps = [abs(spans.to_realtime_ns(mine[i].t0_ns, st) - theirs[i])
            for i in range(9)]
    assert statistics.median(gaps) < 2_000_000


def test_follow_profiler_records_profiled_phases_only(mock):
    from torch.profiler import ProfilerActivity, profile

    spans.disable()
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(["-r", *_args(mock)]) == 0
    assert spans.is_enabled()  # on until a phase starts unprofiled
    assert cli.main(["-r", *_args(mock)]) == 0
    assert not spans.is_enabled()
    got = spans.drain()
    assert len([s for s in got if s.name == "coord.phase"]) == 1
    assert len([s for s in got if s.name == "h2d.block"]) == BLOCKS


def test_spanfile_writes_chrome_trace(mock, tmp_path, capfd):
    out = tmp_path / "spans.json"
    capfd.readouterr()
    before = time.time_ns()
    assert cli.main(["-r", *_args(mock, "--spanfile", str(out))]) == 0
    after = time.time_ns()
    plain = capfd.readouterr().out
    assert cli.main(["-r", *_args(mock)]) == 0
    # the flag adds no line to the result tree
    assert len(plain.splitlines()) == len(capfd.readouterr().out.splitlines())
    trace = json.loads(out.read_text())
    events = trace["traceEvents"]
    assert trace["otherData"]["dropped_spans"] == 0
    names = [e["name"] for e in events]
    assert names.count("h2d.block") == BLOCKS
    assert names.count("coord.phase") == 1
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert all(before / 1e3 - 1e6 <= e["ts"] <= after / 1e3 + 1e6
               for e in events)
    window = next(e for e in events if e["name"] == "reg.window")
    assert window["args"]["outcome"] == "registered"
    assert not spans.is_enabled()
