"""The readers of the port's spans (portspans.py and the metrics that use it)
on spans of known times, and where they have nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import portspans, spec
from elbencho_tpu_torch.spans import Span

MS = 1_000_000
SPAN_METRICS = ("h2d_copy_share", "reg_call_share", "verify_wait_share",
                "block_resident_p50_us")


def _run(*engine_s: float, traced: bool = True):
    return SimpleNamespace(
        trace=object() if traced else None,
        phases=[SimpleNamespace(engine_s=e) for e in engine_s])


def _spans() -> list[Span]:
    """Two window phases: threads 11 and 12 read in the first (1 s of
    engine time), thread 11 alone in the second (2 s): 4 s of readers."""
    def s(name, tid, a_ms, b_ms, code=0):
        return Span(name, tid, a_ms * MS, b_ms * MS, 1 << 23, code)

    return [
        s("coord.phase", 1, 0, 1100), s("coord.wait", 1, 5, 1050),
        s("coord.phase", 1, 1200, 3300),
        s("reg.window", 11, 10, 110, 6), s("reg.pin", 11, 20, 100, 1),
        s("h2d.block", 11, 120, 1120), s("h2d.copy", 11, 130, 630),
        s("verify.wait", 11, 630, 830),
        s("reg.window", 12, 20, 120, 0),
        s("h2d.block", 12, 130, 3130 - 2000), s("h2d.copy", 12, 140, 340),
        s("h2d.block", 11, 1300, 1302), s("h2d.copy", 11, 1300, 1600),
        s("verify.wait", 11, 1600, 1800),
    ]


@pytest.fixture
def drained(monkeypatch):
    """portspans with a log that gives _spans() once."""
    calls = []

    def fake():
        calls.append(1)
        return _spans(), {"threads": 3, "dropped": 0}

    monkeypatch.setattr(portspans, "_drain", fake)
    portspans._CACHE.clear()
    yield calls
    portspans._CACHE.clear()


def _read(name: str, run):
    return spec.metric_reader(name)(run)


def test_readers_time_and_shares(drained):
    run = _run(1.0, 2.0)
    assert portspans.readers_s(run, _spans()) == pytest.approx(4.0)
    assert _read("h2d_copy_share", run) == pytest.approx(
        100 * (0.5 + 0.2 + 0.3) / 4)
    assert _read("reg_call_share", run) == pytest.approx(100 * 0.2 / 4)
    assert _read("verify_wait_share", run) == pytest.approx(100 * 0.4 / 4)
    # the exact median of 1000, 1000 and 2 ms
    assert _read("block_resident_p50_us", run) == pytest.approx(1_000_000)
    assert drained == [1]  # one drain serves every reader of the run


def test_phase_count_must_match(drained):
    assert _read("h2d_copy_share", _run(1.0)) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read(monkeypatch, name):
    portspans._CACHE.clear()
    # an untraced run: no drain at all
    monkeypatch.setattr(portspans, "_drain", lambda: pytest.fail("drained"))
    assert _read(name, _run(1.0, 2.0, traced=False)) is None
    # a port without the span log, or a log with nothing in it
    for result in (None, ([], {"threads": 0, "dropped": 0})):
        portspans._CACHE.clear()
        monkeypatch.setattr(portspans, "_drain", lambda r=result: r)
        assert _read(name, _run(1.0, 2.0)) is None
    portspans._CACHE.clear()


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_dropped_records_read_nothing(monkeypatch, name):
    """A log that lost records would undercount every share: no reading."""
    portspans._CACHE.clear()
    monkeypatch.setattr(portspans, "_drain",
                        lambda: (_spans(), {"threads": 3, "dropped": 1}))
    assert _read(name, _run(1.0, 2.0)) is None
    portspans._CACHE.clear()
