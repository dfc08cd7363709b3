"""The trace reduction on events of known times."""

from __future__ import annotations

import pytest

from benchmark.devtrace import SPAN, Event, summarize

MS = 1_000_000


def test_busy_window_ops_and_gaps():
    ev = [Event(SPAN, -1, 0, 100 * MS), Event(SPAN, -1, 110 * MS, 200 * MS),
          Event("Memcpy HtoD", 0, 10 * MS, 40 * MS),
          Event("Memcpy HtoD", 0, 30 * MS, 50 * MS),  # overlaps the first
          Event("verify_u32_kernel", 0, 50 * MS, 60 * MS),
          Event("Memcpy HtoD", 0, 150 * MS, 190 * MS),
          Event("cudaLaunchKernel", -1, 50 * MS, 51 * MS),
          Event("Memcpy HtoD", 0, 195 * MS, 300 * MS)]  # clipped at 200
    s = summarize(ev, 1)
    assert s.window_s == pytest.approx(0.2)
    assert s.busy_s == pytest.approx(0.05 + 0.04 + 0.005)
    assert s.seconds_of("verify_u32") == pytest.approx(0.01)
    # an operation's device time counts each event whole, overlaps and all
    assert s.device_ops[0] == ["Memcpy HtoD", pytest.approx(0.095)]
    assert s.idle_gaps == [["between_phases@dev0", pytest.approx(0.09)],
                           ["in_phase@dev0", pytest.approx(0.01)],
                           ["in_phase@dev0", pytest.approx(0.005)]]


def test_two_cards_average():
    ev = [Event(SPAN, -1, 0, 100 * MS), Event("k", 0, 0, 100 * MS),
          Event("k", 1, 0, 50 * MS)]
    assert summarize(ev, 2).busy_s == pytest.approx(0.075)


def test_no_span_no_summary():
    assert summarize([Event("k", 0, 0, 10)], 1) is None
