"""pinned_stage_share (metrics/pinned_stage_share.py) on spans of known
bytes, and where it has nothing to read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import portspans, spec
from elbencho_tpu_torch import spans
from elbencho_tpu_torch.spans import Span

MIB = 1 << 20


def _run(traced: bool = True):
    return SimpleNamespace(trace=object() if traced else None,
                           phases=[SimpleNamespace(engine_s=1.0)])


def _copies(*tiers_and_bytes) -> list[Span]:
    out = [Span("coord.phase", 1, 0, 10_000, 0, 0)]
    for i, (tier, n) in enumerate(tiers_and_bytes):
        out.append(Span("h2d.copy", 11, 10 * i, 10 * i + 5, n,
                        spans.COPY_TIERS.index(tier)))
    return out


def _read(monkeypatch, got, dropped=0, traced=True):
    portspans._CACHE.clear()
    monkeypatch.setattr(portspans, "_drain",
                        lambda: (got, {"threads": 2, "dropped": dropped}))
    try:
        return spec.metric_reader("pinned_stage_share")(_run(traced))
    finally:
        portspans._CACHE.clear()


@pytest.mark.parametrize("copies,want", [
    ((("staged", 8 * MIB),) * 3, 100.0),
    ((("staged", 6 * MIB), ("pageable", 2 * MIB)), 75.0),
    ((("registered", 8 * MIB), ("staged", 8 * MIB)), 50.0),
    ((("pageable", 8 * MIB),), 0.0),
])
def test_share_of_the_copied_bytes(monkeypatch, copies, want):
    assert _read(monkeypatch, _copies(*copies)) == pytest.approx(want)


def test_nothing_to_read(monkeypatch):
    staged = _copies(("staged", 8 * MIB))
    # untraced, a dropped record, no copy at all
    assert _read(monkeypatch, staged, traced=False) is None
    assert _read(monkeypatch, staged, dropped=1) is None
    assert _read(monkeypatch, _copies()) is None
    # a port whose log has no staged tier (the tier's code never appears)
    monkeypatch.setattr(spans, "COPY_TIERS", ("pageable", "registered"))
    assert _read(monkeypatch, [Span("h2d.copy", 11, 0, 5, MIB, 0)]) is None
