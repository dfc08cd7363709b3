"""`correct`: the port's counts of what each window phase did, held
against the reference (reference.py) of the same configuration.

The numbers a cell compares depend on the kind of phase its traffic runs
(the traffic file's `phase`); judges/<phase, lower case>.py computes them,
found by name as a metric reader is, so a cell of another kind brings its
judge as a new file. Every number is a gap between the program's count and
the reference's, or a count of things that must not happen, so every limit
is 0: an exact comparison. What each number is, and the control that shows
it can fail, are in PERF.md.
"""

from __future__ import annotations

from .spec import ROOT, plugin


def judge(port: dict, traffic: dict, phases: list, probe: dict | None,
          root: str = ROOT) -> dict:
    """{name: {"value": v, "limit": 0}} plus `attempted` and `failed`
    device copies."""
    checks, due = plugin("judges", traffic["phase"].lower(),
                         root).checks(port, traffic, phases, probe)
    attempted = due * len(phases)
    failed = sum(due - min(due, p.submits) if not p.error else due
                 for p in phases)
    return {"checks": {k: {"value": v, "limit": 0}
                       for k, v in checks.items()},
            "attempted": attempted, "failed": failed}
