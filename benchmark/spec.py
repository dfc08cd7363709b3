"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one `configs` gives for it; the traffic mix
is traffic/<traffic>.json; a metric, end-to-end or per-layer, is read by
metrics/<name>.py; the comparison of a kind of phase is judges/<phase>.py
(judge.py). So a later cell or metric is new files and new entries,
and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str, moved: set[str] | None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return moved is None or entry["moves"] in moved


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(by_name))})")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, moved)]
    return Cell(
        name=name, config_name=w["config"],
        config=_load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=_load_json(os.path.join(root, "benchmark", "traffic",
                                        w["traffic"] + ".json")),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def plugin(kind: str, name: str, root: str = ROOT):
    """The module benchmark/<kind>/<name>.py of `root`, loaded by path."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = ROOT):
    """The `read(run)` function of metrics/<name>.py."""
    return plugin("metrics", name, root).read
