"""The result line: its keys, the metrics of each cell under --trace 0 and
1, `checks` last; and the refusal without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import run, spec

CELLS = tuple(w["name"] for w in json.load(
    open(os.path.join(spec.ROOT, "BENCHMARK.json")))["workloads"])


def _names(entries):
    return {m["name"] for m in entries}


@pytest.mark.parametrize("workload", CELLS)
def test_line_trace0(small_root, run_small, workload):
    line = run_small(small_root, workload)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = spec.load_cell(workload, str(small_root))
    assert set(line["metrics"]) == _names(cell.end_to_end)
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name
        unit = next(e["unit"] for e in cell.end_to_end if e["name"] == name)
        assert m["unit"] == unit
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)  # one JSON object


@pytest.mark.parametrize("workload", CELLS)
def test_line_trace1(small_root, run_small, workload):
    line = run_small(small_root, workload, trace=True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert line["correct"] is True
    cell = spec.load_cell(workload, str(small_root))
    # off the card the device trace has nothing to read: those readers
    # return nothing and the line leaves their metrics out
    device = {m["name"] for m in cell.per_layer
              if m["source"] == "device_trace"}
    assert set(line["metrics"]) == _names(cell.per_layer) - device
    for m in cell.per_layer:
        assert m["moves"] in _names(cell.end_to_end)
    assert {"busy_s", "window_s"} <= set(line["device"])
    bd = line["breakdown"]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_main_refuses_without_card(tmp_path):
    """No CUDA device: exit code not 0 and no line on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ)
    env.pop("EBT_TORCH_DEVICE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "unet3d-1gpu.stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "unet3d-1gpu.stream", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.gpu
def test_device_on_card(card):
    import torch

    dev = run.gpu_device(1)
    assert dev == {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                   "count": 1}
    assert run.gpu_memory_used(1) > 0
