"""Fixtures of the harness's CPU tests: the port on the CPU behind its mock
CUDA driver, and a copy of the benchmark's files at a small size."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips here with a reason)")


@pytest.fixture
def mock_env(monkeypatch):
    """The port on the CPU: EBT_TORCH_DEVICE=cpu and the mock driver."""
    from elbencho_tpu_torch import engine

    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", engine.build_mock())


@pytest.fixture
def card():
    """Skip unless a CUDA device is there (decided in the test, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")


# the shapes the CPU tests run: every cell's configuration cut to a few
# MiB, its kinds and options as committed
SMALL = {
    "READFILES": dict(files=3, file_bytes=(4 << 20) + 12345,
                      block_bytes=1 << 20, threads=2, iodepth=2),
}


@pytest.fixture
def small_root(tmp_path):
    """A benchmark root with BENCHMARK.json, the traffic mixes, the metric
    readers and the judges as committed and every configuration at SMALL
    size."""
    root = tmp_path / "root"
    (root / "benchmark" / "configs").mkdir(parents=True)
    for sub in ("traffic", "metrics", "judges"):
        shutil.copytree(os.path.join(spec.HERE, sub),
                        root / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        conf_entry = next(c for c in bench["configs"]
                          if c["name"] == w["config"])
        with open(os.path.join(spec.ROOT, conf_entry["file"])) as f:
            conf = json.load(f)
        with open(root / "benchmark" / "traffic" /
                  (w["traffic"] + ".json")) as f:
            kind = json.load(f)["phase"]
        conf["port"].update(SMALL[kind])
        with open(root / conf_entry["file"], "w") as f:
            json.dump(conf, f)
    return root


def _run_small(root, workload: str, seed: int = 2147483651,
               seconds: float = 0.3, trace: bool = False) -> dict:
    """One run of a cell of `root` on the mock; the printed line."""
    from benchmark import run

    cell = spec.load_cell(workload, str(root))
    with open(root / "port.log", "a") as log:
        out = run.run_cell(cell, seed, seconds, trace, root=str(root),
                           log=log)
    return run.result_line(out, {"platform": "cpu", "kind": "mock",
                                 "count": cell.chips})


@pytest.fixture
def run_small(mock_env):
    """_run_small, with the port on the CPU."""
    return _run_small
