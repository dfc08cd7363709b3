"""A cell and a per-layer metric added as new files and new entries only:
the harness finds and runs them with no edit to a file that is there."""

from __future__ import annotations

import json
import os

from benchmark import spec


def test_new_cell_and_metric_from_files_alone(small_root, run_small):
    before = {p: open(os.path.join(spec.HERE, p)).read()
              for p in os.listdir(spec.HERE) if p.endswith(".py")}
    bench_path = small_root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    # a new configuration: the stream config with two files
    conf = json.loads((small_root / "benchmark" / "configs" /
                       "unet3d-1gpu.json").read_text())
    conf["name"] = "unet3d-two"
    conf["port"]["files"] = 2
    (small_root / "benchmark" / "configs" / "unet3d-two.json").write_text(
        json.dumps(conf))
    # a new traffic mix: reads in file order, no probe
    (small_root / "benchmark" / "traffic" / "inorder.json").write_text(
        json.dumps({"why": "files in order", "phase": "READFILES",
                    "order": "listed", "verify": True, "flags": []}))
    # a new per-layer metric with its own reader
    (small_root / "benchmark" / "metrics" / "phases_run.py").write_text(
        "def read(run):\n    return float(len(run.phases))\n")
    bench["configs"].append({"name": "unet3d-two", "source": "test",
                             "file": "benchmark/configs/unet3d-two.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "unet3d-two.inorder",
                               "config": "unet3d-two", "traffic": "inorder",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "phases_run", "unit": "phases",
                               "better": "higher",
                               "source": "program_span", "layer": "test",
                               "moves": "read_gib_s",
                               "workloads": ["unet3d-two.inorder"]})
    bench_path.write_text(json.dumps(bench))

    line = run_small(small_root, "unet3d-two.inorder", trace=True)
    assert line["correct"] is True
    assert line["metrics"]["phases_run"]["value"] >= 1
    assert "corrupt_offset_gap" not in line["checks"]
    line = run_small(small_root, "unet3d-two.inorder")
    assert set(line["metrics"]) == {"read_gib_s", "setup_s"}
    after = {p: open(os.path.join(spec.HERE, p)).read() for p in before}
    assert after == before


def test_new_phase_kind_from_files_alone(small_root, run_small):
    """An INGEST cell: its configuration, traffic mix and judge are new
    files; the generator and the counters it needs are there already."""
    root = small_root / "benchmark"
    conf = {"name": "records", "port": {
        "files": 3, "file_bytes": 4096 * 50, "record_bytes": 4096,
        "block_bytes": 4096 * 8, "threads": 3, "iodepth": 1, "gpus": 1,
        "verify_salt": 7}}
    (root / "configs" / "records.json").write_text(json.dumps(conf))
    (root / "traffic" / "epochs.json").write_text(json.dumps(
        {"why": "test", "phase": "INGEST", "epochs_per_phase": 2,
         "flags": ["--shuffleseed", "{seed}"]}))
    # the judge of the new kind: every record of every epoch resident
    (root / "judges" / "ingest.py").write_text(
        "def checks(port, traffic, phases, probe):\n"
        "    n = port['files'] * (port['file_bytes'] // port['record_bytes'])\n"
        "    gap = max(abs(e['resident'] - n) for p in phases\n"
        "              for e in p.epochs)\n"
        "    per = port['block_bytes'] // port['record_bytes']\n"
        "    return ({'phase_errors': sum(1 for p in phases if p.error),\n"
        "             'records_gap': gap}, n // per)\n")
    bench_path = small_root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "records", "source": "test",
                             "file": "benchmark/configs/records.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "records.epochs", "config": "records",
                               "traffic": "epochs", "chips": 1,
                               "why": "test"})
    bench_path.write_text(json.dumps(bench))

    line = run_small(small_root, "records.epochs")
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"phase_errors", "records_gap"}
    assert line["metrics"]["read_gib_s"]["value"] > 0
