"""The DL-ingestion ledger on the port (--ingest, --ingestshards) against the
original package's, on the same inputs.

The original runs its PjrtPath on the mock PJRT plugin
(EBT_MOCK_PJRT_DEVICES=4), the port its CUDA engine (csrc/cuda_path.cpp) on
the mock CUDA driver (EBT_MOCK_CUDA_DEVICES=4, EBT_TORCH_DEVICE=cpu). Both
ingest the same generated datasets. Per-epoch records_read,
records_resident and records_dropped, the tier, the expected totals, the
refusal texts and the result-tree and pod fan-in fields compare exactly; a
mid-epoch fault is attributed "device N epoch E" in both, by the seam of
each mock (EBT_MOCK_STRIPE_FAIL_AT there, EBT_MOCK_CUDA_DEV_FAIL_AT here),
and there the counts follow the workers' timing, so each package is held to
read == resident + dropped. No kernel runs on this path in either package.
(tests/test_torch_ingest.py holds the fused verify + checksum kernel, B4.)
"""

from __future__ import annotations

import ctypes
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.coordinator as jax_coordinator
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.tpu.native as jax_native
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.coordinator as torch_coordinator
import elbencho_tpu_torch.engine_stats as torch_engine_stats
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine
from elbencho_tpu_torch.cuda import native as torch_native
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.ingest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 64 << 10
REC = 4 << 10  # 16 records per batch


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_total_bytes.restype = ctypes.c_uint64
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    return lib


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, 4 devices each, counters zeroed."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    made = tuple(
        SimpleNamespace(
            name=name, config_from_args=cfg.config_from_args,
            Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
            ProgException=exc.ProgException, Statistics=stats.Statistics,
            Remote=remote.RemoteWorkerGroup, Coordinator=coord.Coordinator,
            shuffle_sample=shuffle, mock=_mock_lib(mock), so=mock,
            seam=seam)
        for name, cfg, local, common, exc, stats, remote, coord, shuffle,
        mock, seam in (
            ("jax", jax_config, jax_local, jax_common, jax_exceptions,
             jax_stats, jax_remote, jax_coordinator,
             jax_native.shuffle_sample, JAX_MOCK, "EBT_MOCK_STRIPE_FAIL_AT"),
            ("torch", torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_remote, torch_coordinator,
             torch_engine_stats.shuffle_sample, torch_mock,
             "EBT_MOCK_CUDA_DEV_FAIL_AT")))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def ingest_args(d, shards=3, shard_bytes=4 * BLK, extra=None, epochs=2,
                window=64):
    return (["--ingestshards", str(shards), "-w", "-s", str(shard_bytes),
             "-b", str(BLK), "--recordsize", str(REC),
             "--epochs", str(epochs), "--shufflewindow", str(window),
             "-t", "2", "--tpubackend", "pjrt", "--nolive", str(d)]
            + (extra or []))


def pkg_dir(tmp_path, pkg):
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    return d


def run_phase(group, phase, bench_id="ing-test"):
    group.start_phase(phase, bench_id)
    while not group.wait_done(1000):
        pass


def run_ingest(pkg, args, bench_id="ing-test"):
    """One package's INGEST phase; what the packages are compared on."""
    cfg = pkg.config_from_args(args)
    group = pkg.Group(cfg)
    group.prepare()
    try:
        base = pkg.mock.ebt_mock_total_bytes()
        run_phase(group, pkg.Phase.INGEST, bench_id)
        group.phase_results()  # confirms the tier, as the coordinator does
        out = SimpleNamespace(
            cfg=cfg, stats=group.ingest_stats(), tier=group.ingest_tier(),
            ingest_error=group.ingest_error(), error=group.first_error(),
            landed=pkg.mock.ebt_mock_total_bytes() - base,
            checksum=pkg.mock.ebt_mock_checksum(),
            fault_stats=group.fault_stats() or {},
            engine_fault_stats=group.engine_fault_stats() or {},
            tenants=group.tenant_stats(), arrival=group.arrival_mode(),
            wire=pkg.Statistics(cfg, group).bench_result_wire(
                pkg.Phase.INGEST, bench_id, []))
    finally:
        group.teardown()
    return out


EXACT = ("records_read", "records_submitted", "records_resident",
         "records_dropped", "batch_coalesce_count", "shuffle_window",
         "epochs")


def exact(stats):
    return {k: stats[k] for k in EXACT}


def refusal(pkg, args) -> str:
    with pytest.raises(pkg.ProgException) as ei:
        pkg.config_from_args(args)
    return str(ei.value)


def same_refusal(pkgs, args, needle):
    texts = [refusal(pkg, args) for pkg in pkgs]
    assert needle in texts[0], texts[0]
    assert texts[0] == texts[1]


def file_checksum(paths) -> int:
    total = 0
    for p in paths:
        total += int(np.fromfile(p, dtype=np.uint8).sum(dtype=np.uint64))
    return total & ((1 << 64) - 1)


# --------------------------------------------- shuffle determinism/quality
#
# Both packages draw from the shipped native WindowShuffler (each from its
# own build of the engine): the streams must be identical.

def test_shuffle_same_seed_identical_order(pkgs):
    streams = []
    for pkg in pkgs:
        a = pkg.shuffle_sample(7, 0, 3, 100, 2100, 128)
        assert a == pkg.shuffle_sample(7, 0, 3, 100, 2100, 128)
        assert a != pkg.shuffle_sample(8, 0, 3, 100, 2100, 128)
        assert a != pkg.shuffle_sample(7, 1, 3, 100, 2100, 128)
        streams.append(a)
    assert streams[0] == streams[1]


def test_shuffle_is_exact_permutation_per_rank_partition(pkgs):
    total, ndt, window = 1000, 4, 64
    streams = []
    for pkg in pkgs:
        seen: list[int] = []
        for rank in range(ndt):
            per = total // ndt
            start = rank * per
            end = total if rank == ndt - 1 else (rank + 1) * per
            recs = pkg.shuffle_sample(5, 0, rank, start, end, window)
            assert sorted(recs) == list(range(start, end))
            assert recs == pkg.shuffle_sample(5, 0, rank, start, end,
                                              window)
            seen.extend(recs)
        assert sorted(seen) == list(range(total))
        streams.append(seen)
    assert streams[0] == streams[1]


def test_shuffle_window_one_degenerates_to_sequential(pkgs):
    for pkg in pkgs:
        for seed, epoch, rank in ((1, 0, 0), (99, 3, 7)):
            assert pkg.shuffle_sample(seed, epoch, rank, 40, 140, 1) == \
                list(range(40, 140))


def test_shuffle_distribution_sanity_on_large_window(pkgs):
    n, window = 4096, 512
    streams = []
    for pkg in pkgs:
        recs = pkg.shuffle_sample(13, 0, 0, 0, n, window)
        assert sorted(recs) == list(range(n))
        displaced = sum(1 for i, r in enumerate(recs) if r != i)
        assert displaced > n * 0.9
        mean_disp = sum(abs(r - i) for i, r in enumerate(recs)) / n
        assert mean_disp > window / 8
        for i, r in enumerate(recs):
            assert r <= i + window
        streams.append(recs)
    assert streams[0] == streams[1]


# --------------------------------------------------- config/manifest rules

def test_ingest_scenario_config_rules(pkgs, tmp_path):
    same_refusal(pkgs, ["--ingestshards", "2", "-w", "-s", str(BLK),
                        "-b", str(BLK), "--recordsize", str(REC),
                        "--tpubackend", "staged", "--gpuids", "0",
                        "--nolive", str(tmp_path)],
                 "requires the native pjrt")
    for extra, needle in ((["-r"], "INGEST phase only"),
                          (["--stripe", "rr"], "mutually exclusive"),
                          (["--verify", "7"], "do not apply"),
                          (["--rand"], "does not apply"),
                          (["--checkpoint-shards", "2"],
                           "--checkpoint and --ingest")):
        same_refusal(pkgs, ingest_args(tmp_path, extra=extra), needle)
    same_refusal(pkgs, ["--ingestshards", "2", "-w", "-s", str(4 * BLK),
                        "-b", str(BLK), "--recordsize", "3000", "-t", "1",
                        "--tpubackend", "pjrt", "--nolive", str(tmp_path)],
                 "must divide --block")
    same_refusal(pkgs, ["--ingestshards", "2", "-w", "-s", str(BLK),
                        "-b", str(BLK), "-t", "1", "--tpubackend", "pjrt",
                        "--nolive", str(tmp_path)], "needs --recordsize")
    same_refusal(pkgs, ["--ingestshards", "2", "-w",
                        "-s", str(4 * BLK + 100), "-b", str(BLK),
                        "--recordsize", str(REC), "-t", "1",
                        "--tpubackend", "pjrt", "--nolive", str(tmp_path)],
                 "whole multiple of")
    same_refusal(pkgs, ["-r", "--recordsize", str(REC), "-s", str(BLK),
                        "--nolive", str(tmp_path / "f.bin")],
                 "require the --ingest")
    totals = []
    for pkg in pkgs:
        cfg = pkg.config_from_args(ingest_args(tmp_path))
        assert cfg.selected_phases() == [pkg.Phase.INGEST]
        assert cfg.ingest_total_records() == 3 * (4 * BLK) // REC
        # the INGEST phase's expected totals (the live progress base)
        exp = pkg.Coordinator(cfg).expected_totals(pkg.Phase.INGEST)
        totals.append((exp.entries, exp.bytes, exp.iops))
    assert totals[0] == totals[1] == (
        0, 2 * 3 * 4 * BLK, 2 * 3 * (4 * BLK) // REC)


def test_ingest_direct_io_record_alignment_refused(pkgs, tmp_path):
    same_refusal(pkgs, ["--ingestshards", "2", "-w", "-s", str(4 * BLK),
                        "-b", str(BLK), "--recordsize", "256", "--direct",
                        "-t", "1", "--tpubackend", "pjrt", "--nolive",
                        str(tmp_path)], "multiple of 512")
    for pkg in pkgs:
        assert pkg.config_from_args(
            ingest_args(tmp_path, extra=["--direct"])).use_direct_io


def test_ingest_knobs_refused_under_checkpoint_scenario(pkgs, tmp_path):
    for knob in (["--recordsize", str(REC)], ["--epochs", "5"]):
        same_refusal(pkgs, ["--checkpoint-shards", "2", "-w", "-s", str(BLK),
                            "-b", str(BLK), *knob, "--tpubackend", "pjrt",
                            "--nolive", str(tmp_path)],
                     "require the --ingest")


def test_epoch_times_not_truncated_past_64_epochs(pkgs, tmp_path):
    """epoch_time_ns covers every epoch of the plan: a 70-epoch run reports
    70 reconciliation rows and 70 epoch times in both packages."""
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, [
            "--ingestshards", "1", "-w", "-s", str(4 * REC), "-b",
            str(2 * REC), "--recordsize", str(REC), "--epochs", "70",
            "--shufflewindow", "2", "-t", "1", "--tpubackend", "pjrt",
            "--nolive", str(pkg_dir(tmp_path, pkg))], "many-epochs")
        assert r.error == ""
        assert len(r.stats["epochs"]) == 70
        assert len(r.stats["epoch_time_ns"]) == 70
        for e in r.stats["epochs"]:
            assert e["read"] == e["resident"] == 4 and e["dropped"] == 0
        runs.append(exact(r.stats))
    assert runs[0] == runs[1]


def test_generated_dataset_require_existing_or_w(pkgs, tmp_path):
    same_refusal(pkgs, ["--ingestshards", "2", "-s", str(BLK), "-b",
                        str(BLK), "--recordsize", str(REC), "--tpubackend",
                        "pjrt", "--nolive", str(tmp_path)],
                 "shard file not found")
    for pkg in pkgs:
        cfg = pkg.config_from_args(ingest_args(tmp_path, shards=4))
        assert len(cfg.ingest_dataset) == 4
        assert cfg.ingest_paths()[0].endswith("data.shard.0")


def write_manifest(tmp_path, doc, name="ingest.json") -> str:
    path = tmp_path / name
    path.write_text(json.dumps(doc) if isinstance(doc, dict) else doc)
    return str(path)


def test_record_manifest_refusals(pkgs, tmp_path):
    def args(man, extra=None):
        return (["--ingest", man, "-b", str(BLK), "--recordsize", str(REC),
                 "--tpubackend", "pjrt", "--nolive"] + (extra or []))

    same_refusal(pkgs, args(write_manifest(tmp_path, "{nope")),
                 "not valid JSON")
    same_refusal(pkgs, args(write_manifest(tmp_path, {"shards": []})),
                 '"shards" is empty')
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "no.bin"}]})), "shard file not found")
    (tmp_path / "s0.bin").write_bytes(b"")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "s0.bin"}]})), "zero-byte shard")
    rng = np.random.default_rng(0)
    (tmp_path / "s1.bin").write_bytes(
        rng.integers(0, 256, 2 * BLK, dtype=np.uint8).tobytes())
    (tmp_path / "s2.bin").write_bytes(
        rng.integers(0, 256, BLK, dtype=np.uint8).tobytes())
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "s1.bin"}, {"path": "s2.bin"}]})),
        "share one size")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "s1.bin"}, {"path": "s1.bin"}]})),
        "duplicate shard path")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "s1.bin", "bytes": 1}]})),
        "declared bytes")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"record_size": 2 * REC,
                   "shards": [{"path": "s1.bin"}]})),
        "contradicts the manifest")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"record_size": (2 * BLK) - 8,
                   "shards": [{"path": "s1.bin"}]})),
        "must divide the shard size")
    same_refusal(pkgs, args(write_manifest(
        tmp_path, {"shards": [{"path": "s1.bin"}]}), extra=[str(tmp_path)]),
        "drop the PATH")


def test_record_manifest_supplies_record_size(pkgs, tmp_path):
    (tmp_path / "d0.bin").write_bytes(np.random.default_rng(1).integers(
        0, 256, 2 * BLK, dtype=np.uint8).tobytes())
    man = write_manifest(tmp_path, {"record_size": REC,
                                    "shards": [{"path": "d0.bin"}]})
    for pkg in pkgs:
        cfg = pkg.config_from_args(["--ingest", man, "-b", str(BLK),
                                    "--tpubackend", "pjrt", "--nolive"])
        assert cfg.record_size == REC
        assert cfg.file_size == 2 * BLK
        assert [os.path.basename(p) for p in cfg.ingest_paths()] == \
            ["d0.bin"]


# ------------------------------------------------------------- ingest E2E

@pytest.mark.parametrize("tier", ["registered", "staged"])
def test_ingest_multi_epoch_reconciles_per_epoch(pkgs, tmp_path,
                                                 monkeypatch, tier):
    """Every epoch reconciles exactly at the direction-12 barrier, batches
    coalesce records, the prefetch tier is confirmed from the counters, and
    the mock's landed bytes grow by exactly epochs x dataset — the same
    numbers in both packages, from registered batch buffers and on the
    staged tier (EBT_PJRT_NO_DMAMAP=1)."""
    if tier == "staged":
        monkeypatch.setenv("EBT_PJRT_NO_DMAMAP", "1")
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, ingest_args(pkg_dir(tmp_path, pkg)))
        total = r.cfg.ingest_total_records()
        st = r.stats
        assert r.error == "" and r.ingest_error == ""
        assert st["records_read"] == 2 * total
        assert st["records_read"] == st["records_submitted"] \
            == st["records_resident"]
        assert st["records_dropped"] == 0
        for e in st["epochs"]:
            assert e == {"read": total, "submitted": total,
                         "resident": total, "dropped": 0}
        assert len(st["epoch_time_ns"]) == 2
        assert all(t > 0 for t in st["epoch_time_ns"])
        assert st["batch_coalesce_count"] > 0
        assert st["shuffle_window"] == 64
        assert r.tier == "pipelined"
        assert r.landed == 2 * total * REC
        runs.append((exact(st), r.tier, r.landed))
    assert runs[0] == runs[1]


def test_ingest_window_one_byte_identical_to_sequential_read(pkgs,
                                                             tmp_path):
    """window=1 is the non-shuffled A/B: one epoch lands exactly the
    dataset's bytes, checksum-identical to a plain sequential read of the
    same files, and to the other package's ingest of the same (seeded)
    dataset."""
    rng = np.random.default_rng(4)
    for i in range(2):
        (tmp_path / f"ab{i}.bin").write_bytes(
            rng.integers(0, 256, 4 * BLK, dtype=np.uint8).tobytes())
    man = write_manifest(tmp_path, {"record_size": REC, "shards": [
        {"path": "ab0.bin"}, {"path": "ab1.bin"}]})
    sums = []
    for pkg in pkgs:
        r = run_ingest(pkg, ["--ingest", man, "-b", str(BLK), "--epochs",
                             "1", "--shufflewindow", "1", "-t", "2",
                             "--tpubackend", "pjrt", "--nolive"],
                       "ab-ingest")
        assert r.error == ""
        assert r.stats["records_resident"] == r.cfg.ingest_total_records()
        assert r.checksum == file_checksum(r.cfg.ingest_paths())
        pkg.mock.ebt_mock_reset()
        rcfg = pkg.config_from_args(
            ["-r", "-s", str(r.cfg.file_size), "-b", str(BLK), "-t", "2",
             "--tpubackend", "pjrt", "--nolive"] + r.cfg.ingest_paths())
        g = pkg.Group(rcfg)
        g.prepare()
        try:
            run_phase(g, pkg.Phase.READFILES, "ab-read")
            assert g.first_error() == ""
            assert pkg.mock.ebt_mock_checksum() == r.checksum
        finally:
            g.teardown()
        sums.append(r.checksum)
    assert sums[0] == sums[1]


def test_ingest_partial_tail_batch_reconciles(pkgs, tmp_path):
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, [
            "--ingestshards", "1", "-w", "-s", str(10 * REC),
            "-b", str(4 * REC), "--recordsize", str(REC), "--epochs", "1",
            "--shufflewindow", "4", "-t", "2", "--tpubackend", "pjrt",
            "--nolive", str(pkg_dir(tmp_path, pkg))])
        assert r.error == ""
        assert r.stats["records_read"] == r.stats["records_resident"] == 10
        assert r.stats["records_dropped"] == 0
        runs.append(exact(r.stats))
    assert runs[0] == runs[1]


def test_prefetch_batches_one_is_serial_tier(pkgs, tmp_path):
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, [
            "--ingestshards", "2", "-w", "-s", str(4 * BLK), "-b", str(BLK),
            "--recordsize", str(REC), "--epochs", "2", "--shufflewindow",
            "64", "--prefetchbatches", "1", "-t", "1",
            "--tpubackend", "pjrt", "--nolive", str(pkg_dir(tmp_path, pkg))])
        assert r.error == ""
        assert r.stats["records_dropped"] == 0
        assert r.stats["prefetch_depth_peak"] <= 1
        assert r.tier == "serial"
        runs.append((exact(r.stats), r.tier))
    assert runs[0] == runs[1]


def test_ranks_beyond_dataset_threads_own_no_records(pkgs, tmp_path):
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, [
            "--ingestshards", "2", "-w", "-s", str(4 * BLK), "-b", str(BLK),
            "--recordsize", str(REC), "--epochs", "1", "--datasetthreads",
            "2", "-t", "4", "--tpubackend", "pjrt", "--nolive",
            str(pkg_dir(tmp_path, pkg))])
        total = r.cfg.ingest_total_records()
        assert r.error == ""
        assert r.stats["records_read"] == r.stats["records_resident"] == \
            total
        runs.append(exact(r.stats))
    assert runs[0] == runs[1]


# ------------------------------------------------- faults / open loop

def test_midepoch_failure_attributed_device_and_epoch(pkgs, tmp_path,
                                                      monkeypatch):
    """A batch copy failing in flight on device 1 fails the phase with
    "device 1 epoch 0: cause" in both packages, and the dropped records
    keep the epoch's reconciliation exact."""
    for pkg in pkgs:
        monkeypatch.setenv(pkg.seam, "1:2")
    heads = []
    for pkg in pkgs:
        r = run_ingest(pkg, ingest_args(pkg_dir(tmp_path, pkg), epochs=1),
                       "fault")
        assert "device 1 epoch 0" in r.error
        assert pkg.seam in r.error
        assert r.ingest_error.startswith("device 1 epoch 0: ")
        st = r.stats
        assert st["records_dropped"] > 0
        assert st["records_read"] == st["records_resident"] + \
            st["records_dropped"]
        for e in st["epochs"]:
            assert e["read"] == e["resident"] + e["dropped"]
        heads.append(r.ingest_error.split(":")[0])
    assert heads[0] == heads[1]


def test_midepoch_failure_tolerated_under_budget(pkgs, tmp_path,
                                                 monkeypatch):
    for pkg in pkgs:
        monkeypatch.setenv(pkg.seam, "1:2")
    for pkg in pkgs:
        r = run_ingest(pkg, ingest_args(
            pkg_dir(tmp_path, pkg), epochs=2,
            extra=["--retry", "2", "--maxerrors", "25%"]), "tolerated")
        assert r.error == "", pkg.name
        st = r.stats
        assert st["records_read"] == st["records_resident"] + \
            st["records_dropped"]
        for e in st["epochs"]:
            assert e["read"] == e["resident"] + e["dropped"]
        assert r.fault_stats.get("dev_errors", 0) + \
            r.engine_fault_stats.get("errors_tolerated", 0) >= 1, pkg.name


def test_open_loop_ingest_ledger_exact(pkgs, tmp_path):
    runs = []
    for pkg in pkgs:
        r = run_ingest(pkg, ingest_args(
            pkg_dir(tmp_path, pkg), shards=2, epochs=1,
            extra=["--arrival", "paced", "--rate", "4000"]), "paced")
        assert r.error == ""
        assert r.arrival in ("paced", "closed")
        assert r.tenants
        for st in r.tenants:
            assert st["arrivals"] == st["completions"] + st["dropped"]
        assert r.stats["records_read"] == r.stats["records_resident"]
        runs.append(exact(r.stats))
    assert runs[0] == runs[1]


def test_ab_ingest_byte_identical(pkgs, tmp_path, monkeypatch):
    """The reactor A/B of tests/test_reactor.py on both packages: INGEST
    under open loop reconciles identically with and without the unified
    wait (window=8: the shuffled order does not depend on the schedule),
    and the two packages ingest the same records."""
    results = []
    for pkg in pkgs:
        shard_dir = pkg_dir(tmp_path, pkg) / "shards"
        shard_dir.mkdir()
        args = ["--ingestshards", "2", "-w", "-s", str(256 << 10),
                "-b", str(64 << 10), "--recordsize", str(4 << 10),
                "--epochs", "2", "--shufflewindow", "8", "--shuffleseed",
                "5", "-t", "2", "--tpubackend", "pjrt", "--arrival",
                "paced", "--rate", "300", "--nolive", str(shard_dir)]

        def once():
            g = pkg.Group(pkg.config_from_args(args))
            g.prepare()
            try:
                run_phase(g, pkg.Phase.CREATEFILES)
                run_phase(g, pkg.Phase.INGEST)
                return (g.ingest_stats(), g.reactor_stats(),
                        g.reactor_enabled(), g.tenant_stats())
            finally:
                g.teardown()

        monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
        st_r, rs, en, tstats = once()
        assert en and rs["reactor_waits"] > 0
        assert st_r["records_read"] > 0
        assert st_r["records_read"] == st_r["records_resident"] + \
            st_r["records_dropped"]
        for t in tstats:
            assert t["arrivals"] == t["completions"] + t["dropped"]
        monkeypatch.setenv("EBT_REACTOR_DISABLE", "1")
        try:
            st_p, _, en_p, _ = once()
        finally:
            monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
        assert not en_p
        assert st_p["records_read"] == st_r["records_read"]
        assert st_p["records_resident"] == st_r["records_resident"]
        results.append((st_r["records_read"], st_r["records_resident"]))
    assert results[0] == results[1]


# ----------------------------------------------------- result tree / pod

def test_result_tree_carries_ingest_fields(pkgs, tmp_path):
    trees = []
    for pkg in pkgs:
        r = run_ingest(pkg, ingest_args(pkg_dir(tmp_path, pkg), shards=2,
                                        epochs=2), "ing-wire")
        wire = r.wire
        assert wire["IngestTier"] == "pipelined"
        st = wire["IngestStats"]
        assert st["records_resident"] == 2 * r.cfg.ingest_total_records()
        assert len(st["epochs"]) == 2
        assert not wire["IngestError"]
        trees.append((wire["IngestTier"], exact(st), sorted(st),
                      wire["IngestError"]))
    assert trees[0] == trees[1]


def test_pod_fanin_sums_records_and_maxes_epoch_times(pkgs):
    class P:
        def __init__(self, host, tier, stats, err):
            self.host = host
            self.host_index = int(host[1:])
            self.ingest_tier = tier
            self.ingest_stats = stats
            self.ingest_error = err

    def proxies():
        return [
            P("h1", "pipelined",
              {"records_read": 10, "records_resident": 10,
               "records_dropped": 0, "prefetch_depth_peak": 3,
               "shuffle_window": 64,
               "epochs": [{"read": 5, "resident": 5, "dropped": 0},
                          {"read": 5, "resident": 5, "dropped": 0}],
               "epoch_time_ns": [100, 300]}, None),
            P("h2", "serial",
              {"records_read": 8, "records_resident": 7,
               "records_dropped": 1, "prefetch_depth_peak": 1,
               "shuffle_window": 64,
               "epochs": [{"read": 4, "resident": 4, "dropped": 0},
                          {"read": 4, "resident": 3, "dropped": 1}],
               "epoch_time_ns": [200, 250]}, "device 0 epoch 1: boom"),
        ]

    merged = []
    for pkg in pkgs:
        g = pkg.Remote.__new__(pkg.Remote)
        g.proxies = proxies()
        out = g.ingest_stats()
        assert out["records_read"] == 18
        assert out["records_resident"] == 17
        assert out["records_dropped"] == 1
        assert out["prefetch_depth_peak"] == 3
        assert out["shuffle_window"] == 64
        assert out["epochs"] == [{"read": 9, "resident": 9, "dropped": 0},
                                 {"read": 9, "resident": 8, "dropped": 1}]
        assert out["epoch_time_ns"] == [200, 300]
        assert g.ingest_tier() == "serial"
        assert g.ingest_error() == "service h2: device 0 epoch 1: boom"
        merged.append((out, g.ingest_tier(), g.ingest_error()))
    assert merged[0] == merged[1]


def test_plugin_caps_probe(pkgs, tmp_path):
    for pkg in pkgs:
        g = pkg.Group(pkg.config_from_args(
            ingest_args(pkg_dir(tmp_path, pkg))))
        g.prepare()
        try:
            caps = g.plugin_caps()
            assert caps is not None
            assert isinstance(caps["dma_map"], bool)
            assert caps["mock"] is True
            assert caps["plugin"] == os.path.basename(pkg.so)
            assert caps["onready_clock"] in ("onready", "await")
        finally:
            g.teardown()


def test_ingest_path_launches_no_kernel(pkgs, tmp_path):
    """The port's ingest runs no device program: the engine's kernel
    launch counters stay where they were (the original's engine executes
    only the verify and fill programs)."""
    torch_pkg = pkgs[1]
    torch_native.reset_kernel_launches()
    r = run_ingest(torch_pkg, ingest_args(pkg_dir(tmp_path, torch_pkg)))
    assert r.error == ""
    assert torch_native.kernel_launches() == {"verify_u32": 0,
                                              "fill_u64": 0}
