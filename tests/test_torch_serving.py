"""Serving under live model rotation on the port (--arrival trace, --rotate,
--bgbudget, --bgadapt, --slotarget) against the original package's, on the
same inputs.

The original runs its PjrtPath on the mock PJRT plugin
(EBT_MOCK_PJRT_DEVICES=4), the port its CUDA engine (csrc/cuda_path.cpp) on
the mock CUDA driver (EBT_MOCK_CUDA_DEVICES=4, EBT_TORCH_DEVICE=cpu). Both
restore the same seeded shard files under the same rate traces. Refusal
texts, sampled schedules and every per-record field fixed by the inputs
(shards_total, bytes_submitted, bytes_resident, the first record's
retained_buffers) compare exactly. Rotation counts, restore times and
throttle nanoseconds follow the clock, so each package is held to the
invariants instead: started == complete + failed, one record per completed
rotation, every record reconciled to the manifest, released == the previous
record's retained.

The port's own cases read the resident generation back from device memory
(NativeCudaPath.rotation_read) and follow the mock driver's live-allocation
gauge: a generation is one allocation per shard and placement lane, freed at
the swap that displaces it or at the begin after an aborted rotation.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.engine as jax_engine
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.metrics as jax_metrics
import elbencho_tpu.serving as jax_serving
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.metrics as torch_metrics
import elbencho_tpu_torch.serving as torch_serving
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 64 << 10


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_total_bytes.restype = ctypes.c_uint64
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    lib.ebt_mock_live_buffers.restype = ctypes.c_int64
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
            Remote=remote.RemoteWorkerGroup, serving=serving,
            metrics=metrics, load_lib=lib_loader, mock=_mock_lib(mock))
        for name, cfg, local, common, exc, stats, remote, serving, metrics,
        lib_loader, mock in (
            ("jax", jax_config, jax_local, jax_common, jax_exceptions,
             jax_stats, jax_remote, jax_serving, jax_metrics,
             jax_engine.load_lib, JAX_MOCK),
            ("torch", torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_remote, torch_serving,
             torch_metrics, torch_engine.load_lib, torch_mock)))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def write_model(tmp_path, shards=4, shard_blocks=2, seed=0):
    """Seeded shard files + explicit manifest (device i % 4 per shard)."""
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(shards):
        p = tmp_path / f"model.shard.{i}"
        p.write_bytes(rng.integers(0, 256, BLK * shard_blocks,
                                   dtype=np.uint8).tobytes())
        entries.append({"path": str(p), "bytes": BLK * shard_blocks,
                        "devices": [i % 4]})
    man = tmp_path / "manifest.json"
    man.write_text(json.dumps({"version": 1, "shards": entries}))
    return str(man)


def write_trace(tmp_path, segments, name="trace.json", tenants=None):
    doc = {"segments": segments}
    if tenants is not None:
        doc["tenants"] = tenants
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def run_phase(group, phase, bench_id):
    group.start_phase(phase, bench_id)
    while not group.wait_done(1000):
        pass


def serving_args(pkg, tmp_path, trace, extra=None, fsize=BLK * 128):
    f = tmp_path / f"serve_{pkg.name}.bin"
    return [str(f), "-w", "-r", "-t", "2", "-b", str(BLK), "-s", str(fsize),
            "--tpubackend", "pjrt", "--nolive",
            "--arrival", "trace", "--ratetrace", trace] + (extra or [])


def rotation_args(pkg, tmp_path, trace, man, extra=None):
    return serving_args(
        pkg, tmp_path, trace,
        ["--checkpoint", man, "--rotate", "0.25", "--timelimit", "2"]
        + (extra or []), fsize=BLK * 256)


def refusal(pkg, args) -> str:
    with pytest.raises(pkg.ProgException) as ei:
        pkg.config_from_args(args)
    return str(ei.value)


def check_records(recs, nshards, nbytes):
    """The per-record invariants each package must hold."""
    for i, r in enumerate(recs):
        assert r["generation"] == i + 1
        assert r["shards_resident"] == r["shards_total"] == nshards
        assert r["bytes_submitted"] == r["bytes_resident"] == nbytes
        assert r["retained_buffers"] > 0
        # the swap frees the previous generation's retained set
        assert r["released_buffers"] == \
            (0 if i == 0 else recs[i - 1]["retained_buffers"])


FIXED = ("shards_total", "bytes_submitted", "bytes_resident",
         "retained_buffers")


# ------------------------------------------------- trace grammar refusals

@pytest.mark.parametrize("doc,needle", [
    ("{not json", "invalid JSON"),
    ('{"segments": []}', "non-empty segment list"),
    ('{"nope": 1, "segments": [{"at": 0, "rate": 1}]}',
     "unknown top-level key"),
    ('{"segments": [{"at": 0, "kind": "warp", "rate": 1}]}',
     "unknown segment kind"),
    ('{"segments": [{"at": 0, "rate": 5}, {"at": 5, "rate": 2}, '
     '{"at": 3, "rate": 1}]}', "strictly increasing"),
    ('{"segments": [{"at": 0, "rate": -4}]}', "must be >= 0"),
    ('{"segments": [{"at": 1, "rate": 4}]}', "must start at 0"),
    ('{"segments": [{"at": 0, "kind": "ramp", "rate": 1}]}',
     "needs rate_end"),
    ('{"segments": [{"at": 0, "kind": "ramp", "rate": 1, '
     '"rate_end": 5}]}', "final segment"),
    ('{"segments": [{"at": 0, "kind": "step", "rate": 1, '
     '"rate_end": 5}]}', "only valid on ramp"),
    ('{"segments": [{"at": 0, "rate": 0}]}', "never offers load"),
    ('{"segments": [{"at": 0, "rate": 1, "flux": 2}]}', "unknown key"),
])
def test_trace_refusals(pkgs, doc, needle):
    texts = []
    for pkg in pkgs:
        with pytest.raises(pkg.ProgException) as ei:
            pkg.serving.parse_rate_trace(doc, "t")
        assert "--ratetrace" in str(ei.value) and needle in str(ei.value)
        texts.append(str(ei.value))
    assert texts[0] == texts[1]


def test_trace_tenant_override_must_name_a_class(pkgs, tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "rate": 100}],
                        tenants={"ghost": [{"at": 0, "rate": 5}]})
    texts = [refusal(pkg, serving_args(
        pkg, tmp_path, trace, ["--tenants", "hot:rate=1;bulk:rate=1"]))
        for pkg in pkgs]
    assert "no such class" in texts[0] and texts[0] == texts[1]


def test_trace_requires_trace_mode_and_vice_versa(pkgs, tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "rate": 100}])
    f = tmp_path / "f.bin"
    f.write_bytes(b"\0" * BLK)
    for args, needle in (
            ([str(f), "-r", "--arrival", "poisson", "--rate", "5",
              "--ratetrace", trace, "--nolive"], "--arrival trace"),
            ([str(f), "-r", "--arrival", "trace", "--nolive"],
             "needs --ratetrace")):
        texts = [refusal(pkg, args) for pkg in pkgs]
        assert needle in texts[0] and texts[0] == texts[1]


def test_rotate_config_refusals(pkgs, tmp_path):
    man = write_model(tmp_path)
    f = tmp_path / "f.bin"
    base = [str(f), "-b", str(BLK), "-s", str(BLK * 8), "--tpubackend",
            "pjrt", "--nolive"]
    for extra, needle in (
            (["-r", "--rotate", "1"], "needs --checkpoint MANIFEST"),
            (["--checkpoint", man, "--rotate", "1"], "add -r"),
            (["-r", "--checkpoint", man, "--rotate", "1", "--bgadapt", "20"],
             "--bgbudget"),
            (["-r", "--bgbudget", "4M"], "add --rotate"),
            (["-r", "--checkpoint", man, "--rotate", "1", "--reshard", "2"],
             "mutually exclusive"),
            (["-r", "--checkpoint", man, "--rotate", "1", "--verify", "3"],
             "do not apply"),
            (["-r", "--checkpoint", man, "--rotate", "1", "--stripe", "rr"],
             "mutually exclusive"),
            (["-r", "--checkpoint", man, "--rotate", "1", "--tpubackend",
              "staged", "--gpuids", "0"], "requires the native pjrt")):
        texts = [refusal(pkg, base + extra) for pkg in pkgs]
        assert needle in texts[0], texts[0]
        assert texts[0] == texts[1]


# --------------------------------------------- sampler reproducibility

def _trace_sample(lib, segs, rank, n):
    m = len(segs)
    starts = (ctypes.c_uint64 * m)(*[int(s[0] * 1e9) for s in segs])
    kinds = (ctypes.c_int * m)(*[s[1] for s in segs])
    r0 = (ctypes.c_double * m)(*[float(s[2]) for s in segs])
    r1 = (ctypes.c_double * m)(*[float(s[3]) for s in segs])
    out = (ctypes.c_uint64 * n)()
    got = lib.ebt_trace_sample(starts, kinds, r0, r1, m, rank, out, n)
    return [out[i] for i in range(got)]


def test_trace_sampler_reproducible_across_hosts_and_ranks(pkgs):
    """The port's engine samples the original's schedule exactly: same
    rank, same deadlines, in either package's library."""
    segs = [(0.0, 1, 100.0, 400.0), (1.0, 0, 400.0, 0.0),
            (2.0, 2, 900.0, 0.0)]
    streams = []
    for pkg in pkgs:
        lib = pkg.load_lib()
        a = _trace_sample(lib, segs, 3, 256)
        assert a == _trace_sample(lib, segs, 3, 256) and len(a) == 256
        assert a == sorted(a)
        assert _trace_sample(lib, segs, 4, 256) != a
        streams.append(a)
    assert streams[0] == streams[1]


def test_trace_sampler_tracks_the_schedule_rates(pkgs):
    segs = [(0.0, 0, 200.0, 0.0), (1.0, 1, 200.0, 1000.0),
            (3.0, 0, 1000.0, 0.0), (4.0, 0, 0.0, 0.0)]
    results = []
    for pkg in pkgs:
        lib = pkg.load_lib()
        counts = {"step": 0, "ramp_lo": 0, "ramp_hi": 0, "hi": 0,
                  "tail": 0}
        for rank in range(8):
            for dl in _trace_sample(lib, segs, rank, 8192):
                t = dl / 1e9
                key = ("step" if t < 1.0 else "ramp_lo" if t < 2.0 else
                       "ramp_hi" if t < 3.0 else "hi" if t < 4.0 else "tail")
                counts[key] += 1
        assert counts["tail"] == 0
        assert 0.8 < counts["step"] / (8 * 200) < 1.2
        assert 0.8 < counts["hi"] / (8 * 1000) < 1.2
        assert counts["ramp_lo"] < counts["ramp_hi"]
        assert 0.75 < counts["ramp_lo"] / (8 * 400) < 1.25
        assert 0.75 < counts["ramp_hi"] / (8 * 800) < 1.25
        results.append(counts)
    assert results[0] == results[1]


# ------------------------------------------------- trace pacing E2E

def test_trace_phase_ledger_exact_across_segments(pkgs, tmp_path):
    trace = write_trace(tmp_path, [
        {"at": 0, "kind": "ramp", "rate": 100, "rate_end": 400},
        {"at": 0.4, "kind": "step", "rate": 400},
        {"at": 0.8, "kind": "burst", "rate": 800},
    ])
    modes = []
    for pkg in pkgs:
        cfg = pkg.config_from_args(
            serving_args(pkg, tmp_path, trace, ["--slotarget", "1000"]))
        g = pkg.Group(cfg)
        g.prepare()
        try:
            run_phase(g, pkg.Phase.CREATEFILES, "sw")
            run_phase(g, pkg.Phase.READFILES, "sr")
            modes.append(g.arrival_mode())
            (st,) = g.tenant_stats()
            assert st["arrivals"] == st["completions"] + st["dropped"]
            assert st["completions"] > 0
            assert st["slo_ok"] == st["completions"]
            assert 100.0 <= g.sched_rate(0) <= 800.0
            time.sleep(1.0)
            assert g.sched_rate(0) == 800.0
        finally:
            g.teardown()
    assert modes == ["trace", "trace"]


def test_closed_loop_control_forces_trace_off(pkgs, tmp_path, monkeypatch):
    """EBT_LOAD_CLOSED_LOOP=1 downgrades a trace config to the closed shape
    with byte-identical traffic, in both packages."""
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 300}])
    read_bytes = {}
    for pkg in pkgs:
        got = []
        for closed in (False, True):
            if closed:
                monkeypatch.setenv("EBT_LOAD_CLOSED_LOOP", "1")
            pkg.mock.ebt_mock_reset()
            g = pkg.Group(pkg.config_from_args(
                serving_args(pkg, tmp_path, trace)))
            g.prepare()
            try:
                run_phase(g, pkg.Phase.CREATEFILES, "cw")
                base = pkg.mock.ebt_mock_total_bytes()
                run_phase(g, pkg.Phase.READFILES, "cr")
                if closed:
                    assert g.arrival_mode() == "closed"
                got.append(pkg.mock.ebt_mock_total_bytes() - base)
            finally:
                g.teardown()
                monkeypatch.delenv("EBT_LOAD_CLOSED_LOOP", raising=False)
        assert got[0] == got[1]
        read_bytes[pkg.name] = got[0]
    assert read_bytes["jax"] == read_bytes["torch"]


# ------------------------------------------------- rotation E2E

def run_rotation(pkg, tmp_path, trace, man, extra=None):
    """One package's write + serving read under rotation; what the two
    packages are held to."""
    cfg = pkg.config_from_args(rotation_args(pkg, tmp_path, trace, man,
                                             extra))
    g = pkg.Group(cfg)
    g.prepare()
    try:
        run_phase(g, pkg.Phase.CREATEFILES, "rw")
        run_phase(g, pkg.Phase.READFILES, "rr")
        out = SimpleNamespace(svs=g.serving_stats(),
                              recs=g.rotation_records(),
                              ttrs=g.rotation_ttr_ns(),
                              tenants=g.tenant_stats(),
                              error=g.first_error())
    finally:
        g.teardown()
    out.live = pkg.mock.ebt_mock_live_buffers()
    return out


def test_rotation_reconciles_every_swap_and_releases_buffers(pkgs,
                                                             tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path, shards=4, shard_blocks=2)
    runs = [run_rotation(pkg, tmp_path, trace, man, ["--bgbudget", "8M"])
            for pkg in pkgs]
    for r in runs:
        assert r.error == ""
        svs = r.svs
        assert svs["rotations_complete"] >= 1
        assert svs["rotations_started"] == (svs["rotations_complete"]
                                            + svs["rotations_failed"])
        assert len(r.recs) == svs["rotations_complete"] == len(r.ttrs)
        assert all(t > 0 for t in r.ttrs)
        check_records(r.recs, 4, 4 * 2 * BLK)
        assert svs["bg_throttle_ns"] + svs["bg_lane_throttle_ns"] > 0
        assert svs["bg_read_bytes"] >= 4 * 2 * BLK
        (st,) = r.tenants
        assert st["arrivals"] == st["completions"] + st["dropped"]
        assert r.live == 0
    jax_run, torch_run = runs
    assert set(jax_run.svs) == set(torch_run.svs)
    assert {k: jax_run.recs[0][k] for k in FIXED} == \
        {k: torch_run.recs[0][k] for k in FIXED}
    assert jax_run.svs["bg_rate_bps"] == torch_run.svs["bg_rate_bps"]


def test_rotation_unthrottled_never_throttles(pkgs, tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path)
    runs = [run_rotation(pkg, tmp_path, trace, man) for pkg in pkgs]
    for r in runs:
        assert r.svs["rotations_complete"] >= 1
        assert r.svs["bg_throttle_ns"] == 0
        assert r.svs["bg_lane_throttle_ns"] == 0
        assert r.svs["bg_rate_bps"] == 0
        assert r.live == 0
    assert {k: runs[0].recs[0][k] for k in FIXED} == \
        {k: runs[1].recs[0][k] for k in FIXED}


def test_adaptive_controller_reacts_to_foreground_lag(pkgs, tmp_path,
                                                      monkeypatch):
    """--bgadapt: a slowed channel and an offered rate that outruns it make
    the foreground lag, and the controller halves the budget at least once
    in both packages."""
    for k in ("EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US"):
        monkeypatch.setenv(k, "1500")
    monkeypatch.setenv("EBT_TPU_NO_MMAP", "1")
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 800}])
    man = write_model(tmp_path, shards=4, shard_blocks=4)
    for pkg in pkgs:
        f = tmp_path / f"serve_{pkg.name}.bin"
        setup = pkg.Group(pkg.config_from_args(
            [str(f), "-w", "-t", "2", "-b", str(BLK), "-s", str(BLK * 64),
             "--tpubackend", "pjrt", "--nolive"]))
        setup.prepare()
        try:
            run_phase(setup, pkg.Phase.CREATEFILES, "aw")
        finally:
            setup.teardown()
        g = pkg.Group(pkg.config_from_args(
            [str(f), "-r", "-t", "2", "-b", str(BLK), "-s", str(BLK * 64),
             "--rand", "--randamount", "96M", "--tpubackend", "pjrt",
             "--nolive", "--arrival", "trace", "--ratetrace", trace,
             "--checkpoint", man, "--rotate", "0.25", "--timelimit", "3",
             "--bgbudget", "64M", "--bgadapt", "1"]))
        g.prepare()
        try:
            run_phase(g, pkg.Phase.READFILES, "ar")
            svs = g.serving_stats()
            assert svs["rotations_started"] >= 1, pkg.name
            assert svs["bg_adapt_downs"] >= 1, pkg.name
            assert svs["bg_rate_bps"] < 64 << 20, pkg.name
        finally:
            g.teardown()


def test_slo_goodput_counts_the_target(pkgs, tmp_path, monkeypatch):
    monkeypatch.setenv("EBT_TPU_NO_MMAP", "1")
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 200}])
    for pkg in pkgs:
        for slo_ms, expect_all in (("0.001", False), ("60000", True)):
            g = pkg.Group(pkg.config_from_args(
                serving_args(pkg, tmp_path, trace, ["--slotarget", slo_ms])))
            g.prepare()
            try:
                run_phase(g, pkg.Phase.CREATEFILES, "gw")
                run_phase(g, pkg.Phase.READFILES, "gr")
                (st,) = g.tenant_stats()
                assert st["completions"] > 0
                if expect_all:
                    assert st["slo_ok"] == st["completions"]
                else:
                    assert st["slo_ok"] < st["completions"]
            finally:
                g.teardown()


def test_per_tenant_slo_and_trace_override(pkgs, tmp_path):
    trace = write_trace(
        tmp_path, [{"at": 0, "kind": "step", "rate": 100}],
        tenants={"strict": [{"at": 0, "kind": "step", "rate": 300}]})
    for pkg in pkgs:
        g = pkg.Group(pkg.config_from_args(serving_args(
            pkg, tmp_path, trace,
            ["--tenants", "strict:rate=1,slo=0.001;loose:rate=1,slo=60000"])))
        g.prepare()
        try:
            run_phase(g, pkg.Phase.CREATEFILES, "tw")
            run_phase(g, pkg.Phase.READFILES, "tr")
            strict, loose = g.tenant_stats()
            assert strict["completions"] > 0 and loose["completions"] > 0
            assert strict["slo_ok"] < strict["completions"]
            assert loose["slo_ok"] == loose["completions"]
            assert g.sched_rate(0) == 300.0
            assert g.sched_rate(1) == 100.0
        finally:
            g.teardown()


def test_mid_rotation_fault_tolerated_ledger_exact(pkgs, tmp_path,
                                                   monkeypatch):
    """A seeded in-flight device fault lands mid-rotation (the original's
    EBT_MOCK_STRIPE_FAIL_AT, the port's EBT_MOCK_CUDA_DEV_FAIL_AT): with a
    budget the run completes, the fault is visible, every swapped rotation
    still reconciles and nothing leaks, in both packages."""
    monkeypatch.setenv("EBT_MOCK_STRIPE_FAIL_AT", "0:6")
    monkeypatch.setenv("EBT_MOCK_CUDA_DEV_FAIL_AT", "0:6")
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path)
    for pkg in pkgs:
        g = pkg.Group(pkg.config_from_args(rotation_args(
            pkg, tmp_path, trace, man,
            ["--retry", "1", "--maxerrors", "5%"])))
        g.prepare()
        try:
            run_phase(g, pkg.Phase.CREATEFILES, "fw")
            run_phase(g, pkg.Phase.READFILES, "fr")
            assert not g.first_error(), pkg.name
            svs = g.serving_stats()
            fs = g.fault_stats() or {}
            efs = g.engine_fault_stats() or {}
            visible = (fs.get("dev_retry_attempts", 0)
                       + fs.get("dev_errors", 0)
                       + efs.get("errors_tolerated", 0)
                       + svs["rotations_failed"])
            assert visible >= 1, pkg.name
            for r in g.rotation_records() or []:
                assert r["shards_resident"] == r["shards_total"]
                assert r["bytes_submitted"] == r["bytes_resident"]
        finally:
            g.teardown()
        assert pkg.mock.ebt_mock_live_buffers() == 0, pkg.name


# --------------------------------------------- result tree + pod fan-in

def test_result_tree_carries_serving_fields(pkgs, tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path)
    keys = []
    for pkg in pkgs:
        cfg = pkg.config_from_args(rotation_args(pkg, tmp_path, trace, man,
                                                 ["--bgbudget", "8M"]))
        g = pkg.Group(cfg)
        g.prepare()
        try:
            run_phase(g, pkg.Phase.CREATEFILES, "ww")
            run_phase(g, pkg.Phase.READFILES, "wr")
            wire = pkg.Statistics(cfg, g).bench_result_wire(
                pkg.Phase.READFILES, "wr", [])
            svs = wire["ServingStats"]
            assert {"rotations_started", "rotations_complete",
                    "rotations_failed", "ttr_last_ns", "bg_throttle_ns",
                    "bg_rate_bps", "rotation_generation",
                    "rotation_retained_buffers"} <= set(svs)
            assert wire["RotationTtrNs"] == g.rotation_ttr_ns()
            assert wire["RotationRecords"] == g.rotation_records()
            assert wire["ArrivalMode"] == "trace"
            assert all("slo_ok" in cls for cls in wire["TenantStats"])
            keys.append((sorted(wire), sorted(svs),
                         sorted(wire["RotationRecords"][0])))
        finally:
            g.teardown()
    assert keys[0] == keys[1]


def test_pod_fanin_serving_rules(pkgs):
    """Pod fan-in: counters sum, generation and bg rates take the min, ttr
    lists and records merge by generation over the generations every host
    swapped — the same merge in both packages."""

    class P:
        def __init__(self, svs, ttrs, recs):
            self.serving_stats = svs
            self.rotation_ttr_ns = ttrs
            self.rotation_records = recs

    def proxies():
        return [
            P({"rotations_complete": 2, "bg_throttle_ns": 10,
               "rotation_generation": 3, "bg_rate_bps": 100,
               "rotation_restoring": 0, "ttr_last_ns": 50},
              [10, 20],
              [{"generation": 1, "bytes_submitted": 5, "bytes_resident": 5},
               {"generation": 2, "bytes_submitted": 5,
                "bytes_resident": 5}]),
            P({"rotations_complete": 2, "bg_throttle_ns": 5,
               "rotation_generation": 2, "bg_rate_bps": 80,
               "rotation_restoring": 1, "ttr_last_ns": 70},
              [15, 12],
              [{"generation": 1, "bytes_submitted": 7, "bytes_resident": 7},
               {"generation": 3, "bytes_submitted": 9,
                "bytes_resident": 9}]),
        ]

    merged = []
    for pkg in pkgs:
        g = pkg.Remote.__new__(pkg.Remote)
        g.proxies = proxies()
        svs = g.serving_stats()
        assert svs["rotations_complete"] == 4
        assert svs["bg_throttle_ns"] == 15
        assert svs["rotation_generation"] == 2
        assert svs["bg_rate_bps"] == 80
        assert svs["rotation_restoring"] == 1
        assert svs["ttr_last_ns"] == 70
        assert g.rotation_ttr_ns() == [15]
        recs = g.rotation_records()
        assert len(recs) == 1 and recs[0]["generation"] == 1
        assert recs[0]["bytes_submitted"] == 12
        merged.append((svs, g.rotation_ttr_ns(), recs))
    assert merged[0] == merged[1]


def test_trace_rate_zero_tail_ends_the_phase(pkgs, tmp_path):
    trace = write_trace(tmp_path, [
        {"at": 0, "kind": "step", "rate": 400},
        {"at": 0.4, "kind": "step", "rate": 0},
    ])
    for pkg in pkgs:
        f = tmp_path / f"serve_{pkg.name}.bin"
        setup = pkg.Group(pkg.config_from_args(
            [str(f), "-w", "-t", "2", "-b", str(BLK), "-s", str(BLK * 512),
             "--tpubackend", "pjrt", "--nolive"]))
        setup.prepare()
        try:
            run_phase(setup, pkg.Phase.CREATEFILES, "zw")
        finally:
            setup.teardown()
        for extra in ([], ["--iodepth", "4"]):
            g = pkg.Group(pkg.config_from_args(
                [str(f), "-r", "-t", "2", "-b", str(BLK),
                 "-s", str(BLK * 512), "--tpubackend", "pjrt", "--nolive",
                 "--arrival", "trace", "--ratetrace", trace] + extra))
            g.prepare()
            try:
                t0 = time.monotonic()
                run_phase(g, pkg.Phase.READFILES, "zr")
                assert time.monotonic() - t0 < 30
                (st,) = g.tenant_stats()
                assert st["arrivals"] == st["completions"] + st["dropped"]
                assert 0 < st["completions"] < 512
            finally:
                g.teardown()


# ------------------------------------------------- /metrics gauges

def test_metrics_serving_gauges_and_scrape_during_swap(pkgs, tmp_path):
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path)
    families = []
    for pkg in pkgs:
        m = pkg.metrics
        cfg = pkg.config_from_args(rotation_args(
            pkg, tmp_path, trace, man,
            ["--bgbudget", "8M", "--slotarget", "60000"]))
        g = pkg.Group(cfg)
        g.prepare()
        try:
            run_phase(g, pkg.Phase.CREATEFILES, "mw")
            g.start_phase(pkg.Phase.READFILES, "mr")
            last_gen = -1.0
            last_complete = -1.0
            scrapes = 0
            names = set()
            while not g.wait_done(120):
                samples = m.parse_prometheus_text(
                    m.render_metrics(g, cfg, pkg.Phase.READFILES))
                names |= {k[0] for k in samples if k[0].startswith(
                    ("ebt_rotation", "ebt_serving"))}
                gen = m.metric_value(samples, "ebt_rotation_generation")
                assert gen is not None and gen >= last_gen
                last_gen = gen
                complete = m.metric_value(samples, "ebt_rotations_total",
                                          outcome="complete")
                assert complete is not None and complete >= last_complete
                last_complete = complete
                assert m.metric_value(samples,
                                      "ebt_rotation_bg_rate_bytes") == 8 << 20
                goodput = m.metric_value(samples,
                                         "ebt_serving_goodput_fraction",
                                         tenant="0")
                assert goodput is not None and 0.0 <= goodput <= 1.0
                assert m.metric_value(samples, "ebt_serving_sched_rate",
                                      tenant="0") == 150.0
                scrapes += 1
            assert scrapes >= 3
            assert last_gen >= 1
            families.append(names)
        finally:
            g.teardown()
    assert families[0] == families[1]


# --------------------------------------------- the port's own cases:
# the resident generation in device memory

def _drive(np_):
    """The DevCopyFn of a NativeCudaPath, callable from this thread (the
    engine's rotator calls the same entry: directions 16, 9, 0, 2, 10,
    17)."""
    fn_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_uint64, ctypes.c_uint64)
    fn = fn_t(np_.copy_fn_ptr)

    def call(direction, buf=None, length=0, off=0, device=0):
        return fn(np_.ctx, 0, device, direction,
                  ctypes.cast(buf, ctypes.c_void_p) if buf is not None
                  else None, length, off)
    return call


def _rotate_once(call, cfg, generation, shard_bytes, before_swap=None,
                 bufs=None):
    """One rotation as the engine's rotator drives it: begin, each shard's
    begin and blocks on its placement lane, the reuse barriers, the
    all-resident barrier and the swap. A failed block aborts the rotation
    as the rotator does: its buffers are settled, nothing is swapped.
    Returns the rcs of the blocks."""
    assert call(16, None, generation, 0) == 0
    if bufs is None:
        bufs = [ctypes.create_string_buffer(BLK) for _ in range(2)]
    rcs = []
    bi = 0
    for s, shard in enumerate(cfg.ckpt_shards):
        lane = shard.devices[0]
        assert call(9, None, s, 0, lane) == 0
        data = open(shard.path, "rb").read()
        for off in range(0, shard_bytes, BLK):
            buf = bufs[bi % 2]
            bi += 1
            call(2, buf, 0, 0, lane)
            ctypes.memmove(buf, data[off:off + BLK], BLK)
            rcs.append(call(0, buf, BLK, off, lane))
            if rcs[-1]:
                for b in bufs:
                    call(2, b, 0, 0)
                return rcs
    for buf in bufs:
        call(2, buf, 0, 0)
    assert call(10) == 0
    if before_swap is not None:
        before_swap()
    assert call(17) == 0
    return rcs


def _native_path(pkgs, tmp_path, man):
    torch_pkg = pkgs[1]
    cfg = torch_pkg.config_from_args(
        ["--checkpoint", man, "-b", str(BLK), "--tpubackend", "pjrt",
         "--nolive"])
    from elbencho_tpu_torch.cuda.native import NativeCudaPath

    np_ = NativeCudaPath(cfg)
    np_.set_ckpt_plan(cfg.ckpt_shards)
    return torch_pkg, cfg, np_


@pytest.mark.parametrize("tier", ["staged", "registered"])
def test_rotation_generation_is_resident_in_device_memory(pkgs, tmp_path,
                                                          tier):
    """After each swap the active generation, read back from device memory,
    equals the shard files byte for byte, whether the rotator's buffers
    are pageable (the engine's rotator: the staged tier) or registered.
    Plain reads that go through the landing ring afterwards leave it
    untouched, and after a second swap the read-back shows the second
    generation's bytes. The mock's live allocations rise by one per shard
    while a generation restores, fall by the displaced generation's at the
    swap and return to their start once the path is closed."""
    shard_blocks = 3
    man = write_model(tmp_path, shards=4, shard_blocks=shard_blocks, seed=1)
    shard_bytes = BLK * shard_blocks
    torch_pkg, cfg, np_ = _native_path(pkgs, tmp_path, man)
    live = torch_pkg.mock.ebt_mock_live_buffers
    maps = [mmap.mmap(-1, BLK) for _ in range(2)]
    bufs = [(ctypes.c_char * BLK).from_buffer(m) for m in maps]
    try:
        call = _drive(np_)
        if tier == "registered":
            for b in bufs:
                assert np_.register_buffer(ctypes.addressof(b), BLK)
        base = live()
        zc0 = np_.zero_copy_count
        assert not any(_rotate_once(call, cfg, 1, shard_bytes, bufs=bufs))
        assert (np_.zero_copy_count > zc0) == (tier == "registered")
        assert live() == base + 4
        gen1 = [open(s.path, "rb").read() for s in cfg.ckpt_shards]
        for s in range(4):
            assert np_.rotation_read(s, 0, shard_bytes) == gen1[s]
        # plain reads through the landing ring on every lane
        junk = ctypes.create_string_buffer(b"\xa5" * BLK, BLK)
        for lane in range(4):
            assert call(0, junk, BLK, 0, lane) == 0
            assert call(2, junk, 0, 0, lane) == 0
        for s in range(4):
            assert np_.rotation_read(s, 0, shard_bytes) == gen1[s]
        # the model changes on storage; the second rotation restores it
        rng = np.random.default_rng(2)
        for s in cfg.ckpt_shards:
            with open(s.path, "wb") as f:
                f.write(rng.integers(0, 256, shard_bytes,
                                     dtype=np.uint8).tobytes())
        gen2 = [open(s.path, "rb").read() for s in cfg.ckpt_shards]

        def both_resident():
            # both generations in device memory until the swap
            assert live() == base + 8
            for s in range(4):
                assert np_.rotation_read(s, 0, shard_bytes) == gen1[s]

        assert not any(_rotate_once(call, cfg, 2, shard_bytes,
                                    before_swap=both_resident, bufs=bufs))
        assert live() == base + 4
        for s in range(4):
            got = np_.rotation_read(s, 0, shard_bytes)
            assert got == gen2[s] and got != gen1[s]
        # a sub-range inside the shard
        assert np_.rotation_read(2, BLK + 8, 100) == gen2[2][BLK + 8:
                                                            BLK + 108]
        recs = np_.rotation_records()
        assert [r["generation"] for r in recs] == [1, 2]
        check_records(recs, 4, 4 * shard_bytes)
        assert recs[0]["retained_buffers"] == 4 * shard_blocks
    finally:
        np_.close()
    assert live() == 0


def test_rotation_recovery_lands_in_the_generation(pkgs, tmp_path,
                                                   monkeypatch):
    """With the fault policy armed, a rotation chunk whose copy fails in
    flight (EBT_MOCK_CUDA_DEV_FAIL_AT on device 1) is recovered onto a
    survivor lane into the generation's memory there, and so are the
    chunks replanned off the ejected lane: the rotation swaps reconciled,
    and shard 1 read back from the active generation equals its file."""
    monkeypatch.setenv("EBT_MOCK_CUDA_DEV_FAIL_AT", "1:2")
    man = write_model(tmp_path, shards=4, shard_blocks=2, seed=6)
    torch_pkg, cfg, np_ = _native_path(pkgs, tmp_path, man)
    live = torch_pkg.mock.ebt_mock_live_buffers
    try:
        np_.set_fault_policy(1, 1, 0)
        call = _drive(np_)
        base = live()
        assert not any(_rotate_once(call, cfg, 1, 2 * BLK))
        fs = np_.fault_stats()
        assert fs["dev_retry_success"] >= 1 and fs["ejected_devices"] == 1
        (rec,) = np_.rotation_records()
        assert rec["shards_resident"] == 4
        assert rec["bytes_submitted"] == rec["bytes_resident"] == 8 * BLK
        # the shard's allocation on lane 1 and chunk allocations on the
        # survivors hold it
        assert live() > base + 4
        for s, shard in enumerate(cfg.ckpt_shards):
            assert np_.rotation_read(s, 0, 2 * BLK) == \
                open(shard.path, "rb").read()
    finally:
        np_.close()
    assert live() == 0


def test_failed_rotation_parks_its_memory_until_the_next_begin(
        pkgs, tmp_path, monkeypatch):
    """A copy that fails inside a rotation (no --retry) fails the rotation
    with its cause: no swap, no record, the generation's memory stays
    parked, and the next rotation begin frees it before allocating anew.
    The seam is EBT_MOCK_CUDA_FAIL_AT (the Nth host-to-device copy fails at
    submit); EBT_MOCK_CUDA_XFER_FAIL_AT counts device-to-host copies, which
    a rotation never makes."""
    man = write_model(tmp_path, shards=4, shard_blocks=2, seed=3)
    torch_pkg, cfg, np_ = _native_path(pkgs, tmp_path, man)
    live = torch_pkg.mock.ebt_mock_live_buffers
    h2d_count = torch_pkg.mock.ebt_mock_h2d_count
    h2d_count.restype = ctypes.c_uint64
    try:
        call = _drive(np_)
        base = live()
        monkeypatch.setenv("EBT_MOCK_CUDA_FAIL_AT", str(h2d_count() + 3))
        rcs = _rotate_once(call, cfg, 1, 2 * BLK)
        monkeypatch.delenv("EBT_MOCK_CUDA_FAIL_AT")
        assert rcs == [0, 0, 1]
        assert "EBT_MOCK_CUDA_FAIL_AT" in np_.ckpt_error()
        assert np_.ckpt_error().startswith("device 1 shard 1: ")
        assert np_.rotation_records() == []
        st = np_.rotation_state()
        assert st["rotation_generation"] == 0
        assert st["rotation_restoring"] == 1
        # shards 0 and 1 began before the failure: their memory is parked
        assert live() == base + 2
        with pytest.raises(torch_pkg.ProgException):
            np_.rotation_read(0, 0, BLK)  # nothing was ever swapped in
        # the next begin frees the parked generation
        assert call(16, None, 2, 0) == 0
        assert live() == base
        assert not any(_rotate_once(call, cfg, 2, 2 * BLK))
        assert live() == base + 4
        (rec,) = np_.rotation_records()
        assert rec["generation"] == 2 and rec["shards_resident"] == 4
        assert rec["released_buffers"] == 0
        for s, shard in enumerate(cfg.ckpt_shards):
            assert np_.rotation_read(s, 0, 2 * BLK) == \
                open(shard.path, "rb").read()
    finally:
        np_.close()
    assert live() == 0


def test_rotation_without_device_memory_fails_with_its_cause(
        pkgs, tmp_path, monkeypatch):
    """A shard whose memory cannot be allocated fails the rotation at its
    begin, with the cause attributed to the shard and its lane; nothing of
    it is copied anywhere, and the next rotation that fits swaps."""
    man = write_model(tmp_path, shards=4, shard_blocks=2, seed=7)
    torch_pkg, cfg, np_ = _native_path(pkgs, tmp_path, man)
    live = torch_pkg.mock.ebt_mock_live_buffers
    landed = torch_pkg.mock.ebt_mock_total_bytes
    try:
        call = _drive(np_)
        base = live()
        assert call(16, None, 1, 0) == 0
        monkeypatch.setenv("EBT_MOCK_CUDA_ALLOC_MAX_BYTES", str(BLK))
        before = landed()
        assert call(9, None, 0, 0, 0) == 1
        monkeypatch.delenv("EBT_MOCK_CUDA_ALLOC_MAX_BYTES")
        assert landed() == before
        err = np_.ckpt_error()
        assert err.startswith("device 0 shard 0: rotation cuMemAlloc")
        assert "EBT_MOCK_CUDA_ALLOC_MAX_BYTES" in err
        assert live() == base and np_.rotation_records() == []
        assert not any(_rotate_once(call, cfg, 2, 2 * BLK))
        (rec,) = np_.rotation_records()
        assert rec["generation"] == 2 and rec["shards_resident"] == 4
    finally:
        np_.close()
    assert live() == 0


def test_rotation_fault_without_retry_fails_rotations_not_serving(
        pkgs, tmp_path, monkeypatch):
    """Through the engine's rotator: an in-flight fault on the lane that
    only the rotation uses (shard 3 on device 3; the serving reads use
    devices 0 and 1) fails rotations with their cause and no swap, while
    the serving phase itself completes; nothing leaks."""
    monkeypatch.setenv("EBT_MOCK_CUDA_DEV_FAIL_AT", "3:2")
    trace = write_trace(tmp_path, [{"at": 0, "kind": "step", "rate": 150}])
    man = write_model(tmp_path)
    pkg = pkgs[1]
    r = run_rotation(pkg, tmp_path, trace, man)
    assert r.error == ""
    assert r.svs["rotations_failed"] >= 1
    assert r.svs["rotations_started"] == (r.svs["rotations_complete"]
                                          + r.svs["rotations_failed"])
    assert r.recs == [] and r.svs["rotation_generation"] == 0
    (st,) = r.tenants
    assert st["arrivals"] == st["completions"] + st["dropped"]
    assert r.live == 0
