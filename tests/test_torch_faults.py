"""Device faults, lane ejection and the engine's fault budget on the port
(--retry/--retrybackoff/--maxerrors) against the original package's, on the
same inputs.

The native cases run the port's CUDA engine (csrc/cuda_path.cpp) on its mock
driver (EBT_MOCK_CUDA_DEVICES=4) beside the original's PjrtPath on its mock
plugin (EBT_MOCK_PJRT_DEVICES=4). The per-device fault seams are mapped so
that both fail the same lane's same copy: EBT_MOCK_STRIPE_FAIL_AT there,
EBT_MOCK_CUDA_DEV_FAIL_AT here ("<dev>:<n>", the warm-up copy counted).
The fault counters, ledgers, lane bytes, landed-byte checksums, error texts
and result-tree fields compare exactly. In a cause only the seam's name and
the driver's error-code wrapper differ ("CUDA error 999 (message)" where the
PJRT plugin gives the message), and the backoff clock (dev_retry_backoff_ns)
is not compared.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.coordinator as jax_coordinator
import elbencho_tpu.engine as jax_engine
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.liveops as jax_liveops
import elbencho_tpu.metrics as jax_metrics
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.coordinator as torch_coordinator
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.liveops as torch_liveops
import elbencho_tpu_torch.metrics as torch_metrics
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 256 << 10

# the original's mock seam -> the port's
SEAMS = {
    "EBT_MOCK_PJRT_DEVICES": "EBT_MOCK_CUDA_DEVICES",
    "EBT_MOCK_STRIPE_FAIL_AT": "EBT_MOCK_CUDA_DEV_FAIL_AT",
}


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_total_bytes.restype = ctypes.c_uint64
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    return lib


def _pkg(name, cfg, local, common, exc, stats, remote, coord, liveops,
         metrics, load_lib, lib, seam):
    return SimpleNamespace(
        name=name, config_from_args=cfg.config_from_args, Config=cfg.Config,
        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
        ProgException=exc.ProgException, Statistics=stats.Statistics,
        remote=remote, Coordinator=coord.Coordinator, LiveOps=liveops.LiveOps,
        metrics=metrics, load_lib=load_lib, mock=lib, seam=seam)


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, 4 devices each, counters zeroed."""
    if not os.path.exists(JAX_MOCK):
        subprocess.run(["make", "core"], cwd=REPO, check=True,
                       capture_output=True)
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    made = (
        _pkg("jax", jax_config, jax_local, jax_common, jax_exceptions,
             jax_stats, jax_remote, jax_coordinator, jax_liveops,
             jax_metrics, jax_engine.load_lib, _mock_lib(JAX_MOCK),
             "EBT_MOCK_STRIPE_FAIL_AT"),
        _pkg("torch", torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_remote, torch_coordinator,
             torch_liveops, torch_metrics, torch_engine.load_lib,
             _mock_lib(torch_mock), "EBT_MOCK_CUDA_DEV_FAIL_AT"))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def set_seam(monkeypatch, name: str, value) -> None:
    """Set a mock seam under both packages' names."""
    monkeypatch.setenv(name, str(value))
    monkeypatch.setenv(SEAMS[name], str(value))


def cause(pkg, text: str) -> str:
    """A cause text with the package's seam name and driver wrapper
    taken out."""
    return re.sub(r"CUDA error \d+ \((.*)\)", r"\1",
                  text.replace(pkg.seam, "SEAM"))


def run_phase(pkg, group, phase=None, bench_id="faults-test") -> None:
    group.start_phase(phase or pkg.Phase.READFILES, bench_id)
    while not group.wait_done(1000):
        pass


def file_checksum(path) -> int:
    data = np.fromfile(str(path), dtype=np.uint8)
    return int(data.sum(dtype=np.uint64)) & ((1 << 64) - 1)


def seeded_file(path, nbytes: int, seed: int = 0):
    path.write_bytes(np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes())
    return path


def stripe_args(path, nblocks: int, extra=()) -> list[str]:
    """A striped read of nblocks x 256 KiB, --regwindow at twice the block
    so a stripe unit is one block."""
    return ["-r", "-t", "1", "-s", str(nblocks * BLK), "-b", str(BLK),
            "--tpubackend", "pjrt", "--stripe", "rr",
            "--regwindow", str(2 * BLK), "--nolive", *extra, str(path)]


def faulted_read(pkg, args) -> dict:
    """One package's striped read; what the two packages must agree on."""
    pkg.mock.ebt_mock_reset()
    group = pkg.Group(pkg.config_from_args(args))
    group.prepare()
    try:
        run_phase(pkg, group)
        fs = group.fault_stats()
        fs.pop("dev_retry_backoff_ns")
        st = group.stripe_stats()
        wire = pkg.Statistics(group.cfg, group).bench_result_wire(
            pkg.Phase.READFILES, "b", [])
        wire_fs = dict(wire["FaultStats"])
        wire_fs.pop("dev_retry_backoff_ns")
        return {
            "error": cause(pkg, group.first_error()),
            "fault": fs,
            "engine_fault": group.engine_fault_stats(),
            "ejected": cause(pkg, group.ejected_devices()),
            "checksum": pkg.mock.ebt_mock_checksum(),
            "units": (st["units_submitted"], st["units_awaited"]),
            "stripe_error": cause(pkg, group.stripe_error()),
            "lanes": [ln["to_hbm"] for ln in group.lane_stats()],
            "mask": group._native_path.ejected_mask,
            "wire": (wire_fs, wire["EngineFaultStats"],
                     cause(pkg, wire["EjectedDevices"]),
                     wire["FaultCauses"]),
        }
    finally:
        group.teardown()


# ------------------------------- device ejection + live replanning


def test_recovery_replans_byte_exact(pkgs, tmp_path, monkeypatch):
    """A device failure in flight under --retry/--maxerrors is recovered
    onto a survivor: the lane is ejected with "device N: cause", later
    placements replan, every stripe unit settles, and the landed bytes are
    byte-exact, with the original's counters."""
    nblocks = 12
    f = seeded_file(tmp_path / "data", nblocks * BLK)
    # device 2's copy #2 = its first planner-routed block (the warm-up copy
    # is #1) fails in flight
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    args = stripe_args(f, nblocks, ["--retry", "1", "--maxerrors", "5%"])
    out = {p.name: faulted_read(p, args) for p in pkgs}
    t = out["torch"]
    assert t["error"] == ""
    assert t["fault"]["ejected_devices"] == 1
    assert t["fault"]["dev_retry_success"] >= 1
    assert t["fault"]["replanned_units"] >= 1
    assert t["ejected"].startswith("device 2:") and "SEAM" in t["ejected"]
    assert t["checksum"] == file_checksum(f)
    assert t["units"] == (nblocks, nblocks)
    assert t["stripe_error"] == ""
    assert sum(t["lanes"]) == nblocks * BLK
    assert t["lanes"][2] < nblocks * BLK // 4
    assert t["mask"] == 1 << 2
    assert t == out["jax"]


def test_maxerrors_zero_default_reproduces_abort(pkgs, tmp_path,
                                                 monkeypatch):
    """Without --maxerrors the same injection aborts on the first error with
    the device attribution, and no fault machinery runs."""
    nblocks = 12
    f = seeded_file(tmp_path / "data", nblocks * BLK)
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    out = {}
    for pkg in pkgs:
        group = pkg.Group(pkg.config_from_args(stripe_args(f, nblocks)))
        group.prepare()
        try:
            run_phase(pkg, group)
            err = group.first_error()
            assert "device 2" in err and pkg.seam in err
            out[pkg.name] = (group.fault_stats(),
                             group.engine_fault_stats(),
                             group.ejected_devices())
        finally:
            group.teardown()
    fs, efs, ejected = out["torch"]
    assert all(v == 0 for v in fs.values())
    assert all(v == 0 for v in efs.values())
    assert ejected == ""
    assert out["torch"] == out["jax"]


def test_ckpt_restore_replans_byte_exact(pkgs, tmp_path, monkeypatch):
    """Checkpoint placement replans too: a restore with a device failure
    ends with every shard resident (submitted == resident bytes), the
    recovered bytes credited to the survivor lane."""
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "1:2")
    out = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        cfg = pkg.config_from_args(
            ["--checkpoint-shards", "4", "-w", "-s", str(2 * BLK),
             "-b", str(BLK), "-t", "2", "--tpubackend", "pjrt",
             "--retry", "1", "--maxerrors", "10%", "--nolive", str(d)])
        group = pkg.Group(cfg)
        group.prepare()
        try:
            run_phase(pkg, group, pkg.Phase.CHECKPOINT)
            fs = group.fault_stats()
            fs.pop("dev_retry_backoff_ns")
            cs = group.ckpt_stats()
            out[pkg.name] = {
                "error": group.first_error(),
                "shards": (cs["shards_total"], cs["shards_resident"]),
                "bytes": tuple(group._native_path.ckpt_byte_totals()),
                "dev_bytes": sum(group.ckpt_dev_bytes()),
                "ejected_devices": fs["ejected_devices"],
                "ejected": group.ejected_devices()[:len("device 1:")],
                "ckpt_error": group.ckpt_error(),
            }
        finally:
            group.teardown()
    t = out["torch"]
    assert t["error"] == "" and t["ckpt_error"] == ""
    assert t["shards"] == (4, 4)
    assert t["bytes"][0] == t["bytes"][1] == t["dev_bytes"] == 8 * BLK
    assert t["ejected_devices"] == 1 and t["ejected"] == "device 1:"
    assert t == out["jax"]


def test_recovery_under_eviction_churn_waits_out_unpins(pkgs, tmp_path,
                                                        monkeypatch):
    """Port only: a recovery resubmit copies from the failed block's host
    buffer while four workers' windows churn through a one-block
    --regwindow budget. The mock's unpin takes 1 ms, during which the range
    still counts as pinned, and a copy from a range unpinned before it runs
    faults its stream. The failed block's range stays busy under its
    settle's draining span, and the resubmit takes the registration hold a
    first submit takes, so no copy reads a range mid-unpin: the read ends
    byte-exact with the lane ejected."""
    monkeypatch.setenv("EBT_MOCK_CUDA_UNREGISTER_US", "1000")
    monkeypatch.setenv("EBT_MOCK_CUDA_DELAY_US", "3000")
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    nblocks = 32
    f = seeded_file(tmp_path / "data", nblocks * BLK, seed=3)
    torch = pkgs[1]
    out = faulted_read(torch, ["-r", "-t", "4", "-s", str(nblocks * BLK),
                               "-b", str(BLK // 4), "--tpubackend", "pjrt",
                               "--stripe", "rr", "--regwindow", str(BLK),
                               "--retry", "1", "--maxerrors", "5%",
                               "--nolive", str(f)])
    assert out["error"] == ""
    assert out["fault"]["ejected_devices"] == 1
    assert out["fault"]["dev_retry_success"] >= 1
    assert out["checksum"] == file_checksum(f)
    assert out["units"][0] == out["units"][1]
    assert sum(out["lanes"]) == nblocks * BLK


# ---------------------------------- engine retry + error budget


def _truncated_read_group(pkg, tmp_path, nblocks, lost, extra):
    """A read group whose last `lost` blocks fail: the file shrinks between
    preparation and the phase, so the read hits EOF there."""
    blk = 64 << 10
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    f = d / "shrink.bin"
    f.write_bytes(b"x" * (nblocks * blk))
    cfg = pkg.config_from_args(
        ["-r", "-t", "1", "-s", str(nblocks * blk), "-b", str(blk),
         "--nolive"] + extra + [str(f)])
    group = pkg.Group(cfg)
    group.prepare()
    os.truncate(f, (nblocks - lost) * blk)
    return group, blk


def test_engine_retry_and_budget_absorb(pkgs, tmp_path):
    """Storage failures are retried with backoff, then absorbed by the
    error budget with per-cause attribution."""
    out = {}
    for pkg in pkgs:
        group, blk = _truncated_read_group(
            pkg, tmp_path, 8, 2, ["--retry", "2", "--retrybackoff", "1",
                                  "--maxerrors", "50%"])
        try:
            run_phase(pkg, group)
            efs = group.engine_fault_stats()
            assert efs.pop("io_retry_backoff_ns") > 0
            out[pkg.name] = (group.first_error(), efs, group.fault_causes(),
                             sum(s.ops.bytes for s in group.live_snapshot()))
        finally:
            group.teardown()
    err, efs, causes, total = out["torch"]
    assert err == ""
    assert efs["errors_tolerated"] == 2
    assert efs["io_retry_attempts"] == 4 and efs["io_retry_success"] == 0
    assert "read x2" in causes
    assert total == 6 * (64 << 10)
    assert out["torch"] == out["jax"]


def test_engine_budget_exhaustion_aborts_with_cause(pkgs, tmp_path):
    """An exhausted absolute budget aborts the phase, naming the budget and
    the last failure."""
    errs = {}
    for pkg in pkgs:
        group, _ = _truncated_read_group(
            pkg, tmp_path, 8, 3, ["--retry", "0", "--maxerrors", "1"])
        try:
            run_phase(pkg, group)
            errs[pkg.name] = group.first_error()
        finally:
            group.teardown()
    err = errs["torch"]
    assert "error budget exhausted" in err and "--maxerrors 1" in err
    assert "end of file" in err
    assert err == errs["jax"]


def test_maxerrors_zero_storage_failure_aborts(pkgs, tmp_path):
    """The --maxerrors 0 default keeps the first storage failure fatal."""
    out = {}
    for pkg in pkgs:
        group, _ = _truncated_read_group(pkg, tmp_path, 8, 2, [])
        try:
            run_phase(pkg, group)
            out[pkg.name] = (group.first_error(), group.engine_fault_stats())
        finally:
            group.teardown()
    err, efs = out["torch"]
    assert "end of file" in err
    assert all(v == 0 for v in efs.values())
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_interrupt_wakes_backoff_promptly(pkgs, tmp_path, which):
    """An interrupt mid-backoff wakes the sleeper promptly and leaves no
    registration or uring hold behind, in both packages."""
    pkg = {p.name: p for p in pkgs}[which]
    group, _ = _truncated_read_group(
        pkg, tmp_path, 8, 2, ["--retry", "8", "--retrybackoff", "2000",
                              "--maxerrors", "50%"])
    try:
        group.start_phase(pkg.Phase.READFILES, "intr")
        # let the worker reach the failing block and enter its first
        # 2000 ms-base backoff, then interrupt
        time.sleep(0.4)
        t0 = time.monotonic()
        group.interrupt()
        while not group.wait_done(200):
            assert time.monotonic() - t0 < 5.0, \
                "interrupt did not wake the backoff sleeper"
        assert time.monotonic() - t0 < 2.0
        lib = pkg.load_lib()
        lib.ebt_uring_reg_state.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_uring_reg_state.restype = None
        state = (ctypes.c_uint64 * 3)()
        lib.ebt_uring_reg_state(state)
        assert state[2] == 0
    finally:
        group.teardown()


def test_open_loop_ledger_exact_with_tolerated_failures(pkgs, tmp_path):
    """Tolerated failures count as dropped offered load, keeping
    arrivals == completions + dropped exact."""
    out = {}
    for pkg in pkgs:
        group, _ = _truncated_read_group(
            pkg, tmp_path, 8, 2, ["--retry", "0", "--maxerrors", "50%",
                                  "--arrival", "paced", "--rate", "500"])
        try:
            run_phase(pkg, group)
            assert group.first_error() == ""
            stats = group.tenant_stats()
            for st in stats:
                assert st["arrivals"] == st["completions"] + st["dropped"]
                assert st["dropped"] >= 2
            out[pkg.name] = [(st["arrivals"], st["completions"],
                              st["dropped"]) for st in stats]
        finally:
            group.teardown()
    assert out["torch"] == out["jax"]


# --------------------------------------- result tree + pod fan-in


def test_result_tree_carries_fault_fields(pkgs, tmp_path, monkeypatch):
    """The result tree publishes FaultStats, EngineFaultStats, FaultCauses
    and EjectedDevices with the original's values."""
    nblocks = 12
    f = seeded_file(tmp_path / "data", nblocks * BLK)
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    args = stripe_args(f, nblocks, ["--retry", "1", "--maxerrors", "5%"])
    wires = {p.name: faulted_read(p, args)["wire"] for p in pkgs}
    fs, efs, ejected, causes = wires["torch"]
    assert fs["ejected_devices"] == 1 and fs["replanned_units"] >= 1
    assert efs["errors_tolerated"] == 0
    assert ejected.startswith("device 2:")
    assert causes == ""
    assert wires["torch"] == wires["jax"]


def test_pod_fanin_sums_and_frames_fault_stats(pkgs):
    """Master fan-in: counters sum across services, attributions come back
    host-framed."""
    got = []
    for pkg in pkgs:
        cfg = pkg.Config(paths=["/tmp/x"], hosts=["h0", "h1"],
                         num_threads=1)
        g = pkg.remote.RemoteWorkerGroup(cfg)
        g.proxies[0].fault_stats = {"ejected_devices": 1,
                                    "replanned_units": 3}
        g.proxies[1].fault_stats = {"ejected_devices": 1,
                                    "replanned_units": 2}
        g.proxies[0].engine_fault_stats = {"errors_tolerated": 2}
        g.proxies[1].engine_fault_stats = {"errors_tolerated": 1}
        g.proxies[0].ejected_devices = "device 2: boom"
        g.proxies[1].fault_causes = "read x3"
        g.proxies[1].status = "dead"
        g.proxies[1].error = "service h1: no status reply"
        got.append((g.fault_stats(), g.engine_fault_stats(),
                    g.ejected_devices(), g.fault_causes(),
                    g.degraded_hosts()))
    assert got[1] == ({"ejected_devices": 2, "replanned_units": 5},
                      {"errors_tolerated": 3},
                      "service h0: device 2: boom", "[h1] read x3",
                      [{"host": "h1",
                        "cause": "service h1: no status reply"}])
    assert got[1] == got[0]


class SalvagePod:
    """Mock service layer: healthy hosts finish cleanly, `dead` stops
    answering /status after its first poll. Counts /benchresult requests
    per host (a dead host must get none)."""

    def __init__(self, pkg, dead: str) -> None:
        self.pkg = pkg
        self.dead = dead
        self.polls: dict[str, int] = {}
        self.results: list[str] = []
        self.lock = threading.Lock()

    def request(self, host, endpoint, params=None, body=None, timeout=20.0):
        if endpoint == "/preparephase":
            return {"BenchPathInfo": {"BenchPathType": 1,
                                      "NumBenchPaths": 1,
                                      "FileSize": 1 << 20}}
        if endpoint in ("/startphase", "/interruptphase"):
            return {}
        if endpoint == "/status":
            with self.lock:
                n = self.polls[host] = self.polls.get(host, 0) + 1
            if host == self.dead and n > 1:
                raise self.pkg.remote.ServiceUnreachable(
                    f"service {host}: connection failed: timed out")
            return {"BenchID": "",
                    "LiveOps": self.pkg.LiveOps(bytes=100).to_wire(),
                    "NumWorkersDone": 0, "NumWorkersDoneWithError": 0}
        if endpoint == "/benchresult":
            with self.lock:
                self.results.append(host)
            return {"Ops": self.pkg.LiveOps(bytes=300).to_wire(),
                    "ElapsedUSecsList": [1000, 1000],
                    "NumWorkersDone": 2, "NumWorkersDoneWithError": 0}
        return {}


def _salvage(pkg, monkeypatch, fault_tolerant: bool):
    pod = SalvagePod(pkg, dead="h1")
    cfg = pkg.Config(paths=["/tmp/ebt-salvage"], hosts=["h0", "h1", "h2"],
                     num_threads=2, svc_fanout=3, host_timeout_secs=0.4,
                     svc_update_interval_ms=50, disable_live_stats=True)
    if fault_tolerant:
        cfg.max_errors_pct = 5
        cfg.max_errors_spec = "5%"
    monkeypatch.setattr(pkg.remote, "_request", pod.request)
    g = pkg.remote.RemoteWorkerGroup(cfg)
    coord = pkg.Coordinator(cfg)
    coord.workers = g
    coord.stats = pkg.Statistics(cfg, g)
    g.prepare()
    return pod, g, coord


def test_dead_host_salvages_partial_pod_results(pkgs, monkeypatch):
    """With --hosttimeout declaring a host dead mid-phase and --maxerrors
    set, the pod result is salvaged from the live hosts: no result fetch
    from the dead host, which is named in the degraded summary."""
    got = []
    for pkg in pkgs:
        pod, g, coord = _salvage(pkg, monkeypatch, fault_tolerant=True)
        try:
            coord._run_phase(pkg.Phase.READFILES)  # must not raise
            degraded = g.degraded_hosts()
            assert "hosttimeout" in degraded[0]["cause"]
            got.append((sorted(pod.results),
                        [d["host"] for d in degraded]))
        finally:
            g.teardown()
    assert got[1] == (["h0", "h2"], ["h1"])
    assert got[1] == got[0]


def test_dead_host_without_budget_keeps_abort(pkgs, monkeypatch):
    """The --maxerrors 0 default keeps the dead host fatal."""
    for pkg in pkgs:
        _, g, coord = _salvage(pkg, monkeypatch, fault_tolerant=False)
        try:
            with pytest.raises(pkg.ProgException, match="h1"):
                coord._run_phase(pkg.Phase.READFILES)
        finally:
            g.teardown()


# ------------------------------------------------------------- metrics


def test_mid_ejection_scrape_consistent(pkgs, tmp_path, monkeypatch):
    """A scrape after a mid-phase ejection parses, exports the ejection, and
    its stripe family still reconciles, with the original's values."""
    nblocks = 12
    f = seeded_file(tmp_path / "data", nblocks * BLK)
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    got = []
    for pkg in pkgs:
        cfg = pkg.config_from_args(
            stripe_args(f, nblocks, ["--retry", "1", "--maxerrors", "5%"]))
        group = pkg.Group(cfg)
        group.prepare()
        try:
            run_phase(pkg, group)
            assert group.first_error() == ""
            m = pkg.metrics
            samples = m.parse_prometheus_text(
                m.render_metrics(group, cfg, pkg.Phase.READFILES))
            sub = m.metric_value(samples, "ebt_stripe_units_total",
                                 state="submitted")
            awaited = m.metric_value(samples, "ebt_stripe_units_total",
                                     state="awaited")
            got.append((m.metric_value(samples, "ebt_fault_ejected_devices"),
                        m.metric_value(samples,
                                       "ebt_fault_replanned_units_total"),
                        sub, awaited))
        finally:
            group.teardown()
    ejected, replanned, sub, awaited = got[1]
    assert ejected == 1 and replanned >= 1
    assert sub == awaited and sub > 0
    assert got[1] == got[0]
