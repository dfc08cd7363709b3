"""The completion reactor behind the port's native CUDA engine, against the
original package's, on the same inputs.

On pjrt a copy's completion reaches the worker's reactor through a host
function behind the copy (CudaPath::hostFnTrampoline, armed by
attachCompletion) where the original's reaches it through a PJRT OnReady
callback. Only completions the worker does not await in the same call wake
its reactor, in both packages: the deferred read copies and the deferred
D2H fetches. The original runs on its mock PJRT plugin, the port on its
mock CUDA driver, two devices each with a per-copy service time, so
completions land asynchronously. The ports of tests/test_reactor.py's
onready, bridge-injection, result-tree and pod fan-in cases.
"""

from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.reactor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")

BS = 128 << 10
WAKEUP_KEYS = ("reactor_wakeups_cq", "reactor_wakeups_onready",
               "reactor_wakeups_arrival", "reactor_wakeups_timeout",
               "reactor_wakeups_interrupt")


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks: two devices, 200 us of service
    time per copy."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "2")
    for k in ("EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US"):
        monkeypatch.setenv(k, "200")
    made = []
    for name, cfg, local, common, stats, remote, lib in (
            ("jax", jax_config, jax_local, jax_common, jax_stats, jax_remote,
             JAX_MOCK),
            ("torch", torch_config, torch_local, torch_common, torch_stats,
             torch_remote, torch_mock)):
        mock = ctypes.CDLL(lib)
        mock.ebt_mock_checksum.restype = ctypes.c_uint64
        mock.ebt_mock_reset()
        made.append(SimpleNamespace(
            name=name, config_from_args=cfg.config_from_args,
            Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
            Statistics=stats.Statistics,
            RemoteGroup=remote.RemoteWorkerGroup, mock=mock))
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def make_file(tmp_path, nblocks: int) -> str:
    f = tmp_path / "f.bin"
    f.write_bytes(np.random.default_rng(11).integers(
        0, 256, nblocks * BS, dtype=np.uint8).tobytes())
    return str(f)


def run_read(pkg, path: str, nblocks: int, extra: list[str]) -> SimpleNamespace:
    """One READ phase; the bytes read, the reactor's evidence, the tenant
    ledger and the wire tree."""
    cfg = pkg.config_from_args(["-r", "-s", str(nblocks * BS), "-b", str(BS),
                                "--nolive", *extra, path])
    g = pkg.Group(cfg)
    g.prepare()
    try:
        g.start_phase(pkg.Phase.READFILES, "reactor-test")
        while not g.wait_done(1000):
            pass
        assert g.first_error() == "", (pkg.name, g.first_error())
        return SimpleNamespace(
            bytes=sum(s.ops.bytes for s in g.live_snapshot()),
            stats=g.reactor_stats(), enabled=g.reactor_enabled(),
            cause=g.reactor_cause(), tenants=g.tenant_stats(),
            wire=pkg.Statistics(cfg, g).bench_result_wire(
                pkg.Phase.READFILES, "rw", []))
    finally:
        g.teardown()


def test_ab_mmap_loop_onready_wakeups(pkgs, tmp_path, monkeypatch):
    """The mmap hot loop on pjrt (registered, deferred copies) under open
    loop: the completions of the worker's own copies wake its reactor
    (onready wakeups), every wait is attributed to one cause, and the
    EBT_REACTOR_DISABLE=1 control lands the same bytes on the device; the
    two packages read and land the same bytes."""
    path = make_file(tmp_path, 24)
    # 10 ms gaps: each copy finishes inside its gap, so the worker is ahead
    # of the schedule and sleeps in the unified wait
    extra = ["-t", "2", "--tpubackend", "pjrt", "--arrival", "paced",
             "--rate", "100"]
    landed = {}
    for pkg in pkgs:
        pkg.mock.ebt_mock_reset()
        monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
        r = run_read(pkg, path, 24, extra)
        open_sum = pkg.mock.ebt_mock_checksum()
        assert r.bytes == 24 * BS
        assert r.enabled and r.stats["reactor_waits"] > 0
        assert r.stats["reactor_wakeups_onready"] > 0
        assert r.stats["reactor_waits"] == sum(r.stats[k]
                                               for k in WAKEUP_KEYS)
        for st in r.tenants:
            assert st["arrivals"] == st["completions"] + st["dropped"]
        pkg.mock.ebt_mock_reset()
        monkeypatch.setenv("EBT_REACTOR_DISABLE", "1")
        try:
            p = run_read(pkg, path, 24, extra)
        finally:
            monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
        assert p.bytes == r.bytes and not p.enabled
        assert p.stats["reactor_waits"] == 0
        assert "EBT_REACTOR_DISABLE" in p.cause
        assert pkg.mock.ebt_mock_checksum() == open_sum
        landed[pkg.name] = open_sum
    assert landed["torch"] == landed["jax"]


@pytest.mark.parametrize("backend", [[], ["--tpubackend", "pjrt"]],
                         ids=["host", "pjrt"])
def test_bridge_fault_injection_unwinds_to_polling(pkgs, tmp_path,
                                                   monkeypatch, backend):
    """EBT_MOCK_REACTOR_FAIL_AT=1: the first eventfd-bridge arm fails, the
    worker unwinds to polling with the cause latched (never an error) and
    the same bytes, and the next engine re-arms (the injection is
    consumed). On pjrt the completions still settle every copy while no
    reactor listens: the host functions then carry no descriptor."""
    path = make_file(tmp_path, 16)
    extra = ["-t", "1", "--arrival", "paced", "--rate", "400", *backend]
    for pkg in pkgs:
        clean = run_read(pkg, path, 16, extra)
        monkeypatch.setenv("EBT_MOCK_REACTOR_FAIL_AT", "1")
        try:
            hit = run_read(pkg, path, 16, extra)
        finally:
            monkeypatch.delenv("EBT_MOCK_REACTOR_FAIL_AT", raising=False)
        assert hit.bytes == clean.bytes == 16 * BS
        assert not hit.enabled
        assert "EBT_MOCK_REACTOR_FAIL_AT" in hit.cause
        assert hit.stats["reactor_waits"] == 0
        again = run_read(pkg, path, 16, extra)
        assert again.bytes == clean.bytes
        assert again.enabled and again.cause == ""
        assert again.stats["reactor_waits"] > 0


@pytest.mark.parametrize("backend", [[], ["--tpubackend", "pjrt"]],
                         ids=["host", "pjrt"])
def test_result_tree_carries_reactor_fields(pkgs, tmp_path, backend):
    """ReactorEnabled, ReactorCause, ReactorStats (every wait attributed to
    one cause) and NumaStats reach the wire with the original's keys and,
    for the flags and the family's keys, the original's values."""
    path = make_file(tmp_path, 8)
    extra = ["-t", "1", "--arrival", "paced", "--rate", "400",
             "--numazones", "0", *backend]
    wires = {}
    for pkg in pkgs:
        wire = run_read(pkg, path, 8, extra).wire
        assert wire["ReactorEnabled"] is True
        assert not wire["ReactorCause"]
        rs = wire["ReactorStats"]
        assert set(rs) == {"reactor_waits", *WAKEUP_KEYS,
                           "spin_polls_avoided",
                           "reactor_wakeups_coalesced"}
        assert rs["reactor_waits"] == sum(rs[k] for k in WAKEUP_KEYS)
        assert set(wire["NumaStats"]) == {
            "numa_nodes", "numa_local_bytes", "numa_remote_bytes",
            "numa_bind_fallbacks"}
        wires[pkg.name] = wire
    for key in ("ReactorEnabled", "ReactorCause", "NumaStats"):
        assert wires["torch"][key] == wires["jax"][key], key


class _Proxy:
    def __init__(self, host, enabled, cause, stats, numa):
        self.host = host
        self.host_index = int(host[1:])
        self.reactor_enabled = enabled
        self.reactor_cause = cause
        self.reactor_stats = stats
        self.numa_stats = numa


def test_pod_fanin_reactor_and_numa(pkgs):
    """The master's fan-in: reactor counters sum, ReactorEnabled is the
    pod-lowest claim, the first host-framed cause wins, the numa counters
    sum while numa_nodes takes the largest: the original's answers on the
    same two services."""
    proxies = [
        ("h0", True, None,
         {"reactor_waits": 5, "reactor_wakeups_cq": 2,
          "reactor_wakeups_arrival": 3},
         {"numa_nodes": 2, "numa_local_bytes": 10,
          "numa_remote_bytes": 1, "numa_bind_fallbacks": 0}),
        ("h1", False, "disabled by EBT_REACTOR_DISABLE=1",
         {"reactor_waits": 1, "reactor_wakeups_arrival": 1},
         {"numa_nodes": 1, "numa_local_bytes": 4,
          "numa_remote_bytes": 0, "numa_bind_fallbacks": 2}),
    ]
    got = {}
    for pkg in pkgs:
        g = pkg.RemoteGroup.__new__(pkg.RemoteGroup)
        g.proxies = [_Proxy(*p) for p in proxies]
        got[pkg.name] = (g.reactor_enabled(), g.reactor_cause(),
                         g.reactor_stats(), g.numa_stats())
    assert got["torch"] == got["jax"]
    enabled, cause, merged, numa = got["torch"]
    assert enabled is False
    assert cause == "service h1: disabled by EBT_REACTOR_DISABLE=1"
    assert merged["reactor_waits"] == 6
    assert merged["reactor_wakeups_cq"] == 2
    assert merged["reactor_wakeups_arrival"] == 4
    assert numa == {"numa_nodes": 2, "numa_local_bytes": 14,
                    "numa_remote_bytes": 1, "numa_bind_fallbacks": 2}
