"""The N->M reshard on the port (--reshard M) against the original
package's, on the same inputs.

The planner cases feed both packages' plan_reshard the same manifests and
compare the units field for field. The native cases run the port's CUDA
engine (csrc/cuda_path.cpp) on its mock driver (EBT_MOCK_CUDA_DEVICES=4)
beside the original's PjrtPath on its mock plugin (EBT_MOCK_PJRT_DEVICES=4):
moves ride cuMemcpyPeerAsync there instead of PJRT_Buffer_CopyToDevice, the
bounce tier is a D2H fetch into pinned scratch and an H2D copy. The seams
map EBT_MOCK_D2D_FAIL_AT to EBT_MOCK_CUDA_D2D_FAIL_AT and
EBT_MOCK_PJRT_NO_D2D to EBT_MOCK_CUDA_NO_D2D; EBT_D2D_DISABLE is shared.
Unit outcomes, byte ledgers, the pair matrix, the confirmed tier, entries,
refusal texts, result-tree fields and the mocks' landed-byte checksums
compare exactly; the barriers' wait (resident_wait_ns) is a clock and is not
compared.
"""

from __future__ import annotations

import ctypes
import os
import random
from types import SimpleNamespace

import pytest

import elbencho_tpu.checkpoint as jax_checkpoint
import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.checkpoint as torch_checkpoint
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.reshard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 256 << 10

# the original's mock seam -> the port's
SEAMS = {
    "EBT_MOCK_D2D_FAIL_AT": "EBT_MOCK_CUDA_D2D_FAIL_AT",
    "EBT_MOCK_PJRT_NO_D2D": "EBT_MOCK_CUDA_NO_D2D",
}

PLANNERS = (jax_checkpoint, torch_checkpoint)


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.ebt_mock_total_bytes.restype = ctypes.c_uint64
    lib.ebt_mock_checksum.restype = ctypes.c_uint64
    lib.ebt_mock_d2d_count.restype = ctypes.c_uint64
    return lib


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, 4 devices each, counters zeroed."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_D2D_DISABLE", *SEAMS, *SEAMS.values()):
        monkeypatch.delenv(k, raising=False)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    made = tuple(
        SimpleNamespace(name=name, config_from_args=cfg.config_from_args,
                        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
                        ProgException=exc.ProgException,
                        Statistics=stats.Statistics, remote=remote,
                        mock=_mock_lib(lib))
        for name, cfg, local, common, exc, stats, remote, lib in (
            ("jax", jax_config, jax_local, jax_common, jax_exceptions,
             jax_stats, jax_remote, JAX_MOCK),
            ("torch", torch_config, torch_local, torch_common,
             torch_exceptions, torch_stats, torch_remote, torch_mock)))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def set_seam(monkeypatch, name: str, value) -> None:
    """Set a mock seam under both packages' names."""
    monkeypatch.setenv(name, str(value))
    monkeypatch.setenv(SEAMS[name], str(value))


def reshard_args(d, nshards: int, target: int, extra=()) -> list[str]:
    """A generated nshards-shard manifest (shard i on lane i % 4) resharded
    onto the first `target` lanes."""
    return ["--checkpoint-shards", str(nshards), "-w", "-s", str(BLK),
            "-b", str(BLK), "--reshard", str(target), "-t", "2",
            "--tpubackend", "pjrt", "--nolive", *extra, str(d)]


def run_session(pkg, d, nshards: int, target: int, extra=()) -> dict:
    """One fresh-group RESHARD session of one package; what the two packages
    must agree on."""
    d.mkdir(parents=True, exist_ok=True)
    cfg = pkg.config_from_args(reshard_args(d, nshards, target, extra))
    group = pkg.Group(cfg)
    group.prepare()
    try:
        group.start_phase(pkg.Phase.RESHARD, "rs-test")
        while not group.wait_done(1000):
            pass
        st = group.reshard_stats()
        st.pop("resident_wait_ns")
        return {
            "error": group.first_error(),
            "stats": st,
            "pairs": sorted((p["src"], p["dst"], p["moves"], p["bytes"])
                            for p in group.reshard_pairs() or []),
            "tier": group.reshard_tier(),
            "reshard_error": group.reshard_error(),
            "entries": sum(r.ops.entries for r in group.phase_results()),
            "d2d_calls": pkg.mock.ebt_mock_d2d_count(),
            "checksum": pkg.mock.ebt_mock_checksum(),
        }
    finally:
        group.teardown()


def both(pkgs, tmp_path, nshards, target, extra=()) -> dict:
    out = {}
    for pkg in pkgs:
        pkg.mock.ebt_mock_reset()
        out[pkg.name] = run_session(pkg, tmp_path / pkg.name, nshards,
                                    target, extra)
    return out


# ------------------------------------------------- planner properties


def shard(ckpt, devices, nbytes: int = BLK, path: str = "s.bin"):
    return ckpt.CheckpointShard(path=path, devices=devices, bytes=nbytes)


def plans(make_shards, num_devices, target):
    """Both packages' plans of the same manifest, as comparable tuples."""
    out = []
    for ckpt in PLANNERS:
        units = ckpt.plan_reshard(make_shards(ckpt), num_devices, target)
        out.append(([(u.shard, u.action, u.src_dev, u.dst_dev, u.bytes,
                      u.path) for u in units],
                    ckpt.reshard_plan_summary(units)))
    assert out[1] == out[0]
    return out[1]


def test_plan_identity_zero_moves():
    units, summary = plans(
        lambda c: [shard(c, [i % 4], path=f"s{i}") for i in range(8)], 4, 4)
    assert [u[1] for u in units] == ["resident"] * 8
    assert all(u[2] == u[3] == i % 4 for i, u in enumerate(units))
    assert summary == {"units": 8, "resident": 8, "move": 0, "read": 0,
                       "move_bytes": 0, "read_bytes": 0}


def test_plan_consolidation_drains_evicted_exactly():
    units, _ = plans(
        lambda c: [shard(c, [i % 4], path=f"s{i}") for i in range(8)], 4, 2)
    assert all(u[3] < 2 for u in units)
    moves = [u for u in units if u[1] == "move"]
    assert sorted(u[0] for u in moves) == [2, 3, 6, 7]
    assert all(u[2] == u[0] % 4 and u[2] >= 2 for u in moves)


def test_plan_growth_spreads_onto_new_lanes():
    units, _ = plans(
        lambda c: [shard(c, [i % 2], path=f"s{i}") for i in range(8)], 4, 4)
    moves = [u for u in units if u[1] == "move"]
    assert sorted(u[0] for u in moves) == [2, 3, 6, 7]
    assert all(u[2] == u[0] % 2 and u[3] == u[0] % 4 for u in moves)


def test_plan_read_units_when_no_live_source():
    units, _ = plans(
        lambda c: [shard(c, [0], path="s0"), shard(c, [3], path="s1")], 2, 2)
    assert units[0][1] == "resident"
    assert units[1] == (1, "read", -1, 1, BLK, "s1")


def test_plan_fuzz_same_units():
    """The N->M fuzz of the original over uneven grids (replicated and dead
    placements included): both planners emit the same units."""
    rng = random.Random(0xD2D)
    for _ in range(300):
        live = rng.randint(1, 6)
        target = rng.randint(1, live)
        nshards = rng.randint(1, 13)
        spec = []
        for i in range(nshards):
            ndevs = rng.randint(1, 3)
            devs = sorted(rng.sample(range(live + 2), min(ndevs, live + 2)))
            spec.append((devs, rng.randint(1, 1 << 20), f"s{i}"))
        units, summary = plans(
            lambda c: [shard(c, d, n, p) for d, n, p in spec], live, target)
        assert [u[0] for u in units] == list(range(nshards))
        assert summary["resident"] + summary["move"] + summary["read"] == \
            nshards


def test_plan_refusals():
    for ckpt in PLANNERS:
        with pytest.raises(Exception, match="must target >= 1"):
            ckpt.plan_reshard([shard(ckpt, [0])], 2, 0)
        with pytest.raises(Exception, match="more devices than the live"):
            ckpt.plan_reshard([shard(ckpt, [0])], 2, 3)


def test_reshard_config_rules(pkgs, tmp_path):
    """--reshard needs a manifest, a target within --gpuids, and the native
    backend; with a plan the measured phase is RESHARD. The refusal texts
    are the original's."""
    cases = [
        ["-r", "-s", "1M", "--reshard", "2", str(tmp_path)],
        ["--checkpoint-shards", "4", "-w", "-s", str(BLK), "-b", str(BLK),
         "--reshard", "3", "--gpuids", "0,1", "--tpubackend", "pjrt",
         str(tmp_path)],
        ["--checkpoint-shards", "4", "-w", "-s", str(BLK), "-b", str(BLK),
         "--reshard", "2", str(tmp_path)],
    ]
    texts = []
    for pkg in pkgs:
        row = []
        for args in cases:
            with pytest.raises(pkg.ProgException) as ei:
                pkg.config_from_args(args)
            row.append(str(ei.value))
        cfg = pkg.config_from_args(reshard_args(tmp_path, 4, 2))
        assert cfg.selected_phases() == [pkg.Phase.RESHARD]
        plain = pkg.config_from_args(
            ["--checkpoint-shards", "4", "-w", "-s", str(BLK), "-b",
             str(BLK), "--tpubackend", "pjrt", str(tmp_path)])
        assert plain.selected_phases() == [pkg.Phase.CHECKPOINT]
        texts.append(row)
    assert "requires a --checkpoint" in texts[1][0]
    assert "targets more devices" in texts[1][1]
    assert "requires the native pjrt" in texts[1][2]
    assert texts[1] == texts[0]


# --------------------------------------------- the move tier end-to-end


def test_reshard_e2e_d2d_moves_byte_exact(pkgs, tmp_path):
    """4->2 consolidation of 8 shards: 4 units resident, 4 moved device to
    device (one driver copy per move), the pair matrix carries exactly the
    planned pairs, and submitted == resident bytes at the barrier."""
    out = both(pkgs, tmp_path, 8, 2)
    t = out["torch"]
    st = t["stats"]
    assert t["error"] == "" and not t["reshard_error"]
    assert (st["units_total"], st["units_resident"], st["units_moved"],
            st["units_read"]) == (8, 4, 4, 0)
    assert t["entries"] == 8
    assert t["tier"] == "d2d"
    assert (st["d2d_moves"], st["bounce_moves"], t["d2d_calls"]) == (4, 0, 4)
    assert st["d2d_submitted_bytes"] == st["d2d_resident_bytes"] == 4 * BLK
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 4 * BLK
    assert st["barriers"] >= 1
    assert t["pairs"] == [(2, 0, 2, 2 * BLK), (3, 1, 2, 2 * BLK)]
    assert t == out["jax"]


def test_reshard_identity_plan_no_motion(pkgs, tmp_path):
    """N==M: 8 resident no-ops, no preload, no moves, no reads, and no
    device bytes moved by the phase."""
    got = []
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        cfg = pkg.config_from_args(reshard_args(d, 8, 4))
        group = pkg.Group(cfg)
        group.prepare()
        base = pkg.mock.ebt_mock_total_bytes()
        try:
            group.start_phase(pkg.Phase.RESHARD, "rs-id")
            while not group.wait_done(1000):
                pass
            st = group.reshard_stats()
            st.pop("resident_wait_ns")
            got.append((group.first_error(), st,
                        sum(r.ops.entries for r in group.phase_results()),
                        group.reshard_pairs(), group.reshard_tier(),
                        pkg.mock.ebt_mock_total_bytes() - base))
        finally:
            group.teardown()
    err, st, entries, pairs, tier, moved = got[1]
    assert err == ""
    assert st["units_resident"] == st["units_total"] == 8
    assert st["units_moved"] == st["units_read"] == 0
    assert entries == 8
    assert st["d2d_moves"] == st["bounce_moves"] == 0
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 0
    assert pairs in ([], None) and tier is None and moved == 0
    assert got[1] == got[0]


def test_reshard_bounce_control_byte_identical(pkgs, tmp_path, monkeypatch):
    """EBT_D2D_DISABLE=1 sends every move through the host bounce on the
    same plan: no device-to-device copy, the same reconciliation and pairs,
    and a landed-byte checksum equal to the native run's, in both
    packages."""
    native = both(pkgs, tmp_path / "native", 8, 2)
    monkeypatch.setenv("EBT_D2D_DISABLE", "1")
    bounce = both(pkgs, tmp_path / "bounce", 8, 2)
    t = bounce["torch"]
    st = t["stats"]
    assert t["error"] == "" and not t["reshard_error"]
    assert t["tier"] == "bounce"
    assert (st["d2d_moves"], st["bounce_moves"], t["d2d_calls"]) == (0, 4, 0)
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 4 * BLK
    assert [p[:2] + p[3:] for p in t["pairs"]] == \
        [p[:2] + p[3:] for p in native["torch"]["pairs"]]
    assert t["checksum"] == native["torch"]["checksum"]
    assert bounce["torch"] == bounce["jax"]
    assert native["torch"] == native["jax"]


def test_reshard_unsupported_driver_bounces(pkgs, tmp_path, monkeypatch):
    """A driver that refuses device-to-device copies (the original: a
    plugin without CopyToDevice): the session still reshards byte-exact,
    every move through the bounce, and the tier reads "bounce"."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_NO_D2D", "1")
    out = both(pkgs, tmp_path, 8, 2)
    t = out["torch"]
    st = t["stats"]
    assert t["error"] == "" and not t["reshard_error"]
    assert t["tier"] == "bounce"
    assert st["d2d_moves"] == 0 and st["bounce_moves"] == 4
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 4 * BLK
    assert t == out["jax"]


def test_reshard_injected_move_failure_recovers_exact(pkgs, tmp_path,
                                                      monkeypatch):
    """The first device-to-device copy fails in flight (nothing lands): the
    settle moves its bytes again through the bounce, the unit ends
    resident, and the reconciliation and pair matrix are exact, with the
    landed bytes equal to a clean run's."""
    clean = both(pkgs, tmp_path / "clean", 8, 2)
    set_seam(monkeypatch, "EBT_MOCK_D2D_FAIL_AT", "1")
    out = both(pkgs, tmp_path / "fail", 8, 2)
    t = out["torch"]
    st = t["stats"]
    assert t["error"] == "" and not t["reshard_error"]
    assert t["entries"] == 8
    assert st["units_moved"] == 4
    assert st["move_recovered"] == 1
    assert (st["d2d_moves"], st["bounce_moves"]) == (3, 1)
    assert t["tier"] == "d2d"
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 4 * BLK
    assert t["pairs"] == [(2, 0, 2, 2 * BLK), (3, 1, 2, 2 * BLK)]
    assert t["checksum"] == clean["torch"]["checksum"]
    assert t == out["jax"]


def test_reshard_repeated_sessions_reconcile(pkgs, tmp_path):
    """Two sessions on fresh groups reconcile one plan execution each."""
    for i in range(2):
        out = both(pkgs, tmp_path / str(i), 4, 2)
        st = out["torch"]["stats"]
        assert st["units_total"] == 4
        assert st["units_resident"] + st["units_moved"] == 4
        assert st["unit_bytes_submitted"] == st["unit_bytes_resident"]
        assert out["torch"] == out["jax"]


# --------------------------------------------------- wire + pod fan-in


def test_result_tree_carries_reshard_fields(pkgs, tmp_path):
    wires = {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        cfg = pkg.config_from_args(reshard_args(d, 8, 2))
        group = pkg.Group(cfg)
        group.prepare()
        try:
            group.start_phase(pkg.Phase.RESHARD, "rs-wire")
            while not group.wait_done(1000):
                pass
            wire = pkg.Statistics(cfg, group).bench_result_wire(
                pkg.Phase.RESHARD, "rs-wire", [])
            st = dict(wire["ReshardStats"])
            st.pop("resident_wait_ns")
            wires[pkg.name] = (st, wire["ReshardTier"],
                               wire["ReshardPairs"], wire["ReshardError"])
        finally:
            group.teardown()
    st, tier, pairs, err = wires["torch"]
    assert st["units_total"] == 8 and st["units_moved"] == 4
    assert tier == "d2d"
    assert {(p["src"], p["dst"]) for p in pairs} == {(2, 0), (3, 1)}
    assert not err
    assert wires["torch"] == wires["jax"]


def test_pod_fanin_reshard_rules(pkgs):
    """Pod fan-in: outcome, byte and move counters sum, units_total and
    units_resident take the max, the pair matrix sums pair-wise, the pod
    tier is the lowest any host rode, and the first host-framed failure
    wins."""

    class P:
        def __init__(self, host, stats, pairs, tier, err):
            self.host = host
            self.host_index = int(host[1:])
            self.reshard_stats = stats
            self.reshard_pairs = pairs
            self.reshard_tier = tier
            self.reshard_error = err

    got = []
    for pkg in pkgs:
        g = pkg.remote.RemoteWorkerGroup.__new__(pkg.remote.RemoteWorkerGroup)
        g.proxies = [
            P("h1", {"units_total": 8, "units_resident": 4,
                     "units_moved": 2, "d2d_moves": 2, "bounce_moves": 0,
                     "unit_bytes_submitted": 100,
                     "unit_bytes_resident": 100},
              [{"src": 2, "dst": 0, "moves": 2, "bytes": 100}], "d2d",
              None),
            P("h2", {"units_total": 8, "units_resident": 4,
                     "units_moved": 2, "d2d_moves": 0, "bounce_moves": 2,
                     "unit_bytes_submitted": 60, "unit_bytes_resident": 60},
              [{"src": 2, "dst": 0, "moves": 1, "bytes": 20},
               {"src": 3, "dst": 1, "moves": 1, "bytes": 40}],
              "bounce", "unit 5 src 3 dst 1: boom"),
        ]
        got.append((g.reshard_stats(),
                    sorted((p["src"], p["dst"], p["moves"], p["bytes"])
                           for p in g.reshard_pairs()),
                    g.reshard_tier(), g.reshard_error()))
    st, pairs, tier, err = got[1]
    assert st["units_total"] == 8 and st["units_resident"] == 4
    assert st["units_moved"] == 4
    assert st["d2d_moves"] == 2 and st["bounce_moves"] == 2
    assert st["unit_bytes_submitted"] == st["unit_bytes_resident"] == 160
    assert pairs == [(2, 0, 3, 120), (3, 1, 1, 40)]
    assert tier == "bounce"
    assert err == "service h2: unit 5 src 3 dst 1: boom"
    assert got[1] == got[0]


# ------------------------------------------------- engine wake coalescing


def test_reactor_wakeups_coalesced_engagement(pkgs, tmp_path, monkeypatch):
    """On the port's engine build: one reactor wakeup drains every pending
    completion signal (reactor_wakeups_coalesced), and the wait count
    reconciles with the five cause counters."""
    monkeypatch.delenv("EBT_REACTOR_DISABLE", raising=False)
    pkg = pkgs[1]
    nblocks = 128
    f = tmp_path / "f.bin"
    f.write_bytes(os.urandom(nblocks * BLK))
    args = ["-r", "-s", str(nblocks * BLK), "-b", str(BLK), "-t", "2",
            "--iodepth", "8", "--arrival", "poisson", "--rate", "3000",
            "--nolive", str(f)]
    coalesced = 0
    for attempt in range(3):  # bursts are random; one run may be all single
        group = pkg.Group(pkg.config_from_args(args))
        group.prepare()
        try:
            group.start_phase(pkg.Phase.READFILES, f"rs-coalesce-{attempt}")
            while not group.wait_done(1000):
                pass
            assert group.first_error() == ""
            rs = group.reactor_stats()
            assert group.reactor_enabled()
            assert rs["reactor_waits"] > 0
            assert rs["reactor_waits"] == sum(
                rs[k] for k in ("reactor_wakeups_cq",
                                "reactor_wakeups_onready",
                                "reactor_wakeups_arrival",
                                "reactor_wakeups_timeout",
                                "reactor_wakeups_interrupt"))
            coalesced = rs["reactor_wakeups_coalesced"]
        finally:
            group.teardown()
        if coalesced:
            break
    assert coalesced > 0
