"""The whole /benchresult tree of the port against the original package's,
field by field, on the same inputs.

Each case runs one benchmark on both packages: the original on its CPU jax
devices (staged, direct) or its mock PJRT plugin (pjrt,
elbencho_tpu/libebtpjrtmock.so), the port on the CPU device (staged,
direct) or its mock CUDA driver (pjrt, build/torch_core/libebtcudamock.so
with EBT_TORCH_DEVICE=cpu). After every phase the two
Statistics.bench_result_wire trees are compared recursively. Only the named
timing fields may differ (TIMING below): their values depend on the clock,
not on what was moved. Every other field, including which keys exist and
which are null, must be equal.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.tpu.native as jax_native
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.engine_stats as torch_engine_stats
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")

# Fields whose values are clock readings. Top-level keys are skipped with
# everything below them; the (family, key) pairs are skipped inside a
# family (a dict, or each dict of a list). The fault and reshard families
# add their own clocks: the backoff time and the barriers' wait. UringStats
# are process-cumulative in both packages, so each tree's are compared as
# the run's deltas.
TIMING_TOP = ("CPUUtilStoneWall", "StoneWall", "StoneWallUSecs",
              "ElapsedUSecsList", "DevLatHistos")
TIMING_PREFIX = ("LatHisto",)
TIMING_NESTED = {
    "LaneStats": ("lock_wait_ns",),
    "StripeStats": ("barrier_wait_ns",),
    "CkptStats": ("resident_wait_ns",),
    "D2HStats": ("await_wait_ns", "overlap_bytes"),
    "FaultStats": ("dev_retry_backoff_ns",),
    "ReshardStats": ("resident_wait_ns",),
    "UringStats": ("uring_register_ns",),
    "IngestStats": ("resident_wait_ns", "epoch_time_ns"),
}
# Open-loop arrivals (--arrival paced) on pjrt. The tenant latencies and
# the schedule's lag are read off the clock against the scheduled arrival;
# whether a wakeup finds a second event already pending (coalesced) depends
# on when the completion lands against the next arrival. reactor_waits and
# reactor_wakeups_onready stay compared: they count the waits and the
# completions that signal the worker, which the code decides. On the engine's
# io_uring emulation (URING_EMULATED_CASES) a storage write completes inside
# its submit, so what one wakeup drains is the code's to decide too, and the
# coalesced count is compared as well.
TIMING_TOP_OPEN_LOOP = ("TenantLatHistos",)
TIMING_NESTED_OPEN_LOOP = {
    "TenantStats": ("sched_lag_ns",),
    "ReactorStats": ("reactor_wakeups_coalesced", "spin_polls_avoided"),
}
TIMING_NESTED_OPEN_LOOP_EMULATED = {
    "TenantStats": ("sched_lag_ns",),
    "ReactorStats": ("spin_polls_avoided",),
}
# Serving rotation: how many rotations fit into the read phase follows the
# clock, and with them every count the rotator adds to (the rotation
# family, the lane bytes, the checkpoint ledger of an unfinished rotation).
# These are compared as each package's invariants in
# tests/test_torch_serving.py; here their key sets are compared.
ROTATION_CLOCKED = ("ServingStats", "RotationTtrNs", "RotationRecords",
                    "LaneStats", "CkptStats", "CkptBytesPerDevice")

BASE = ["-s", "4M", "-b", "256K", "--nolive"]
# The pjrt cases run one worker. With two, several counters follow the
# workers' interleaving in either package: LaneStats awaits counts the reuse
# barriers that found a queue (a sibling's gather or all-resident barrier
# may take it first), and RegCache pinned_peak_bytes depends on whether the
# two workers' windows were pinned at the same time.
PJRT = ["-t", "1", "--gpuids", "0,1"]
STAGED = ["-t", "2", "--gpuids", "0,1"]
PACED = ["--arrival", "paced", "--rate", "20"]

# (id, backend, extra args, phases) — phases "w"/"r" of a file benchmark,
# "c" the checkpoint restore, "s" the reshard
CASES = [
    ("staged", "staged", STAGED, "wr"),
    ("staged-verify", "staged", STAGED + ["--verify", "7"], "wr"),
    ("staged-stripe", "staged", STAGED + ["--stripe", "rr"], "wr"),
    ("staged-tpustripe", "staged", STAGED + ["--tpustripe"], "wr"),
    ("direct", "direct", STAGED, "wr"),
    ("direct-verify", "direct", STAGED + ["--verify", "7"], "wr"),
    ("pjrt", "pjrt", PJRT, "wr"),
    ("pjrt-verify", "pjrt", PJRT + ["--verify", "7"], "wr"),
    ("pjrt-stripe", "pjrt", PJRT + ["--stripe", "rr"], "wr"),
    ("pjrt-tpustripe", "pjrt", PJRT + ["--tpustripe", "--d2hdepth", "2"],
     "wr"),
    ("pjrt-faults", "pjrt", PJRT + ["--retry", "1", "--maxerrors", "5%"],
     "wr"),
    ("pjrt-checkpoint", "pjrt", PJRT + ["--checkpoint-shards", "4"], "c"),
    ("pjrt-reshard", "pjrt",
     PJRT + ["--checkpoint-shards", "4", "--reshard", "1"], "s"),
    # a seeded 4-shard model rotated every 0.1 s under a read phase whose
    # copies the mocks slow to 25 ms each (0.4 s for the 16 blocks)
    ("pjrt-rotate", "pjrt", PJRT + ["--rotate", "0.1", "--bgbudget", "8M"],
     "wr"),
    # one worker and --prefetchbatches 1: the serial tier by construction
    ("pjrt-ingest", "pjrt",
     PJRT + ["--ingestshards", "2", "--recordsize", "64K", "--epochs", "2",
             "--prefetchbatches", "1"], "i"),
    # the transfer-manager tier (EBT_PJRT_XFER_MGR=1, XFER_MGR_CASES): a
    # plain read and a checkpoint restore, one block buffer per block
    ("pjrt-xfer-mgr", "pjrt", PJRT, "wr"),
    ("pjrt-xfer-mgr-checkpoint", "pjrt", PJRT + ["--checkpoint-shards", "4"],
     "c"),
    # open-loop arrivals (OPEN_LOOP): a serial D2H fetch (--d2hdepth 1)
    # must not wake the worker's reactor, a deferred one does. The
    # iodepth-2 cases run on the engine's io_uring emulation
    # (URING_EMULATED_CASES)
    ("pjrt-paced-iodepth2-d2h1", "pjrt",
     PJRT + PACED + ["--iodepth", "2", "--d2hdepth", "1"], "wr"),
    ("pjrt-paced-iodepth2-d2h2", "pjrt",
     PJRT + PACED + ["--iodepth", "2", "--d2hdepth", "2"], "wr"),
    ("pjrt-paced-d2h1", "pjrt", PJRT + PACED + ["--d2hdepth", "1"], "wr"),
    ("pjrt-paced-d2h2", "pjrt", PJRT + PACED + ["--d2hdepth", "2"], "wr"),
    ("pjrt-paced-tenants", "pjrt",
     ["-t", "2", "--gpuids", "0,1", "--arrival", "paced",
      "--tenants", "fg:rate=20;bg:rate=20,bs=128K"], "wr"),
]
OPEN_LOOP_TWO_WORKERS_CLOCKED = ("LaneStats",)
# the one-worker paced cases at --iodepth 2 run on the engine's io_uring
# emulation (EBT_MOCK_URING=1), set for both packages. On the kernel's ring
# a buffered write is handed to an io-wq thread, and whether it completes
# before the worker's next reactor wait follows where the scheduler runs
# that thread: a deferred fetch's signal then wakes the worker alone or is
# drained beside the storage completion, and the last block's completion
# is reaped before the loop ends or wakes one more wait, so reactor_waits,
# reactor_wakeups_cq and reactor_wakeups_onready follow the scheduler in
# either package. The emulation completes the write inside its submit; the
# mocks keep no copy time, so the original's fetch signals inside its own
# call and the port's before its completion is visible: every signal of a
# block is then pending at one wait. (At --iodepth 1 the engine writes
# synchronously: those cases stay on the kernel's ring.)
URING_EMULATED_CASES = ("pjrt-paced-iodepth2-d2h1",
                        "pjrt-paced-iodepth2-d2h2")
# cases run with EBT_PJRT_XFER_MGR=1; besides the tree, the tier's block
# counter and each device's latency sample count (one per block on the
# tier) must equal the original's
XFER_MGR_CASES = ("pjrt-xfer-mgr", "pjrt-xfer-mgr-checkpoint")


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port): CPU devices for staged/direct, the mocks (two
    devices each) for pjrt."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "2")
    return tuple(
        SimpleNamespace(name=name, config_from_args=cfg.config_from_args,
                        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
                        Statistics=stats.Statistics, uring_stats=uring)
        for name, cfg, local, common, stats, uring in (
            ("jax", jax_config, jax_local, jax_common, jax_stats,
             jax_native.uring_stats),
            ("torch", torch_config, torch_local, torch_common, torch_stats,
             torch_engine_stats.uring_stats)))


def _skip_key(family: str | None, key: str, open_loop: dict) -> bool:
    if family is None:
        return (key in TIMING_TOP or key.startswith(TIMING_PREFIX)
                or (bool(open_loop) and key in TIMING_TOP_OPEN_LOOP))
    return (key in TIMING_NESTED.get(family, ())
            or key in open_loop.get(family, ()))


def tree_diff(a, b, path="", family=None, clocked=(),
              open_loop=None) -> list[str]:
    """Every path where the two trees differ, timing fields left out (and
    the `clocked` top-level families compared by their keys only; with
    `open_loop`, the nested open-loop clock fields to leave out, the
    open-loop top-level ones are left out too)."""
    open_loop = open_loop or {}
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            if _skip_key(family, k, open_loop):
                continue
            if family is None and k in clocked and k in a and k in b:
                out += key_diff(a[k], b[k], f"{path}/{k}")
                continue
            if k not in a or k not in b:
                out.append(f"{path}/{k}: only in "
                           f"{'original' if k in a else 'port'}")
                continue
            out += tree_diff(a[k], b[k], f"{path}/{k}",
                             k if family is None else family,
                             open_loop=open_loop)
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += tree_diff(x, y, f"{path}[{i}]", family,
                             open_loop=open_loop)
        return out
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def key_diff(a, b, path) -> list[str]:
    """The shape of a clocked family: which keys exist, which are null."""
    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shape(v) for v in x[:1]]
        return x is None
    return [] if shape(a) == shape(b) else [f"{path}: shapes differ"]


def run_trees(pkg, args: list[str], phases: str,
              counters: list | None = None) -> list[dict]:
    """One package's benchmark; the result tree after each phase (and,
    into `counters`, the transfer-manager tier's block count and the
    latency sample count per device after each phase)."""
    cfg = pkg.config_from_args(args)
    uring_base = pkg.uring_stats()
    group = pkg.Group(cfg)
    group.prepare()
    trees = []
    try:
        for ph in phases:
            phase = {"w": pkg.Phase.CREATEFILES, "r": pkg.Phase.READFILES,
                     "c": pkg.Phase.CHECKPOINT,
                     "s": pkg.Phase.RESHARD, "i": pkg.Phase.INGEST}[ph]
            group.start_phase(phase, f"tree-{ph}")
            while not group.wait_done(1000):
                pass
            assert group.first_error() == "", (pkg.name, group.first_error())
            tree = pkg.Statistics(cfg, group).bench_result_wire(
                phase, f"tree-{ph}", [])
            tree["UringStats"] = {k: v - uring_base[k]
                                  for k, v in tree["UringStats"].items()}
            trees.append(tree)
            if counters is not None:
                counters.append((
                    group._native_path.xfer_mgr_active,
                    group._native_path.xfer_mgr_count,
                    {k: h["count"] for k, h in tree["DevLatHistos"].items()}))
    finally:
        group.teardown()
    return trees


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_result_tree_matches_original(pkgs, tmp_path, monkeypatch, case):
    name, backend, extra, phases = case
    data = np.random.default_rng(7).integers(0, 256, 4 << 20,
                                             dtype=np.uint8).tobytes()
    clocked = ()
    if "--rotate" in extra:
        rng = np.random.default_rng(8)
        shards = []
        for i in range(4):
            p = tmp_path / f"model.{i}"
            p.write_bytes(rng.integers(0, 256, 256 << 10,
                                       dtype=np.uint8).tobytes())
            shards.append({"path": str(p), "devices": [i % 2]})
        man = tmp_path / "model.json"
        man.write_text(json.dumps({"version": 1, "shards": shards}))
        extra = extra + ["--checkpoint", str(man)]
        clocked = ROTATION_CLOCKED
        for k in ("EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US"):
            monkeypatch.setenv(k, "25000")
    open_loop = TIMING_NESTED_OPEN_LOOP if "--arrival" in extra else {}
    one_worker = extra[extra.index("-t") + 1] == "1"
    if name in URING_EMULATED_CASES:
        monkeypatch.setenv("EBT_MOCK_URING", "1")
        open_loop = TIMING_NESTED_OPEN_LOOP_EMULATED
    if open_loop and not one_worker:
        # two workers: the lanes' awaits follow their interleaving
        clocked = OPEN_LOOP_TWO_WORKERS_CLOCKED
    xfer_mgr = name in XFER_MGR_CASES
    if xfer_mgr:
        monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    trees, counters = {}, {}
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        if phases in ("c", "s", "i"):
            target = str(d)
            pre = ["-w"]
        else:
            target = str(d / "f")
            pre = ["-w", "-r"]
            if "--verify" not in extra:
                # reads of a file the write phase just filled: the bytes
                # come from the same seeded file on both sides
                (d / "f").write_bytes(data)
        args = pre + BASE + ["--tpubackend", backend] + extra + [target]
        counters[pkg.name] = [] if xfer_mgr else None
        trees[pkg.name] = run_trees(pkg, args, phases, counters[pkg.name])
    assert len(trees["torch"]) == len(trees["jax"])
    for ph, jt, tt in zip(phases, trees["jax"], trees["torch"]):
        diff = tree_diff(jt, tt, clocked=clocked, open_loop=open_loop)
        assert not diff, f"phase {ph}: " + "; ".join(diff)
    if open_loop:
        # one latency sample per chunk on both packages: a serial D2H fetch
        # is sampled once whether or not its completion wakes the reactor
        # (one chunk per 256 KiB block, 16 blocks per worker's 4 MiB)
        for jt, tt in zip(trees["jax"], trees["torch"]):
            counts = {k: h["count"] for k, h in tt["DevLatHistos"].items()}
            assert counts == {k: h["count"]
                              for k, h in jt["DevLatHistos"].items()}
            if one_worker:
                assert sum(counts.values()) == 16
    if clocked == ROTATION_CLOCKED:
        for t in (trees["jax"][-1], trees["torch"][-1]):
            assert t["ServingStats"]["rotations_complete"] >= 1
            assert len(t["RotationRecords"]) == \
                t["ServingStats"]["rotations_complete"]
    if xfer_mgr:
        assert counters["torch"] == counters["jax"]
        # the tier carried every block read or restored, one latency
        # sample each: 4 MiB read, or 4 shards of 4 MiB restored, in 256
        # KiB blocks
        want = 16 if phases == "wr" else 64
        active, blocks, samples = counters["torch"][-1]
        assert active and blocks == want
        assert sum(samples.values()) == want
        assert trees["torch"][-1]["DataPathTier"] == "xfer_mgr"
    if backend == "pjrt":
        # the C1 fields exist and carry the original's values
        for tt in trees["torch"]:
            assert tt["FaultStats"] is not None
            assert tt["EjectedDevices"] == ""


@pytest.mark.parametrize("d2h", ["1", "2"])
def test_paced_fetch_signals_reach_the_reactor(pkgs, tmp_path, monkeypatch,
                                               d2h):
    """On the kernel's io_uring, with both mocks at one copy time, every
    signal a write phase sends the worker's reactor is drained by its waits:
    the 16 storage completions, and at --d2hdepth 2 the 16 deferred fetches;
    a serial fetch sends none. Whether a fetch's signal wakes the worker
    alone (reactor_wakeups_onready) or beside a storage completion
    (reactor_wakeups_coalesced) follows where the scheduler runs the io-wq
    thread that completes the write, so the test holds the sum: cq + onready
    + coalesced counts each signal drained once. The last block's signals
    are left to the next phase's rearm when its write completes before the
    loop's last reap. Both packages hold this, the port's parent commit too:
    the order of a fetch's signal and its completion, which the deferred
    tree case [pjrt-paced-iodepth2-d2h2] holds, does not show here."""
    for k in ("EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US"):
        monkeypatch.setenv(k, "2000")
    monkeypatch.delenv("EBT_MOCK_URING", raising=False)
    data = np.random.default_rng(7).integers(0, 256, 4 << 20,
                                             dtype=np.uint8).tobytes()
    for pkg in pkgs:
        d = tmp_path / pkg.name
        d.mkdir()
        (d / "f").write_bytes(data)
        args = (["-w"] + BASE + ["--tpubackend", "pjrt"] + PJRT + PACED
                + ["--iodepth", "2", "--d2hdepth", d2h, str(d / "f")])
        rs = run_trees(pkg, args, "w")[0]["ReactorStats"]
        assert rs["reactor_waits"] == sum(rs[k] for k in (
            "reactor_wakeups_cq", "reactor_wakeups_onready",
            "reactor_wakeups_arrival", "reactor_wakeups_timeout",
            "reactor_wakeups_interrupt")), (pkg.name, rs)
        drained = (rs["reactor_wakeups_cq"] + rs["reactor_wakeups_onready"]
                   + rs["reactor_wakeups_coalesced"])
        if d2h == "1":
            assert rs["reactor_wakeups_onready"] == 0, (pkg.name, rs)
            assert drained in (15, 16), (pkg.name, rs)
        else:
            assert drained in (30, 31, 32), (pkg.name, rs)
