"""The port's headline bench (elbencho_tpu_torch/bench.py) against the
original's bench.py, on the same inputs.

The original's bench.py is loaded with importlib and runs on its mock PJRT
plugin (elbencho_tpu/libebtpjrtmock.so); the port's runs on its mock CUDA
driver (build/torch_core/libebtcudamock.so) with EBT_TORCH_DEVICE=cpu.
The harness units of tests/test_bench_harness.py run on both modules; the
end-to-end main() of each package is compared by its JSON key sets and its
tier/shape fields, never by rates, which follow the clock. Both benches
write their scratch files under the test's tmp dir (their files go to
/dev/shm where it exists, so the test hides it).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

import elbencho_tpu_torch.bench as torch_bench
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")

# the pair counts the original's end-to-end harness shrinks to
SHRUNK = {"NUM_PAIRS": 4, "WRITE_PAIRS": 5, "RAND_PAIRS": 3,
          "MIN_READ_PAIRS": 2}
# the serving leg's random-read op count in the end-to-end comparison, on
# both sides alike: a third of the original's 192 MiB (1024 ops of 64 KiB
# instead of 3072), so each of its four trace-paced phases takes about 4 s
# on the mocks instead of 10 and the slowest budget still completes a
# rotation
# (tests/test_torch_bench_legs.py runs the leg at the original's constants)
SERVING_SHRUNK = {"SERVING_RAND_BYTES": 64 << 20}
# the thirteen legs of both reports
LEGS = {"write", "read", "random", "scale", "stripe", "ckpt", "meta",
        "uring", "load", "serving", "faults", "ingest", "reshard"}


def _load_original_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_original", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.fixture(scope="module")
def jax_bench():
    return _load_original_bench()


@pytest.fixture(params=["jax", "torch"])
def bench(request, jax_bench):
    """Each bench module in turn: the harness units hold for both."""
    return jax_bench if request.param == "jax" else torch_bench


def _stats_module(bench) -> str:
    return ("elbencho_tpu_torch.stats" if bench is torch_bench
            else "elbencho_tpu.stats")


@pytest.fixture
def mocks(monkeypatch, tmp_path):
    """Both mocks (one device each unless a test says otherwise), the
    port on the CPU, and both benches' workdir under tmp_path."""
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_engine.build_mock())
    for k in ("EBT_D2D_DISABLE", "EBT_PJRT_SINGLE_LANE",
              "EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES",
              "EBT_MOCK_PJRT_NO_D2D", "EBT_MOCK_CUDA_NO_D2D"):
        monkeypatch.delenv(k, raising=False)
    real_isdir = os.path.isdir
    monkeypatch.setattr(
        os.path, "isdir",
        lambda p: False if p == "/dev/shm" else real_isdir(p))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return monkeypatch


# ---------------------------------------------------------------- harness


@pytest.mark.parametrize("rate,file_mib", [
    (0.3, 8), (5, 8), (49, 8), (50, 32), (299, 32), (300, 128), (1500, 128),
])
def test_sizes_rate_classes(bench, rate, file_mib):
    assert bench.Sizes(rate).file_size == file_mib << 20


@pytest.mark.parametrize("rate", [0.3, 5, 60, 400, 1500])
def test_sizes_shape_invariants(bench, jax_bench, rate):
    s = bench.Sizes(rate)
    assert s.block_size * 16 == s.file_size
    assert s.raw_bytes == s.file_size
    assert s.raw_d2h_bytes == s.file_size
    assert s.raw_chunk == min(bench.CHUNK, s.block_size)
    assert s.raw_d2h_chunk == s.raw_chunk
    assert s.raw_depth >= 4
    assert s.raw_d2h_depth >= 1
    assert s.raw_depth * s.raw_chunk <= 8 * s.block_size or \
        s.raw_depth == 4
    # the port's windows are the original's, field for field
    assert vars(s) == vars(jax_bench.Sizes(rate))


@pytest.mark.parametrize("rate", [0.3, 60, 400])
def test_rand_leg_sizes(bench, rate):
    s = bench.Sizes(rate)
    assert 4 << 10 <= s.rand_block <= 256 << 10
    assert s.rand_block <= s.block_size
    assert s.rand_chunk == s.rand_block
    assert s.rand_depth == 2 * bench.RAND_IODEPTH
    assert s.rand_amount == s.file_size


def test_constants_match_original(jax_bench):
    for name in ("NUM_PAIRS", "CHUNK", "PROBE_DEPTH", "WRITE_PAIRS",
                 "READ_LEG_BUDGET_S", "MIN_READ_PAIRS", "RAND_PAIRS",
                 "SOFT_BUDGET_S", "WRITE_LEG_BUDGET_CAP_S",
                 "RAND_LEG_BUDGET_CAP_S", "RAND_IODEPTH", "SCALE_THREADS",
                 "SCALE_LEG_BUDGET_CAP_S", "STRIPE_LEG_BUDGET_CAP_S",
                 "STRIPE_POLICY", "CKPT_LEG_BUDGET_CAP_S", "CKPT_SHARDS",
                 "CKPT_SESSIONS", "RESHARD_LEG_BUDGET_CAP_S",
                 "RESHARD_SHARDS", "RESHARD_SESSIONS",
                 "BENCH_GLOBAL_DEADLINE_S", "TIER_MISMATCH_EXIT",
                 "PHASE_DEADLINE_S", "DRAIN_DEADLINE_S",
                 "INITIAL_BURN_DEADLINE_S"):
        assert getattr(torch_bench, name) == getattr(jax_bench, name), name


@pytest.mark.parametrize("prev,nxt,usable", [
    (100.0, 120.0, True), (0.1, 50.0, False), (5.0, 60.0, False),
    (5.0, 49.0, True), (0.0, 0.0, False)])
def test_usable_pair(bench, prev, nxt, usable):
    assert bench.usable_pair(prev, nxt) is usable


class _MockGroup:
    """wait_done returns 0 (running) until the scripted moment."""

    def __init__(self, done_after_s=0.0, drain_after_interrupt_s=0.0,
                 error=""):
        self.t0 = time.monotonic()
        self.done_after_s = done_after_s
        self.drain_after_interrupt_s = drain_after_interrupt_s
        self.error = error
        self.interrupted_at = None

    def start_phase(self, phase, bench_id):
        self.t0 = time.monotonic()

    def wait_done(self, timeout_ms):
        time.sleep(min(timeout_ms / 1000.0, 0.01))
        if self.interrupted_at is not None:
            return int(time.monotonic() - self.interrupted_at >=
                       self.drain_after_interrupt_s)
        return int(time.monotonic() - self.t0 >= self.done_after_s)

    def interrupt(self):
        self.interrupted_at = time.monotonic()

    def first_error(self):
        return self.error

    def phase_results(self):
        return []


def test_run_phase_clean_completion(bench, monkeypatch):
    monkeypatch.setattr(
        f"{_stats_module(bench)}.aggregate_results",
        lambda phase, results: type(
            "A", (), {"last_ops": type("O", (), {"bytes": 1 << 20})(),
                      "last_elapsed_us": 1_000_000})())
    assert bench._run_phase(_MockGroup(), 0, "t") == 1.0  # 1 MiB in 1 s


def test_run_phase_error_propagates(bench):
    with pytest.raises(RuntimeError, match="boom"):
        bench._run_phase(_MockGroup(error="boom"), 0, "t")


def test_run_phase_stall_interrupts_and_classifies(bench):
    g = _MockGroup(done_after_s=9e9, drain_after_interrupt_s=0.05)
    with pytest.raises(bench.TransportStalled, match="exceeded"):
        bench._run_phase(g, 0, "t", deadline_s=0.05)
    assert g.interrupted_at is not None


def test_run_phase_wedge_when_drain_never_completes(bench, monkeypatch):
    monkeypatch.setattr(bench, "DRAIN_DEADLINE_S", 0.05)
    g = _MockGroup(done_after_s=9e9, drain_after_interrupt_s=9e9)
    with pytest.raises(bench.TransportWedged, match="did not drain"):
        bench._run_phase(g, 0, "t", deadline_s=0.05)


def test_stalled_is_not_wedged(bench):
    assert issubclass(bench.TransportStalled, RuntimeError)
    assert issubclass(bench.TransportWedged, RuntimeError)
    assert not issubclass(bench.TransportStalled, bench.TransportWedged)


# ----------------------------------------------------------- end to end


def _run_main(bench, monkeypatch, tmp_path, capsys, pairs=SHRUNK):
    for k, v in pairs.items():
        monkeypatch.setattr(bench, k, v)
    monkeypatch.setattr(bench, "REPO", str(tmp_path))  # ledger under tmp
    monkeypatch.setattr(sys, "argv", ["bench"])
    rc = bench.main()
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_main_matches_original(mocks, jax_bench, tmp_path, capsys):
    """One main() of each package on its one-device mock with the shrunk
    pair counts and serving op count: the same report shape (key sets,
    top level and per leg, all thirteen legs), the same ledger entry
    shape, and the same tiers, leg shapes and refusals."""
    reps = {}
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        d = tmp_path / name
        d.mkdir()
        rc, reps[name] = _run_main(b, mocks, d, capsys,
                                   {**SHRUNK, **SERVING_SHRUNK})
        assert rc == 0, (name, reps[name])
    jr, tr = reps["jax"], reps["torch"]
    assert set(jr) == set(tr)
    assert set(jr["legs"]) == set(tr["legs"]) == LEGS
    for leg in tr["legs"]:
        assert set(jr["legs"][leg]) == set(tr["legs"][leg]), (
            leg, jr["legs"][leg].get("error"), tr["legs"][leg].get("error"))
    for k in ("backend", "fallback_events", "tier", "dev_lat_clock",
              "rand_block_kib", "rand_iodepth", "write_tier", "d2h_depth",
              "tier_mismatch", "wedged", "ceiling", "ceiling_fallback",
              "stripe_devices", "stripe_tier", "ckpt_shards",
              "ckpt_devices", "ckpt_cold_mode", "scale_threads",
              "ioengine", "uring_error", "ingest_tier",
              "serving_engagement", "reactor_enabled"):
        assert jr[k] == tr[k], k
    # the six host-heavy legs: clean where the original is, the same
    # refusals where it refuses (the uring leg's engagement refusal on a
    # kernel with io_uring), faults skipped on one device
    for k in ("meta_error", "load_error", "serving_error", "ingest_error",
              "faults_error"):
        assert jr[k] is None and tr[k] is None, (k, jr[k], tr[k])
    assert "skipped" in tr["legs"]["faults"]
    assert tr["legs"]["ingest"]["ingest"]["records_read"] == \
        jr["legs"]["ingest"]["ingest"]["records_read"]
    assert tr["ingest_records_s"] > 0 and tr["meta_vs_ceiling"] > 0
    # graded pairs: the first of each leg is discarded, a pair with an
    # unusable ceiling window too (that follows the clock)
    for r in (jr, tr):
        assert 1 <= r["write_pairs"] <= SHRUNK["WRITE_PAIRS"] - 1
        assert 1 <= r["rand_pairs"] <= SHRUNK["RAND_PAIRS"] - 1
    assert tr["backend"] == "pjrt" and tr["tier"] == "zero_copy"
    assert tr["legs"]["read"]["probe_tier"] == \
        jr["legs"]["read"]["probe_tier"] == "zero_copy"
    assert tr["legs"]["scale"]["single_lane_engaged"] is True
    # one device: the stripe and reshard legs record the skip
    assert "skipped" in tr["legs"]["stripe"]
    assert "skipped" in tr["legs"]["reshard"]
    # every restore session reconciled all shards and landed the manifest,
    # on both sides (the shard size follows the window class, which the
    # rate probe picks off the clock)
    for r in (jr, tr):
        ck = r["legs"]["ckpt"]
        assert "reconcile_error" not in ck
        assert ck["ckpt"]["shards_resident"] == ck["shards"] == 8
        sessions = sum(ck[v]["sessions"] for v in ("cold", "warm",
                                                   "under_load"))
        assert sessions == 3 * torch_bench.CKPT_SESSIONS
        assert sum(ck["bytes_per_device"]) == sessions * ck["total_bytes"]
    assert jr["legs"]["ckpt"]["ckpt"] == {
        **tr["legs"]["ckpt"]["ckpt"],
        "resident_wait_ns": jr["legs"]["ckpt"]["ckpt"]["resident_wait_ns"]}
    assert tr["value"] > 0 and tr["vs_baseline"] > 0
    assert tr["write_vs_d2h_ceiling"] > 0 and tr["rand_iops"] > 0
    assert tr["plugin_caps"]["mock"] is True
    # the port's own ledger, never the original's
    led = tmp_path / "torch" / "results" / "torch_bench" / "ledger.jsonl"
    entries = [json.loads(x) for x in led.read_text().splitlines()]
    assert len(entries) == 1
    assert entries[0]["read_vs_ceiling"] == tr["vs_baseline"]
    # the original's entry, with the card's name and power limit beside it
    jled = tmp_path / "jax" / "results" / "fastwindow" / "ledger.jsonl"
    jentries = [json.loads(x) for x in jled.read_text().splitlines()]
    assert set(entries[0]) == set(jentries[0]) | {"card"}
    assert not (tmp_path / "torch" / "results" / "fastwindow").exists()
    assert tr["session_medians"] == [tr["vs_baseline"]]
    # the port's run directory (under the temp dir here) is gone
    assert not list(tmp_path.glob("elbencho_tpu_torch_bench_*"))


def test_bench_tier_mismatch_exits_distinct(mocks, tmp_path, capsys):
    """Size-capped registration (the counterpart of the original's
    EBT_MOCK_PJRT_DMAMAP_MAX_BYTES): the probes' chunk-sized sources pin,
    every 16 MiB window registration fails, so the read leg runs staged
    while its first probe priced zero-copy. The bench marks the leg
    staged, records the mismatch, exits TIER_MISMATCH_EXIT and keeps the
    session out of the ledger."""
    mocks.setenv("EBT_MOCK_CUDA_HOSTREG_MAX_BYTES", str(4 << 20))
    rc, rep = _run_main(torch_bench, mocks, tmp_path, capsys,
                        {"NUM_PAIRS": 3, "WRITE_PAIRS": 2, "RAND_PAIRS": 2,
                         "MIN_READ_PAIRS": 2, **SERVING_SHRUNK})
    assert rc == torch_bench.TIER_MISMATCH_EXIT, rep
    assert rep["tier"] == "staged"
    assert rep["tier_mismatch"]
    read_leg = rep["legs"]["read"]
    assert read_leg["tier"] == "staged"
    pt = read_leg["probe_tier"]
    assert "zero_copy" in (pt if isinstance(pt, list) else [pt])
    assert read_leg["reg_cache"]["staged_fallbacks"] > 0
    assert not (tmp_path / "results" / "torch_bench"
                / "ledger.jsonl").exists()


def test_bench_module_refuses_without_cuda(tmp_path):
    """Without a CUDA device and without EBT_TORCH_DEVICE=cpu the bench
    refuses before any leg, prints no result and exits 1."""
    env = {k: v for k, v in os.environ.items() if k != "EBT_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "elbencho_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    assert "no CUDA device found" in out.stderr
    assert out.stdout == ""


# ------------------------------------------------- multi-device legs


def _bench_legs(mocks, devices: int, seams: dict | None = None):
    """`devices` mock devices on both sides; `seams` maps each (original,
    port) pair of mock variables to the one value both get."""
    mocks.setenv("EBT_MOCK_PJRT_DEVICES", str(devices))
    mocks.setenv("EBT_MOCK_CUDA_DEVICES", str(devices))
    for (jax_var, cuda_var), v in (seams or {}).items():
        mocks.setenv(jax_var, v)
        mocks.setenv(cuda_var, v)


def test_stripe_leg_matches_original(mocks, jax_bench, tmp_path):
    """The mesh-striped fill leg on four mock devices: the same confirmed
    tier, unit counters and per-device fill bytes on both sides."""
    _bench_legs(mocks, 4)
    sizes = {}
    entries = {}
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        path = str(tmp_path / f"{name}.bin")
        with open(path, "wb") as f:
            f.write(os.urandom(8 << 20))
        sizes[name] = b.Sizes(1.0)
        g = b.build_stripe_group(path, "pjrt", sizes[name])
        try:
            entries[name] = b.measure_stripe_leg(g, sizes[name],
                                                 budget_s=240)
            assert not g.stripe_error()
        finally:
            g.teardown()
    je, te = entries["jax"], entries["torch"]
    assert set(je) == set(te)
    assert te["devices"] == 4 and te["tier"] == "striped"
    for k in ("devices", "policy", "tier", "lanes"):
        assert je[k] == te[k], k
    # the unit counters, less the barrier's clock
    assert {k: v for k, v in je["stripe"].items() if k != "barrier_wait_ns"} \
        == {k: v for k, v in te["stripe"].items() if k != "barrier_wait_ns"}
    assert sum(ln["fill_bytes"] for ln in te["lanes"]) == 8 << 20
    assert te["vs_device_ceiling_sum"] > 0


def test_checkpoint_leg_matches_original(mocks, jax_bench, tmp_path):
    """The checkpoint-restore leg on two mock devices, with the
    under-load variant: every session reconciles all shards, and the
    per-device resident bytes and the ledger's barrier count agree."""
    _bench_legs(mocks, 2)
    entries = {}
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        d = tmp_path / name
        d.mkdir()
        load = str(tmp_path / f"{name}.bin")
        with open(load, "wb") as f:
            f.write(os.urandom(8 << 20))
        sizes = b.Sizes(1.0)
        g = b.build_ckpt_group(str(d), "pjrt", sizes)
        try:
            entries[name] = b.measure_checkpoint_leg(
                g, sizes, budget_s=240, load_path=load, sessions=2)
            assert not g.ckpt_error()
        finally:
            g.teardown()
    je, te = entries["jax"], entries["torch"]
    assert set(je) == set(te)
    assert "reconcile_error" not in te
    for k in ("shards", "devices", "shard_bytes", "total_bytes",
              "bytes_per_device", "ckpt_cold_mode"):
        assert je[k] == te[k], k
    for k in ("barriers", "shards_total", "shards_resident"):
        assert je["ckpt"][k] == te["ckpt"][k], k
    for variant in ("cold", "warm", "under_load"):
        assert te[variant]["sessions"] == 2
        assert set(je[variant]) == set(te[variant]), variant


def test_reshard_leg_on_mock(mocks, jax_bench, tmp_path):
    """The port of tests/test_reshard.py's bench-leg acceptance on four
    mock devices, held against the original's leg: the D2D tier engaged
    and confirmed, the same plan (moved bytes, lane pairs) on both sides,
    every pair's ceiling probed, and the D2D tier beating its own
    byte-identical host-bounce control (one service slot per move against
    a D2H and an H2D slot per bounced move)."""
    # ten times the original test's service times (400 and 100 us), so a
    # loaded host's scheduling stays small beside the sessions' ttr
    _bench_legs(mocks, 4, {
        ("EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US"): "4000",
        ("EBT_MOCK_D2D_US", "EBT_MOCK_CUDA_D2D_US"): "1000"})
    legs = {}
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        d = tmp_path / name
        d.mkdir()
        legs[name] = b.measure_reshard_leg(str(d), b.Sizes(1.0),
                                           budget_s=240)
    jl, tl = legs["jax"], legs["torch"]
    assert "skipped" not in tl
    assert tl.get("error") is None
    assert tl["engagement"] == jl["engagement"] == "confirmed"
    assert tl["devices"] == 4 and tl["target_devices"] == 2
    for k in ("shards", "devices", "target_devices", "shard_bytes",
              "sessions"):
        assert jl[k] == tl[k], k
    d2d = tl["d2d"]
    assert d2d["tier"] == "d2d" and d2d["reshard"]["d2d_moves"] > 0
    assert "reconcile_error" not in d2d
    assert "reconcile_error" not in tl["bounce"]
    assert tl["bounce"]["tier"] == "bounce"
    assert d2d["plan_moves"] == jl["d2d"]["plan_moves"]
    assert d2d["reshard"]["d2d_resident_bytes"] == \
        jl["d2d"]["reshard"]["d2d_resident_bytes"]
    assert d2d["pairs"] == jl["d2d"]["pairs"]
    assert {(c["src"], c["dst"]) for c in tl["per_pair_ceiling_mib_s"]} \
        == {(p["src"], p["dst"]) for p in d2d["pairs"]}
    assert tl["hbm_reshard_gib_s"] > 0
    assert 0 < tl["vs_d2d_ceiling"] <= 2.0
    assert tl["d2d_vs_bounce"] > 1.0


def test_reshard_leg_refuses_unengaged(mocks, jax_bench, tmp_path):
    """Moves that all settled through the bounce tier grade REFUSED on
    both sides, never a bounce number under a D2D label."""
    _bench_legs(mocks, 4, {
        ("EBT_MOCK_PJRT_NO_D2D", "EBT_MOCK_CUDA_NO_D2D"): "1"})
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        d = tmp_path / name
        d.mkdir()
        leg = b.measure_reshard_leg(str(d), b.Sizes(1.0), budget_s=240,
                                    sessions=1)
        assert leg["engagement"] == "refused", name
        assert "unengaged" in leg["error"], name
        assert "hbm_reshard_gib_s" not in leg, name
