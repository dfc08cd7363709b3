"""The port bench's six host-heavy legs (metadata, io_uring A/B, offered
load, serving under rotation, faults, ingest) against the original's
bench.py, one leg function of each package on the same constants and the
same environment.

The original runs on its mock PJRT plugin (elbencho_tpu/libebtpjrtmock.so),
the port on its mock CUDA driver (build/torch_core/libebtcudamock.so) with
EBT_TORCH_DEVICE=cpu. Rates follow the clock and are never compared: each
case holds the key sets, the counts that both mocks make alike, the
refusals, and the invariants each leg grades itself by. Every case first
asserts that neither side returned "skipped", unless the skip is the case
under test. The serving leg runs at the original's constants (about a
minute per package on the mocks), which is why these cases have a file of
their own.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

import elbencho_tpu_torch.bench as torch_bench
from elbencho_tpu_torch import chaos as torch_chaos
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
URING_COUNTERS = {"uring_fixed_hits", "uring_register_ns",
                  "uring_sqpoll_wakeups", "double_pin_avoided_bytes",
                  "aio_setup_retries"}


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_original_legs", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


@pytest.fixture
def mocks(monkeypatch):
    """Both mocks with one device each unless a case says otherwise, the
    port on the CPU, and no A/B or seam variable left from elsewhere."""
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_engine.build_mock())
    for k in ("EBT_URING_DISABLE", "EBT_LOAD_CLOSED_LOOP",
              "EBT_REACTOR_DISABLE", "EBT_TPU_NO_MMAP",
              "EBT_MOCK_PJRT_XFER_US", "EBT_MOCK_CUDA_XFER_US",
              "EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.delenv(k, raising=False)
    for k in list(os.environ):
        if k.startswith("EBT_MOCK_") and "FAIL" in k:
            monkeypatch.delenv(k)
    return monkeypatch


def _both(jax_bench, tmp_path, leg: str) -> tuple[dict, dict]:
    """measure_<leg>_leg of each package, each in a workdir of its own."""
    out = []
    for name, b in (("jax", jax_bench), ("torch", torch_bench)):
        d = tmp_path / name
        d.mkdir()
        out.append(getattr(b, f"measure_{leg}_leg")(str(d), budget_s=600))
    return out[0], out[1]


def _not_skipped(je: dict, te: dict) -> None:
    assert "skipped" not in je, je
    assert "skipped" not in te, te


@pytest.mark.parametrize("name", [
    "META", "URING", "LOAD", "SERVING", "FAULTS", "INGEST"])
def test_leg_constants_match_original(jax_bench, name):
    """Every constant of the six legs (sizes, grids, budgets, seeds) is the
    original's."""
    names = [n for n in vars(jax_bench) if n.startswith(name + "_")]
    assert names
    for n in names:
        assert getattr(torch_bench, n) == getattr(jax_bench, n), n


def test_meta_leg_matches_original(mocks, jax_bench, tmp_path):
    """The metadata leg (the metadata assertions of
    tests/test_bench_harness.py): the same tree on both sides, every phase
    graded against its raw-syscall ceiling."""
    je, te = _both(jax_bench, tmp_path, "meta")
    _not_skipped(je, te)
    assert set(je) == set(te)
    assert je["total_files"] == te["total_files"] == 512
    for e in (je, te):
        assert "error" not in e
        for k in ("mkdirs", "stat", "delfiles"):
            assert e[f"{k}_vs_ceiling"] > 0, k
        assert e["vs_ceiling"] > 0
    assert not (tmp_path / "torch" / "ebt_meta_leg").exists()


def test_uring_leg_matches_original(mocks, jax_bench, tmp_path):
    """The io_uring A/B leg (the uring assertions of
    tests/test_bench_harness.py): the same resolved backend, cause, counter
    group and refusal text. Where the kernel has io_uring but the default
    backend's groups ride no fixed buffer, both refuse the engagement
    word for word and record no ratio."""
    je, te = _both(jax_bench, tmp_path, "uring")
    _not_skipped(je, te)
    assert set(je) == set(te)
    for k in ("ioengine", "ioengine_cause", "error", "threads", "iodepth",
              "block_kib", "file_mib"):
        assert je.get(k) == te.get(k), k
    assert set(je["uring"]) == set(te["uring"]) == URING_COUNTERS
    assert ("uring_vs_aio" in je) == ("uring_vs_aio" in te)
    if te["ioengine"] == "aio":
        assert te["ioengine_cause"] and te["aio_mib_s"] > 0
    elif "error" in te:
        assert te["error"] == (
            "uring engagement not confirmed: resolved backend is uring "
            "but uring_fixed_hits did not move")
        assert te["uring"]["uring_fixed_hits"] == 0
    else:
        assert te["uring_vs_aio"] > 0 and je["uring_vs_aio"] > 0


def test_uring_leg_aio_branch_matches_original(mocks, jax_bench, tmp_path):
    """The leg's AIO branch, which a host without io_uring takes (as the
    card's machine does): with the backend pinned to kernel AIO in both
    packages' configurations, both legs record the AIO shape with no
    ratio and no refusal, graded against the raw pread."""
    import elbencho_tpu.config
    import elbencho_tpu_torch.config

    for mod in (elbencho_tpu.config, elbencho_tpu_torch.config):
        parse = mod.config_from_args
        mocks.setattr(mod, "config_from_args",
                      lambda args, _p=parse: _p(["--ioengine", "aio"]
                                                + list(args)))
    je, te = _both(jax_bench, tmp_path, "uring")
    _not_skipped(je, te)
    assert set(je) == set(te)
    assert je["ioengine"] == te["ioengine"] == "aio"
    assert je["ioengine_cause"] == te["ioengine_cause"]
    assert "error" not in te and "uring_vs_aio" not in te
    assert "uring_mib_s" not in te
    assert te["aio_mib_s"] > 0 and te["aio_vs_raw"] > 0
    assert te["uring"]["uring_fixed_hits"] == 0


def test_load_leg_matches_original(mocks, jax_bench, tmp_path):
    """The offered-load leg (tests/test_bench_harness.py:227-251): the
    same grid and arrival shape, a monotone curve, the byte-identical
    closed-loop A/B, and the reactor confirmed from its wakeup counters
    wherever it ran."""
    je, te = _both(jax_bench, tmp_path, "load")
    _not_skipped(je, te)
    assert set(je) == set(te)
    assert [p["offered_frac"] for p in je["points"]] == \
        [p["offered_frac"] for p in te["points"]] == \
        list(torch_bench.LOAD_GRID)
    for k in ("arrival", "threads", "iodepth", "block_kib", "hot_bs_kib",
              "file_mib", "ab_frac", "reactor_enabled"):
        assert je[k] == te[k], k
    assert [p["arrival_mode"] for p in je["points"]] == \
        [p["arrival_mode"] for p in te["points"]]
    for e in (je, te):
        assert "error" not in e, e.get("error")
        assert e["closed_loop_iops"] > 0
        offered = [p["offered_iops"] for p in e["points"]]
        assert offered == sorted(offered)
        assert e["curve_monotone"] is True
        assert e["ab_bytes_identical"] is True
        assert e["ab_closed_mode"] == "closed"
        for p in e["points"]:
            assert set(p["classes"]) == {"hot", "bulk"}
            for cls in p["classes"].values():
                assert cls["p99_us"] >= cls["p50_us"] >= 0
        if e["reactor_enabled"]:
            assert e["reactor"]["reactor_waits"] > 0
            assert e["reactor_vs_poll"]["poll_sched_lag_ns"] >= 0
    # the whole file is read once per phase on both sides
    assert je["ab_open_bytes"] == te["ab_open_bytes"] == \
        torch_bench.LOAD_FILE_BYTES
    assert os.environ.get("EBT_LOAD_CLOSED_LOOP") is None
    assert os.environ.get("EBT_REACTOR_DISABLE") is None


def test_serving_leg_matches_original(mocks, jax_bench, tmp_path):
    """The serving-under-rotation leg at the original's constants: the
    same budgets in the frontier, rotation engaged and its buckets
    throttled, every open-loop ledger exact, and byte-identical traffic
    across the variants on both sides. The mock knobs are restored."""
    je, te = _both(jax_bench, tmp_path, "serving")
    _not_skipped(je, te)
    assert "error" not in je, je.get("error")
    assert "error" not in te, te.get("error")
    assert set(je) == set(te)
    for k in ("threads", "block_kib", "file_mib", "shards", "shard_kib",
              "rotate_period_s"):
        assert je[k] == te[k], k
    assert [p["bgbudget"] for p in je["frontier"]] == \
        [p["bgbudget"] for p in te["frontier"]] == \
        list(torch_bench.SERVING_BG_BUDGETS)
    for e in (je, te):
        assert e["engagement"] == "confirmed"
        assert e["ab_bytes_identical"] is True
        assert {p["bytes"] for p in e["frontier"]} == {e["baseline_bytes"]}
        for p in e["frontier"]:
            assert p["ledger_exact"] is True
            assert p["rotations"] > 0
    assert te["baseline_bytes"] == je["baseline_bytes"] == \
        torch_bench.SERVING_RAND_BYTES
    assert os.environ.get("EBT_MOCK_CUDA_XFER_US") is None
    assert os.environ.get("EBT_TPU_NO_MMAP") is None


def test_faults_leg_matches_original(mocks, jax_bench, tmp_path):
    """The faults leg on four mock devices (tests/test_faults.py:509): the
    same seed and the same injection points (each original variable
    mapped to the port's through chaos.ORIGINAL_SEAM_ENVS), a read that
    completes byte-exact through one ejection, and the --maxerrors 0 A/B
    aborting, on both sides. The seams are unarmed again afterwards."""
    mocks.setenv("EBT_MOCK_PJRT_DEVICES", "4")
    mocks.setenv("EBT_MOCK_CUDA_DEVICES", "4")
    je, te = _both(jax_bench, tmp_path, "faults")
    _not_skipped(je, te)
    assert "error" not in je, je.get("error")
    assert "error" not in te, te.get("error")
    assert set(je) == set(te)
    assert je["devices"] == te["devices"] == 4
    assert je["seed"] == te["seed"]
    mapped = {torch_chaos.SEAMS[torch_chaos.ORIGINAL_SEAM_ENVS[k]].env
              if k in torch_chaos.ORIGINAL_SEAM_ENVS else k: v
              for k, v in je["seams"].items()}
    assert mapped == te["seams"]
    assert "EBT_MOCK_CUDA_DEV_FAIL_AT" in te["seams"]
    assert "EBT_MOCK_URING_REGISTER_FAIL_AT" in te["seams"]
    for e in (je, te):
        assert e["completed_under_faults"] is True
        assert e["reconciled"] is True
        assert e["ab_default_aborts"] is True
        assert e["ejected"].startswith("device ")
        assert e["under_faults_vs_clean"] > 0
    assert je["fault"]["ejected_devices"] == \
        te["fault"]["ejected_devices"] >= 1
    assert je["fault"]["replanned_units"] == te["fault"]["replanned_units"]
    for k in set(je["seams"]) | set(te["seams"]):
        assert k not in os.environ, k


def test_faults_leg_skips_on_one_device(mocks, jax_bench, tmp_path):
    """One mock device: ejection has no survivor to replan onto, and both
    legs record the skip."""
    mocks.setenv("EBT_MOCK_PJRT_DEVICES", "1")
    je, te = _both(jax_bench, tmp_path, "faults")
    assert set(je) == set(te) == {"skipped"}
    assert "1 device(s)" in je["skipped"] and "1 device(s)" in te["skipped"]


def test_faults_leg_skips_off_the_mock(mocks, tmp_path):
    """Against any driver but the mock, the port's leg records the
    original's mock-only skip in its own words (on the card this is the
    real driver, libcuda.so.1)."""
    mocks.setenv("EBT_CUDA_DRIVER", "libcuda.so.1")
    leg = torch_bench.measure_faults_leg(str(tmp_path), budget_s=60)
    assert leg == {"skipped": "fault seams are mock-only (EBT_CUDA_DRIVER "
                              "must point at libebtcudamock.so)"}


def test_ingest_leg_matches_original(mocks, jax_bench, tmp_path):
    """The ingest leg (tests/test_ingest.py:622): the same dataset, tier
    and record ledger (per epoch too), reconciled, and graded against the
    raw record ceiling on both sides."""
    je, te = _both(jax_bench, tmp_path, "ingest")
    _not_skipped(je, te)
    assert set(je) == set(te)
    for k in ("records_per_epoch", "tier", "threads", "shards",
              "record_bytes", "epochs", "shuffle_window"):
        assert je[k] == te[k], k
    for k in ("records_read", "records_resident", "records_dropped",
              "barriers", "epochs"):
        assert je["ingest"][k] == te["ingest"][k], k
    assert te["ingest"]["records_read"] == \
        torch_bench.INGEST_EPOCHS * te["records_per_epoch"]
    for e in (je, te):
        assert "reconcile_error" not in e
        assert "ingest_failure" not in e
        assert e["tier"] in ("pipelined", "serial")
        assert e["ingest_records_s"] > 0
        assert len(e["epoch_times_s"]) == torch_bench.INGEST_EPOCHS
        assert e["vs_ceiling"] > 0
    assert not (tmp_path / "torch" / "ebt_ingest_leg").exists()


def test_faults_leg_recovery_is_not_held_by_the_poll_slice(mocks, tmp_path):
    """The port's degraded pass pays one poll slice for its fault, not one
    per copy: a wait on a copy whose stream faulted finds out by querying
    the stream every 50 ms (its completion will never run), and a later
    wait on a lane that already reported a fault queries at once. When
    every wait on the faulted stream paid its own slice, 8 MiB under
    faults took about 0.86 s (9.3 MiB/s); with one slice about 56 ms.
    32 MiB/s bounds the pass at 0.25 s."""
    mocks.setenv("EBT_MOCK_CUDA_DEVICES", "4")
    leg = torch_bench.measure_faults_leg(str(tmp_path), budget_s=600)
    assert "error" not in leg and "skipped" not in leg, leg
    assert leg["fault"]["ejected_devices"] == 1
    assert leg["faults_mib_s"] > 32, leg


@pytest.mark.parametrize("per_worker", [986.0, 9072.0, 40000.0])
def test_serving_variants_outlast_the_slowest_rotation(jax_bench,
                                                       per_worker):
    """The serving variants read long enough for the slowest budget's
    first rotation: it starts one period in and moves the 8 MiB payload
    at 6 MiB/s from an empty bucket. At the mock's closed loop (986 ops/s)
    the original's 192 MiB already last about 10 s and are kept, so the
    mock runs compare byte for byte; at an H100's (9072 ops/s) they
    lasted about 1.4 s and the variant ended before its rotation. The
    trace is the original's schedule."""
    b = torch_bench
    payload = b.SERVING_SHARDS * b.SERVING_SHARD_BLOCKS * b.SERVING_BLOCK_BYTES
    need_s = b.SERVING_ROTATE_S + 2 * payload / min(
        x for x in b.SERVING_BG_BUDGETS if x)
    nbytes = b.serving_rand_bytes(per_worker)
    ops = nbytes // b.SERVING_BLOCK_BYTES
    assert ops >= b.serving_trace_ops(per_worker, need_s)
    if per_worker < 1000:
        assert nbytes == jax_bench.SERVING_RAND_BYTES
    else:
        assert b.SERVING_RAND_BYTES // b.SERVING_BLOCK_BYTES < \
            b.serving_trace_ops(per_worker, need_s)
    # the schedule: the original's segments, whose mean rate over the
    # ramp's first second is 0.21 of the closed loop
    assert b.serving_trace_ops(per_worker, 1.0) == \
        pytest.approx(0.21 * per_worker)
    assert b.serving_trace_ops(per_worker, 2.9) == pytest.approx(
        (0.21 + 1.4 * 0.3 + 0.5 * 0.42) * per_worker)
