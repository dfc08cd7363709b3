"""The stripe tier of the port (--stripe, --tpustripe, the threaded
submitters) against the original package's, on the same inputs.

The native cases run the port's CUDA engine (csrc/cuda_path.cpp) on its mock
driver (EBT_MOCK_CUDA_DEVICES=4) beside the original's PjrtPath on its mock
plugin (EBT_MOCK_PJRT_DEVICES=4); the staged and direct cases run the port's
staging path on the CPU device beside the original's on CPU jax devices.
Counters, bytes, device indices, result fields and refusal texts compare
exactly; only the name of the per-device fault seam differs in an error
text (EBT_MOCK_STRIPE_FAIL_AT there, EBT_MOCK_CUDA_DEV_FAIL_AT here).
"""

from __future__ import annotations

import ctypes
import os
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu_torch import engine as torch_engine
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.stripe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
BLK = 256 << 10

# the original's mock seam -> the port's
SEAMS = {
    "EBT_MOCK_PJRT_DEVICES": "EBT_MOCK_CUDA_DEVICES",
    "EBT_MOCK_PJRT_DELAY_US": "EBT_MOCK_CUDA_DELAY_US",
    "EBT_MOCK_STRIPE_FAIL_AT": "EBT_MOCK_CUDA_DEV_FAIL_AT",
}


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
    tlib = _mock_lib(torch_mock)
    tlib.ebt_mock_dev_h2d_count.restype = ctypes.c_uint64
    made = []
    for name, cfg_mod, local, common, exc, lib, seam in (
            ("jax", jax_config, jax_local, jax_common, jax_exceptions,
             _mock_lib(JAX_MOCK), lambda k: k),
            ("torch", torch_config, torch_local, torch_common,
             torch_exceptions, tlib, lambda k: SEAMS.get(k, k))):
        made.append(SimpleNamespace(
            name=name, config_from_args=cfg_mod.config_from_args,
            Config=cfg_mod.Config, Group=local.LocalWorkerGroup,
            Phase=common.BenchPhase, ProgException=exc.ProgException,
            mock=lib, seam=seam))
    for p in made:
        p.mock.ebt_mock_reset()
    yield tuple(made)
    for p in made:
        p.mock.ebt_mock_reset()


def set_seam(monkeypatch, name: str, value) -> None:
    """Set a mock seam under both packages' names."""
    monkeypatch.setenv(name, str(value))
    monkeypatch.setenv(SEAMS[name], str(value))


def stripe_args(path: str, nblocks: int, policy: str = "rr",
                threads: int = 1, extra=()) -> list[str]:
    """A striped read of nblocks x 256 KiB, --regwindow at twice the block
    so a stripe unit is one block."""
    return ["-r", "-t", str(threads), "-s", str(nblocks * BLK),
            "-b", str(BLK), "--tpubackend", "pjrt", "--stripe", policy,
            "--regwindow", str(2 * BLK), "--nolive", *extra, path]


def run_phase(pkg, group, phase="r") -> None:
    ph = {"r": pkg.Phase.READFILES, "w": pkg.Phase.CREATEFILES}[phase]
    group.start_phase(ph, "stripe-test")
    while not group.wait_done(1000):
        pass


def file_checksum(path) -> int:
    data = np.fromfile(str(path), dtype=np.uint8)
    return int(data.sum(dtype=np.uint64)) & ((1 << 64) - 1)


def striped_read(pkg, path: str, nblocks: int, policy: str = "rr",
                 threads: int = 1) -> dict:
    """Run one package's striped read and collect what the two packages
    must agree on."""
    pkg.mock.ebt_mock_reset()
    group = pkg.Group(pkg.config_from_args(
        stripe_args(path, nblocks, policy, threads)))
    group.prepare()
    try:
        base = group.tier_counter_snapshot()
        lanes0 = [ln["to_hbm"] for ln in group.lane_stats()]
        run_phase(pkg, group)
        st = group.stripe_stats()
        return {
            "error": group.first_error(),
            "checksum": pkg.mock.ebt_mock_checksum(),
            "units": (st["units_submitted"], st["units_awaited"]),
            "barriers": st["barriers"],
            "lanes": [ln["to_hbm"] - b for ln, b in
                      zip(group.lane_stats(), lanes0)],
            "tier": group.confirm_stripe_tier(base),
            "stripe_error": group.stripe_error(),
            "wire": {k: v for k, v in pkg.Statistics(
                group.cfg, group).bench_result_wire(
                    pkg.Phase.READFILES, "w", []).items()
                     if k in ("StripeTier", "StripeError")},
        }
    finally:
        group.teardown()


# ---------------------------------------------------------------- planner


@pytest.mark.parametrize("policy,expect", [
    ("rr", [i % 4 for i in range(13)]),
    ("contig", [0] * 4 + [1] * 4 + [2] * 4 + [3]),
])
def test_planner_covers_every_block_uneven(pkgs, tmp_path, policy, expect):
    """13 blocks over 4 devices: every block maps to one device, rr
    balances within one unit, contig gives each device one run with the
    tail on the last; both packages place every block alike."""
    f = tmp_path / "f"
    f.write_bytes(b"\0" * (13 * BLK))
    got = {}
    for pkg in pkgs:
        group = pkg.Group(pkg.config_from_args(stripe_args(str(f), 13,
                                                           policy)))
        group.prepare()
        try:
            np_ = group._native_path
            got[pkg.name] = [np_.stripe_device_for(i * BLK)
                             for i in range(13)]
            # an offset inside a block maps like the block's base
            assert np_.stripe_device_for(5 * BLK + 17) == got[pkg.name][5]
        finally:
            group.teardown()
    assert got["torch"] == got["jax"] == expect


def test_planner_rejected_after_first_transfer(pkgs, tmp_path):
    """The plan is read lock-free on the hot path: once traffic ran it is
    refused, with the original's text."""
    f = tmp_path / "f"
    f.write_bytes(b"\0" * (4 * BLK))
    msgs = {}
    for pkg in pkgs:
        group = pkg.Group(pkg.config_from_args(stripe_args(str(f), 4)))
        group.prepare()
        try:
            run_phase(pkg, group)
            assert group.first_error() == ""
            with pytest.raises(pkg.ProgException) as ei:
                group._native_path.set_stripe_plan("rr", 4, 1)
            msgs[pkg.name] = str(ei.value)
        finally:
            group.teardown()
    assert "stripe plan rejected" in msgs["torch"]
    assert msgs["torch"] == msgs["jax"]


# --------------------------------------------------------- scatter/gather


@pytest.fixture
def stats_cls(pkgs):
    import elbencho_tpu.stats as jax_stats
    import elbencho_tpu_torch.stats as torch_stats

    pkgs[0].Statistics = jax_stats.Statistics
    pkgs[1].Statistics = torch_stats.Statistics
    return pkgs


@pytest.mark.parametrize("policy", ["rr", "contig"])
def test_scatter_gather_fills_all_devices_byte_exact(stats_cls, tmp_path,
                                                     policy):
    """One file's 13 blocks land on all 4 devices byte-exactly, every unit
    is settled, the tier reads "striped" and the per-lane bytes, units and
    result fields equal the original's."""
    f = tmp_path / "data"
    f.write_bytes(np.random.default_rng(7).integers(
        0, 256, 13 * BLK, dtype=np.uint8).tobytes())
    out = {p.name: striped_read(p, str(f), 13, policy) for p in stats_cls}
    t = out["torch"]
    assert t["error"] == ""
    assert t["checksum"] == file_checksum(f)
    assert t["units"] == (13, 13)
    assert t["barriers"] >= 1
    assert all(b > 0 for b in t["lanes"]) and sum(t["lanes"]) == 13 * BLK
    assert t["tier"] == "striped" and t["stripe_error"] == ""
    assert t["wire"] == {"StripeTier": "striped", "StripeError": ""}
    assert out["torch"] == out["jax"]


def test_multi_worker_striped_fill_delayed_transfers(stats_cls, tmp_path,
                                                     monkeypatch):
    """-t 2 with delayed copies: one worker's gather barrier sweeps the
    other's in-flight blocks, whose pre-reuse barrier must wait out that
    draining hold (a premature reuse corrupts the checksum)."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DELAY_US", 1500)
    f = tmp_path / "data"
    f.write_bytes(np.random.default_rng(8).integers(
        0, 256, 16 * BLK, dtype=np.uint8).tobytes())
    out = {p.name: striped_read(p, str(f), 16, threads=2)
           for p in stats_cls}
    t = out["torch"]
    assert t["error"] == "" and t["checksum"] == file_checksum(f)
    assert t["units"] == (16, 16)
    assert t["barriers"] >= 2  # one gather per worker
    for k in ("error", "checksum", "units", "lanes", "tier"):
        assert t[k] == out["jax"][k], k


def test_single_device_degenerate_is_byte_identical_ab(pkgs, tmp_path,
                                                       monkeypatch):
    """On one device the striped read moves the same bytes as the plain
    read and the tier reads "single", in both packages."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DEVICES", 1)
    f = tmp_path / "data"
    f.write_bytes(np.random.default_rng(9).integers(
        0, 256, 8 * BLK, dtype=np.uint8).tobytes())
    got = {}
    for pkg in pkgs:
        for label in ("striped", "plain"):
            pkg.mock.ebt_mock_reset()
            args = stripe_args(str(f), 8)
            if label == "plain":
                i = args.index("--stripe")
                del args[i:i + 2]
            group = pkg.Group(pkg.config_from_args(args))
            group.prepare()
            try:
                base = group.tier_counter_snapshot()
                run_phase(pkg, group)
                assert group.first_error() == ""
                got[pkg.name, label] = (pkg.mock.ebt_mock_total_bytes(),
                                        pkg.mock.ebt_mock_checksum(),
                                        group.confirm_stripe_tier(base))
            finally:
                group.teardown()
    for name in ("jax", "torch"):
        assert got[name, "striped"][:2] == got[name, "plain"][:2]
        assert got[name, "striped"][1] == file_checksum(f)
        assert got[name, "striped"][2] == "single"
        assert got[name, "plain"][2] is None
    assert got["torch", "striped"] == got["jax", "striped"]


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("args", [
    # 3 MiB blocks would split the 16 MiB registration span
    ["-r", "-s", "6M", "-b", "3145728", "--tpubackend", "pjrt",
     "--stripe", "rr", "--regwindow", "33554432"],
    ["-r", "-s", "1M", "-b", "256k", "--tpubackend", "pjrt",
     "--stripe", "rr", "--tpustripe"],
    ["-r", "-s", "1M", "-b", "256k", "--tpubackend", "direct",
     "--gpuids", "0,1", "--stripe", "rr"],
    ["-r", "-s", "1M", "-b", "256k", "--tpubackend", "pjrt",
     "--stripe", "zigzag"],
], ids=["alignment", "tpustripe-combo", "direct-backend", "policy-name"])
def test_stripe_refusals_match(pkgs, tmp_path, args):
    """The stripe checks refuse with the original's texts."""
    f = tmp_path / "f"
    f.write_bytes(b"\0" * (6 << 20))
    msgs = {}
    for pkg in pkgs:
        with pytest.raises(pkg.ProgException) as ei:
            pkg.config_from_args(args + ["--nolive", str(f)])
        msgs[pkg.name] = str(ei.value)
    assert msgs["torch"] == msgs["jax"]


def test_span_mirror_pinned_to_native_formula(pkgs):
    """Config.stripe_reg_span_bytes mirrors the engine's span formula;
    pinned against the engine's ebt_reg_span_bytes and the original."""
    lib = torch_engine.load_lib()
    for regwin, blk in [(0, 1 << 20), (2 * BLK, BLK), (32 << 20, 3 << 20),
                        (64 << 20, 4096), (8 << 20, 1 << 20), (0, 32 << 20),
                        (128 << 20, 16 << 20)]:
        spans = []
        for pkg in pkgs:
            cfg = pkg.Config(reg_window=regwin, block_size=blk,
                             tpu_backend_name="pjrt")
            spans.append(cfg.stripe_reg_span_bytes())
            assert spans[-1] == lib.ebt_reg_span_bytes(
                regwin or cfg.effective_reg_window(), blk), (regwin, blk)
            assert cfg.stripe_unit_blocks() == max(1, spans[-1] // blk)
        assert spans[0] == spans[1]


# ------------------------------------------------------------ faults


def test_gather_barrier_surfaces_device_and_cause(pkgs, tmp_path,
                                                  monkeypatch):
    """The second copy to device 2 (the warm-up is the first, so the first
    block routed there) fails in flight: the phase fails with "device 2
    unit 2: cause", and every unit still settles."""
    set_seam(monkeypatch, "EBT_MOCK_STRIPE_FAIL_AT", "2:2")
    f = tmp_path / "data"
    f.write_bytes(np.random.default_rng(10).integers(
        0, 256, 12 * BLK, dtype=np.uint8).tobytes())
    got = {}
    for pkg in pkgs:
        pkg.mock.ebt_mock_reset()
        group = pkg.Group(pkg.config_from_args(stripe_args(str(f), 12)))
        group.prepare()
        try:
            run_phase(pkg, group)
            st = group.stripe_stats()
            got[pkg.name] = (group.first_error(), group.stripe_error(),
                             st["units_awaited"] == st["units_submitted"])
        finally:
            group.teardown()
    err, serr, settled = got["torch"]
    assert "device 2" in err and "EBT_MOCK_CUDA_DEV_FAIL_AT" in err
    assert serr.startswith("device 2 unit 2: ")
    assert settled
    # the same attribution as the original's, up to the cause's text
    assert serr.split(": ")[0] == got["jax"][1].split(": ")[0]
    assert got["jax"][2]


def test_dev_fail_seam_counts_per_device(pkgs, tmp_path, monkeypatch):
    """The per-device copy count the seam counts against: the warm-up copy
    and the rr share of 12 blocks on each of the 4 devices."""
    f = tmp_path / "data"
    f.write_bytes(b"\1" * (12 * BLK))
    tlib = pkgs[1].mock
    group = pkgs[1].Group(pkgs[1].config_from_args(stripe_args(str(f), 12)))
    group.prepare()
    try:
        tlib.ebt_mock_reset()
        run_phase(pkgs[1], group)
        assert group.first_error() == ""
        assert [tlib.ebt_mock_dev_h2d_count(d) for d in range(4)] == [3] * 4
    finally:
        group.teardown()


# ---------------------------------------------------- verify on the planner


def test_stripe_verify_reports_exact_offset(pkgs, tmp_path):
    """--stripe rr --verify 42 on pjrt: the verified path checks each block
    on the lane the planner chose; a flipped byte is reported at its exact
    file offset, as by the original."""
    f = tmp_path / "v"
    args = ["-w", "-r", "-t", "1", "-s", str(8 * BLK), "-b", str(BLK),
            "--verify", "42", "--tpubackend", "pjrt", "--stripe", "rr",
            "--regwindow", str(2 * BLK), "--nolive", str(f)]
    bad = 5 * BLK + 1234
    got = {}
    for pkg in pkgs:
        if f.exists():
            f.unlink()
        group = pkg.Group(pkg.config_from_args(args))
        group.prepare()
        try:
            run_phase(pkg, group, "w")
            assert group.first_error() == ""
            run_phase(pkg, group, "r")
            clean = (group.first_error(),
                     [ln["to_hbm"] for ln in group.lane_stats()])
            data = bytearray(f.read_bytes())
            data[bad] ^= 0x40
            f.write_bytes(bytes(data))
            run_phase(pkg, group, "r")
            got[pkg.name] = clean, group.first_error()
        finally:
            group.teardown()
    (clean, err) = got["torch"]
    assert clean[0] == ""
    assert clean[1] == [2 * BLK] * 4
    assert f"offset {bad}" in err
    assert clean == got["jax"][0]
    assert f"offset {bad}" in got["jax"][1]


# ----------------------------------------- staged and direct (CPU devices)


def _staged_group(pkg, path, nblocks, backend, extra=()):
    return pkg.Group(pkg.config_from_args(
        ["-r", "-t", "1", "-s", str(nblocks * BLK), "-b", str(BLK),
         "--gpuids", "0,1,2,3", "--tpubackend", backend, *extra,
         "--nolive", str(path)]))


def _jax_dev_bytes(staging, arrs_by_dev):
    """Wrap the original staging path's device_put so the bytes it puts on
    each device are counted (its own counters are totals only)."""
    real = staging.jax.device_put
    index = {id(d): i for i, d in enumerate(staging.devices)}

    def put(x, device=None, *a, **kw):
        if isinstance(x, np.ndarray) and device is not None and \
                id(device) in index:
            arrs_by_dev[index[id(device)]] += x.nbytes
        elif isinstance(x, list) and isinstance(device, list):
            for v, d in zip(x, device):
                arrs_by_dev[index[id(d)]] += v.nbytes
        elif isinstance(x, np.ndarray):  # a sharding over every device
            for i in range(len(staging.devices)):
                arrs_by_dev[i] += x.nbytes // len(staging.devices)
        return real(x, device, *a, **kw)

    staging.jax = SimpleNamespace(device_put=put)


@pytest.mark.parametrize("backend,extra,submitters", [
    ("staged", ["--stripe", "rr"], None),       # the mesh fallback
    ("staged", ["--tpustripe"], None),
    ("direct", ["--tpustripe"], None),          # two submitters by default
    ("direct", ["--tpustripe"], "0"),
    ("direct", [], "0"),
    ("direct", [], "2"),
    ("direct", ["--tpustripe"], "2"),
], ids=["staged-stripe", "staged-tpustripe", "direct-tpustripe-default",
        "direct-tpustripe-inline", "direct-inline", "direct-submitters",
        "direct-tpustripe-submitters"])
def test_placement_bytes_per_device_match(pkgs, tmp_path, monkeypatch,
                                          backend, extra, submitters):
    """Each staged/direct placement puts the same bytes on each device as
    the original's, moves the whole file, and keeps the last block
    byte-available; the submitter count and mode match the original's."""
    if submitters is None:
        monkeypatch.delenv("EBT_TPU_SUBMITTERS", raising=False)
    else:
        monkeypatch.setenv("EBT_TPU_SUBMITTERS", submitters)
    # 1 MiB chunks: a 1 MiB-and-a-half block splits into two uneven chunks
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(1 << 20))
    nblocks, blk = 5, 6 * BLK
    f = tmp_path / "data"
    raw = np.random.default_rng(11).integers(0, 256, nblocks * blk,
                                             dtype=np.uint8)
    f.write_bytes(raw.tobytes())
    got = {}
    for pkg in pkgs:
        group = pkg.Group(pkg.config_from_args(
            ["-r", "-t", "1", "-s", str(nblocks * blk), "-b", str(blk),
             "--gpuids", "0,1,2,3", "--tpubackend", backend, *extra,
             "--nolive", str(f)]))
        group.prepare()
        try:
            staging = group._dev_callback.staging_path
            per_dev = [0] * 4
            if pkg.name == "jax":
                _jax_dev_bytes(staging, per_dev)
            run_phase(pkg, group)
            assert group.first_error() == ""
            if pkg.name == "torch":
                per_dev = staging.device_bytes()
            last = b"".join(bytes(np.asarray(a)) for a in
                            staging.last_staged_arrays(0))
            got[pkg.name] = (per_dev, staging.transferred_bytes[0],
                             staging.num_submitters, staging.inline_submit,
                             staging.stripe, staging.mesh_stripe, last)
        finally:
            group.teardown()
    per_dev, total, *_, last = got["torch"]
    assert total == nblocks * blk == sum(per_dev)
    assert last == raw[(nblocks - 1) * blk:].tobytes()
    assert got["torch"] == got["jax"]


def test_tpustripe_staged_verify_checks_each_chunk_on_its_device(
        pkgs, tmp_path, monkeypatch):
    """Staged --tpustripe --verify: each chunk is checked on the device it
    landed on (one call of the verify wrapper per chunk, at the chunk's
    file offset), and a flipped byte is reported at its exact offset, as
    by the original."""
    from elbencho_tpu_torch.cuda import backend

    calls = []
    real = backend.verify_block_u32

    def counted(block, off, salt):
        calls.append((off, int(block.numel())))
        return real(block, off, salt)

    monkeypatch.setattr(backend, "verify_block_u32", counted)
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(BLK))
    nblocks, blk = 3, 4 * BLK
    f = tmp_path / "v"
    args = ["-w", "-r", "-t", "1", "-s", str(nblocks * blk), "-b", str(blk),
            "--verify", "42", "--gpuids", "0,1,2,3", "--tpubackend",
            "staged", "--tpustripe", "--nolive", str(f)]
    bad = blk + 2 * BLK + 77
    got = {}
    for pkg in pkgs:
        if f.exists():
            f.unlink()
        group = pkg.Group(pkg.config_from_args(args))
        group.prepare()
        try:
            run_phase(pkg, group, "w")
            assert group.first_error() == ""
            calls.clear()
            run_phase(pkg, group, "r")
            clean = group.first_error()
            launches = sorted(calls)
            data = bytearray(f.read_bytes())
            data[bad] ^= 0x01
            f.write_bytes(bytes(data))
            run_phase(pkg, group, "r")
            got[pkg.name] = clean, launches, group.first_error()
        finally:
            group.teardown()
    clean, launches, err = got["torch"]
    assert clean == ""
    assert launches == [(i * BLK, BLK) for i in range(nblocks * 4)]
    assert f"offset {bad}" in err and f"offset {bad}" in got["jax"][2]
    assert got["jax"][0] == ""


def test_pjrt_tpustripe_round_trip_rotates_chunks(pkgs, tmp_path,
                                                  monkeypatch):
    """--tpustripe on pjrt: read blocks and write round trips put each
    block's chunks on the lanes in turn, with the original's per-lane byte
    counts."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(BLK))
    f = tmp_path / "d"
    # --blockvarpct refills each write block on the host, which then
    # round-trips through the device before it is written
    args = ["-w", "-r", "-t", "1", "-s", str(8 * BLK), "-b", str(2 * BLK),
            "--blockvarpct", "100", "--tpubackend", "pjrt", "--tpustripe",
            "--nolive", str(f)]
    got = {}
    for pkg in pkgs:
        if f.exists():
            f.unlink()
        group = pkg.Group(pkg.config_from_args(args))
        group.prepare()
        try:
            run_phase(pkg, group, "w")
            run_phase(pkg, group, "r")
            got[pkg.name] = (group.first_error(),
                             [(ln["to_hbm"], ln["from_hbm"])
                              for ln in group.lane_stats()])
        finally:
            group.teardown()
    assert got["torch"][0] == ""
    # the chunks rotate over lanes 0 and 1; the round trip's bytes count
    # on the rank's lane, as in the original
    assert got["torch"][1] == [(3 << 20, 2 << 20), (1 << 20, 0), (0, 0),
                               (0, 0)]
    assert got["torch"] == got["jax"]


def test_submitters_stress_keeps_every_byte(pkgs, tmp_path, monkeypatch):
    """More submitters and engine threads than cores, with a shortened
    switch interval: every chunk is counted once on its device, the total
    is the file, and the last block of each rank reads back exactly (a
    lost update or an early buffer reuse breaks one of them)."""
    import signal
    import sys

    def hang(signum, frame):
        raise TimeoutError("submitter stress exceeded its 120 s limit")

    cores = os.cpu_count() or 1
    monkeypatch.setenv("EBT_TPU_SUBMITTERS", str(cores + 4))
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(64 << 10))
    threads, nblocks, blk = 4, 64, BLK
    f = tmp_path / "data"
    raw = np.random.default_rng(12).integers(0, 256, nblocks * blk,
                                             dtype=np.uint8)
    f.write_bytes(raw.tobytes())
    old_alarm = signal.signal(signal.SIGALRM, hang)
    old_switch = sys.getswitchinterval()
    signal.alarm(120)
    sys.setswitchinterval(1e-5)
    try:
        torch_pkg = pkgs[1]
        group = torch_pkg.Group(torch_pkg.config_from_args(
            ["-r", "-t", str(threads), "-s", str(nblocks * blk), "-b",
             str(blk), "--gpuids", "0,1,2,3", "--tpubackend", "direct",
             "--tpustripe", "--nolive", str(f)]))
        group.prepare()
        try:
            sp = group._dev_callback.staging_path
            assert sp.num_submitters == cores + 4 and not sp.inline_submit
            run_phase(torch_pkg, group)
            assert group.first_error() == ""
            # 4 chunks per block, chunk j on device j
            assert sp.device_bytes() == [nblocks * blk // 4] * 4
            assert sp.transferred_bytes[0] == nblocks * blk
            per_rank = nblocks // threads
            for rank in range(threads):
                last = (rank + 1) * per_rank - 1
                got = b"".join(bytes(np.asarray(a)) for a in
                               sp.last_staged_arrays(rank))
                assert got == raw[last * blk:(last + 1) * blk].tobytes()
        finally:
            group.teardown()
    finally:
        sys.setswitchinterval(old_switch)
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old_alarm)
