"""The port's native CUDA transfer engine (--tpubackend pjrt) against the
original package's native PJRT engine, on their mocks.

The port runs its real C++ engine (csrc/cuda_path.cpp) against the mock
CUDA driver (csrc/cuda_mock.cpp -> build/torch_core/libebtcudamock.so), the
original runs its PjrtPath against the mock PJRT plugin (libebtpjrtmock.so).
Both get the same arguments, the same seeded files and the same mock
seams (EBT_MOCK_CUDA_* beside EBT_MOCK_PJRT_*); each case compares what
both packages must agree on: bytes written to storage, byte counters,
lane and registration-cache counters, d2h counts, the per-chip latency
rows' presence and clock, and error texts.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.cli as jax_cli
import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.cli as torch_cli
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu.tpu.native import uring_stats as jax_uring_stats
from elbencho_tpu_torch import engine as torch_engine
from elbencho_tpu_torch.cuda import native
from elbencho_tpu_torch.engine_stats import uring_stats as torch_uring_stats
from elbencho_tpu_torch.ops import integrity
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
U64 = (1 << 64) - 1

# mock seams: the original's EBT_MOCK_PJRT_* name -> the port's
# EBT_MOCK_CUDA_* name (the d2h fetch failure has no PJRT prefix there)
SEAMS = {
    "EBT_MOCK_PJRT_DEVICES": "EBT_MOCK_CUDA_DEVICES",
    "EBT_MOCK_PJRT_DELAY_US": "EBT_MOCK_CUDA_DELAY_US",
    "EBT_MOCK_PJRT_XFER_US": "EBT_MOCK_CUDA_XFER_US",
    "EBT_MOCK_PJRT_FAIL_AT": "EBT_MOCK_CUDA_FAIL_AT",
    "EBT_MOCK_D2H_FAIL_AT": "EBT_MOCK_CUDA_XFER_FAIL_AT",
    "EBT_MOCK_PJRT_FAIL_READY_AT": "EBT_MOCK_CUDA_FAIL_READY_AT",
    "EBT_MOCK_PJRT_ONREADY_UNSUPPORTED": "EBT_MOCK_CUDA_HOSTFUNC_UNSUPPORTED",
    "EBT_MOCK_PJRT_NO_DMAMAP": "EBT_MOCK_CUDA_NO_HOSTREG",
    "EBT_MOCK_PJRT_DMAMAP_FAIL": "EBT_MOCK_CUDA_HOSTREG_FAIL",
    "EBT_MOCK_PJRT_DMAMAP_FAIL_AT": "EBT_MOCK_CUDA_HOSTREG_FAIL_AT",
    "EBT_MOCK_PJRT_DMAMAP_FAIL_AFTER": "EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER",
    "EBT_MOCK_PJRT_DMAMAP_MAX_BYTES": "EBT_MOCK_CUDA_HOSTREG_MAX_BYTES",
}


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("ebt_mock_total_bytes", "ebt_mock_checksum",
                 "ebt_mock_exec_count"):
        getattr(lib, name).restype = ctypes.c_uint64
    lib.ebt_mock_live_buffers.restype = ctypes.c_int64
    return lib


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port): each package's config parser, worker group, mock
    library and the seam/counter names its mock uses."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    jlib, tlib = _mock_lib(JAX_MOCK), _mock_lib(torch_mock)
    jlib.ebt_mock_dmamap_active.restype = ctypes.c_uint64
    jlib.ebt_mock_ready_event_count.restype = ctypes.c_uint64
    tlib.ebt_mock_hostreg_active.restype = ctypes.c_uint64
    tlib.ebt_mock_h2d_count.restype = ctypes.c_uint64
    tlib.ebt_mock_completion_count.restype = ctypes.c_uint64
    jax_pkg = SimpleNamespace(
        name="jax", config_from_args=jax_config.config_from_args,
        Group=jax_local.LocalWorkerGroup, Phase=jax_common.BenchPhase,
        ProgException=jax_exceptions.ProgException, main=jax_cli.main,
        mock=jlib, seam=lambda k: k,
        reg_active=jlib.ebt_mock_dmamap_active,
        # calls so far of the transfer call the FAIL_AT seam counts
        h2d_calls=lambda: jlib.ebt_mock_total_bytes() // (1 << 20),
        completion_calls=jlib.ebt_mock_ready_event_count)
    torch_pkg = SimpleNamespace(
        name="torch", config_from_args=torch_config.config_from_args,
        Group=torch_local.LocalWorkerGroup, Phase=torch_common.BenchPhase,
        ProgException=torch_exceptions.ProgException, main=torch_cli.main,
        mock=tlib, seam=lambda k: SEAMS[k],
        reg_active=tlib.ebt_mock_hostreg_active,
        h2d_calls=tlib.ebt_mock_h2d_count,
        completion_calls=tlib.ebt_mock_completion_count)
    for p in (jax_pkg, torch_pkg):
        p.mock.ebt_mock_reset()
    yield jax_pkg, torch_pkg
    for p in (jax_pkg, torch_pkg):
        p.mock.ebt_mock_reset()


def set_seam(monkeypatch, name: str, value) -> None:
    """Set a mock seam under both packages' names."""
    monkeypatch.setenv(name, str(value))
    monkeypatch.setenv(SEAMS[name], str(value))


def pattern(size: int, salt: int, off: int = 0) -> bytes:
    """The offset+salt verify pattern (the plain version of B3)."""
    words = integrity.fill_block_u32(size // 8, off, salt, "cpu")
    return words.numpy().tobytes()[:size]


@dataclasses.dataclass
class Outcome:
    """What one package's run left behind (timings excluded)."""
    first_error: str = ""
    worker_errors: str = ""
    native_error: str = ""
    reg_error: str = ""
    to_hbm: int = 0
    from_hbm: int = 0
    zero_copy: int = 0
    reg_cache: dict = dataclasses.field(default_factory=dict)
    d2h: dict = dataclasses.field(default_factory=dict)
    lanes: list = dataclasses.field(default_factory=list)
    latency: dict = dataclasses.field(default_factory=dict)
    clock: dict = dataclasses.field(default_factory=dict)
    tier: str | None = None
    d2h_tier: str | None = None
    dma_supported: bool = False
    zero_copy_engaged: bool = False
    single_lane: bool = False
    num_devices: int = 0
    d2h_depth: int = 0
    landed: int = 0
    checksum: int = 0
    reg_active_after: int = 0
    live_buffers_after: int = 0
    data: bytes = b""


def run(pkg, args: list[str], phases=("w",), env=None, monkeypatch=None,
        after_prepare=None) -> Outcome:
    """Build one package's worker group from `args`, run `phases` ('w' =
    create files, 'r' = read) and collect its Outcome. `after_prepare`
    (pkg, monkeypatch) runs between prepare and the first phase."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(pkg.seam(k) if k.startswith("EBT_MOCK") else k,
                           str(v))
    pkg.mock.ebt_mock_reset()
    cfg = pkg.config_from_args(args + ["--tpubackend", "pjrt", "--nolive"])
    group = pkg.Group(cfg)
    out = Outcome()
    group.prepare()
    try:
        np_ = group._native_path
        out.dma_supported = np_.dma_supported
        out.zero_copy_engaged = np_.zero_copy_engaged
        out.num_devices = np_.num_devices
        out.single_lane = group.single_lane()
        out.d2h_depth = group.effective_d2h_depth()
        if after_prepare:
            after_prepare(pkg, monkeypatch)
        # the warm-up transfer is not phase traffic
        base_landed = pkg.mock.ebt_mock_total_bytes()
        base_sum = pkg.mock.ebt_mock_checksum()
        zc0 = np_.zero_copy_count
        for ph in phases:
            phase = {"w": pkg.Phase.CREATEFILES,
                     "r": pkg.Phase.READFILES}[ph]
            group.start_phase(phase, "test")
            while not group.wait_done(1000):
                pass
        results = group.phase_results()
        out.first_error = group.first_error()
        out.worker_errors = " | ".join(r.error for r in results)
        out.native_error = np_.last_error()
        out.reg_error = np_.reg_error()
        out.to_hbm, out.from_hbm = np_.transferred_bytes
        out.zero_copy = np_.zero_copy_count - zc0
        out.reg_cache = group.reg_cache_stats()
        out.d2h = group.d2h_stats()
        out.lanes = [{k: v for k, v in ln.items() if k != "lock_wait_ns"}
                     for ln in group.lane_stats()]
        out.latency = {k: h.count for k, h in group.device_latency().items()}
        out.clock = group.device_latency_clock()
        out.tier = group.data_path_tier()
        out.d2h_tier = group.d2h_tier()
        out.landed = pkg.mock.ebt_mock_total_bytes() - base_landed
        out.checksum = (pkg.mock.ebt_mock_checksum() - base_sum) & U64
    finally:
        group.teardown()
    out.reg_active_after = pkg.reg_active()
    out.live_buffers_after = pkg.mock.ebt_mock_live_buffers()
    path = args[-1]
    if os.path.isfile(path):
        out.data = open(path, "rb").read()
    return out


def run_both(pkgs, args, tmp_path, phases=("w",), env=None, monkeypatch=None,
             seed_file: int = 0, after_prepare=None):
    """Run the original and the port on the same arguments; each gets its
    own copy of the seeded input file (seed_file bytes, 0 = none)."""
    outs = []
    rng = np.random.default_rng(1234)
    data = rng.integers(0, 256, seed_file, dtype=np.uint8).tobytes() \
        if seed_file else b""
    for pkg in pkgs:
        path = tmp_path / pkg.name
        if seed_file:
            path.write_bytes(data)
        outs.append(run(pkg, args + [str(path)], phases, env, monkeypatch,
                        after_prepare))
    return outs[0], outs[1], data


# fields both packages must agree on in every clean run
PARITY = ("first_error", "to_hbm", "from_hbm", "zero_copy", "lanes",
          "latency", "clock", "tier", "d2h_tier", "dma_supported",
          "zero_copy_engaged", "single_lane", "num_devices", "d2h_depth",
          "reg_active_after", "data")
# registration-cache counters that do not depend on timing when the window
# budget is not under pressure (the peak of pinned bytes depends on when
# the workers' windows overlap in time)
REG_EXACT = ("hits", "misses", "evictions", "pinned_bytes",
             "staged_fallbacks")


def assert_parity(j: Outcome, t: Outcome, fields=PARITY,
                  exact_cache: bool = True) -> None:
    for f in fields:
        assert getattr(t, f) == getattr(j, f), f
    assert t.d2h["deferred_count"] == j.d2h["deferred_count"]
    if exact_cache:
        for k in REG_EXACT:
            assert t.reg_cache[k] == j.reg_cache[k], k


# ---------------------------------------------------------------- read leg


def test_read_phase_stages_every_block(pkgs, tmp_path, monkeypatch):
    """Every storage block lands on the device byte-exactly: landed bytes
    and the additive checksum match the file, in both packages."""
    j, t, data = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                          tmp_path, ("r",), monkeypatch=monkeypatch,
                          seed_file=4 << 20)
    assert_parity(j, t)
    for o in (j, t):
        assert o.first_error == ""
        assert o.landed == 4 << 20
        assert o.checksum == sum(data) & U64
        assert o.to_hbm == 4 << 20


@pytest.mark.parametrize("env,args", [
    ({"EBT_MOCK_PJRT_DELAY_US": 2000}, ["-t", "1", "-s", "2M", "-b", "512k"]),
    ({"EBT_MOCK_PJRT_XFER_US": 200}, ["-t", "2", "-s", "4M", "-b", "1M"]),
    ({"EBT_MOCK_PJRT_DEVICES": 4},
     ["-t", "2", "-s", "4M", "-b", "1M", "--iodepth", "4"]),
], ids=["delayed_completion_barrier", "lane_stats_under_service_time",
        "multi_device_round_robin"])
def test_read_completion(pkgs, tmp_path, monkeypatch, env, args):
    """Asynchronous completion (pure delay, per-device service time, four
    devices): the pre-reuse barrier holds the engine back until every
    in-flight chunk completed — the checksum proves no buffer was reused
    mid-copy — and the lanes report real awaits."""
    j, t, data = run_both(pkgs, ["-r", *args], tmp_path, ("r",), env,
                          monkeypatch, seed_file=_size(args))
    assert_parity(j, t)
    for o in (j, t):
        assert o.first_error == ""
        assert o.checksum == sum(data) & U64
        assert sum(ln["awaits"] for ln in o.lanes) > 0


def _size(args: list[str]) -> int:
    s = args[args.index("-s") + 1]
    return int(s[:-1]) << {"M": 20, "k": 10}[s[-1]]


def test_transfer_failure_propagates(pkgs, tmp_path, monkeypatch):
    """A failed copy fails the worker with the driver's root cause behind
    the engine's generic message, never a silently dropped block."""
    outs = []
    for pkg in pkgs:
        path = tmp_path / pkg.name
        path.write_bytes(b"\xab" * (4 << 20))

        def fail_soon(p, mp):
            mp.setenv(p.seam("EBT_MOCK_PJRT_FAIL_AT"), str(p.h2d_calls() + 2))

        outs.append(run(pkg, ["-r", "-t", "2", "-s", "4M", "-b", "1M",
                              str(path)], ("r",), None, monkeypatch,
                        fail_soon))
        monkeypatch.delenv(pkg.seam("EBT_MOCK_PJRT_FAIL_AT"))
    for o in outs:
        assert o.first_error != ""
        assert "device copy failed" in o.worker_errors
        assert "mock transfer failure" in o.worker_errors
        assert "mock transfer failure" in o.native_error


def test_gpuids_select_devices_and_range_error(pkgs, tmp_path, monkeypatch):
    """--gpuids picks concrete devices; an id past the driver's device
    count is refused with the original's words."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DEVICES", 4)
    causes = []
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(b"\0" * (1 << 20))
        o = run(pkg, ["-r", "-s", "1M", "--gpuids", "2,3", str(f)], ("r",),
                monkeypatch=monkeypatch)
        assert o.num_devices == 2 and o.first_error == ""
        cfg = pkg.config_from_args(["-r", "-s", "1M", "--gpuids", "9",
                                    "--tpubackend", "pjrt", "--nolive",
                                    str(f)])
        with pytest.raises(pkg.ProgException) as e:
            pkg.Group(cfg).prepare()
        causes.append(str(e.value).split("): ", 1)[1])
    assert causes[0] == causes[1] == \
        "device id 9 out of range (4 addressable devices)"


def test_warmup_failure_fails_init(pkgs, tmp_path, monkeypatch):
    """A driver that cannot move the warm-up transfer fails init loudly."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_FAIL_AT", 1)
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(b"\0" * (1 << 20))
        cfg = pkg.config_from_args(["-r", "-s", "1M", "--tpubackend", "pjrt",
                                    "--nolive", str(f)])
        with pytest.raises(pkg.ProgException, match="warmup transfer failed"):
            pkg.Group(cfg).prepare()


# --------------------------------------------------------------- write leg


@pytest.mark.parametrize("args,env", [
    (["-t", "2", "-s", "4M", "-b", "1M"], {}),
    (["-t", "2", "-s", "4M", "-b", "1M", "--blockvarpct", "100"], {}),
    (["-t", "1", "-s", "4M", "-b", "1M"], {}),
    (["-t", "1", "-s", "6M", "-b", "3M"], {"EBT_TPU_CHUNK_BYTES": 2 << 20}),
], ids=["random_device_source", "block_variance", "no_variance",
        "rotating_sources_and_tail"])
def test_write_sources_identical_bytes(pkgs, tmp_path, monkeypatch, args,
                                       env):
    """The write phase serves each block from the device: both packages
    write IDENTICAL files (rank-seeded random device sources, rotating
    chunk variants, tail chunks from their own size class, and the
    block-variance round trip through device memory)."""
    j, t, _ = run_both(pkgs, ["-w", *args], tmp_path, ("w",), env,
                       monkeypatch)
    assert_parity(j, t)
    data = t.data
    assert t.first_error == "" and len(data) == _size(args)
    counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    assert counts.min() > 0 and counts.max() < len(data) / 64
    assert t.from_hbm == len(data)
    if "--blockvarpct" in args:
        blocks = [data[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20)]
        assert len(set(blocks)) == len(blocks) and t.to_hbm >= len(data)
    elif "-t" in args and args[args.index("-t") + 1] == "1" \
            and "-b" in args and args[args.index("-b") + 1] == "1M":
        blocks = [data[i:i + (1 << 20)] for i in range(0, len(data), 1 << 20)]
        assert len(set(blocks)) == 1 and t.to_hbm == 0
    elif "3M" in args:
        assert data[2 << 20:3 << 20] != data[:1 << 20]
        assert data[:3 << 20] == data[3 << 20:]


# ---------------------------------------------------------- on-device verify


@pytest.mark.parametrize("corrupt_off", [1 << 20, 1234567, (2 << 20) - 1, 8])
def test_on_device_verify_catches_corruption(pkgs, tmp_path, capfd,
                                             corrupt_off):
    """--verify through the native engines, on the CLI: a verified
    write+read passes, and a planted corrupt byte is reported at its exact
    offset with the same text and rc by both packages."""
    outs = []
    for pkg in pkgs:
        f = str(tmp_path / pkg.name)
        base = ["-t", "1", "-s", "2M", "-b", "1M", "--verify", "5",
                "--tpubackend", "pjrt", "--nolive", f]
        assert pkg.main(["-w", "-r", *base]) == 0
        with open(f, "r+b") as fh:
            fh.seek(corrupt_off)
            b = fh.read(1)
            fh.seek(corrupt_off)
            fh.write(bytes([b[0] ^ 0xFF]))
        capfd.readouterr()
        rc = pkg.main(["-r", *base])
        out = capfd.readouterr()
        errs = [ln for ln in (out.out + out.err).splitlines()
                if "verification failed" in ln]
        outs.append((rc, errs))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1
    assert f"on-device data verification failed at file offset " \
           f"{corrupt_off}" in outs[1][1][0]


def test_on_device_verify_in_process(pkgs, tmp_path, monkeypatch):
    """In-process: verify passes on intact data, and the native error names
    the exact corrupt byte; the verify kernel ran once per block."""
    native.reset_kernel_launches()
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(pattern(2 << 20, 5))
        args = ["-r", "-t", "1", "-s", "2M", "-b", "1M", "--verify", "5",
                str(f)]
        assert run(pkg, args, ("r",), monkeypatch=monkeypatch
                   ).first_error == ""
        if pkg.name == "torch":
            assert pkg.mock.ebt_mock_exec_count(0) == 2  # 2 blocks
            assert native.kernel_launches() == {"verify_u32": 2,
                                                "fill_u64": 0}
        with open(f, "r+b") as fh:
            fh.seek(1234567)
            fh.write(b"\xee")
        o = run(pkg, args, ("r",), monkeypatch=monkeypatch)
        assert o.first_error != ""
        assert "on-device data verification failed at file offset 1234567" \
            in o.native_error


def test_write_gen_produces_exact_pattern(pkgs, tmp_path, monkeypatch):
    """Verified writes source device-GENERATED data (B3): the file holds the
    byte-exact offset+salt pattern, no h2d traffic was paid, and the fill
    kernel ran once per block."""
    native.reset_kernel_launches()
    j, t, _ = run_both(pkgs, ["-w", "-t", "1", "-s", "2M", "-b", "1M",
                              "--verify", "11"], tmp_path, ("w",),
                       monkeypatch=monkeypatch)
    assert_parity(j, t)
    assert t.data == pattern(2 << 20, 11)
    assert t.to_hbm == 0 and t.from_hbm == 2 << 20
    assert pkgs[1].mock.ebt_mock_exec_count(0) == 2
    assert native.kernel_launches() == {"verify_u32": 0, "fill_u64": 2}


def test_verify_and_write_gen_follow_device_assignment(pkgs, tmp_path,
                                                       monkeypatch):
    """--gpuids 0,1 --verify: the fill and verify kernels run on the device
    each worker's blocks are assigned to, not pinned to device 0."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DEVICES", 2)
    for pkg in pkgs:
        f = tmp_path / pkg.name
        args = ["-t", "2", "-s", "4M", "-b", "1M", "--verify", "9",
                "--gpuids", "0,1", str(f)]
        o = run(pkg, ["-w", *args], ("w",), monkeypatch=monkeypatch)
        assert o.first_error == ""
        write_exec = [pkg.mock.ebt_mock_exec_count(d) for d in (0, 1)]
        assert all(c > 0 for c in write_exec), (pkg.name, write_exec)
        assert o.data == pattern(4 << 20, 9)
        o = run(pkg, ["-r", *args], ("r",), monkeypatch=monkeypatch)
        assert o.first_error == ""
        read_exec = [pkg.mock.ebt_mock_exec_count(d) for d in (0, 1)]
        assert all(c > 0 for c in read_exec), (pkg.name, read_exec)


# ---------------------------------------------------------------- latency


def test_per_device_transfer_latency_histograms(pkgs, tmp_path, monkeypatch):
    """Every selected device accumulates a phase-scoped enqueue->complete
    histogram; the mock's delay is visible in it."""
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DEVICES", 2)
    set_seam(monkeypatch, "EBT_MOCK_PJRT_DELAY_US", 1500)
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(os.urandom(4 << 20))
        cfg = pkg.config_from_args(
            ["-w", "-r", "-t", "2", "-s", "4M", "-b", "1M", "--gpuids",
             "0,1", "--tpubackend", "pjrt", "--nolive", str(f)])
        group = pkg.Group(cfg)
        group.prepare()
        try:
            for phase in (pkg.Phase.CREATEFILES, pkg.Phase.READFILES):
                group.start_phase(phase, "test")
                while not group.wait_done(1000):
                    pass
                assert group.first_error() == ""
                assert group.device_latency()
            histos = group.device_latency()
            assert sorted(histos) == ["0", "1"]
            for label, h in histos.items():
                assert h.count == 2, (pkg.name, label, h.count)
                assert h.percentile_us(50.0) >= 1000
            assert set(group.device_latency_clock().values()) == {"onready"}
        finally:
            group.teardown()


@pytest.mark.parametrize("hostfunc,clock", [(True, "onready"),
                                            (False, "await")])
def test_cli_prints_per_chip_latency(pkgs, tmp_path, capfd, monkeypatch,
                                     hostfunc, clock):
    """--lat/--lathisto print the per-chip rows with their clock, and the
    CSV carries the device-leg columns, field for field as the original;
    a driver without host functions gets clock=await."""
    if not hostfunc:
        set_seam(monkeypatch, "EBT_MOCK_PJRT_ONREADY_UNSUPPORTED", 1)
    rows = []
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(os.urandom(2 << 20))
        csvf = tmp_path / f"{pkg.name}.csv"
        capfd.readouterr()
        assert pkg.main(["-r", "-t", "1", "-s", "2M", "-b", "1M", "--lat",
                         "--lathisto", "--csvfile", str(csvf),
                         "--tpubackend", "pjrt", "--nolive", str(f)]) == 0
        out = capfd.readouterr().out
        assert "TPU 0 xfer lat us" in out and "p50=" in out
        assert f"clock={clock}" in out
        assert "TPU 0 xfer lat histogram" in out
        import csv

        row = list(csv.DictReader(open(csvf)))[0]
        assert int(row["tpu xfer lat p99 us"]) >= 0
        rows.append({k: v for k, v in row.items()
                     if k in ("operation", "entries last", "bytes last",
                              "TPU backend", "tpu xfer lat clock")})
    assert rows[0] == rows[1]
    assert rows[1]["tpu xfer lat clock"] == clock


def test_latency_fallback_without_host_functions(pkgs, tmp_path,
                                                 monkeypatch):
    """Without host functions the per-chip latency is sampled at the
    completion awaits (an upper bound), not silently absent."""
    j, t, _ = run_both(pkgs, ["-r", "-t", "1", "-s", "4M", "-b", "1M"],
                       tmp_path, ("r",),
                       {"EBT_MOCK_PJRT_ONREADY_UNSUPPORTED": 1,
                        "EBT_MOCK_PJRT_DELAY_US": 1500}, monkeypatch,
                       seed_file=4 << 20)
    for o in (j, t):
        assert o.first_error == ""
        assert o.latency["0"] >= 4 and o.clock == {"0": "await"}


def test_ready_event_failure_fails_transfer(pkgs, tmp_path, monkeypatch):
    """A completion that cannot be attached means arrival can never be
    confirmed: the transfer counts as FAILED at the barrier."""
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(os.urandom(8 << 20))

        def fail_ready(p, mp):
            mp.setenv(p.seam("EBT_MOCK_PJRT_FAIL_READY_AT"),
                      str(p.completion_calls() + 3))

        o = run(pkg, ["-r", "-t", "1", "-s", "8M", "-b", "1M", str(f)],
                ("r",), None, monkeypatch, fail_ready)
        monkeypatch.delenv(pkg.seam("EBT_MOCK_PJRT_FAIL_READY_AT"))
        assert o.first_error != ""
        assert "mock" in o.native_error and "fail" in o.native_error


# ------------------------------------------------- registered-buffer tier


@pytest.mark.parametrize("env", [
    {},
    {"EBT_TPU_NO_MMAP": 1},
    {"EBT_MOCK_PJRT_DELAY_US": 2000},
], ids=["mmap_window", "io_buffers", "delayed_completion"])
def test_zero_copy_tier(pkgs, tmp_path, monkeypatch, env):
    """Registration supported: reads copy from registered memory (mmap
    windows, or the I/O buffers registered at prepare), the same number of
    chunks in both packages, byte-exact even with delayed completion, and
    every registration is undone by teardown."""
    j, t, data = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                          tmp_path, ("r",), env, monkeypatch,
                          seed_file=4 << 20)
    assert_parity(j, t)
    assert t.dma_supported and t.zero_copy > 0 and t.tier == "zero_copy"
    assert t.checksum == sum(data) & U64
    assert t.reg_active_after == 0


@pytest.mark.parametrize("env,cause", [
    ({"EBT_MOCK_PJRT_NO_DMAMAP": 1}, None),
    ({"EBT_MOCK_PJRT_DMAMAP_FAIL": 1}, "(EBT_MOCK_CUDA_HOSTREG_FAIL)"),
    ({"EBT_PJRT_NO_DMAMAP": 1}, None),
], ids=["unsupported", "stubbed_registration", "kill_switch"])
def test_zero_copy_unavailable_runs_staged(pkgs, tmp_path, monkeypatch, env,
                                           cause):
    """Registration unsupported, failing at the init probe, or switched
    off: the phase runs staged byte-exact with no zero-copy copy, the
    cause (when there is one) in reg_error, never a transfer error."""
    j, t, data = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                          tmp_path, ("r",), env, monkeypatch,
                          seed_file=4 << 20)
    assert_parity(j, t)
    assert not t.dma_supported and t.zero_copy == 0 and t.tier == "staged"
    assert t.native_error == "" and t.checksum == sum(data) & U64
    if cause:
        assert cause in t.reg_error


def test_zero_copy_registration_size_limit(pkgs, tmp_path, monkeypatch):
    """Registrations above a size limit fail (as large pins do on real
    hosts) while smaller ones succeed: the windows that fit run zero-copy,
    the rest fall to the staged tier visibly, with equal counters."""
    j, t, data = run_both(pkgs, ["-r", "-t", "1", "-s", "24M", "-b", "6M"],
                          tmp_path, ("r",),
                          {"EBT_MOCK_PJRT_DMAMAP_MAX_BYTES": 12 << 20},
                          monkeypatch, seed_file=24 << 20)
    assert_parity(j, t)
    assert t.dma_supported and t.checksum == sum(data) & U64
    assert "HOSTREG_MAX_BYTES" in t.reg_error


def test_zero_copy_partial_registration_failure(pkgs, tmp_path, monkeypatch):
    """The init probe passes but one I/O buffer's registration fails: that
    buffer stays staged, the rest run zero-copy, byte-exact."""
    j, t, data = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                          tmp_path, ("r",),
                          {"EBT_MOCK_PJRT_DMAMAP_FAIL_AT": 2,
                           "EBT_TPU_NO_MMAP": 1}, monkeypatch,
                          seed_file=4 << 20)
    assert_parity(j, t)
    assert t.dma_supported and t.zero_copy > 0
    assert "EBT_MOCK_CUDA_HOSTREG_FAIL_AT" in t.reg_error
    assert t.checksum == sum(data) & U64 and t.reg_active_after == 0


@pytest.mark.parametrize("args,env", [
    (["-t", "1", "-s", "8M", "-b", "256K", "--regwindow", "2M"], {}),
    (["-t", "1", "-s", "24M", "-b", "6M"], {}),
    (["-t", "2", "-s", "4M", "-b", "1M"],
     {"EBT_MOCK_PJRT_DMAMAP_FAIL_AFTER": 1}),
], ids=["lru_eviction_smaller_than_file", "span_crossing_block",
        "registration_failure_visible_and_staged"])
def test_regwindow(pkgs, tmp_path, monkeypatch, args, env):
    """--regwindow LRU pin cache: span windows registered ahead of the
    cursor, evicted under budget, a block crossing the span grid covered
    by two adjacent windows, and a registration failure visible in the
    counters and the confirmed tier — every counter equal to the
    original's."""
    j, t, data = run_both(pkgs, ["-r", *args], tmp_path, ("r",), env,
                          monkeypatch, seed_file=_size(args))
    # under budget pressure, which window the LRU can evict depends on
    # which transfers are still in flight: the counters are checked per
    # package, as the original's own test checks them
    pressure = "--regwindow" in args
    assert_parity(j, t, PARITY if not pressure else
                  tuple(f for f in PARITY if f != "zero_copy"),
                  exact_cache=not pressure)
    for o in (j, t):
        st = o.reg_cache
        assert o.checksum == sum(data) & U64 and o.reg_active_after == 0
        if env:
            assert st["staged_fallbacks"] > 0 and o.tier == "staged"
            assert o.zero_copy == 0 and "FAIL_AFTER" in o.reg_error
        elif pressure:
            # pressure shows as evictions, or as staged fallbacks where
            # every candidate window still had a transfer in flight
            assert st["misses"] > 0 and st["hits"] > 0 and o.zero_copy > 0
            assert st["evictions"] + st["staged_fallbacks"] > 0
            assert st["pinned_peak_bytes"] <= 4 << 20
            assert o.tier == "zero_copy"
        else:
            assert st["staged_fallbacks"] == 0 and o.tier == "zero_copy"
            assert o.zero_copy == (24 << 20) // (2 << 20)


def test_window_eviction_releases_registration_and_uring_slot(
        pkgs, tmp_path, monkeypatch):
    """A --regwindow eviction unregisters the window AND releases its slot
    in the engine's shared io_uring registration authority, together; the
    exports behave as the original's step for step. An attached ring's
    table mirrors every claim and release, and the live slot count never
    holds the evicted window beside its successor (the steps of
    tests/test_uring.py::test_eviction_releases_dmamap_and_fixed_slot_together)."""
    import mmap

    # the rings run on the engine's syscall-shim emulation (EBT_MOCK_URING)
    monkeypatch.setenv("EBT_MOCK_URING", "1")
    win = 1 << 20
    steps = []
    for pkg in pkgs:
        f = tmp_path / pkg.name
        f.write_bytes(b"\0" * win)
        cfg = pkg.config_from_args(["-r", "-s", "1M", "--tpubackend", "pjrt",
                                    "--nolive", str(f)])
        group = pkg.Group(cfg)
        group.prepare()
        np_ = group._native_path
        lib = np_._lib
        reg_window = getattr(lib, f"ebt_{'pjrt' if pkg.name == 'jax' else 'cuda'}"
                                  "_register_window")
        stats = (jax_uring_stats if pkg.name == "jax" else
                 torch_uring_stats)

        def live_slots():
            out = (ctypes.c_uint64 * 3)()
            lib.ebt_uring_reg_state(out)
            return out[0]

        maps = [mmap.mmap(-1, win) for _ in range(2)]
        addrs = [ctypes.addressof(ctypes.c_char.from_buffer(m)) for m in maps]
        ring = lib.ebt_uring_ring_new()
        try:
            slots0, ring0 = live_slots(), lib.ebt_uring_ring_slots(ring)
            avoided0 = stats()["double_pin_avoided_bytes"]
            np_.set_reg_window(win)  # budget: exactly one window
            got = [reg_window(np_.ctx, addrs[0], win),
                   lib.ebt_uring_fixed_index(addrs[0], win) >= 0]
            mirror = [live_slots() - slots0,
                      lib.ebt_uring_ring_slots(ring) - ring0,
                      stats()["double_pin_avoided_bytes"] - avoided0]
            got += [reg_window(np_.ctx, addrs[1], win),
                    np_.reg_cache_stats()["evictions"],
                    lib.ebt_uring_fixed_index(addrs[0], win),
                    lib.ebt_uring_fixed_index(addrs[1], win) >= 0]
            # one live slot, not two, and the ring mirrors it
            mirror += [live_slots() - slots0,
                       lib.ebt_uring_ring_slots(ring) - ring0]
            got += [np_.deregister_buffer(addrs[1]),
                    lib.ebt_uring_fixed_index(addrs[1], win),
                    pkg.reg_active()]
            mirror += [live_slots() - slots0,
                       lib.ebt_uring_ring_slots(ring) - ring0]
            # a lifetime pin: registering it twice is idempotent, growing
            # it is refused with the cause in reg_error
            got += [np_.register_buffer(addrs[0], win),
                    np_.register_buffer(addrs[0], win),
                    np_.register_buffer(addrs[0], 2 * win),
                    np_.reg_error(), np_.deregister_buffer(addrs[0])]
        finally:
            lib.ebt_uring_ring_free(ring)
            group.teardown()
            del addrs
        steps.append(got + [ring >= 0] + mirror)
    assert steps[0] == steps[1]
    assert steps[1][:8] == [0, True, 0, 1, -1, True, True, -1]
    assert steps[1][-8:] == [True, 1, 1, win, 1, 1, 0, 0]


# ------------------------------------------------------------------- lanes


def test_lane_stats_fan_in_per_worker(pkgs, tmp_path, monkeypatch):
    """2 workers x 2 devices: each worker's traffic lands in its device's
    lane and the per-lane sums reconcile with the global byte totals."""
    j, t, _ = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M",
                              "--gpuids", "0,1"], tmp_path, ("r",),
                       {"EBT_MOCK_PJRT_DEVICES": 2}, monkeypatch,
                       seed_file=4 << 20)
    assert_parity(j, t)
    assert [ln["lane"] for ln in t.lanes] == [0, 1]
    assert sum(ln["to_hbm"] for ln in t.lanes) == t.to_hbm == 4 << 20
    for ln in t.lanes:
        assert ln["submits"] > 0 and ln["awaits"] > 0
        assert ln["to_hbm"] == 2 << 20


@pytest.mark.parametrize("value,single", [("1", True), ("0", False)])
def test_single_lane_ab_identical_bytes(pkgs, tmp_path, monkeypatch, value,
                                        single):
    """EBT_PJRT_SINGLE_LANE (value-parsed, "0" keeps the default) changes
    only the lock shape: the same bytes and lane accounting as the
    sharded run, in both packages."""
    j0, t0, data = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                            tmp_path, ("r",), monkeypatch=monkeypatch,
                            seed_file=4 << 20)
    j1, t1, _ = run_both(pkgs, ["-r", "-t", "2", "-s", "4M", "-b", "1M"],
                         tmp_path, ("r",), {"EBT_PJRT_SINGLE_LANE": value},
                         monkeypatch, seed_file=4 << 20)
    assert_parity(j1, t1)
    assert t1.single_lane is single and not t0.single_lane
    for a, b in ((j0, j1), (t0, t1)):
        assert a.checksum == b.checksum == sum(data) & U64
        assert a.lanes == b.lanes


# ------------------------------------------------------------ config, CLI


def test_cli_end_to_end(pkgs, tmp_path, capfd):
    """Full CLI write + read on the native backend: the same phase rows and
    CSV counts as the original."""
    import csv

    rows, labels = [], []
    for pkg in pkgs:
        csvf = tmp_path / f"{pkg.name}.csv"
        capfd.readouterr()
        assert pkg.main(["-w", "-r", "-t", "2", "-s", "4M", "-b", "1M",
                         "--lat", "--csvfile", str(csvf), "--tpubackend",
                         "pjrt", "--nolive", str(tmp_path / pkg.name)]) == 0
        out = capfd.readouterr().out
        labels.append([ln.split(":")[0].strip() for ln in out.splitlines()
                       if " : " in ln])
        rows.append([{k: r[k] for k in ("operation", "entries last",
                                        "bytes last", "threads",
                                        "TPU backend", "tpu xfer lat clock")}
                     for r in csv.DictReader(open(csvf))])
    assert rows[0] == rows[1] and labels[0] == labels[1]
    assert [r["operation"] for r in rows[1]] == ["WRITE", "READ"]


@pytest.mark.parametrize("args,env,flag", [
    # --chaos over serving rotation, with a spec that arms no seam
    (["--rotate", "3", "--chaos", "seed=1"], {}, "--chaos"),
    ([], {"EBT_PJRT_XFER_MGR": "1"}, "EBT_PJRT_XFER_MGR"),
    (["--retry", "2", "--chaos", "seed=1"], {}, "--chaos"),
])
def test_unported_pjrt_parts_refused(tmp_path, monkeypatch, args, env, flag):
    """The native engine's parts the port once refused by name (--chaos,
    the transfer-manager tier) get the original's outcome now: the same
    refusal of a --chaos spec that arms no seam (or of the scenario that
    comes first), and the tier accepted."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["-r", "-s", "1M", "--tpubackend", "pjrt", *args,
            str(tmp_path / "f")]
    outcomes = []
    for cfg, exc in ((jax_config, jax_exceptions),
                     (torch_config, torch_exceptions)):
        try:
            cfg.config_from_args(argv)
            outcomes.append("accepted")
        except exc.ProgException as e:
            outcomes.append(str(e))
    assert outcomes[1] == outcomes[0]
    if flag == "EBT_PJRT_XFER_MGR":
        assert outcomes[0] == "accepted"
    else:
        assert outcomes[0] in ("--chaos: no seams armed (empty spec)",
                               "--rotate re-restores a checkpoint and needs "
                               "--checkpoint MANIFEST (the generated "
                               "--checkpoint-shards mode owns the PATH "
                               "argument, which serving needs for its bench "
                               "files — write an explicit manifest instead)")


@pytest.mark.parametrize("args", [
    ["--regwindow", "8M", "--gpuids", "0"],
    ["--regwindow", "1M", "-b", "1M", "--tpubackend", "pjrt"],
    ["--gpuids", "0,1", "--tpubackend", "pjrt"],
])
def test_pjrt_flag_validation_matches_original(tmp_path, args):
    """--regwindow without pjrt or below two blocks is refused with the
    original's text; multi-device --gpuids on pjrt is accepted by both."""
    outcomes = []
    for parse, exc in ((jax_config.config_from_args,
                        jax_exceptions.ProgException),
                       (torch_config.config_from_args,
                        torch_exceptions.ProgException)):
        try:
            cfg = parse(["-r", "-s", "4M", *args, str(tmp_path / "f")])
            outcomes.append(("ok", cfg.tpu_ids))
        except exc as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[0] == outcomes[1]


def test_no_driver_on_cpu_refuses(tmp_path, monkeypatch):
    """EBT_TORCH_DEVICE=cpu without EBT_CUDA_DRIVER: the native path names
    what is missing; it never picks a stand-in by itself."""
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("EBT_CUDA_DRIVER", raising=False)
    with pytest.raises(torch_exceptions.ProgException,
                       match="needs EBT_CUDA_DRIVER"):
        native.resolve_driver()


def test_no_cuda_device_refuses(monkeypatch):
    """Without a card and without EBT_TORCH_DEVICE=cpu the native path
    raises the port's device error."""
    import torch

    monkeypatch.delenv("EBT_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(torch_exceptions.ProgException,
                       match="no CUDA device found"):
        native.resolve_driver()


def test_missing_driver_entry_named(tmp_path, monkeypatch):
    """A driver library lacking a required entry is refused with the
    PJRT loader's words and the entry's name."""
    lib = tmp_path / "libempty.so"
    src = tmp_path / "empty.c"
    src.write_text("int cuInit(unsigned f) { return 0; }\n")
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", str(lib))
    cfg = torch_config.config_from_args(
        ["-r", "-s", "1M", "--tpubackend", "pjrt", "--nolive",
         str(tmp_path / "f")])
    with pytest.raises(torch_exceptions.ProgException,
                       match="is missing required API function "
                             "cuGetErrorString"):
        native.NativeCudaPath(cfg)
