"""The in-session raw transport ceilings of the port's native CUDA engine
(CudaPath::rawH2DCeiling, rawD2HCeiling, rawD2DCeiling and the group's
native_raw_ceiling / native_raw_d2d_ceiling / probe_tier) and its standalone
copy probe (csrc/cuda_probe.cpp), against the original package's on the
same arguments.

The original runs on its mock PJRT plugin, the port on its mock CUDA
driver, two devices each. Rates are never compared: both packages are held
to the bytes that landed in the mocks, the tier rung a ceiling ran on, the
refusal causes, the session error left untouched and the framework counters
left unmoved. The mocks' seams are mapped where the two drivers differ
(DmaMap is cuMemHostRegister on the port).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.exceptions as jax_exceptions
import elbencho_tpu.tpu.native as jax_native
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.exceptions as torch_exceptions
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu_torch import engine as torch_engine
from elbencho_tpu_torch.cuda import native as torch_native
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
MB = 1 << 20

# the original's mock seam -> the port's
SEAMS = {
    "EBT_MOCK_PJRT_NO_DMAMAP": "EBT_MOCK_CUDA_NO_HOSTREG",
    "EBT_MOCK_PJRT_DMAMAP_FAIL_AFTER": "EBT_MOCK_CUDA_HOSTREG_FAIL_AFTER",
    "EBT_MOCK_PJRT_FAIL_READY_AT": "EBT_MOCK_CUDA_FAIL_READY_AT",
}


def _mock_lib(path: str, active: str, completions: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("ebt_mock_total_bytes", "ebt_mock_d2d_count", active,
                 completions):
        getattr(lib, name).restype = ctypes.c_uint64
    lib.ebt_mock_live_buffers.restype = ctypes.c_int64
    # registered ranges now, and completions attached so far (the *_AT
    # seams count from 1)
    lib.active = getattr(lib, active)
    lib.completions = getattr(lib, completions)
    return lib


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, two devices each."""
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "2")
    made = (
        SimpleNamespace(
            name="jax", config_from_args=jax_config.config_from_args,
            Group=jax_local.LocalWorkerGroup, Phase=jax_common.BenchPhase,
            Path=jax_native.NativePjrtPath,
            ProgException=jax_exceptions.ProgException, seam=lambda k: k,
            mock=_mock_lib(JAX_MOCK, "ebt_mock_dmamap_active",
                           "ebt_mock_ready_event_count")),
        SimpleNamespace(
            name="torch", config_from_args=torch_config.config_from_args,
            Group=torch_local.LocalWorkerGroup, Phase=torch_common.BenchPhase,
            Path=torch_native.NativeCudaPath,
            ProgException=torch_exceptions.ProgException,
            seam=lambda k: SEAMS.get(k, k),
            mock=_mock_lib(torch_mock, "ebt_mock_hostreg_active",
                           "ebt_mock_completion_count")),
    )
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def run_phase(group, phase) -> None:
    group.start_phase(phase, "test")
    while not group.wait_done(1000):
        pass


def make_group(pkg, tmp_path, extra=(), env=None, monkeypatch=None):
    """A prepared read group over a seeded 4 MiB file (the original test's
    make_group: -t 2 -s 4M -b 1M)."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(pkg.seam(k), str(v))
    f = tmp_path / f"{pkg.name}.data"
    f.write_bytes(np.random.default_rng(5).integers(
        0, 256, 4 * MB, dtype=np.uint8).tobytes())
    cfg = pkg.config_from_args(["-r", "-t", "2", "-s", "4M", "-b", "1M",
                                "--tpubackend", "pjrt", "--nolive",
                                *extra, str(f)])
    group = pkg.Group(cfg)
    group.prepare()
    return group


def framework_counters(group) -> dict:
    """What a ceiling must leave as it found it. The port's ceilings pin
    through the driver alone, so its registration cache stays too; the
    original's zero-copy ceiling pins through its cache (its pinned peak
    moves), so its cache is left out."""
    np_ = group._native_path
    out = {"bytes": np_.transferred_bytes,
           "lanes": group.lane_stats(),
           "zero_copy": np_.zero_copy_count,
           "latency": {k: h.count
                       for k, h in group.device_latency().items()}}
    if isinstance(np_, torch_native.NativeCudaPath):
        out["reg_cache"] = group.reg_cache_stats()
    return out


def test_raw_ceilings_move_bytes(pkgs, tmp_path):
    """The h2d and d2h ceilings return a positive rate, the h2d loop's
    bytes land in the mock, the d2h loop stages the same sources in both
    packages, and neither moves the path's own counters (ceilings are not
    framework traffic); the port's kernel launch counters stay too."""
    deltas = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"])
        try:
            torch_native.reset_kernel_launches()
            before = framework_counters(group)
            base = pkg.mock.ebt_mock_total_bytes()
            v = group.native_raw_ceiling(4 * MB, depth=4, chunk_bytes=MB)
            assert v > 0
            h2d = pkg.mock.ebt_mock_total_bytes() - base
            base = pkg.mock.ebt_mock_total_bytes()
            v = group.native_raw_ceiling(2 * MB, depth=2, direction="d2h",
                                         chunk_bytes=MB)
            assert v > 0
            deltas[pkg.name] = (h2d, pkg.mock.ebt_mock_total_bytes() - base)
            assert framework_counters(group) == before
            assert group._native_path.raw_last_error() == ""
            assert group._native_path.last_error() == ""
        finally:
            group.teardown()
    assert deltas["torch"] == deltas["jax"]
    assert deltas["torch"][0] == 4 * MB
    assert torch_native.kernel_launches() == {"verify_u32": 0,
                                              "fill_u64": 0}


def test_raw_ceiling_error_isolated_from_session_error(pkgs, tmp_path,
                                                       monkeypatch):
    """A failed ceiling leaves its cause in raw_last_error() and never in
    the session's first transfer error: a following READ phase passes with
    no stale cause. The seam fails the loop's first completion."""
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"])
        try:
            consumed = pkg.mock.completions()
            seam = pkg.seam("EBT_MOCK_PJRT_FAIL_READY_AT")
            monkeypatch.setenv(seam, str(consumed + 1))
            with pytest.raises(pkg.ProgException,
                               match="^raw ceiling transfer failed: .+"):
                group._native_path.raw_h2d_ceiling(2 * MB, depth=2,
                                                   chunk_bytes=MB)
            monkeypatch.delenv(seam)
            assert group._native_path.raw_last_error() != ""
            assert group._native_path.last_error() == ""
            run_phase(group, pkg.Phase.READFILES)
            assert group.first_error() == ""
        finally:
            group.teardown()


def test_raw_ceiling_zero_copy_ab(pkgs, tmp_path):
    """The zero-copy ceiling pins its sources before the clock and unpins
    them after it: the staged and the zero-copy ceiling land the same bytes
    in both packages, and the engine's own registrations are all that stay
    registered."""
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"])
        try:
            np_ = group._native_path
            base = pkg.mock.ebt_mock_total_bytes()
            active0 = pkg.mock.active()
            v_staged = np_.raw_h2d_ceiling(2 * MB, depth=2, chunk_bytes=MB)
            v_zc = np_.raw_h2d_ceiling(2 * MB, depth=2, chunk_bytes=MB,
                                       tier="zero_copy")
            assert v_staged > 0 and v_zc > 0
            assert pkg.mock.ebt_mock_total_bytes() - base == 4 * MB
            assert pkg.mock.active() == active0
        finally:
            group.teardown()


@pytest.mark.parametrize("env", [{"EBT_PJRT_NO_DMAMAP": 1},
                                 {"EBT_MOCK_PJRT_NO_DMAMAP": 1}],
                         ids=["kill-switch", "driver"])
def test_raw_ceiling_zero_copy_requires_registration(pkgs, tmp_path,
                                                     monkeypatch, env):
    """Without the registration tier (the kill switch, or a driver without
    it) the zero-copy ceiling refuses with the same cause in both packages,
    each naming its own registration call, and never measures the staged
    tier instead."""
    causes = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"], env,
                           monkeypatch)
        try:
            with pytest.raises(pkg.ProgException) as e:
                group._native_path.raw_h2d_ceiling(MB, depth=2,
                                                   chunk_bytes=MB,
                                                   tier="zero_copy")
            causes[pkg.name] = str(e.value)
        finally:
            group.teardown()
    assert "PJRT_Client_DmaMap" in causes["jax"]
    assert "cuMemHostRegister" in causes["torch"]
    for cause in causes.values():
        assert cause.startswith("raw ceiling transfer failed: zero-copy "
                                "ceiling requested but the ")
        assert cause.endswith("(or EBT_PJRT_NO_DMAMAP is set)")


# (id, env, read before the first ceiling, the confirmed tier, the rung)
PROBE_TIER_CASES = [
    # every registration after the init probe's fails: the zero-copy
    # rung's own pins fail and the ladder lands on staged, before and after
    # traffic confirmed staged
    ("descends-to-staged", {"EBT_MOCK_PJRT_DMAMAP_FAIL_AFTER": 1}, False,
     "staged", "staged"),
    # a clean driver: the read confirms zero copy and the ceiling rides it
    ("follows-zero-copy", {}, True, "zero_copy", "zero_copy"),
    # the transfer-manager tier engaged: the ceiling takes its topology
    # (one buffer per block) and every buffer is freed by the teardown
    ("xfer-mgr-topology", {"EBT_PJRT_XFER_MGR": 1, "EBT_TPU_NO_MMAP": 1},
     True, "xfer_mgr", "xfer_mgr"),
]


@pytest.mark.parametrize("case", PROBE_TIER_CASES,
                         ids=[c[0] for c in PROBE_TIER_CASES])
def test_probe_tier(pkgs, tmp_path, monkeypatch, case):
    """The h2d ceiling rides the engagement-confirmed tier (the capability
    prediction before any traffic), descends zero_copy -> xfer_mgr ->
    staged when a rung fails, and probe_tier() names the rung that gave the
    number: the same rung in both packages."""
    _, env, read_first, tier, rung = case
    got = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"], env,
                           monkeypatch)
        try:
            if read_first:
                run_phase(group, pkg.Phase.READFILES)
                assert group.first_error() == ""
            else:
                assert group.native_raw_ceiling(2 * MB, depth=2,
                                                chunk_bytes=MB) > 0
                assert group.probe_tier() == rung
                run_phase(group, pkg.Phase.READFILES)
            assert group.confirm_engaged_tier() == tier
            assert group.native_raw_ceiling(2 * MB, depth=2,
                                            chunk_bytes=MB) > 0
            got[pkg.name] = group.probe_tier()
        finally:
            group.teardown()
        assert pkg.mock.ebt_mock_live_buffers() == 0
    assert got["torch"] == got["jax"] == rung


def test_raw_ceiling_multi_stream(pkgs, tmp_path):
    """streams > 1 runs that many submitter pipelines and moves exactly the
    requested bytes, staged and zero copy; the zero-copy submitters unpin
    every source they pinned. A path on its own, with no engine."""
    for pkg in pkgs:
        f = tmp_path / f"{pkg.name}.f"
        f.write_bytes(b"\0" * MB)
        p = pkg.Path(pkg.config_from_args(
            ["-r", "-s", "1M", "--tpubackend", "pjrt", "--nolive", str(f)]))
        try:
            for tier in ("staged", "zero_copy"):
                base = pkg.mock.ebt_mock_total_bytes()
                v = p.raw_h2d_ceiling(8 * MB, depth=4, chunk_bytes=MB,
                                      streams=4, tier=tier)
                assert v > 0
                assert pkg.mock.ebt_mock_total_bytes() - base == 8 * MB
            assert pkg.mock.active() == 0
        finally:
            p.close()


def test_raw_ceiling_multi_stream_refuses_xfer_mgr(pkgs, tmp_path,
                                                   monkeypatch):
    """The transfer-manager topology (one buffer per block) has no
    per-submitter form: streams > 1 on it is refused with the same cause in
    both packages, and the ladder skips it for a multi-stream ceiling."""
    monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    causes = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0"])
        try:
            np_ = group._native_path
            assert np_.xfer_mgr_active
            with pytest.raises(pkg.ProgException) as e:
                np_.raw_h2d_ceiling(8 * MB, depth=4, chunk_bytes=MB,
                                    streams=4, tier="xfer_mgr")
            causes[pkg.name] = str(e.value)
            assert group.native_raw_ceiling(8 * MB, depth=4, chunk_bytes=MB,
                                            streams=4) > 0
            assert group.probe_tier() == "staged"
        finally:
            group.teardown()
    for cause in causes.values():
        assert cause.startswith("raw ceiling transfer failed: multi-stream "
                                "ceiling supports the staged and zero-copy "
                                "tiers only (the transfer-manager's one-")


def test_raw_d2d_ceiling_lands_bytes(pkgs, tmp_path):
    """The device-to-device ceiling stages depth + 1 chunk sources on the
    src lane and copies whole chunks onto dst: the same bytes land and the
    same number of device-to-device copies run in both mocks (3 MiB in 1
    MiB chunks at depth 2: 3 staged, 3 moved), with the session untouched
    and no chunk move engaged."""
    got = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0,1"])
        try:
            np_ = group._native_path
            before = framework_counters(group)
            base = pkg.mock.ebt_mock_total_bytes()
            d2d0 = pkg.mock.ebt_mock_d2d_count()
            v = group.native_raw_d2d_ceiling(3 * MB, depth=2, src_device=0,
                                             dst_device=1, chunk_bytes=MB)
            assert v > 0
            got[pkg.name] = (pkg.mock.ebt_mock_total_bytes() - base,
                             pkg.mock.ebt_mock_d2d_count() - d2d0)
            assert framework_counters(group) == before
            assert np_.raw_last_error() == np_.last_error() == ""
            assert not np_.d2d_engaged
        finally:
            group.teardown()
    assert got["torch"] == got["jax"] == (6 * MB, 3)


# (id, env, src, dst)
D2D_REFUSALS = [
    ("same-lane", {}, 0, 0),
    ("out-of-range", {}, 0, 2),
    ("negative", {}, -1, 1),
    ("bounce-control", {"EBT_D2D_DISABLE": 1}, 0, 1),
]


@pytest.mark.parametrize("case", D2D_REFUSALS,
                         ids=[c[0] for c in D2D_REFUSALS])
def test_raw_d2d_ceiling_refusals(pkgs, tmp_path, monkeypatch, case):
    """src and dst must be distinct lanes in range, and the bounce control
    (EBT_D2D_DISABLE=1) has no device-to-device copy to price: each is
    refused with the original's cause (each package naming its own copy
    call) and nothing is moved."""
    _, env, src, dst = case
    causes = {}
    for pkg in pkgs:
        group = make_group(pkg, tmp_path, ["--gpuids", "0,1"], env,
                           monkeypatch)
        try:
            base = pkg.mock.ebt_mock_total_bytes()
            with pytest.raises(pkg.ProgException) as e:
                group.native_raw_d2d_ceiling(MB, depth=2, src_device=src,
                                             dst_device=dst, chunk_bytes=MB)
            causes[pkg.name] = str(e.value)
            assert pkg.mock.ebt_mock_total_bytes() == base
            assert group._native_path.last_error() == ""
        finally:
            group.teardown()
    if env:
        assert "PJRT_Buffer_CopyToDevice" in causes["jax"]
        assert "cuMemcpyPeerAsync" in causes["torch"]
        pattern = (r"raw d2d ceiling transfer failed: raw d2d ceiling: "
                   r"native device-to-device copy unavailable \(\w+ lacks "
                   r"\w+ or EBT_D2D_DISABLE=1 forces the bounce control\)")
        for cause in causes.values():
            assert re.fullmatch(pattern, cause), cause
    else:
        assert causes["torch"] == causes["jax"] == (
            "raw d2d ceiling transfer failed: raw d2d ceiling: src/dst "
            "must be distinct in-range device indices")


def _original_probe_keys(tmp_path) -> dict[str, list[str]]:
    """The original probe's last-line keys per mode: run on its mock where
    its Makefile recipe builds into a scratch directory, else read from its
    printf formats."""
    src = os.path.join(REPO, "core", "tools", "pjrt_probe.cpp")
    exe = tmp_path / "pjrt_probe"
    build = subprocess.run(
        [os.environ.get("CXX", "g++"), "-Icore/include", "-Icore/third_party",
         "-O2", "-std=c++17", src, "-ldl", "-o", str(exe)],
        cwd=REPO, capture_output=True)
    keys = {}
    for mode in ("h2d", "d2h"):
        if build.returncode == 0:
            r = subprocess.run([str(exe), "8", "1", "4", "2", "4", "1", mode],
                               env=dict(os.environ, EBT_PJRT_PLUGIN=JAX_MOCK),
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr
            keys[mode] = list(json.loads(r.stdout.strip().splitlines()[-1]))
        else:
            text = open(src).read()
            fmt = re.findall(r'"\{(\\"native_' + mode + r'.*?)\}\\n"',
                             text, re.S)[0]
            keys[mode] = re.findall(r'\\"(\w+)\\"', fmt)
    return keys


def test_cuda_probe_matches_original_keys(pkgs, tmp_path):
    """cuda_probe is built from the repo's sources at first use into
    build/torch_core/ and runs on the mock driver in both modes, its last
    line carrying the original probe's JSON keys; a driver that cannot be
    loaded exits 1 with the cause and prints no result."""
    exe = torch_engine.build_probe()
    assert exe == os.path.join(REPO, "build", "torch_core", "cuda_probe")
    want = _original_probe_keys(tmp_path)
    for mode in ("h2d", "d2h"):
        r = subprocess.run([exe, "8", "1", "4", "2", "4", "1", mode],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert list(line) == want[mode]
        assert line[f"native_{mode}_mib_s"] > 0
        assert (line["chunk_mib"], line["depth"], line["nbufs"]) == (1, 4, 4)
    r = subprocess.run([exe, "8", "1"], capture_output=True, text=True,
                       env=dict(os.environ,
                                EBT_CUDA_DRIVER=str(tmp_path / "none.so")),
                       timeout=60)
    assert r.returncode == 1 and r.stdout == ""
    assert "none.so" in r.stderr
