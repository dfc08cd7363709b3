"""The transfer-manager tier (EBT_PJRT_XFER_MGR) of the port's native CUDA
engine against the original package's, on the same inputs.

The original runs its PjrtPath::submitH2DXferMgr on the mock PJRT plugin
(one AsyncHostToDeviceTransferManager per block, chunks TransferData'd into
its buffer); the port runs CudaPath::submitH2DXferMgr on the mock CUDA
driver (one cuMemAllocAsync buffer per block, chunks copied into it). The
mocks' seams are mapped: EBT_MOCK_PJRT_NO_XFERMGR -> EBT_MOCK_CUDA_NO_XFERMGR
(no pool support), EBT_MOCK_PJRT_XFERMGR_FAIL -> EBT_MOCK_CUDA_XFERMGR_FAIL
(every allocation fails: the probe downgrades), EBT_MOCK_PJRT_XFER_FAIL_AT
-> EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT (the Nth copy into a block buffer,
the probe's counted as 1). Counters, tiers, latency sample counts, landed
checksums, rotation records and the live-buffer gauges compare exactly;
a downgrade cause differs only where it names the API that is missing.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.workers.local as torch_local
from elbencho_tpu_torch import engine as torch_engine
from elbencho_tpu_torch.cuda import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
U64 = (1 << 64) - 1
MB = 1 << 20

# the original's mock seam -> the port's
SEAMS = {
    "EBT_MOCK_PJRT_DEVICES": "EBT_MOCK_CUDA_DEVICES",
    "EBT_MOCK_PJRT_DELAY_US": "EBT_MOCK_CUDA_DELAY_US",
    "EBT_MOCK_PJRT_NO_XFERMGR": "EBT_MOCK_CUDA_NO_XFERMGR",
    "EBT_MOCK_PJRT_XFERMGR_FAIL": "EBT_MOCK_CUDA_XFERMGR_FAIL",
    "EBT_MOCK_PJRT_XFER_FAIL_AT": "EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT",
}


def _mock_lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("ebt_mock_total_bytes", "ebt_mock_checksum",
                 "ebt_mock_xfer_mgr_count"):
        getattr(lib, name).restype = ctypes.c_uint64
    lib.ebt_mock_live_buffers.restype = ctypes.c_int64
    return lib


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port) on their mocks, the tier requested in both."""
    if not os.path.exists(JAX_MOCK):
        subprocess.run(["make", "core"], cwd=REPO, check=True,
                       capture_output=True)
    torch_mock = torch_engine.build_mock()
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_mock)
    monkeypatch.setenv("EBT_PJRT_XFER_MGR", "1")
    made = tuple(
        SimpleNamespace(name=name, config_from_args=cfg.config_from_args,
                        Group=local.LocalWorkerGroup, Phase=common.BenchPhase,
                        mock=_mock_lib(lib), seam=seam)
        for name, cfg, local, common, lib, seam in (
            ("jax", jax_config, jax_local, jax_common, JAX_MOCK,
             lambda k: k),
            ("torch", torch_config, torch_local, torch_common, torch_mock,
             lambda k: SEAMS.get(k, k))))
    for p in made:
        p.mock.ebt_mock_reset()
    yield made
    for p in made:
        p.mock.ebt_mock_reset()


def run_phase(group, phase) -> None:
    group.start_phase(phase, "test")
    while not group.wait_done(1000):
        pass


def seeded(path, size: int, seed: int = 1234) -> bytes:
    data = np.random.default_rng(seed).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    path.write_bytes(data)
    return data


def run(pkg, tmp_path, monkeypatch, args: list[str], env=None,
        size: int = 4 * MB, phases: str = "r") -> SimpleNamespace:
    """One package's run of `args` over a seeded file of `size` bytes (0 =
    the write phase makes it); what the two packages are held to."""
    for k, v in (env or {}).items():
        monkeypatch.setenv(pkg.seam(k), str(v))
    f = tmp_path / pkg.name
    data = seeded(f, size) if size else b""
    pkg.mock.ebt_mock_reset()
    cfg = pkg.config_from_args(args + ["--tpubackend", "pjrt", "--nolive",
                                       str(f)])
    group = pkg.Group(cfg)
    group.prepare()
    out = SimpleNamespace(data=data)
    try:
        np_ = group._native_path
        out.active = np_.xfer_mgr_active
        out.reg_error = np_.reg_error()
        out.native_error = np_.last_error()
        out.zero_copy_engaged = np_.zero_copy_engaged
        out.caps_xfer_mgr = group.plugin_caps()["xfer_mgr"]
        for ph in phases:
            run_phase(group, {"w": pkg.Phase.CREATEFILES,
                              "r": pkg.Phase.READFILES}[ph])
        out.first_error = group.first_error()
        out.count = np_.xfer_mgr_count
        out.to_hbm = np_.transferred_bytes[0]
        out.tier = group.confirm_engaged_tier()
        out.latency = {k: h.count for k, h in group.device_latency().items()}
        out.checksum = pkg.mock.ebt_mock_checksum()
        out.mock_mgrs = pkg.mock.ebt_mock_xfer_mgr_count()
    finally:
        group.teardown()
    out.live_after = pkg.mock.ebt_mock_live_buffers()
    return out


def both(pkgs, tmp_path, monkeypatch, args, env=None, **kw):
    return [run(p, tmp_path, monkeypatch, args, env, **kw) for p in pkgs]


BASE = ["-r", "-t", "2", "-s", "4M", "-b", "1M"]


def test_xfer_mgr_tier_end_to_end(pkgs, tmp_path, monkeypatch):
    """One device buffer per block, chunks copied in at their offsets:
    every storage block lands byte-exact, the counter counts the hot path's
    four blocks (the probe's is reset), the tier is confirmed from it and
    the capability is reported, in both packages."""
    j, t = both(pkgs, tmp_path, monkeypatch, BASE,
                {"EBT_TPU_NO_MMAP": 1})
    for o in (j, t):
        assert o.active and o.caps_xfer_mgr
        assert o.reg_error == o.native_error == o.first_error == ""
        assert o.count == 4
        assert o.checksum == sum(o.data) & U64
        assert o.to_hbm == 4 * MB
        assert o.tier == "xfer_mgr"
        assert not o.zero_copy_engaged
        assert o.live_after == 0
    # the mocks count the probe's block beside the hot path's
    assert t.mock_mgrs == j.mock_mgrs == 5
    assert (t.count, t.tier, t.latency) == (j.count, j.tier, j.latency)


def test_xfer_mgr_delayed_completion_barrier(pkgs, tmp_path, monkeypatch):
    """Chunks landing late: the pre-reuse barrier awaits every chunk and
    the block's buffer before the engine reuses the host buffer (the
    checksum catches a premature reuse), and the buffers are freed after
    the copies into them."""
    j, t = both(pkgs, tmp_path, monkeypatch, BASE,
                {"EBT_MOCK_PJRT_DELAY_US": 2000})
    for o in (j, t):
        assert o.first_error == ""
        assert o.checksum == sum(o.data) & U64
        assert o.count == 4 and o.live_after == 0


def test_xfer_mgr_unsupported_falls_back(pkgs, tmp_path, monkeypatch):
    """Requested on a driver without the capability: the tier stays off
    with the cause recorded (each package names its own missing API), and
    the chunked path carries the phase byte-exact on the same tier."""
    j, t = both(pkgs, tmp_path, monkeypatch, BASE,
                {"EBT_MOCK_PJRT_NO_XFERMGR": 1})
    assert "AsyncHostToDeviceTransferManager" in j.reg_error
    assert "does not support memory pools" in t.reg_error
    for o in (j, t):
        assert not o.active and not o.caps_xfer_mgr
        assert o.reg_error.startswith("transfer-manager tier requested but ")
        assert o.first_error == ""
        assert o.checksum == sum(o.data) & U64
        assert o.count == 0 and o.mock_mgrs == 0
    assert t.tier == j.tier == "zero_copy"


def test_xfer_mgr_stubbed_probe_downgrades(pkgs, tmp_path, monkeypatch):
    """The entries are there but every allocation fails: the init probe
    downgrades the tier with its cause (a downgrade, not an error) and the
    phase runs on the chunked path with no error."""
    j, t = both(pkgs, tmp_path, monkeypatch, BASE,
                {"EBT_MOCK_PJRT_XFERMGR_FAIL": 1})
    assert "EBT_MOCK_PJRT_XFERMGR_FAIL" in j.reg_error
    assert "EBT_MOCK_CUDA_XFERMGR_FAIL" in t.reg_error
    for o in (j, t):
        assert not o.active
        assert o.reg_error.startswith("transfer-manager probe failed: ")
        assert o.native_error == ""
        assert o.first_error == ""
        assert o.checksum == sum(o.data) & U64
        assert o.count == 0 and o.live_after == 0
    assert t.tier == j.tier


def test_xfer_mgr_off_by_default(pkgs, tmp_path, monkeypatch):
    """Without the opt-in the tier never engages, even on a capable
    driver."""
    monkeypatch.delenv("EBT_PJRT_XFER_MGR")
    j, t = both(pkgs, tmp_path, monkeypatch, BASE)
    for o in (j, t):
        assert not o.active and o.reg_error == ""
        assert o.first_error == ""
        assert o.mock_mgrs == 0 and o.count == 0
    assert t.tier == j.tier == "zero_copy"


def test_xfer_mgr_never_latches_on_striped_configs(pkgs, tmp_path,
                                                   monkeypatch):
    """--tpustripe spreads a block's chunks over the devices, which one
    block buffer cannot hold: the tier must not latch, with the same cause
    in both packages."""
    j, t = both(pkgs, tmp_path, monkeypatch,
                BASE + ["--gpuids", "0,1", "--tpustripe"],
                {"EBT_MOCK_PJRT_DEVICES": 2})
    assert t.reg_error == j.reg_error == (
        "transfer-manager tier requested but --tpustripe keeps the chunked "
        "path")
    for o in (j, t):
        assert not o.active
        assert o.first_error == ""
        assert o.mock_mgrs == 0


@pytest.mark.parametrize("fail_at", [2, 3])
def test_xfer_mgr_midblock_failure_no_orphan(pkgs, tmp_path, monkeypatch,
                                             fail_at):
    """A copy into a block buffer fails at the call: copy 1 is the init
    probe's, 2 the first hot chunk (nothing of the block enqueued yet), 3
    the block's second chunk (one in flight). The block fails the worker,
    and the block buffer is freed after the chunk already copying: the
    live-buffer gauge reads 0 after teardown."""
    j, t = both(pkgs, tmp_path, monkeypatch,
                ["-r", "-t", "1", "-s", "4M", "-b", "4M"],
                {"EBT_TPU_NO_MMAP": 1, "EBT_MOCK_PJRT_XFER_FAIL_AT": fail_at})
    for o in (j, t):
        assert o.active
        assert o.first_error != ""
        assert o.count == 0
        assert o.live_after == 0
    assert "EBT_MOCK_CUDA_XFERMGR_COPY_FAIL_AT" in t.first_error
    assert t.to_hbm == j.to_hbm == (fail_at - 2) * 2 * MB


@pytest.mark.parametrize("tier", ["xfer_mgr", "chunked"])
def test_xfer_mgr_one_latency_sample_per_block(pkgs, tmp_path, monkeypatch,
                                               tier):
    """The tier clocks a block from its start to its buffer's arrival: one
    latency sample per block, not per chunk (here four 256 KiB chunks per
    1 MiB block, over two devices), in both packages; the chunked path
    keeps one per chunk."""
    if tier == "chunked":
        monkeypatch.delenv("EBT_PJRT_XFER_MGR")
    args = BASE + ["--gpuids", "0,1", "--lat"]
    env = {"EBT_MOCK_PJRT_DEVICES": 2, "EBT_TPU_CHUNK_BYTES": 256 << 10}
    j, t = both(pkgs, tmp_path, monkeypatch, args, env)
    per_dev = 2 if tier == "xfer_mgr" else 8
    for o in (j, t):
        assert o.first_error == ""
        assert o.latency == {"0": per_dev, "1": per_dev}
        assert o.count == (4 if tier == "xfer_mgr" else 0)
    assert t.latency == j.latency


def test_xfer_mgr_verify_takes_the_verified_path(pkgs, tmp_path,
                                                 monkeypatch):
    """--verify takes the verified path before the tier: the tier is
    active but no block rides it, and the port's engine launches the
    verify kernel once per block read."""
    native.reset_kernel_launches()
    j, t = both(pkgs, tmp_path, monkeypatch,
                ["-w", "-r", "-t", "2", "-s", "4M", "-b", "1M", "--verify",
                 "7"], size=0, phases="wr")
    for o in (j, t):
        assert o.active
        assert o.first_error == ""
        assert o.count == 0
    assert native.kernel_launches() == {"verify_u32": 4, "fill_u64": 4}


BLK = 64 << 10


def test_xfer_mgr_rotation_retains_one_buffer_per_block(pkgs, tmp_path,
                                                        monkeypatch):
    """A fault-free --rotate on the tier: each rotation's record is
    reconciled to the manifest and retains one buffer per block (four 16
    KiB chunks per 64 KiB block), as the original's retained manager
    buffers; the records' fixed fields equal the original's."""
    for k in ("EBT_MOCK_PJRT_DEVICES", "EBT_MOCK_CUDA_DEVICES"):
        monkeypatch.setenv(k, "4")
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))
    rng = np.random.default_rng(3)
    entries = []
    for i in range(4):
        p = tmp_path / f"model.shard.{i}"
        p.write_bytes(rng.integers(0, 256, 2 * BLK, dtype=np.uint8)
                      .tobytes())
        entries.append({"path": str(p), "bytes": 2 * BLK, "devices": [i]})
    man = tmp_path / "manifest.json"
    man.write_text(json.dumps({"version": 1, "shards": entries}))
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"segments": [{"at": 0, "kind": "step",
                                               "rate": 150}]}))
    recs = {}
    for pkg in pkgs:
        f = tmp_path / f"serve_{pkg.name}.bin"
        cfg = pkg.config_from_args(
            [str(f), "-w", "-r", "-t", "2", "-b", str(BLK), "-s",
             str(256 * BLK), "--tpubackend", "pjrt", "--nolive", "--arrival",
             "trace", "--ratetrace", str(trace), "--checkpoint", str(man),
             "--rotate", "0.25", "--timelimit", "2"])
        g = pkg.Group(cfg)
        g.prepare()
        try:
            assert g._native_path.xfer_mgr_active
            run_phase(g, pkg.Phase.CREATEFILES)
            run_phase(g, pkg.Phase.READFILES)
            assert g.first_error() == ""
            assert g._native_path.xfer_mgr_count > 0
            recs[pkg.name] = g.rotation_records()
        finally:
            g.teardown()
        assert pkg.mock.ebt_mock_live_buffers() == 0
    for rs in recs.values():
        assert rs
        for i, r in enumerate(rs):
            assert r["shards_resident"] == r["shards_total"] == 4
            assert r["bytes_submitted"] == r["bytes_resident"] == 8 * BLK
            assert r["retained_buffers"] == 8  # 4 shards x 2 blocks
            assert r["released_buffers"] == (0 if i == 0 else 8)
    fixed = ("shards_total", "shards_resident", "bytes_submitted",
             "bytes_resident", "retained_buffers")
    assert [{k: r[k] for k in fixed} for r in recs["torch"][:1]] == \
        [{k: r[k] for k in fixed} for r in recs["jax"][:1]]


def test_xfer_mgr_rotation_lands_in_the_generation(pkgs, tmp_path):
    """A tier block of a restoring generation lands at its file offset in
    the generation's memory and needs no block buffer: read back from
    device memory, the generation equals the shard files."""
    from elbencho_tpu_torch.cuda.native import NativeCudaPath

    rng = np.random.default_rng(5)
    entries = []
    for i in range(2):
        p = tmp_path / f"shard.{i}"
        p.write_bytes(rng.integers(0, 256, 3 * BLK, dtype=np.uint8)
                      .tobytes())
        entries.append({"path": str(p), "bytes": 3 * BLK, "devices": [0]})
    man = tmp_path / "man.json"
    man.write_text(json.dumps({"version": 1, "shards": entries}))
    torch_pkg = pkgs[1]
    cfg = torch_pkg.config_from_args(
        ["--checkpoint", str(man), "-b", str(BLK), "--tpubackend", "pjrt",
         "--nolive"])
    np_ = NativeCudaPath(cfg)
    np_.set_ckpt_plan(cfg.ckpt_shards)
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_uint64, ctypes.c_uint64)(np_.copy_fn_ptr)
    buf = ctypes.create_string_buffer(BLK)
    try:
        assert np_.xfer_mgr_active
        live0 = torch_pkg.mock.ebt_mock_live_buffers()
        assert fn(np_.ctx, 0, 0, 16, None, 1, 0) == 0
        for s, e in enumerate(entries):
            assert fn(np_.ctx, 0, 0, 9, None, s, 0) == 0
            data = open(e["path"], "rb").read()
            for off in range(0, 3 * BLK, BLK):
                fn(np_.ctx, 0, 0, 2, buf, 0, 0)
                ctypes.memmove(buf, data[off:off + BLK], BLK)
                assert fn(np_.ctx, 0, 0, 0, buf, BLK, off) == 0
        assert fn(np_.ctx, 0, 0, 2, buf, 0, 0) == 0
        assert fn(np_.ctx, 0, 0, 10, None, 0, 0) == 0
        assert fn(np_.ctx, 0, 0, 17, None, 0, 0) == 0
        assert np_.xfer_mgr_count == 6
        # one allocation per shard, no block buffer left behind
        assert torch_pkg.mock.ebt_mock_live_buffers() == live0 + 2
        for s, e in enumerate(entries):
            assert np_.rotation_read(s, 0, 3 * BLK) == \
                open(e["path"], "rb").read()
        (rec,) = np_.rotation_records()
        assert rec["retained_buffers"] == 6
    finally:
        np_.close()
    assert torch_pkg.mock.ebt_mock_live_buffers() == 0


@pytest.mark.parametrize("tiers", [
    ["zero_copy", "xfer_mgr"], ["xfer_mgr", "xfer_mgr"],
    ["staged", "xfer_mgr", "zero_copy"], ["xfer_mgr", None], [None]])
def test_pod_tier_ladder_matches_the_original(tiers):
    """A master reports the lowest tier any service rode (staged <
    xfer_mgr < zero_copy): a host on the transfer-manager tier lowers a
    zero-copy pod to xfer_mgr, as in the original."""
    import elbencho_tpu.workers.remote as jax_remote
    import elbencho_tpu_torch.workers.remote as torch_remote

    pod = SimpleNamespace(proxies=[SimpleNamespace(data_path_tier=t)
                                   for t in tiers])
    got = [m.RemoteWorkerGroup.data_path_tier(pod)
           for m in (jax_remote, torch_remote)]
    assert got[1] == got[0]
    if "staged" in tiers:
        assert got[1] == "staged"
    elif "xfer_mgr" in tiers:
        assert got[1] == "xfer_mgr"
