"""The io_uring storage backend and the unified buffer registration
(--ioengine) of the original (tests/test_uring.py) held against the port.

Every ring runs through the engine's EBT_MOCK_URING=1 syscall-shim
emulation (core/src/uring.cpp), which both packages build from the same
source, so the backend's probe and fallback, the fixed-buffer submission
shape, SQPOLL wakeups and the registration authority shared with the
--regwindow cache are exercised alike. The original's registration cache
sits in its PjrtPath on the mock PJRT plugin (ebt_pjrt_register_window,
ebt_pjrt_deregister, NativePjrtPath), the port's in its CudaPath on the
mock CUDA driver (ebt_cuda_register_window, ebt_cuda_deregister,
NativeCudaPath, EBT_TORCH_DEVICE=cpu). uring_stats comes from each
package's own engine library (tpu/native.py; engine_stats.py in the
port), and is process-cumulative, so every case compares deltas.

Each case runs the same steps in both packages and compares every return
code, slot count, cache counter, resolved engine, cause and byte count.

Held by invariants, not by equality, in both packages:
- uring_register_ns (time inside io_uring_register) is positive;
- uring_sqpoll_wakeups grows: how many flushes find the emulated poller
  asleep follows when the two workers' completions arrive;
- with -t 2 the registration cache's hits and evictions follow the two
  workers' interleaving; no case here reads them at -t 2;
- the authority's error after a refused fixed-buffer update says it
  failed; the authority keeps the first error its process latched, so
  its wording follows what earlier tests in the same process did.

Cases of tests/test_uring.py held elsewhere:
- test_eviction_releases_dmamap_and_fixed_slot_together is held by
  tests/test_torch_native.py::test_window_eviction_releases_registration_and_uring_slot,
  which runs the original's steps (ring mirror and slot counts included)
  in both packages.
Every other case has a counterpart here under the same name. The one skip
is the original's: on a kernel with io_uring there is no fallback to
observe.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.config as jax_config
import elbencho_tpu.engine as jax_engine
import elbencho_tpu.histogram as jax_histogram
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.tpu.native as jax_native
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu.workers.remote as jax_remote
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.cuda.native as torch_native
import elbencho_tpu_torch.engine as torch_engine
import elbencho_tpu_torch.engine_stats as torch_engine_stats
import elbencho_tpu_torch.histogram as torch_histogram
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.local as torch_local
import elbencho_tpu_torch.workers.remote as torch_remote
from test_torch_engine import same
from test_torch_worker_state import worker_state  # noqa: F401

pytestmark = pytest.mark.uring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MOCK = os.path.join(REPO, "elbencho_tpu", "libebtpjrtmock.so")
WIN = 1 << 20  # unified-registration test window size


def _pkg(name, engine, common, config, local, stats, remote, histogram,
         uring_stats, path_cls, reg_prefix, seam):
    return SimpleNamespace(
        name=name, engine=engine, Phase=common.BenchPhase,
        config_from_args=config.config_from_args,
        Group=local.LocalWorkerGroup, Statistics=stats.Statistics,
        RemoteWorkerGroup=remote.RemoteWorkerGroup,
        LatencyHistogram=histogram.LatencyHistogram,
        uring_stats=uring_stats, Path=path_cls, reg_prefix=reg_prefix,
        seam=seam)


JAX = _pkg("jax", jax_engine, jax_common, jax_config, jax_local, jax_stats,
           jax_remote, jax_histogram, jax_native.uring_stats,
           jax_native.NativePjrtPath, "ebt_pjrt", "EBT_MOCK_PJRT_DEVICES")
TORCH = _pkg("torch", torch_engine, torch_common, torch_config, torch_local,
             torch_stats, torch_remote, torch_histogram,
             torch_engine_stats.uring_stats, torch_native.NativeCudaPath,
             "ebt_cuda", "EBT_MOCK_CUDA_DEVICES")


@pytest.fixture
def pkgs():
    return JAX, TORCH


@pytest.fixture
def mock_uring(monkeypatch):
    """Route every ring created during the test through the userspace
    emulation (per-ring routing: rings outlive the variable)."""
    monkeypatch.setenv("EBT_MOCK_URING", "1")
    for k in ("EBT_URING_DISABLE", "EBT_MOCK_URING_NO_UPDATE",
              "EBT_MOCK_URING_REGISTER_FAIL_AT"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def mock_devices(monkeypatch):
    """Each package's mock device driver: the original's PJRT plugin, the
    port's CUDA driver on the CPU."""
    monkeypatch.setenv("EBT_PJRT_PLUGIN", JAX_MOCK)
    monkeypatch.delenv("EBT_PJRT_OPTIONS", raising=False)
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("EBT_CUDA_DRIVER", torch_engine.build_mock())
    mocks = [ctypes.CDLL(JAX_MOCK), ctypes.CDLL(torch_engine.build_mock())]
    for m in mocks:
        m.ebt_mock_reset()
    yield
    for m in mocks:
        m.ebt_mock_reset()


def lib(pkg):
    return pkg.engine.load_lib()


def reg_state(pkg) -> tuple[int, int, int]:
    out = (ctypes.c_uint64 * 3)()
    lib(pkg).ebt_uring_reg_state(out)
    return out[0], out[1], out[2]  # live slots, rings, in-flight holds


def register(pkg, p, addr, length=WIN) -> int:
    return getattr(lib(pkg), f"{pkg.reg_prefix}_register_window")(
        ctypes.c_void_p(p.ctx), ctypes.c_void_p(addr), length)


def deregister(pkg, p, addr) -> int:
    return getattr(lib(pkg), f"{pkg.reg_prefix}_deregister")(
        ctypes.c_void_p(p.ctx), ctypes.c_void_p(addr))


def build_engine(pkg, path, io_engine=0, sqpoll=0, salt=0, iodepth=4):
    e = pkg.engine.NativeEngine()
    e.add_path(str(path))
    for k, v in (("path_type", 1), ("num_threads", 2),
                 ("block_size", 64 << 10), ("file_size", 1 << 20),
                 ("iodepth", iodepth), ("io_engine", io_engine),
                 ("uring_sqpoll", sqpoll), ("do_trunc_to_size", 1)):
        e.set(k, v)
    if salt:
        e.set("verify_enabled", 1)
        e.set("verify_salt", salt)
    e.prepare_paths()
    e.prepare()
    return e


def run_phase(pkg, e, phase: str) -> None:
    e.start_phase(int(getattr(pkg.Phase, phase)))
    while True:
        rc = e.wait_done(5000)
        if rc:
            break
    assert rc == 1, (pkg.name, e.error())


def checksum(path) -> int:
    with open(path, "rb") as f:
        return sum(f.read()) & ((1 << 64) - 1)


def delta(pkg, base: dict, key: str) -> int:
    return pkg.uring_stats()[key] - base[key]


class Window:
    """A page-aligned anonymous host range registered as a --regwindow
    cache entry."""

    def __init__(self, length: int = WIN):
        self.mem = mmap.mmap(-1, length)
        self.len = length
        self.addr = ctypes.addressof(ctypes.c_char.from_buffer(self.mem))


# ---------------------------------------------------------------- resolution


def test_probe_fallback_logs_cause_without_uring(pkgs, tmp_path,
                                                 monkeypatch):
    """--ioengine auto on a kernel without io_uring resolves to kernel AIO
    with the fallback's cause, never an error."""
    monkeypatch.delenv("EBT_MOCK_URING", raising=False)
    monkeypatch.delenv("EBT_URING_DISABLE", raising=False)
    if any(lib(p).ebt_uring_supported() for p in pkgs):
        pytest.skip("kernel supports io_uring: no fallback to observe")

    def sc(pkg, d):
        cause = ctypes.create_string_buffer(256)
        probe = lib(pkg).ebt_uring_probe(cause, len(cause))
        e = build_engine(pkg, d / "f", io_engine=0)
        try:
            got = (probe, cause.value, e.io_engine(), e.io_engine_cause())
            run_phase(pkg, e, "CREATEFILES")
            return got
        finally:
            e.terminate()
    probe, cause, engine, why = same(pkgs, tmp_path, sc)
    assert probe == 0 and b"io_uring" in cause
    assert engine == "aio" and "falling back to kernel AIO" in why


def test_mock_engine_resolves_uring_and_rides_fixed_ops(pkgs, tmp_path,
                                                        mock_uring):
    """Under the shim, auto resolves to uring and the block loops ride
    READ/WRITE_FIXED through slots the queue claimed in the unified table;
    teardown releases every slot."""
    def sc(pkg, d):
        base, slots0 = pkg.uring_stats(), reg_state(pkg)[0]
        e = build_engine(pkg, d / "f", salt=11)
        try:
            got = (e.io_engine(), e.io_engine_cause())
            run_phase(pkg, e, "CREATEFILES")
            run_phase(pkg, e, "READFILES")  # verify pattern checked
            hits = delta(pkg, base, "uring_fixed_hits")
        finally:
            e.terminate()
        e.close()
        return (*got, hits, reg_state(pkg)[0] - slots0,
                checksum(d / "f"))
    # 16 blocks written + 16 read, every one through a fixed slot; the
    # queue's slots released with the ring
    assert same(pkgs, tmp_path, sc)[:4] == ("uring", "", 32, 0)


def test_disable_env_forces_byte_identical_aio_shape(pkgs, tmp_path,
                                                     mock_uring,
                                                     monkeypatch):
    """EBT_URING_DISABLE=1 is the A/B control: the AIO shape with
    byte-identical traffic, and the forced fallback names its cause."""
    def sc(pkg, d):
        f1, f2 = d / "a", d / "b"
        monkeypatch.delenv("EBT_URING_DISABLE", raising=False)
        e = build_engine(pkg, f1, salt=23)
        try:
            run_phase(pkg, e, "CREATEFILES")
        finally:
            e.terminate()
        monkeypatch.setenv("EBT_URING_DISABLE", "1")
        e2 = build_engine(pkg, f2, salt=23)
        try:
            got = (e2.io_engine(), e2.io_engine_cause())
            run_phase(pkg, e2, "CREATEFILES")
            run_phase(pkg, e2, "READFILES")  # pattern verifies via aio
        finally:
            e2.terminate()
        return (*got, checksum(f1), checksum(f2))
    engine, cause, c1, c2 = same(pkgs, tmp_path, sc)
    assert engine == "aio" and "EBT_URING_DISABLE=1" in cause
    assert c1 == c2


def test_explicit_aio_has_no_fallback_cause(pkgs, tmp_path, mock_uring):
    def sc(pkg, d):
        e = build_engine(pkg, d / "f", io_engine=1)
        try:
            return e.io_engine(), e.io_engine_cause()
        finally:
            e.terminate()
    assert same(pkgs, tmp_path, sc) == ("aio", "")


def test_sqpoll_wakeups_counted(pkgs, tmp_path, mock_uring):
    """--uringsqpoll: the emulated poller is always asleep, so flushes take
    the NEED_WAKEUP enter — the counted SQPOLL event."""
    def sc(pkg, d):
        base = pkg.uring_stats()
        e = build_engine(pkg, d / "f", sqpoll=1)
        try:
            engine = e.io_engine()
            run_phase(pkg, e, "CREATEFILES")
            # the count follows the workers' timing: held by invariant
            assert delta(pkg, base, "uring_sqpoll_wakeups") > 0, pkg.name
            return engine, checksum(d / "f")
        finally:
            e.terminate()
    assert same(pkgs, tmp_path, sc)[0] == "uring"


# one package's engine in a fresh process: EBT_MOCK_AIO_SETUP_FAIL fires
# once per process and library, so run in this process it would take the
# refusal tests/test_uring.py's case counts on (and the reverse)
_AIO_RETRY_CHILD = r"""
import ctypes, json, sys
import importlib
name, path = sys.argv[1], sys.argv[2]
engine = importlib.import_module(name + ".engine")
common = importlib.import_module(name + ".common")
lib = engine.load_lib()

def retries():
    out = (ctypes.c_uint64 * 5)()
    lib.ebt_uring_stats(out)
    return out[4]

base = retries()
e = engine.NativeEngine()
e.add_path(path)
for k, v in (("path_type", 1), ("num_threads", 2), ("block_size", 64 << 10),
             ("file_size", 1 << 20), ("iodepth", 4), ("io_engine", 1),
             ("do_trunc_to_size", 1), ("verify_enabled", 1),
             ("verify_salt", 5)):
    e.set(k, v)
e.prepare_paths()
e.prepare()
e.start_phase(int(common.BenchPhase.CREATEFILES))
while not (rc := e.wait_done(5000)):
    pass
print(json.dumps([rc, e.io_engine(), e.error(), retries() - base,
                  sum(open(path, "rb").read())]))
e.close()
"""


def test_aio_setup_retry_counter_surfaces(pkgs, tmp_path, mock_uring,
                                          monkeypatch):
    """EBT_MOCK_AIO_SETUP_FAIL=1 forces one first-attempt io_setup refusal;
    the retry succeeds, is counted, and the phase completes (each package
    in a process of its own)."""
    monkeypatch.setenv("EBT_MOCK_AIO_SETUP_FAIL", "1")

    def sc(pkg, d):
        r = subprocess.run(
            [sys.executable, "-c", _AIO_RETRY_CHILD,
             {"jax": "elbencho_tpu", "torch": "elbencho_tpu_torch"}[pkg.name],
             str(d / "f")], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, (pkg.name, r.stderr[-2000:])
        return json.loads(r.stdout.strip().splitlines()[-1])
    # one refusal, retried once and counted
    assert same(pkgs, tmp_path, sc)[:4] == [1, "aio", "", 1]


# ------------------------------------------------- unified registration


@pytest.fixture
def native_paths(pkgs, mock_uring, mock_devices, tmp_path):
    """One registration-cache owner per package on a 1 MiB seed file:
    NativePjrtPath for the original, NativeCudaPath for the port."""
    f = tmp_path / "seed"
    f.write_bytes(b"\0" * (1 << 20))
    paths = {}
    for pkg in pkgs:
        cfg = pkg.config_from_args(["-r", "-s", "1M", "--tpubackend", "pjrt",
                                    "--nolive", str(f)])
        paths[pkg.name] = pkg.Path(cfg)
    yield paths
    for p in paths.values():
        p.close()


def test_inflight_sqe_blocks_eviction_like_inflight_dmamap(pkgs,
                                                           native_paths):
    """An in-flight fixed SQE holds its slot, and the eviction loop skips
    the held window like one with an in-flight transfer: the new window
    stays a staged fallback until the op completes."""
    steps = []
    for pkg in pkgs:
        p, lb = native_paths[pkg.name], lib(pkg)
        p.set_reg_window(WIN)
        w1, w2 = Window(), Window()
        got = [register(pkg, p, w1.addr)]
        held = lb.ebt_uring_op_hold(w1.addr, WIN)  # a simulated SQE
        got.append(held >= 0)
        try:
            st0 = p.reg_cache_stats()
            # over budget, but the only victim has an in-flight SQE
            got.append(register(pkg, p, w2.addr))
            st = p.reg_cache_stats()
            got += [st["evictions"], st0["evictions"],
                    st["staged_fallbacks"] - st0["staged_fallbacks"],
                    lb.ebt_uring_fixed_index(w1.addr, WIN) >= 0]
        finally:
            got.append(lb.ebt_uring_op_release(w1.addr, WIN) == held)
        # hold released -> the eviction proceeds and the pair swaps
        got += [register(pkg, p, w2.addr),
                p.reg_cache_stats()["evictions"],
                lb.ebt_uring_fixed_index(w1.addr, WIN),
                deregister(pkg, p, w2.addr)]
        steps.append(got)
    assert steps[1] == steps[0]
    assert steps[1] == [0, True, 1, 0, 0, 1, True, True, 0, 1, -1, 0]


def test_release_while_sqe_inflight_defers_ring_clear(pkgs, native_paths):
    """Releasing a slot whose fixed SQE is in flight does not zero the ring
    entry under the op: the slot turns dying, and the last completion
    clears it."""
    steps = []
    for pkg in pkgs:
        p, lb = native_paths[pkg.name], lib(pkg)
        ring = lb.ebt_uring_ring_new()
        got = [ring >= 0]
        try:
            ring0 = lb.ebt_uring_ring_slots(ring)
            w = Window()
            got.append(register(pkg, p, w.addr))
            held = lb.ebt_uring_op_hold(w.addr, WIN)  # in-flight SQE
            got.append(held >= 0)
            got += [deregister(pkg, p, w.addr),
                    lb.ebt_uring_fixed_index(w.addr, WIN),
                    lb.ebt_uring_ring_slots(ring) - ring0,
                    # a dying slot is invisible to a range release; the
                    # completion arrives by index, like the reap path
                    lb.ebt_uring_op_release(w.addr, WIN)]
            lb.ebt_uring_op_end_idx(held)
            got.append(lb.ebt_uring_ring_slots(ring) - ring0)
        finally:
            lb.ebt_uring_ring_free(ring)
        steps.append(got)
    assert steps[1] == steps[0]
    assert steps[1] == [True, 0, True, 0, -1, 1, -1, 0]


def test_register_fail_injection_leaves_dmamap_entry_clean(pkgs,
                                                           native_paths,
                                                           monkeypatch):
    """A refused fixed-buffer update is a clean best-effort fallback: the
    window stays registered, no slot is half claimed, and the cause is
    latched in the authority's error, not the registration error."""
    steps = []
    for pkg in pkgs:
        p, lb = native_paths[pkg.name], lib(pkg)
        ring = lb.ebt_uring_ring_new()
        got = [ring >= 0]
        try:
            slots0 = reg_state(pkg)[0]
            ring0 = lb.ebt_uring_ring_slots(ring)
            w, w2 = Window(), Window()
            # the first register call from now: the shim re-arms on a
            # changed value, so a value no other test sets (an unchanged
            # one, left by an earlier test in this process, would not fire)
            monkeypatch.setenv("EBT_MOCK_URING_REGISTER_FAIL_AT", "01")
            got.append(register(pkg, p, w.addr))
            got += [lb.ebt_uring_fixed_index(w.addr, WIN),
                    reg_state(pkg)[0] - slots0,
                    lb.ebt_uring_ring_slots(ring) - ring0]
            err = ctypes.create_string_buffer(256)
            lb.ebt_uring_last_error(err, len(err))
            got += [b"failed" in err.value, p.reg_error()]
            # the injection fired once: the next window claims normally
            got += [register(pkg, p, w2.addr),
                    lb.ebt_uring_fixed_index(w2.addr, WIN) >= 0,
                    deregister(pkg, p, w.addr), deregister(pkg, p, w2.addr)]
        finally:
            monkeypatch.delenv("EBT_MOCK_URING_REGISTER_FAIL_AT")
            lb.ebt_uring_ring_free(ring)
        steps.append(got)
    assert steps[1] == steps[0]
    assert steps[1][:7] == [True, 0, -1, 0, 0, True, ""]


def test_dense_reregister_fallback_without_update_support(pkgs,
                                                          native_paths,
                                                          monkeypatch):
    """Without IORING_REGISTER_BUFFERS_UPDATE the dense re-registration
    fallback keeps indices stable and the ring still mirrors claims and
    releases."""
    monkeypatch.setenv("EBT_MOCK_URING_NO_UPDATE", "1")
    steps = []
    for pkg in pkgs:
        p, lb = native_paths[pkg.name], lib(pkg)
        ring = lb.ebt_uring_ring_new()  # attach rides the dense path
        got = [ring >= 0]
        try:
            ring0 = lb.ebt_uring_ring_slots(ring)
            w = Window()
            got += [register(pkg, p, w.addr),
                    lb.ebt_uring_fixed_index(w.addr, WIN) >= 0,
                    lb.ebt_uring_ring_slots(ring) - ring0,
                    deregister(pkg, p, w.addr),
                    lb.ebt_uring_ring_slots(ring) - ring0]
        finally:
            lb.ebt_uring_ring_free(ring)
        steps.append(got)
    assert steps[1] == steps[0] == [True, 0, True, 1, 0, 0]


def test_fixed_index_resolves_chunk_subranges(pkgs, mock_uring,
                                              mock_devices, tmp_path):
    """Per-chunk scatter submits sub-ranges of one registered buffer: any
    chunk inside a claimed window resolves to the window's slot, and stops
    resolving once the window is released."""
    steps = []
    for pkg in pkgs:
        lb = lib(pkg)
        cfg = pkg.config_from_args(["-r", "-s", "4M", "-b", "1M",
                                    "--tpubackend", "pjrt", "--tpustripe",
                                    "--gpuids", "0", "--nolive",
                                    str(tmp_path / "x")])
        p = pkg.Path(cfg)
        try:
            buf = mmap.mmap(-1, 4 << 20)
            addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
            got = [register(pkg, p, addr, 4 << 20)]
            whole = lb.ebt_uring_fixed_index(ctypes.c_void_p(addr), 4 << 20)
            got.append(whole >= 0)
            # every 1 MiB chunk of the window resolves to the same slot
            got += [lb.ebt_uring_fixed_index(ctypes.c_void_p(addr + off),
                                             1 << 20) == whole
                    for off in range(0, 4 << 20, 1 << 20)]
            # a range crossing the window's end does not resolve
            got += [lb.ebt_uring_fixed_index(
                        ctypes.c_void_p(addr + (3 << 20)), 2 << 20),
                    deregister(pkg, p, addr),
                    lb.ebt_uring_fixed_index(ctypes.c_void_p(addr), 1 << 20)]
            del buf
        finally:
            p.close()
        steps.append(got)
    assert steps[1] == steps[0]
    assert steps[1] == [0, True, True, True, True, True, -1, 0, -1]


# ------------------------------------------------------------ engine runs


def _group_run(pkg, args, phases):
    """A worker group over `args`: io_engine, each phase's first error and
    per-lane to_hbm after it, the uring_stats deltas (from before
    prepare) and the wire tree of the last phase."""
    base = pkg.uring_stats()  # before prepare: pool claims land there
    cfg = pkg.config_from_args(args)
    group = pkg.Group(cfg)
    group.prepare()
    try:
        out = SimpleNamespace(io_engine=group.io_engine(), phases=[])
        for ph in phases:
            group.start_phase(getattr(pkg.Phase, ph), "uring-e2e")
            while not group.wait_done(1000):
                pass
            out.phases.append((group.first_error(),
                               [ln["to_hbm"] for ln in group.lane_stats()]))
        now = pkg.uring_stats()
        out.deltas = {k: now[k] - base[k] for k in now}
        out.wire = pkg.Statistics(cfg, group).bench_result_wire(
            getattr(pkg.Phase, phases[-1]), "uring-wire", [])
        return out
    finally:
        group.teardown()


def test_engine_pool_reuses_cache_claimed_slots(pkgs, mock_uring,
                                                mock_devices, tmp_path):
    """One pin serving both sides: with registration active the engine's
    I/O buffers are lifetime pins whose cache entries already claimed
    fixed-buffer slots, and the uring block loop rides those slots instead
    of registering the pool a second time."""
    def sc(pkg, d):
        f = d / "data"
        # the write phase runs the storage syscalls on the ring (pjrt read
        # phases ride the mmap ingest, which has no kernel I/O)
        o = _group_run(pkg, ["-w", "-t", "2", "-s", "4M", "-b", "256K",
                             "--iodepth", "4", "--tpubackend", "pjrt",
                             "--nolive", str(f)], ["CREATEFILES"])
        assert o.deltas["uring_register_ns"] > 0, pkg.name
        return (o.io_engine, o.phases[0][0], o.deltas["uring_fixed_hits"],
                o.deltas["double_pin_avoided_bytes"], f.stat().st_size)
    engine, err, hits, avoided, size = same(pkgs, tmp_path, sc)
    assert engine == "uring" and err == ""
    assert hits > 0 and avoided > 0 and size == 4 << 20


def test_tpustripe_scatter_rides_unified_pins(pkgs, mock_uring, mock_devices,
                                              tmp_path, monkeypatch):
    """The fixed-buffer table under --tpustripe's per-chunk scatter: the
    pool buffers stay one pin each, the uring loop's kernel I/O rides
    them, and every block's chunks fan out across both devices."""
    for pkg in pkgs:
        monkeypatch.setenv(pkg.seam, "2")
    monkeypatch.setenv("EBT_TPU_NO_MMAP", "1")  # buffered reads -> ring I/O

    def sc(pkg, d):
        # block 4M over 2M transfer chunks -> 2 chunks per block, scattered
        # (device_idx + chunk_i) % 2: every block touches both devices
        o = _group_run(pkg, ["-w", "-r", "-t", "1", "-s", "8M", "-b", "4M",
                             "--iodepth", "2", "--tpubackend", "pjrt",
                             "--gpuids", "0,1", "--tpustripe", "--nolive",
                             str(d / "data")], ["CREATEFILES", "READFILES"])
        (werr, lanes0), (rerr, lanes1) = o.phases
        return (o.io_engine, werr, rerr,
                [b - a for a, b in zip(lanes0, lanes1)],
                o.deltas["uring_fixed_hits"],
                o.deltas["double_pin_avoided_bytes"])
    engine, werr, rerr, deltas, hits, avoided = same(pkgs, tmp_path, sc)
    assert engine == "uring" and werr == rerr == ""
    assert hits > 0 and avoided > 0
    # the scatter fanned out: both lanes took h2d bytes during the read
    assert deltas == [4 << 20, 4 << 20]


def test_result_tree_carries_backend_fields(pkgs, mock_uring, mock_devices,
                                            tmp_path):
    def sc(pkg, d):
        o = _group_run(pkg, ["-w", "-t", "1", "-s", "2M", "-b", "1M",
                             "--iodepth", "4", "--tpubackend", "pjrt",
                             "--nolive", str(d / "data")], ["CREATEFILES"])
        # the wire's counters are process-cumulative: the run's own share
        # is the delta
        us = o.wire["UringStats"]
        assert us["uring_fixed_hits"] >= o.deltas["uring_fixed_hits"]
        return (o.wire["IoEngine"], o.wire["IoEngineCause"], sorted(us),
                o.deltas["uring_fixed_hits"])
    engine, cause, keys, hits = same(pkgs, tmp_path, sc)
    assert engine == "uring" and not cause
    assert keys == sorted({"uring_fixed_hits", "uring_register_ns",
                           "uring_sqpoll_wakeups",
                           "double_pin_avoided_bytes", "aio_setup_retries"})
    assert hits > 0


def test_pod_fanin_sums_counters_and_downgrades_engine(pkgs):
    """Pod fan-in: UringStats sum across hosts, IoEngine takes the lowest
    backend any host rode, and the first host-framed cause wins."""
    class P:
        def __init__(self, host, rank, engine, cause, stats):
            self.host = host
            self.host_index = rank
            self.io_engine = engine
            self.io_engine_cause = cause
            self.uring_stats = stats

    got = []
    for pkg in pkgs:
        g = pkg.RemoteWorkerGroup.__new__(pkg.RemoteWorkerGroup)
        g.proxies = [
            P("h0", 0, "uring", None, {"uring_fixed_hits": 5,
                                       "double_pin_avoided_bytes": 100}),
            P("h1", 1, "aio", "io_uring_setup failed: ENOSYS; falling back",
              {"uring_fixed_hits": 0, "double_pin_avoided_bytes": 0}),
        ]
        out = [g.io_engine(), g.io_engine_cause(), g.uring_stats()]
        g.proxies = [P("h0", 0, "uring", None, {"uring_fixed_hits": 2}),
                     P("h1", 1, "uring", None, {"uring_fixed_hits": 3})]
        got.append(out + [g.io_engine(), g.io_engine_cause(),
                          g.uring_stats()])
    assert got[1] == got[0]
    assert got[1] == [
        "aio", "service h1: io_uring_setup failed: ENOSYS; falling back",
        {"uring_fixed_hits": 5, "double_pin_avoided_bytes": 100},
        "uring", None, {"uring_fixed_hits": 5}]
