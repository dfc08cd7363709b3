"""ctypes binding to the native I/O engine (core/ -> libebtcore.so).

This is the Python-side twin of the reference's LocalWorker/WorkerManager
native layer: the hot I/O loops, latency capture and phase barrier all run in
C++ threads; Python drives phases and reads back stats. The device-copy hook
lets the PyTorch/CUDA layer inject the storage->device staging step per block
(reference analogue: the CUDA/cuFile function-pointer slots,
LocalWorker.h:31-44).

The port builds its own copy of the engine from core/src, together with its
native CUDA transfer engine (csrc/cuda_*.cpp, `--tpubackend pjrt`), into
build/torch_core/libebtcore.so on first use, with the Makefile's compiler
flags, and never loads the original package's library. The CPU tests' mock
CUDA driver (csrc/cuda_mock.cpp) is built beside it into
build/torch_core/libebtcudamock.so by build_mock().
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from dataclasses import dataclass, field

from .histogram import NUM_BUCKETS, LatencyHistogram
from .liveops import LiveOps

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_core")
_LIB_PATH = os.path.join(_BUILD_DIR, "libebtcore.so")
MOCK_DRIVER_PATH = os.path.join(_BUILD_DIR, "libebtcudamock.so")
# the Makefile's CORE_SRCS, CPPFLAGS, CXXFLAGS and LDFLAGS (make core), plus
# the port's CUDA engine, which must share the engine's singletons
_CORE_SRCS = tuple(f"core/src/{s}.cpp" for s in (
    "engine", "capi", "pjrt_path", "uring", "reactor", "numa")) + tuple(
    f"elbencho_tpu_torch/csrc/{s}.cpp" for s in (
        "cuda_api", "cuda_path", "cuda_capi"))
_MOCK_SRC = "elbencho_tpu_torch/csrc/cuda_mock.cpp"
_CPPFLAGS = ("-Icore/include", "-Icore/third_party")
_CXXFLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread")
_LDFLAGS = ("-shared", "-pthread", "-ldl")

# int fn(void* ctx, int rank, int device_idx, int direction,
#        void* buf, uint64 len, uint64 file_offset)
DEV_COPY_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_uint64, ctypes.c_uint64)

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _fresh(out: str) -> bool:
    """`out` exists and is newer than every native source it may contain."""
    if not os.path.exists(out):
        return False
    built = os.path.getmtime(out)
    for d in ("core/src", "core/include/ebt", "elbencho_tpu_torch/csrc"):
        d = os.path.join(_REPO_ROOT, d)
        if any(os.path.getmtime(os.path.join(d, f)) > built
               for f in os.listdir(d)):
            return False
    return True


def _build(out: str, srcs) -> None:
    """Compile `srcs` into the shared library `out`. A file lock serialises
    concurrent first uses (test workers, several processes); the library
    appears atomically, so a reader never loads a half-written file."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(out):
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        # nice: a low priority keeps the ~25 s compile from disturbing work
        # that runs beside a first use (other benchmark or test processes)
        cmd = ["nice", "-n", "10", os.environ.get("CXX", "g++"), *_CPPFLAGS,
               *_CXXFLAGS, *srcs, *_LDFLAGS, "-o", tmp]
        subprocess.run(cmd, cwd=_REPO_ROOT, check=True, capture_output=True)
        os.replace(tmp, out)


def build_mock() -> str:
    """The mock CUDA driver library (built on first use); returns its
    path."""
    if not _fresh(MOCK_DRIVER_PATH):
        _build(MOCK_DRIVER_PATH, [_MOCK_SRC])
    return MOCK_DRIVER_PATH


def load_lib() -> ctypes.CDLL:
    """Load (building if necessary) the native core library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _fresh(_LIB_PATH):
            _build(_LIB_PATH, _CORE_SRCS)
        lib = ctypes.CDLL(_LIB_PATH)
        # Every ebt_* symbol declares BOTH restype and argtypes: ctypes
        # defaults the restype to c_int, which silently truncates pointers
        # (and 64-bit counters) on LP64 — tools/lint_interfaces.py enforces
        # full coverage against the capi.cpp export list (`make lint`).
        lib.ebt_engine_new.argtypes = []
        lib.ebt_engine_new.restype = ctypes.c_void_p
        lib.ebt_engine_free.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_free.restype = None
        lib.ebt_engine_add_path.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ebt_engine_add_path.restype = ctypes.c_int
        lib.ebt_engine_add_cpu.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_engine_add_cpu.restype = ctypes.c_int
        lib.ebt_engine_add_ckpt_shard.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.ebt_engine_add_ckpt_shard.restype = ctypes.c_int
        lib.ebt_engine_add_reshard_unit.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_char_p]
        lib.ebt_engine_add_reshard_unit.restype = ctypes.c_int
        lib.ebt_engine_set_u64.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_uint64]
        lib.ebt_engine_set_u64.restype = ctypes.c_int
        lib.ebt_engine_set_d.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_double]
        lib.ebt_engine_set_d.restype = ctypes.c_int
        lib.ebt_engine_set_dev_callback.argtypes = [ctypes.c_void_p, DEV_COPY_FN,
                                                    ctypes.c_void_p]
        lib.ebt_engine_set_dev_callback.restype = ctypes.c_int
        lib.ebt_engine_prepare.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_prepare.restype = ctypes.c_int
        lib.ebt_engine_prepare_paths.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_prepare_paths.restype = ctypes.c_int
        lib.ebt_engine_start_phase.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_engine_start_phase.restype = ctypes.c_int
        lib.ebt_engine_wait_done.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_engine_wait_done.restype = ctypes.c_int
        lib.ebt_engine_interrupt.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_interrupt.restype = None
        lib.ebt_engine_time_limit_hit.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_time_limit_hit.restype = ctypes.c_int
        lib.ebt_engine_terminate.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_terminate.restype = None
        lib.ebt_engine_num_workers.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_num_workers.restype = ctypes.c_int
        lib.ebt_engine_live.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_live.restype = ctypes.c_int
        lib.ebt_engine_result.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_result.restype = ctypes.c_int
        lib.ebt_engine_histo.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_histo.restype = ctypes.c_int
        lib.ebt_engine_error.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_error.restype = ctypes.c_char_p
        lib.ebt_engine_worker_error.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_engine_worker_error.restype = ctypes.c_char_p
        lib.ebt_engine_phase_elapsed_us.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_phase_elapsed_us.restype = ctypes.c_uint64
        lib.ebt_engine_cpu_snapshots.argtypes = [ctypes.c_void_p,
                                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_cpu_snapshots.restype = None
        lib.ebt_histo_num_buckets.argtypes = []
        lib.ebt_histo_num_buckets.restype = ctypes.c_int
        lib.ebt_histo_bucket_index.argtypes = [ctypes.c_uint64]
        lib.ebt_histo_bucket_index.restype = ctypes.c_uint64
        lib.ebt_histo_bucket_lower_edge.argtypes = [ctypes.c_int]
        lib.ebt_histo_bucket_lower_edge.restype = ctypes.c_uint64
        lib.ebt_fill_verify_pattern.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                                ctypes.c_uint64, ctypes.c_uint64]
        lib.ebt_fill_verify_pattern.restype = None
        lib.ebt_check_verify_pattern.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                                 ctypes.c_uint64, ctypes.c_uint64]
        lib.ebt_check_verify_pattern.restype = ctypes.c_uint64
        lib.ebt_uring_supported.argtypes = []
        lib.ebt_uring_supported.restype = ctypes.c_int
        # io_uring backend + unified registration authority (ebt/uring.h)
        lib.ebt_uring_probe.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ebt_uring_probe.restype = ctypes.c_int
        lib.ebt_uring_stats.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_uring_stats.restype = None
        lib.ebt_uring_reg_state.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_uring_reg_state.restype = None
        lib.ebt_uring_fixed_index.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64]
        lib.ebt_uring_fixed_index.restype = ctypes.c_int
        lib.ebt_uring_op_hold.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ebt_uring_op_hold.restype = ctypes.c_int
        lib.ebt_uring_op_release.argtypes = [ctypes.c_void_p,
                                             ctypes.c_uint64]
        lib.ebt_uring_op_release.restype = ctypes.c_int
        lib.ebt_uring_op_end_idx.argtypes = [ctypes.c_int]
        lib.ebt_uring_op_end_idx.restype = None
        lib.ebt_uring_last_error.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ebt_uring_last_error.restype = None
        lib.ebt_uring_ring_new.argtypes = []
        lib.ebt_uring_ring_new.restype = ctypes.c_int
        lib.ebt_uring_ring_slots.argtypes = [ctypes.c_int]
        lib.ebt_uring_ring_slots.restype = ctypes.c_int
        lib.ebt_uring_ring_free.argtypes = [ctypes.c_int]
        lib.ebt_uring_ring_free.restype = None
        # open-loop load generation (--arrival/--rate/--tenants)
        lib.ebt_engine_add_tenant.argtypes = [ctypes.c_void_p,
                                              ctypes.c_double,
                                              ctypes.c_uint64, ctypes.c_int,
                                              ctypes.c_double]
        lib.ebt_engine_add_tenant.restype = ctypes.c_int
        # serving under live model rotation (--arrival trace/--rotate/
        # --bgbudget/--slotarget): the trace-schedule segments + sampler
        # seam, the engine-side rotation/throttle evidence, and the
        # current-scheduled-rate gauge
        lib.ebt_engine_add_trace_segment.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_double, ctypes.c_double]
        lib.ebt_engine_add_trace_segment.restype = ctypes.c_int
        lib.ebt_engine_sched_rate.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_engine_sched_rate.restype = ctypes.c_double
        lib.ebt_engine_serving_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_serving_stats.restype = None
        lib.ebt_engine_rotation_ttr_ns.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_engine_rotation_ttr_ns.restype = ctypes.c_int
        lib.ebt_trace_sample.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.ebt_trace_sample.restype = ctypes.c_int
        lib.ebt_engine_num_tenants.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_num_tenants.restype = ctypes.c_int
        lib.ebt_engine_worker_tenant.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        lib.ebt_engine_worker_tenant.restype = ctypes.c_int
        lib.ebt_engine_tenant_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_tenant_stats.restype = ctypes.c_int
        lib.ebt_engine_tenant_histo.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_tenant_histo.restype = ctypes.c_int
        lib.ebt_engine_arrival_mode.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_arrival_mode.restype = ctypes.c_int
        lib.ebt_engine_closed_loop_forced.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_closed_loop_forced.restype = ctypes.c_int
        lib.ebt_pacer_sample.argtypes = [ctypes.c_int, ctypes.c_double,
                                         ctypes.c_uint64,
                                         ctypes.POINTER(ctypes.c_uint64),
                                         ctypes.c_int]
        lib.ebt_pacer_sample.restype = None
        # DL-ingestion phase family (--ingest): the shuffle test seam +
        # the engine-side per-epoch wall times
        lib.ebt_shuffle_sample.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_shuffle_sample.restype = ctypes.c_int
        lib.ebt_engine_ingest_epoch_ns.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_engine_ingest_epoch_ns.restype = ctypes.c_int
        # fault tolerance (--retry/--maxerrors): engine-side retry/budget
        # counters, cause attribution, and the interrupt-flag plumbing
        lib.ebt_engine_fault_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_fault_stats.restype = None
        lib.ebt_engine_fault_causes.argtypes = [ctypes.c_void_p,
                                                ctypes.c_char_p,
                                                ctypes.c_int]
        lib.ebt_engine_fault_causes.restype = None
        lib.ebt_engine_interrupt_flag.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_interrupt_flag.restype = ctypes.c_void_p
        # completion reactor + NUMA placement (--numazones)
        lib.ebt_engine_reactor_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_reactor_stats.restype = None
        lib.ebt_engine_reactor_enabled.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_reactor_enabled.restype = ctypes.c_int
        lib.ebt_engine_reactor_cause.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_char_p,
                                                 ctypes.c_int]
        lib.ebt_engine_reactor_cause.restype = None
        lib.ebt_engine_numa_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_engine_numa_stats.restype = None
        lib.ebt_engine_add_numa_zone.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int]
        lib.ebt_engine_add_numa_zone.restype = ctypes.c_int
        lib.ebt_engine_io_engine.argtypes = [ctypes.c_void_p]
        lib.ebt_engine_io_engine.restype = ctypes.c_int
        lib.ebt_engine_io_engine_cause.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_char_p,
                                                   ctypes.c_int]
        lib.ebt_engine_io_engine_cause.restype = None
        lib.ebt_reg_span_bytes.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.ebt_reg_span_bytes.restype = ctypes.c_uint64
        lib.ebt_bind_zone.argtypes = [ctypes.c_int]
        lib.ebt_bind_zone.restype = ctypes.c_int
        lib.ebt_last_bind_error.argtypes = []
        lib.ebt_last_bind_error.restype = ctypes.c_char_p
        # native PJRT transfer path (core/src/pjrt_path.cpp)
        lib.ebt_pjrt_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.ebt_pjrt_create.restype = ctypes.c_void_p
        lib.ebt_pjrt_num_devices.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_num_devices.restype = ctypes.c_int
        lib.ebt_pjrt_copy_fn.argtypes = []
        lib.ebt_pjrt_copy_fn.restype = ctypes.c_void_p
        lib.ebt_pjrt_stats.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_stats.restype = None
        lib.ebt_pjrt_last_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_int]
        lib.ebt_pjrt_last_error.restype = None
        lib.ebt_pjrt_raw_last_error.argtypes = lib.ebt_pjrt_last_error.argtypes
        lib.ebt_pjrt_raw_last_error.restype = None
        lib.ebt_pjrt_drain.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_drain.restype = None
        lib.ebt_pjrt_raw_h2d.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint64, ctypes.c_int,
                                         ctypes.c_int]
        lib.ebt_pjrt_raw_h2d.restype = ctypes.c_double
        lib.ebt_pjrt_raw_d2h.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint64]
        lib.ebt_pjrt_raw_d2h.restype = ctypes.c_double
        # mesh-striped HBM fill (--stripe slice-wide striped tier)
        lib.ebt_pjrt_set_stripe_plan.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                                 ctypes.c_uint64,
                                                 ctypes.c_uint64]
        lib.ebt_pjrt_set_stripe_plan.restype = ctypes.c_int
        lib.ebt_pjrt_stripe_device_for.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_uint64]
        lib.ebt_pjrt_stripe_device_for.restype = ctypes.c_int
        lib.ebt_pjrt_stripe_stats.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_stripe_stats.restype = None
        lib.ebt_pjrt_stripe_barrier.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_stripe_barrier.restype = ctypes.c_int
        lib.ebt_pjrt_stripe_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                              ctypes.c_int]
        lib.ebt_pjrt_stripe_error.restype = None
        # checkpoint-restore ledger (--checkpoint manifest workload)
        lib.ebt_pjrt_set_ckpt_plan.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int]
        lib.ebt_pjrt_set_ckpt_plan.restype = ctypes.c_int
        lib.ebt_pjrt_ckpt_stats.argtypes = [ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_ckpt_stats.restype = None
        lib.ebt_pjrt_ckpt_byte_totals.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_ckpt_byte_totals.restype = None
        lib.ebt_pjrt_ckpt_dev_bytes.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_pjrt_ckpt_dev_bytes.restype = ctypes.c_int
        lib.ebt_pjrt_ckpt_barrier.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_ckpt_barrier.restype = ctypes.c_int
        lib.ebt_pjrt_ckpt_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_int]
        lib.ebt_pjrt_ckpt_error.restype = None
        # serving rotation (--rotate): device-side ledger — lane-side bg
        # token bucket, live rotation gauges, per-rotation reconciliation
        lib.ebt_pjrt_set_bg_budget.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint64]
        lib.ebt_pjrt_set_bg_budget.restype = None
        lib.ebt_pjrt_rotation_state.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_rotation_state.restype = None
        lib.ebt_pjrt_rotation_count.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_rotation_count.restype = ctypes.c_int
        lib.ebt_pjrt_rotation_record.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_rotation_record.restype = ctypes.c_int
        # DL-ingestion ledger (--ingest record reconciliation)
        lib.ebt_pjrt_set_ingest_plan.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_uint64,
                                                 ctypes.c_int]
        lib.ebt_pjrt_set_ingest_plan.restype = ctypes.c_int
        lib.ebt_pjrt_ingest_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_ingest_stats.restype = None
        lib.ebt_pjrt_ingest_epoch_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_ingest_epoch_bytes.restype = ctypes.c_int
        lib.ebt_pjrt_ingest_epochs.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_ingest_epochs.restype = ctypes.c_int
        lib.ebt_pjrt_ingest_barrier.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_ingest_barrier.restype = ctypes.c_int
        lib.ebt_pjrt_ingest_error.argtypes = [ctypes.c_void_p,
                                              ctypes.c_char_p, ctypes.c_int]
        lib.ebt_pjrt_ingest_error.restype = None
        lib.ebt_pjrt_ingest_rearm.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_ingest_rearm.restype = None
        # N->M reshard plan + the D2D data-path tier (--reshard)
        lib.ebt_pjrt_set_reshard_plan.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_pjrt_set_reshard_plan.restype = ctypes.c_int
        lib.ebt_pjrt_reshard_preload.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_reshard_preload.restype = ctypes.c_int
        lib.ebt_pjrt_reshard_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_reshard_stats.restype = None
        lib.ebt_pjrt_reshard_byte_totals.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_reshard_byte_totals.restype = None
        lib.ebt_pjrt_reshard_pair_matrix.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int]
        lib.ebt_pjrt_reshard_pair_matrix.restype = ctypes.c_int
        lib.ebt_pjrt_reshard_barrier.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_reshard_barrier.restype = ctypes.c_int
        lib.ebt_pjrt_reshard_error.argtypes = [ctypes.c_void_p,
                                               ctypes.c_char_p, ctypes.c_int]
        lib.ebt_pjrt_reshard_error.restype = None
        lib.ebt_pjrt_d2d_supported.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_d2d_supported.restype = ctypes.c_int
        lib.ebt_pjrt_d2d_engaged.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_d2d_engaged.restype = ctypes.c_int
        lib.ebt_pjrt_raw_d2d.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_uint64]
        lib.ebt_pjrt_raw_d2d.restype = ctypes.c_double
        # fault tolerance: device ejection + live replanning
        lib.ebt_pjrt_set_fault_policy.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.ebt_pjrt_set_fault_policy.restype = None
        lib.ebt_pjrt_fault_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_fault_stats.restype = None
        lib.ebt_pjrt_ejected.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int]
        lib.ebt_pjrt_ejected.restype = None
        lib.ebt_pjrt_ejected_mask.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_ejected_mask.restype = ctypes.c_uint64
        lib.ebt_pjrt_eject_device.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_char_p]
        lib.ebt_pjrt_eject_device.restype = ctypes.c_int
        lib.ebt_pjrt_set_interrupt_flag.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_void_p]
        lib.ebt_pjrt_set_interrupt_flag.restype = None
        # deferred D2H fetch engine (--d2hdepth pipelined write path)
        lib.ebt_pjrt_set_d2h_depth.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ebt_pjrt_set_d2h_depth.restype = None
        lib.ebt_pjrt_d2h_stats.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_d2h_stats.restype = None
        # zero-copy / registered-buffer tier (DmaMap — the GDS analogue)
        lib.ebt_pjrt_dma_supported.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_dma_supported.restype = ctypes.c_int
        lib.ebt_pjrt_register.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_uint64]
        lib.ebt_pjrt_register.restype = ctypes.c_int
        lib.ebt_pjrt_deregister.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ebt_pjrt_deregister.restype = ctypes.c_int
        lib.ebt_pjrt_register_window.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.ebt_pjrt_register_window.restype = ctypes.c_int
        lib.ebt_pjrt_reg_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int]
        lib.ebt_pjrt_reg_error.restype = None
        lib.ebt_pjrt_zero_copy_count.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_zero_copy_count.restype = ctypes.c_uint64
        lib.ebt_pjrt_xfer_mgr_count.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_xfer_mgr_count.restype = ctypes.c_uint64
        # bounded registration windows (--regwindow LRU pin cache)
        lib.ebt_pjrt_set_reg_window.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint64]
        lib.ebt_pjrt_set_reg_window.restype = None
        lib.ebt_pjrt_reg_cache_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_reg_cache_stats.restype = None
        lib.ebt_pjrt_onready_clock.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_onready_clock.restype = ctypes.c_int
        # per-device transfer lanes (sharded-lock contention evidence)
        lib.ebt_pjrt_num_lanes.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_num_lanes.restype = ctypes.c_int
        lib.ebt_pjrt_lane_stats.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_lane_stats.restype = ctypes.c_int
        lib.ebt_pjrt_single_lane.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_single_lane.restype = ctypes.c_int
        lib.ebt_pjrt_xfer_mgr.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_xfer_mgr.restype = ctypes.c_int
        lib.ebt_pjrt_zero_copy_engaged.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_zero_copy_engaged.restype = ctypes.c_int
        lib.ebt_pjrt_dev_histo.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.ebt_pjrt_dev_histo.restype = ctypes.c_int
        lib.ebt_pjrt_reset_dev_histos.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_reset_dev_histos.restype = None
        lib.ebt_pjrt_enable_verify.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_int]
        lib.ebt_pjrt_enable_verify.restype = ctypes.c_int
        lib.ebt_pjrt_enable_write_gen.argtypes = \
            lib.ebt_pjrt_enable_verify.argtypes
        lib.ebt_pjrt_enable_write_gen.restype = ctypes.c_int
        lib.ebt_pjrt_destroy.argtypes = [ctypes.c_void_p]
        lib.ebt_pjrt_destroy.restype = None
        _declare_cuda(lib)
        _lib = lib
        return lib


def _declare_cuda(lib: ctypes.CDLL) -> None:
    """argtypes/restype of the native CUDA engine's ebt_cuda_* exports
    (csrc/cuda_capi.cpp)."""
    vp, u64, i32, s = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                       ctypes.c_char_p)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name, args, res in (
            ("create", [s, u64, u64, i32, ctypes.POINTER(ctypes.c_int), i32,
                        s, i32], vp),
            ("destroy", [vp], None),
            ("copy_fn", [], vp),
            ("num_devices", [vp], i32),
            ("drain", [vp], None),
            ("stats", [vp, u64p, u64p], None),
            ("last_error", [vp, s, i32], None),
            ("dma_supported", [vp], i32),
            ("zero_copy_engaged", [vp], i32),
            ("register", [vp, vp, u64], i32),
            ("deregister", [vp, vp], i32),
            ("register_window", [vp, vp, u64], i32),
            ("set_reg_window", [vp, u64], None),
            ("reg_cache_stats", [vp, u64p], None),
            ("reg_error", [vp, s, i32], None),
            ("zero_copy_count", [vp], u64),
            ("xfer_mgr", [vp], i32),
            ("xfer_mgr_count", [vp], u64),
            ("num_lanes", [vp], i32),
            ("lane_stats", [vp, i32, u64p], i32),
            ("single_lane", [vp], i32),
            ("dev_histo", [vp, i32, u64p, u64p], i32),
            ("reset_dev_histos", [vp], None),
            ("onready_clock", [vp], i32),
            ("set_d2h_depth", [vp, i32], None),
            ("d2h_stats", [vp, u64p], None),
            ("enable_verify", [vp, u64, s, s, i32], i32),
            ("enable_write_gen", [vp, u64, s, s, i32], i32),
            ("kernel_launches", [u64p], None),
            ("reset_kernel_launches", [], None),
            # the stripe tier and the checkpoint-restore ledger, with the
            # ebt_pjrt_* twins' signatures
            ("set_stripe_plan", [vp, i32, u64, u64], i32),
            ("stripe_device_for", [vp, u64], i32),
            ("stripe_stats", [vp, u64p], None),
            ("stripe_barrier", [vp], i32),
            ("stripe_error", [vp, s, i32], None),
            ("set_ckpt_plan", [vp, i32, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int), u64p, i32], i32),
            ("ckpt_stats", [vp, u64p], None),
            ("ckpt_byte_totals", [vp, u64p], None),
            ("ckpt_dev_bytes", [vp, u64p, i32], i32),
            ("ckpt_barrier", [vp], i32),
            ("ckpt_error", [vp, s, i32], None),
            # the device fault policy and the reshard ledger, with the
            # ebt_pjrt_* twins' signatures
            ("set_fault_policy", [vp, i32, i32, u64], None),
            ("fault_stats", [vp, u64p], None),
            ("ejected", [vp, s, i32], None),
            ("ejected_mask", [vp], u64),
            ("eject_device", [vp, i32, s], i32),
            ("set_interrupt_flag", [vp, vp], None),
            ("set_reshard_plan", [vp, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int), u64p, i32],
             i32),
            ("reshard_preload", [vp], i32),
            ("reshard_stats", [vp, u64p], None),
            ("reshard_byte_totals", [vp, u64p], None),
            ("reshard_pair_matrix", [vp, u64p, i32], i32),
            ("reshard_barrier", [vp], i32),
            ("reshard_error", [vp, s, i32], None),
            ("d2d_supported", [vp], i32),
            ("peer_access", [vp, ctypes.POINTER(ctypes.c_int)], None),
            # serving rotation and the ingest ledger, with the ebt_pjrt_*
            # twins' signatures, plus the rotation read-back
            ("set_bg_budget", [vp, u64], None),
            ("rotation_state", [vp, u64p], None),
            ("rotation_count", [vp], i32),
            ("rotation_record", [vp, i32, u64p], i32),
            ("rotation_read", [vp, ctypes.c_int64, i32, u64, u64, vp], i32),
            ("set_ingest_plan", [vp, u64, i32], i32),
            ("ingest_stats", [vp, u64p], None),
            ("ingest_epoch_bytes", [vp, ctypes.c_int64, u64p], i32),
            ("ingest_epochs", [vp], i32),
            ("ingest_barrier", [vp], i32),
            ("ingest_error", [vp, s, i32], None),
            ("ingest_rearm", [vp], None)):
        fn = getattr(lib, f"ebt_cuda_{name}")
        fn.argtypes = args
        fn.restype = res


def bind_zone_self(zone: int) -> int:
    """Bind the calling thread to NUMA zone/CPU `zone` using the exact engine
    binding path (affinity + preferred memory policy on NUMA hosts). Returns
    1 when a NUMA zone binding was applied, 0 on the raw-CPU-id fallback."""
    lib = load_lib()
    rc = lib.ebt_bind_zone(int(zone))
    if rc < 0:
        raise EngineError(lib.ebt_last_bind_error().decode())
    return rc


@dataclass
class WorkerLive:
    ops: LiveOps = field(default_factory=LiveOps)
    done: bool = False
    has_error: bool = False


@dataclass
class WorkerResult:
    elapsed_us: int = 0
    stonewall_us: int = 0
    have_stonewall: bool = False
    stonewall_ops: LiveOps = field(default_factory=LiveOps)


class EngineError(RuntimeError):
    pass


class NativeEngine:
    """One native engine instance = the N LocalWorker threads of this process."""

    def __init__(self) -> None:
        self._lib = load_lib()
        self._h = ctypes.c_void_p(self._lib.ebt_engine_new())
        self._cb_ref = None  # keep the CFUNCTYPE object alive
        self._terminated = False

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def close(self) -> None:
        if self._h:
            self._lib.ebt_engine_terminate(self._h)
            self._lib.ebt_engine_free(self._h)
            self._h = None

    # -- config ------------------------------------------------------------

    def add_path(self, path: str) -> None:
        self._lib.ebt_engine_add_path(self._h, path.encode())

    def add_cpu(self, cpu: int) -> None:
        self._lib.ebt_engine_add_cpu(self._h, int(cpu))

    def add_numa_zone(self, zone: int) -> None:
        """Append one --numazones worker -> NUMA node binding
        (local_rank % list length; NumaTk-backed, inert single-node
        fallback)."""
        self._lib.ebt_engine_add_numa_zone(self._h, int(zone))

    def add_ckpt_shard(self, path: str, nbytes: int,
                       devices: list[int]) -> None:
        """Append one --checkpoint manifest shard (restored to every listed
        device index; len > 1 = replicated placement)."""
        arr = (ctypes.c_int * len(devices))(*devices)
        rc = self._lib.ebt_engine_add_ckpt_shard(
            self._h, path.encode(), int(nbytes), arr, len(devices))
        if rc != 0:
            raise EngineError(f"bad checkpoint shard: {path}")

    def add_reshard_unit(self, action: int, src_dev: int, dst_dev: int,
                         nbytes: int, path: str) -> None:
        """Append one --reshard plan unit (action 0 = already resident,
        1 = D2D move src->dst, 2 = storage read from `path`); units
        partition over workers by index % num_dataset_threads, like
        checkpoint shards."""
        rc = self._lib.ebt_engine_add_reshard_unit(
            self._h, int(action), int(src_dev), int(dst_dev), int(nbytes),
            path.encode())
        if rc != 0:
            raise EngineError(
                f"bad reshard unit (action={action}, src={src_dev}, "
                f"dst={dst_dev}, bytes={nbytes})")

    def set(self, key: str, val: int | bool) -> None:
        rc = self._lib.ebt_engine_set_u64(self._h, key.encode(), int(val))
        if rc != 0:
            raise EngineError(f"unknown engine config key: {key}")

    def set_float(self, key: str, val: float) -> None:
        rc = self._lib.ebt_engine_set_d(self._h, key.encode(), float(val))
        if rc != 0:
            raise EngineError(f"unknown engine config key: {key}")

    def set_dev_callback(self, fn) -> None:
        """fn(rank, device_idx, direction, buf_ptr, length, file_offset) -> int.

        direction 0 = host buffer -> device (post read), 1 = device -> host.
        Called from native worker threads; ctypes re-acquires the GIL per call.
        """
        def trampoline(_ctx, rank, dev_idx, direction, buf, length, off):
            try:
                return int(fn(rank, dev_idx, direction, buf, length, off))
            except Exception:
                return 1

        self._cb_ref = DEV_COPY_FN(trampoline)
        self._lib.ebt_engine_set_dev_callback(self._h, self._cb_ref, None)

    def set_dev_callback_native(self, fn_ptr: int, ctx: int) -> None:
        """Install a native (C) DevCopyFn directly — no Python trampoline, no
        GIL on the hot path. fn_ptr/ctx come from the native PJRT transfer
        path (engine_stats.py)."""
        self._cb_ref = ctypes.cast(fn_ptr, DEV_COPY_FN)
        self._lib.ebt_engine_set_dev_callback(self._h, self._cb_ref,
                                              ctypes.c_void_p(ctx))

    # -- lifecycle ---------------------------------------------------------

    def prepare_paths(self) -> None:
        if self._lib.ebt_engine_prepare_paths(self._h) != 0:
            raise EngineError(self.error())

    def prepare(self) -> None:
        if self._lib.ebt_engine_prepare(self._h) != 0:
            raise EngineError(self.error())

    def start_phase(self, phase: int) -> None:
        self._lib.ebt_engine_start_phase(self._h, int(phase))

    def wait_done(self, timeout_ms: int) -> int:
        """0 = running, 1 = done ok, 2 = done with error."""
        return self._lib.ebt_engine_wait_done(self._h, timeout_ms)

    def interrupt(self) -> None:
        self._lib.ebt_engine_interrupt(self._h)

    def io_engine(self) -> str:
        """The resolved async-loop kernel backend ("aio"/"uring") —
        --ioengine auto-probes io_uring at engine construction and falls
        back to kernel AIO with the cause in io_engine_cause()."""
        return "uring" if self._lib.ebt_engine_io_engine(self._h) == 2 \
            else "aio"

    # -- open-loop load generation (--arrival/--rate/--tenants) ------------

    def add_tenant(self, rate: float, block_size: int,
                   rwmix_pct: int, slo_ms: float = 0.0) -> None:
        """Append one tenant traffic class (rate = arrivals/s per worker of
        the class; block_size 0 = the configured --block; rwmix_pct -1 =
        the global --rwmixpct; slo_ms 0 = the global --slotarget)."""
        self._lib.ebt_engine_add_tenant(self._h, float(rate),
                                        int(block_size), int(rwmix_pct),
                                        float(slo_ms))

    def add_trace_segment(self, cls: int, start_ns: int, kind: int,
                          rate0: float, rate1: float = 0.0) -> None:
        """Append one --ratetrace schedule segment (cls < 0 = the default
        schedule, cls >= 0 = a tenant class's override; kind 0 step /
        1 ramp / 2 burst)."""
        if self._lib.ebt_engine_add_trace_segment(
                self._h, int(cls), int(start_ns), int(kind), float(rate0),
                float(rate1)) != 0:
            raise EngineError(
                f"bad trace segment (cls={cls}, kind={kind})")

    def sched_rate(self, cls: int = 0) -> float:
        """The schedule's CURRENT offered rate for a tenant class
        (arrivals/s per worker): the trace's instantaneous rate at the
        phase-elapsed clock, or the static class/global rate."""
        return float(self._lib.ebt_engine_sched_rate(self._h, int(cls)))

    @property
    def num_tenants(self) -> int:
        return self._lib.ebt_engine_num_tenants(self._h)

    def worker_tenant(self, worker: int) -> int:
        """Class index of a worker rank (rank % num classes), -1 without
        tenant classes."""
        return self._lib.ebt_engine_worker_tenant(self._h, worker)

    def tenant_stats_raw(self, cls: int) -> list[int]:
        """[arrivals, completions, sched_lag_ns, backlog_peak, dropped,
        slo_ok] of one class (phase-scoped); the wire dict is built in
        engine_stats.py so the counter-coverage audit sees one key
        authority."""
        out = (ctypes.c_uint64 * 6)()
        if self._lib.ebt_engine_tenant_stats(self._h, cls, out) != 0:
            raise EngineError(f"bad tenant class {cls}")
        return list(out)

    # -- serving rotation (--rotate/--bgbudget) ----------------------------

    def serving_stats_raw(self) -> list[int]:
        """[rotations_started, rotations_complete, rotations_failed,
        ttr_last_ns, ttr_max_ns, ttr_total_ns, bg_throttle_ns,
        bg_read_bytes, bg_rate_bps, bg_adapt_downs, bg_adapt_ups] —
        phase-scoped; the wire dict is built in engine_stats.py so the
        counter-coverage audit sees one key authority."""
        out = (ctypes.c_uint64 * 11)()
        self._lib.ebt_engine_serving_stats(self._h, out)
        return list(out)

    def rotation_ttr_ns(self, max_rotations: int = 256) -> list[int]:
        """Per-rotation restore times in ns (completed rotations this
        phase, completion order)."""
        out = (ctypes.c_uint64 * max(1, max_rotations))()
        n = self._lib.ebt_engine_rotation_ttr_ns(self._h, out,
                                                 max_rotations)
        return [out[i] for i in range(min(n, max_rotations))]

    def tenant_histogram(self, cls: int) -> LatencyHistogram:
        """Merged iops latency histogram of one tenant class's workers —
        the per-class latency surface of the open-loop subsystem."""
        buckets = (ctypes.c_uint64 * NUM_BUCKETS)()
        meta = (ctypes.c_uint64 * 4)()
        if self._lib.ebt_engine_tenant_histo(self._h, cls, buckets,
                                             meta) != 0:
            raise EngineError(f"bad tenant class {cls}")
        return LatencyHistogram.from_raw(list(buckets), meta[0], meta[1],
                                         meta[2], meta[3])

    def arrival_mode(self) -> str:
        """The RESOLVED arrival mode ("closed"/"poisson"/"paced"/
        "trace") — "closed" when EBT_LOAD_CLOSED_LOOP=1 forced the A/B
        control."""
        return {0: "closed", 1: "poisson", 2: "paced",
                3: "trace"}[self._lib.ebt_engine_arrival_mode(self._h)]

    def closed_loop_forced(self) -> bool:
        return bool(self._lib.ebt_engine_closed_loop_forced(self._h))

    def io_engine_cause(self) -> str:
        """Why the backend resolution fell back to AIO (probe failure,
        EBT_URING_DISABLE=1); empty when no fallback happened."""
        buf = ctypes.create_string_buffer(512)
        self._lib.ebt_engine_io_engine_cause(self._h, buf, len(buf))
        return buf.value.decode()

    # -- fault tolerance (--retry/--maxerrors) -----------------------------

    def fault_stats_raw(self) -> list[int]:
        """[io_retry_attempts, io_retry_success, io_retry_backoff_ns,
        errors_tolerated] — phase-scoped; the wire dict is built in
        engine_stats.py so the counter-coverage audit sees one key
        authority."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.ebt_engine_fault_stats(self._h, out)
        return list(out)

    def fault_causes(self) -> str:
        """Per-cause attribution of budget-absorbed failures
        ("what xN; ..."); empty when nothing was tolerated."""
        buf = ctypes.create_string_buffer(2048)
        self._lib.ebt_engine_fault_causes(self._h, buf, len(buf))
        return buf.value.decode()

    # -- completion reactor + NUMA placement -------------------------------

    def reactor_stats_raw(self) -> list[int]:
        """[reactor_waits, reactor_wakeups_cq, reactor_wakeups_onready,
        reactor_wakeups_arrival, reactor_wakeups_timeout,
        reactor_wakeups_interrupt, spin_polls_avoided,
        reactor_wakeups_coalesced] — phase-scoped; the wire dict is built
        in engine_stats.py so the counter-coverage audit sees one key
        authority."""
        out = (ctypes.c_uint64 * 8)()
        self._lib.ebt_engine_reactor_stats(self._h, out)
        return list(out)

    def reactor_enabled(self) -> bool:
        """True when at least one worker runs an ACTIVE completion
        reactor (False before prepare, under EBT_REACTOR_DISABLE=1, or
        when every eventfd bridge arm failed)."""
        return bool(self._lib.ebt_engine_reactor_enabled(self._h))

    def reactor_cause(self) -> str:
        """First latched inactive cause (disable control, the
        EBT_MOCK_REACTOR_FAIL_AT injection, a real eventfd refusal);
        empty when the reactor is live."""
        buf = ctypes.create_string_buffer(512)
        self._lib.ebt_engine_reactor_cause(self._h, buf, len(buf))
        return buf.value.decode()

    def numa_stats_raw(self) -> list[int]:
        """[numa_nodes, numa_local_bytes, numa_remote_bytes,
        numa_bind_fallbacks] — session-cumulative (consumers record
        deltas); the wire dict is built in engine_stats.py."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.ebt_engine_numa_stats(self._h, out)
        return list(out)

    @property
    def interrupt_flag(self) -> int:
        """Address of the engine's interrupt flag, for
        NativePjrtPath.set_interrupt_flag (recovery backoff waits in the
        device layer wake promptly on interrupt)."""
        return self._lib.ebt_engine_interrupt_flag(self._h)

    def ingest_epoch_ns(self, max_epochs: int = 64) -> list[int]:
        """Per-epoch ingest wall times in ns (maxed over workers — the
        slowest rank defines the epoch, like a training step's
        all-reduce); empty outside the INGEST phase."""
        out = (ctypes.c_uint64 * max(1, max_epochs))()
        n = self._lib.ebt_engine_ingest_epoch_ns(self._h, out, max_epochs)
        return [out[i] for i in range(n)]

    def time_limit_hit(self) -> bool:
        """True when --timelimit ended the last phase: a clean stop with
        partial results, not an error (reference: ProgTimeLimitException
        keeps EXIT_SUCCESS, Coordinator.cpp:77-82)."""
        return bool(self._lib.ebt_engine_time_limit_hit(self._h))

    def terminate(self) -> None:
        self._lib.ebt_engine_terminate(self._h)

    # -- stats -------------------------------------------------------------

    @property
    def num_workers(self) -> int:
        return self._lib.ebt_engine_num_workers(self._h)

    def live(self, worker: int) -> WorkerLive:
        out = (ctypes.c_uint64 * 7)()
        if self._lib.ebt_engine_live(self._h, worker, out) != 0:
            raise EngineError(f"bad worker index {worker}")
        return WorkerLive(
            ops=LiveOps(entries=out[0], bytes=out[1], iops=out[2],
                        read_bytes=out[3], read_iops=out[4]),
            done=bool(out[5]), has_error=bool(out[6]))

    def result(self, worker: int) -> WorkerResult:
        out = (ctypes.c_uint64 * 8)()
        if self._lib.ebt_engine_result(self._h, worker, out) != 0:
            raise EngineError(f"bad worker index {worker}")
        return WorkerResult(
            elapsed_us=out[0], stonewall_us=out[1], have_stonewall=bool(out[2]),
            stonewall_ops=LiveOps(entries=out[3], bytes=out[4], iops=out[5],
                                  read_bytes=out[6], read_iops=out[7]))

    def histogram(self, worker: int, which: int) -> LatencyHistogram:
        """which: 0 = per-block (iops) latency, 1 = per-entry latency."""
        buckets = (ctypes.c_uint64 * NUM_BUCKETS)()
        meta = (ctypes.c_uint64 * 4)()
        if self._lib.ebt_engine_histo(self._h, worker, which, buckets, meta) != 0:
            raise EngineError(f"bad worker index {worker}")
        return LatencyHistogram.from_raw(list(buckets), meta[0], meta[1], meta[2],
                                         meta[3])

    def error(self) -> str:
        return (self._lib.ebt_engine_error(self._h) or b"").decode()

    def worker_error(self, worker: int) -> str:
        return (self._lib.ebt_engine_worker_error(self._h, worker) or b"").decode()

    def phase_elapsed_us(self) -> int:
        return self._lib.ebt_engine_phase_elapsed_us(self._h)

    def cpu_stonewall_pct(self) -> float:
        """CPU utilization between phase start and the stonewall moment,
        or -1 when no stonewall was taken."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.ebt_engine_cpu_snapshots(self._h, out)
        total = out[2] - out[0]
        idle = out[3] - out[1]
        if out[2] == 0 or total <= 0:
            return -1.0
        return max(0.0, min(100.0, 100.0 * (total - idle) / total))
