"""Local worker group: drives the native C++ I/O engine.

This is the scheduler-side twin of the reference's LocalWorker path
(WorkerManager::prepareThreads spawning LocalWorker threads,
WorkerManager.cpp:152-171): here the threads live inside the native engine
(core/src/engine.cpp) and this class feeds it config, attaches the GPU device
backend, and reads back live counters and results.

The port carries the staged/direct callback backend, the hostsim backend,
and the native pjrt path (`--tpubackend pjrt`: the C++ CUDA transfer engine
of csrc/cuda_path.cpp, installed as a C function pointer). The scenarios
the original builds on the native path (striping, checkpoint restore,
reshard, ingest, serving rotation, the device fault policy) are refused at
config validation, so the counter families only they produce stay at the
WorkerGroup defaults (None).
"""

from __future__ import annotations

import os

from ..common import BenchPathType, BenchPhase, DevBackend, RAND_ALGO_NAMES
from ..config import Config
from ..engine import NativeEngine
from ..engine_stats import (engine_fault_stats, engine_numa_stats,
                            engine_reactor_stats, tenant_stats, uring_stats)
from ..logger import LOGGER
from .base import WorkerGroup, WorkerPhaseResult, WorkerSnapshot


class LocalWorkerGroup(WorkerGroup):
    def __init__(self, cfg: Config, dev_callback=None) -> None:
        self.cfg = cfg
        self.engine: NativeEngine | None = None
        self._dev_callback = dev_callback
        self._native_path = None  # NativeCudaPath on --tpubackend pjrt
        self._mesh_reducer = None  # slice_stats' device reduction
        self._prepared = False
        self._reg_window = 0
        self._d2h_depth = 0
        # engagement-confirmed tiers and the phase's counter base
        self._engaged_tier: str | None = None
        self._engaged_d2h_tier: str | None = None
        self._tier_base: dict = {}

    # ------------------------------------------------------------- lifecycle

    def _build_engine(self) -> NativeEngine:
        cfg = self.cfg
        e = NativeEngine()
        for p in cfg.paths:
            e.add_path(p)
        e.set("path_type", int(cfg.path_type))
        e.set("num_threads", cfg.num_threads)
        e.set("num_dataset_threads", cfg.num_dataset_threads)
        e.set("rank_offset", cfg.rank_offset)
        e.set("block_size", cfg.block_size)
        e.set("file_size", cfg.file_size)
        e.set("iodepth", cfg.iodepth)
        # validated --ioengine name -> native enum (auto=0, aio=1, uring=2);
        # --iouring was already folded into io_engine by config validation
        e.set("io_engine", {"auto": 0, "aio": 1, "uring": 2}[cfg.io_engine])
        e.set("uring_sqpoll", cfg.uring_sqpoll)
        e.set("num_dirs", cfg.num_dirs)
        e.set("num_files", cfg.num_files)
        e.set("rand_amount", cfg.random_amount)
        e.set("use_direct_io", cfg.use_direct_io)
        e.set("random_offsets", cfg.use_random_offsets)
        e.set("rand_aligned", cfg.use_random_aligned)
        e.set("do_truncate", cfg.do_truncate)
        e.set("do_trunc_to_size", cfg.do_trunc_to_size)
        e.set("do_prealloc", cfg.do_prealloc)
        e.set("verify_enabled", 1 if cfg.verify_salt else 0)
        e.set("verify_salt", cfg.verify_salt)
        e.set("verify_direct", cfg.do_verify_direct)
        e.set("block_variance_pct", cfg.block_variance_pct)
        e.set("rand_algo", int(RAND_ALGO_NAMES[cfg.rand_offset_algo]))
        e.set("fill_algo", int(RAND_ALGO_NAMES[cfg.block_variance_algo]))
        e.set("rwmix_pct", cfg.rwmix_pct)
        # open-loop load generation (--arrival/--rate/--tenants): the
        # pacer + tenant-class subsystem lives in the engine's hot loops;
        # EBT_LOAD_CLOSED_LOOP=1 downgrades the resolved mode natively
        if cfg.arrival_mode:
            e.set("arrival_mode",
                  {"poisson": 1, "paced": 2,
                   "trace": 3}[cfg.arrival_mode])
            if cfg.arrival_rate:
                e.set_float("arrival_rate", float(cfg.arrival_rate))
            for t in cfg.tenant_classes:
                e.add_tenant(t.rate, t.block_size, t.rwmix_pct, t.slo_ms)
            if cfg.trace_schedule is not None:
                # --arrival trace: hand the validated piecewise schedule
                # to the native sampler — the default segment list plus
                # per-class overrides resolved by class INDEX (the
                # engine's rank % K mapping)
                from ..serving import TRACE_KINDS

                names = [t.name for t in cfg.tenant_classes]
                for seg in cfg.trace_schedule.segments:
                    e.add_trace_segment(-1, int(seg.at_s * 1e9),
                                        TRACE_KINDS[seg.kind], seg.rate,
                                        seg.rate_end)
                for name, segs in cfg.trace_schedule.tenants.items():
                    cls = names.index(name)
                    for seg in segs:
                        e.add_trace_segment(cls, int(seg.at_s * 1e9),
                                            TRACE_KINDS[seg.kind],
                                            seg.rate, seg.rate_end)
        if cfg.slo_target_ms:
            e.set_float("slo_target_ms", float(cfg.slo_target_ms))
        # fault tolerance (--retry/--retrybackoff/--maxerrors): retries
        # with backoff in the block hot loops, plus the error budget that
        # lets a phase continue past exhausted retries. Both default to
        # the first-error abort (engine defaults are 0).
        if cfg.retry_max:
            e.set("retry_max", cfg.retry_max)
        e.set("retry_backoff_ms", cfg.retry_backoff_ms)
        if cfg.max_errors:
            e.set("max_errors", cfg.max_errors)
        if cfg.max_errors_pct:
            e.set("max_errors_pct", cfg.max_errors_pct)
        e.set("dirs_shared", cfg.do_dir_sharing)
        e.set("ignore_delete_errors", cfg.ignore_del_errors)
        zones = cfg.zones
        if not zones and not cfg.numa_zones and \
                cfg.tpu_backend != DevBackend.NONE:
            # default binding: if a local GPU PCI device advertises a NUMA
            # node, bind workers there so staging buffers sit on GPU-adjacent
            # memory (opt out with --zones)
            from ..cuda.devices import gpu_numa_node

            node = gpu_numa_node()
            if node >= 0:
                LOGGER.info(f"binding workers to GPU-local NUMA zone {node}")
                zones = [node]
        for cpu in zones:
            e.add_cpu(cpu)
        # --numazones (mutually exclusive with --zones at config time):
        # NumaTk worker->node binding with node-pinned buffer pools; inert
        # logged-once fallback on hosts without the named nodes (NumaStats
        # records where bytes landed)
        for node in cfg.numa_zones:
            e.add_numa_zone(node)
        if cfg.time_limit_secs:
            e.set_float("time_limit_secs", float(cfg.time_limit_secs))

        backend = cfg.tpu_backend
        e.set("dev_backend", int(backend))
        if cfg.tpu_backend_name == "pjrt":
            self._build_native(e)
        elif backend == DevBackend.CALLBACK:
            if cfg.verify_salt and not cfg.tpu_host_verify:
                # staged/direct backends check --verify patterns on device,
                # against the GPU copy (ops/verify_kernel.py); the engine
                # skips its host-side postReadCheck for staged blocks
                e.set("dev_verify", 1)
            if self._dev_callback is None:
                from ..cuda.backend import make_dev_callback
                self._dev_callback = make_dev_callback(cfg)
            e.set_dev_callback(self._dev_callback)
            e.set("num_devices", max(1, len(cfg.tpu_ids)))
            e.set("dev_write_path", 1)
            if cfg.tpu_backend_name == "direct":
                # zero-copy deferred backend: read phases hand page-cache
                # pages to the transfer via mmap (the GDS-direct analogue);
                # O_DIRECT runs keep the buffer path, and EBT_TPU_NO_MMAP=1
                # forces it for comparison
                e.set("dev_deferred", 1)
                if not os.environ.get("EBT_TPU_NO_MMAP"):
                    e.set("dev_mmap", 1)
        elif backend == DevBackend.HOSTSIM:
            e.set("num_devices", max(1, len(cfg.tpu_ids)))
            e.set("dev_write_path", 1)
        return e

    def _build_native(self, e: NativeEngine) -> None:
        """--tpubackend pjrt: the engine calls straight into the C++ CUDA
        transfer engine (csrc/cuda_path.cpp) — a C function pointer, never
        a Python trampoline."""
        from ..cuda.native import NativeCudaPath

        cfg = self.cfg
        if self._native_path is None:
            self._native_path = NativeCudaPath(cfg)
        np_ = self._native_path
        e.set_dev_callback_native(np_.copy_fn_ptr, np_.ctx)
        if cfg.verify_salt and not cfg.tpu_host_verify:
            # read blocks are checked by the verify kernel, launched from
            # C++ once per block, and verified writes source the pattern the
            # fill kernel generates on the device; a kernel that cannot be
            # built or loaded raises
            np_.enable_device_verify(cfg)
            e.set("dev_verify", 1)
            np_.enable_device_write_gen(cfg)
            e.set("dev_write_gen", 1)
        # --gpuids are resolved to driver devices inside the native path;
        # num_devices is the selected-device count
        e.set("num_devices", max(1, np_.num_devices))
        e.set("dev_write_path", 1)
        e.set("dev_deferred", 1)  # completion at the pre-reuse barrier
        if not os.environ.get("EBT_TPU_NO_MMAP"):
            e.set("dev_mmap", 1)
        # bounded registration windows (--regwindow): an LRU cache of
        # pinned spans registered ahead of the engine's I/O cursor
        regwin = cfg.effective_reg_window()
        np_.set_reg_window(regwin)
        e.set("reg_window", regwin)
        self._reg_window = regwin
        # deferred D2H fetch engine (--d2hdepth, default = iodepth). Both
        # sides get the SAME resolved depth: the native path decides
        # per-fetch deferral with it, the engine the hot-loop shape.
        d2h_depth = cfg.d2h_depth or max(1, cfg.iodepth)
        np_.set_d2h_depth(d2h_depth)
        e.set("d2h_depth", d2h_depth)
        self._d2h_depth = d2h_depth
        if np_.dma_supported:
            # registered-buffer tier: the engine registers its I/O buffers
            # at prepare and mmap windows per mapping (directions 4/5/6);
            # the capability was probed with one real registration
            LOGGER.info("native CUDA tier: zero-copy (registered (pinned) "
                        "host memory, cuMemHostRegister)")
            e.set("dev_register", 1)
        else:
            LOGGER.info(
                "native CUDA tier: staged (pageable copies, host-synchronous "
                "for their source; "
                + (np_.reg_error() or "registration unavailable") + ")")

    def prepare(self) -> None:
        if self._prepared:
            return
        self.engine = self._build_engine()
        if self.cfg.path_type != BenchPathType.DIR and (
                self.cfg.run_create_files or self.cfg.path_type ==
                BenchPathType.BLOCKDEV):
            self.engine.prepare_paths()
        self.engine.prepare()
        self._prepared = True

    def _staging_path(self):
        return getattr(self._dev_callback, "staging_path", None)

    def start_phase(self, phase: BenchPhase, bench_id: str) -> None:
        assert self.engine is not None
        # tier-engagement deltas are phase-scoped: confirm_engaged_tier()
        # sees only THIS phase's traffic
        self._tier_base = self.tier_counter_snapshot()
        # per-chip latency is phase-scoped like every other histogram
        source = self._native_path or self._staging_path()
        if source is not None:
            source.reset_device_latency()
        self.engine.start_phase(int(phase))

    def wait_done(self, timeout_ms: int) -> int:
        assert self.engine is not None
        return self.engine.wait_done(timeout_ms)

    def interrupt(self) -> None:
        if self.engine is not None:
            self.engine.interrupt()

    def teardown(self) -> None:
        # order matters: engine.close() joins the worker threads, whose
        # end-of-phase / error-path reuse barriers drain any deferred
        # transfers — that needs the staging path still alive. Only then is
        # it safe to close the staging path.
        if self.engine is not None:
            self.engine.close()
            self.engine = None
        staging = self._staging_path()
        if staging is not None:
            try:
                staging.close()
            except Exception:
                pass
        if self._native_path is not None:
            try:
                self._native_path.close()
            except Exception:
                pass
            self._native_path = None
        self._prepared = False
        self._engaged_tier = None  # a fresh session must re-confirm
        self._engaged_d2h_tier = None
        self._tier_base = {}

    # ----------------------------------------------------------------- stats

    def slice_stats(self) -> dict | None:
        """Reduce this slice's per-worker LiveOps across its devices — the
        device stats tier below the HTTP fan-in. Counters are grouped per
        device on the host (each device owns its assigned ranks, rank %
        num_devices like the engine); the totals come from the device
        reduction of parallel/mesh.py (MeshStatsReducer: one row per
        device, gathered with peer copies, summed by the B5 kernel). None
        below two devices, as in the original."""
        staging = self._staging_path()
        if staging is None or self.engine is None or len(staging.devices) < 2:
            return None
        import numpy as np

        ndev = len(staging.devices)
        per_dev = np.zeros((ndev, 5), dtype=np.uint64)
        for i in range(self.engine.num_workers):
            o = self.engine.live(i).ops
            d = (self.cfg.rank_offset + i) % ndev
            per_dev[d] += np.array([o.entries, o.bytes, o.iops, o.read_bytes,
                                    o.read_iops], dtype=np.uint64)
        if self._mesh_reducer is None:
            from ..parallel.mesh import MeshStatsReducer
            self._mesh_reducer = MeshStatsReducer(staging.devices)
        tot = self._mesh_reducer.reduce(per_dev)
        return {
            "Ops": {"entries": tot[0], "bytes": tot[1], "iops": tot[2],
                    "read_bytes": tot[3], "read_iops": tot[4]},
            "NumDevices": ndev,
            "Reduction": "psum",
        }

    def time_limit_hit(self) -> bool:
        return self.engine is not None and self.engine.time_limit_hit()

    def engine_fault_stats(self) -> dict[str, int] | None:
        """Engine-side retry/budget evidence (phase-scoped), or None
        before the engine exists."""
        if self.engine is None:
            return None
        return engine_fault_stats(self.engine)

    def reactor_stats(self) -> dict[str, int] | None:
        """Completion-reactor evidence (unified waits + per-cause wakeup
        counters, phase-scoped), or None before the engine exists."""
        if self.engine is None:
            return None
        return engine_reactor_stats(self.engine)

    def reactor_enabled(self) -> bool | None:
        """True when at least one worker runs an active reactor; None
        before the engine exists."""
        if self.engine is None:
            return None
        return self.engine.reactor_enabled()

    def reactor_cause(self) -> str | None:
        """First latched reactor-inactive cause, or None before the engine
        exists; empty string when live."""
        if self.engine is None:
            return None
        return self.engine.reactor_cause()

    def numa_stats(self) -> dict[str, int] | None:
        """NumaTk placement evidence (--numazones), or None before the
        engine exists."""
        if self.engine is None:
            return None
        return engine_numa_stats(self.engine)

    def fault_causes(self) -> str | None:
        """Per-cause attribution of budget-absorbed failures; None before
        the engine exists, empty string when nothing was tolerated."""
        if self.engine is None:
            return None
        return self.engine.fault_causes()

    def tenant_stats(self) -> list[dict[str, int]] | None:
        """Per-tenant-class open-loop accounting (phase-scoped), or None
        when no open-loop subsystem is active."""
        if self.engine is None or self.engine.num_tenants <= 0:
            return None
        return tenant_stats(self.engine)

    def tenant_latency(self) -> dict[str, "LatencyHistogram"]:
        """Per-tenant-class latency histograms (class label -> merged iops
        histogram of the class's workers). Empty without tenant classes."""
        if self.engine is None or self.engine.num_tenants <= 0:
            return {}
        names = [t.name for t in self.cfg.tenant_classes]
        out = {}
        for cls in range(self.engine.num_tenants):
            label = names[cls] if cls < len(names) else str(cls)
            out[label] = self.engine.tenant_histogram(cls)
        return out

    def sched_rate(self, cls: int = 0) -> float | None:
        """The current scheduled offered rate of a tenant class, or None
        without an engine."""
        if self.engine is None:
            return None
        return self.engine.sched_rate(cls)

    def arrival_mode(self) -> str | None:
        """The resolved arrival mode ("closed"/"poisson"/"paced"), or None
        before the engine exists."""
        if self.engine is None:
            return None
        return self.engine.arrival_mode()

    def uring_stats(self) -> dict[str, int] | None:
        """Unified-registration storage-backend evidence (see
        engine_stats.uring_stats); None only before the engine exists."""
        if self.engine is None:
            return None
        return uring_stats()

    def io_engine(self) -> str | None:
        """The resolved async-loop backend ("uring"/"aio") of this group's
        native engine."""
        if self.engine is None:
            return None
        return self.engine.io_engine()

    def io_engine_cause(self) -> str | None:
        """The logged AIO-fallback cause; empty when uring engaged or aio
        was pinned explicitly."""
        if self.engine is None:
            return None
        return self.engine.io_engine_cause()

    # ------------------------------------- empirical tier engagement
    #
    # The h2d tier (zero-copy -> staged) is CONFIRMED from counter deltas,
    # never from capability alone: a registration that passed the init
    # probe can still fail per buffer, silently dropping the leg to the
    # staged tier. The counters say which path the bytes actually took.

    def tier_counter_snapshot(self) -> dict[str, int]:
        """Cumulative tier counters (zero-copy chunks, h2d/d2h bytes,
        deferred d2h blocks) — diffed by confirm_engaged_tier()."""
        np_ = self._native_path
        if np_ is None:
            return {}
        to_hbm, from_hbm = np_.transferred_bytes
        return {"zero_copy": np_.zero_copy_count,
                "to_hbm": to_hbm,
                "from_hbm": from_hbm,
                "d2h_deferred": np_.d2h_stats()["deferred_count"]}

    def confirm_engaged_tier(self,
                             base: dict[str, int] | None = None) -> str | None:
        """Which h2d tier the traffic since `base` (default: the last
        start_phase) actually ran: "zero_copy" when copies from registered
        memory happened, else "staged". Returns the previous confirmation
        (or None) when the window moved no h2d bytes — a write phase must
        not un-confirm the read tier."""
        np_ = self._native_path
        if np_ is None:
            return None
        base = self._tier_base if base is None else base
        now = self.tier_counter_snapshot()
        if now["to_hbm"] - base.get("to_hbm", 0) <= 0:
            return self._engaged_tier
        tier = ("zero_copy"
                if now["zero_copy"] - base.get("zero_copy", 0) > 0
                else "staged")
        if tier != self._engaged_tier and self._engaged_tier is not None:
            LOGGER.info(f"native CUDA tier engagement changed: "
                        f"{self._engaged_tier} -> {tier}"
                        + (f" ({np_.reg_error()})" if np_.reg_error()
                           else ""))
        self._engaged_tier = tier
        return tier

    def confirm_d2h_tier(self,
                         base: dict[str, int] | None = None) -> str | None:
        """Write-direction twin of confirm_engaged_tier: "deferred" when
        blocks went through the deferred fetch engine since `base`, else
        "serial". Returns the previous confirmation when the window moved
        no d2h bytes."""
        np_ = self._native_path
        if np_ is None:
            return None
        base = self._tier_base if base is None else base
        now = self.tier_counter_snapshot()
        if now["from_hbm"] - base.get("from_hbm", 0) <= 0:
            return self._engaged_d2h_tier
        tier = ("deferred"
                if now["d2h_deferred"] - base.get("d2h_deferred", 0) > 0
                else "serial")
        if (self._engaged_d2h_tier is not None
                and tier != self._engaged_d2h_tier):
            LOGGER.info(f"native CUDA d2h tier engagement changed: "
                        f"{self._engaged_d2h_tier} -> {tier}")
        self._engaged_d2h_tier = tier
        return tier

    def plugin_caps(self) -> dict | None:
        """Capability probes of the session's driver library: registration
        (zero-copy tier possible), the latency clock, and whether the
        driver is the CPU test mock. None off the native path."""
        np_ = self._native_path
        if np_ is None:
            return None
        driver = os.path.basename(np_.so_path)
        return {"dma_map": bool(np_.dma_supported), "xfer_mgr": False,
                "onready_clock": np_.latency_clock, "plugin": driver,
                "mock": "mock" in driver}

    def native_device_count(self) -> int:
        """Selected-device count of the native path (0 off it)."""
        if self._native_path is None:
            return 0
        return self._native_path.num_devices

    def d2h_tier(self) -> str | None:
        return self._engaged_d2h_tier

    def d2h_stats(self) -> dict[str, int] | None:
        if self._native_path is None:
            return None
        return self._native_path.d2h_stats()

    def effective_d2h_depth(self) -> int:
        """Resolved --d2hdepth (0 before the pjrt engine was built)."""
        return self._d2h_depth

    def data_path_tier(self) -> str | None:
        return self._engaged_tier

    def reg_cache_stats(self) -> dict[str, int] | None:
        if self._native_path is None:
            return None
        return self._native_path.reg_cache_stats()

    def effective_reg_window(self) -> int:
        """Resolved --regwindow byte budget (0 before prepare / off the
        native path)."""
        return self._reg_window

    def lane_stats(self) -> list[dict[str, int]] | None:
        if self._native_path is None:
            return None
        return self._native_path.lane_stats()

    def single_lane(self) -> bool:
        """True when EBT_PJRT_SINGLE_LANE=1 forced the single-shard ledger
        shape (the lane-split A/B control)."""
        return (self._native_path is not None
                and self._native_path.single_lane)

    def device_latency(self) -> dict[str, "LatencyHistogram"]:
        """Per-chip transfer latency histograms, whichever backend ran the
        device leg (the native path's host-function-stamped histograms, or
        the staged/direct path's), labelled by --gpuids entry like the
        original."""
        source = self._native_path or self._staging_path()
        if source is None:
            return {}
        ids = self.cfg.tpu_ids
        out = {}
        for dev, histo in source.device_latency_histograms().items():
            label = str(ids[dev]) if dev < len(ids) else str(dev)
            out[label] = histo
        return out

    def device_latency_clock(self) -> dict[str, str]:
        """One clock word per label: native = 'onready'/'await' (the path
        knows whether host-function stamps were available); staged/direct =
        'barrier' like the original's (event completion observed at the
        block's wait or at the pre-reuse barrier)."""
        if self._native_path is not None:
            clock = self._native_path.latency_clock
        elif self._staging_path() is not None:
            clock = "barrier"
        else:
            return {}
        return {label: clock for label in self.device_latency()}

    def num_slots(self) -> int:
        return self.cfg.num_threads

    def live_snapshot(self) -> list[WorkerSnapshot]:
        assert self.engine is not None
        out = []
        for i in range(self.engine.num_workers):
            lv = self.engine.live(i)
            out.append(WorkerSnapshot(ops=lv.ops, done=lv.done,
                                      has_error=lv.has_error))
        return out

    def phase_results(self) -> list[WorkerPhaseResult]:
        assert self.engine is not None
        # every finished phase refreshes the engagement confirmations, so
        # the stats/result trees report the tiers the phase actually ran
        if self._native_path is not None:
            self.confirm_engaged_tier()
            self.confirm_d2h_tier()
        out = []
        cpu_sw = self.engine.cpu_stonewall_pct()
        staging = self._staging_path()
        for i in range(self.engine.num_workers):
            lv = self.engine.live(i)
            res = self.engine.result(i)
            err = self.engine.worker_error(i)
            if err and staging is not None:
                # on-device verify failures carry the exact corrupt offset;
                # prefer that over the engine's generic device-copy rc message
                verr = staging.verify_errors.get(self.cfg.rank_offset + i)
                if verr:
                    err = verr
            if err and self._native_path is not None:
                # surface the driver's root cause behind the engine's
                # generic "device copy failed (rc=N)" message
                nerr = self._native_path.last_error()
                if nerr and nerr not in err:
                    err = f"{err}: {nerr}"
            out.append(WorkerPhaseResult(
                ops=lv.ops,
                elapsed_us_list=[res.elapsed_us],
                iops_histo=self.engine.histogram(i, 0),
                entries_histo=self.engine.histogram(i, 1),
                stonewall_ops=res.stonewall_ops,
                stonewall_us=res.stonewall_us,
                have_stonewall=res.have_stonewall,
                cpu_stonewall_pct=cpu_sw,
                error=err,
            ))
        return out
