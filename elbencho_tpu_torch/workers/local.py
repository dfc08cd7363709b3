"""Local worker group: drives the native C++ I/O engine.

This is the scheduler-side twin of the reference's LocalWorker path
(WorkerManager::prepareThreads spawning LocalWorker threads,
WorkerManager.cpp:152-171): here the threads live inside the native engine
(core/src/engine.cpp) and this class feeds it config, attaches the GPU device
backend, and reads back live counters and results.

The port carries the staged/direct callback backend, the hostsim backend,
and the native pjrt path (`--tpubackend pjrt`: the C++ CUDA transfer engine
of csrc/cuda_path.cpp, installed as a C function pointer) with its stripe
planner, checkpoint restore, N->M reshard, device fault policy, serving
rotation, DL-ingestion ledger and transfer-manager tier (EBT_PJRT_XFER_MGR),
and arms --chaos seams at prepare.
"""

from __future__ import annotations

import os

from ..common import BenchPathType, BenchPhase, DevBackend, RAND_ALGO_NAMES
from ..config import Config
from ..engine import NativeEngine
from ..engine_stats import (engine_fault_stats, engine_numa_stats,
                            engine_reactor_stats, engine_serving_stats,
                            tenant_stats, uring_stats)
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
        self._engaged_stripe_tier: str | None = None
        # reshard move tier, confirmed from settled-move deltas: "d2d" when
        # a chunk move settled device to device, "bounce" when moves
        # settled only through the host bounce
        self._engaged_reshard_tier: str | None = None
        # DL-ingestion tier, confirmed from counter deltas: "pipelined"
        # when records landed resident and the in-flight gauge peaked at
        # >= 2 batches, "serial" when it peaked at <= 1
        self._engaged_ingest_tier: str | None = None
        self._tier_base: dict = {}
        # device FaultStats at the last start_phase: the native counters
        # are session-cumulative (ejection is sticky), the result tree
        # reports phase-scoped deltas
        self._fault_base: dict[str, int] = {}

    # ------------------------------------------------------------- lifecycle

    def _build_engine(self) -> NativeEngine:
        cfg = self.cfg
        e = NativeEngine()
        # ingest mode: the engine reads the resolved dataset shard files,
        # not the CLI PATH (a directory in generated mode)
        for p in (cfg.ingest_paths() if cfg.ingest_dataset else cfg.paths):
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
        # SLO goodput grading + serving rotation (--slotarget/--rotate/
        # --bgbudget/--bgadapt): the target never gates issue, the
        # rotation arms the engine's rotator thread on read phases
        if cfg.slo_target_ms:
            e.set_float("slo_target_ms", float(cfg.slo_target_ms))
        if cfg.rotate_period_s:
            e.set_float("rotate_period_s", float(cfg.rotate_period_s))
            if cfg.bg_budget:
                e.set("bg_budget_bps", cfg.bg_budget)
            if cfg.bg_adapt_lag_ms:
                e.set("bg_adapt_lag_ms", cfg.bg_adapt_lag_ms)
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
        if self._native_path is not None:
            # the last config step: reading the interrupt flag's address
            # makes the native engine from the finished config (a later
            # e.set() would be lost); recovery backoff waits poll it
            self._native_path.set_interrupt_flag(e.interrupt_flag)
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
        # device-side fault policy: with an error budget a lane that fails
        # is ejected and its work replanned onto survivors (stripe planner,
        # checkpoint placement, rank routing and reshard destinations)
        if cfg.fault_tolerant:
            np_.set_fault_policy(1, cfg.retry_max, cfg.retry_backoff_ms)
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
        if cfg.ckpt_shards:
            # checkpoint restore: resolve the generated shards' deferred
            # i % ndev placement against the lanes the native path actually
            # selected, re-check every explicit placement against them,
            # install the plan in the restore ledger and hand the engine
            # the manifest (it owns the per-shard routing and the
            # direction-9/10 protocol)
            from ..checkpoint import (resolve_generated_placement,
                                      validate_placement)

            resolve_generated_placement(cfg.ckpt_shards, np_.num_devices)
            if not cfg.reshard_devices:
                # a reshard accepts placements beyond the live lanes (the
                # pre-shift topology: plan_reshard makes them read units);
                # a plain restore refuses them
                validate_placement(
                    cfg.ckpt_shards, np_.num_devices,
                    cfg.checkpoint_manifest or "--checkpoint-shards")
            if cfg.reshard_devices:
                # topology-shift restore (--reshard M): diff the manifest's
                # placement against the M-lane target now that the lanes
                # are known, install the plan in the reshard ledger (the
                # move tier and per-unit reconciliation) and hand the
                # engine the units (the direction-13/14/15 protocol and the
                # storage reads)
                from ..checkpoint import plan_reshard, reshard_plan_summary

                cfg.reshard_units = plan_reshard(
                    cfg.ckpt_shards, np_.num_devices, cfg.reshard_devices)
                np_.set_reshard_plan(cfg.reshard_units)
                for u in cfg.reshard_units:
                    e.add_reshard_unit(
                        np_.RESHARD_ACTIONS[u.action], u.src_dev,
                        u.dst_dev, u.bytes, u.path)
                e.set("dev_reshard", 1)
                plan = reshard_plan_summary(cfg.reshard_units)
                LOGGER.info(
                    f"reshard plan: {plan['units']} unit(s) -> "
                    f"{cfg.reshard_devices} device(s) "
                    f"({plan['resident']} resident, {plan['move']} "
                    f"move / {plan['move_bytes'] >> 20} MiB, "
                    f"{plan['read']} read / "
                    f"{plan['read_bytes'] >> 20} MiB); D2D "
                    + ("native" if np_.d2d_supported else "bounce"))
                enabled, pairs = np_.peer_access()
                if pairs:
                    LOGGER.info(f"D2D peer access: on for {enabled} of "
                                f"{pairs} device pair(s)")
            else:
                np_.set_ckpt_plan(cfg.ckpt_shards)
                for shard in cfg.ckpt_shards:
                    e.add_ckpt_shard(shard.path, shard.bytes, shard.devices)
                e.set("dev_ckpt", 1)
                if cfg.rotate_period_s:
                    # serving rotation: arm the lane-side background token
                    # bucket (the engine's rotator re-syncs the rate at
                    # each rotation begin)
                    if cfg.bg_budget:
                        np_.set_bg_budget(cfg.bg_budget)
                    LOGGER.info(
                        f"model rotation: {len(cfg.ckpt_shards)} "
                        f"shard(s) every {cfg.rotate_period_s}s, "
                        f"bg budget "
                        + (f"{cfg.bg_budget} B/s" if cfg.bg_budget
                           else "unthrottled")
                        + (f" (adaptive, {cfg.bg_adapt_lag_ms}ms "
                           "lag target)" if cfg.bg_adapt_lag_ms
                           else ""))
                else:
                    LOGGER.info(
                        f"checkpoint restore: {len(cfg.ckpt_shards)} "
                        f"shard(s) over {np_.num_devices} device(s), "
                        f"{cfg.ckpt_total_bytes() >> 20} MiB total")
        if cfg.ingest_dataset:
            # DL ingestion: arm the per-epoch record ledger in the native
            # path and hand the engine the record/shuffle/prefetch geometry
            # (it owns the shuffled record loop and the direction-11/12
            # protocol)
            np_.set_ingest_plan(cfg.record_size, cfg.ingest_epochs)
            e.set("dev_ingest", 1)
            e.set("record_size", cfg.record_size)
            e.set("shuffle_window", cfg.shuffle_window)
            e.set("shuffle_seed", cfg.shuffle_seed)
            e.set("ingest_epochs", cfg.ingest_epochs)
            e.set("prefetch_batches", cfg.prefetch_batches)
            LOGGER.info(
                f"ingest: {len(cfg.ingest_dataset)} shard(s) x "
                f"{cfg.ingest_records_per_shard()} records of "
                f"{cfg.record_size} B, {cfg.ingest_epochs} epoch(s), "
                f"window {cfg.shuffle_window}, seed {cfg.shuffle_seed}")
        if cfg.stripe_policy:
            # the stripe tier: install the block->lane plan (the planner
            # owns direction-0 placement from here on) and have the engine
            # run the direction-8 gather barrier at the end of each
            # read-phase block loop. Units cover whole registration spans
            # when the span grid will engage, one block otherwise.
            unit = cfg.stripe_unit_blocks(spans_active=np_.dma_supported)
            np_.set_stripe_plan(cfg.stripe_policy, cfg.stripe_total_blocks(),
                                unit)
            e.set("dev_stripe", 1)
            LOGGER.info(
                f"mesh-striped fill: policy={cfg.stripe_policy} over "
                f"{np_.num_devices} device(s), unit={unit} block(s)")
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
        if os.environ.get("EBT_PJRT_XFER_MGR") is not None:
            LOGGER.info(
                "native CUDA transfer-manager tier: "
                + ("one cuMemAllocAsync device buffer per block"
                   if np_.xfer_mgr_active else
                   f"not active ({np_.reg_error()})"))

    def prepare(self) -> None:
        if self._prepared:
            return
        if self.cfg.chaos_spec:
            # arm the mock fault seams BEFORE the engine and the native
            # path exist (the seams are environment reads inside them)
            from ..chaos import arm_chaos

            arm_chaos(self.cfg.chaos_spec)
        if self.cfg.ckpt_shards and self.cfg.run_create_files and \
                not self.cfg.rotate_period_s:
            # generated --checkpoint-shards manifest with -w: create/size
            # the shard files up front (set-up, never measured). Serving
            # rotation is excluded: there -w creates the bench files and
            # the explicit manifest's shards must already exist
            from ..checkpoint import write_generated_shards

            write_generated_shards(self.cfg.ckpt_shards)
        if self.cfg.ingest_dataset and self.cfg.run_create_files:
            # generated --ingestshards dataset with -w: same set-up rule
            from ..ingest import write_generated_dataset

            write_generated_dataset(self.cfg.ingest_dataset)
        self.engine = self._build_engine()
        if (not self.cfg.ckpt_shards or self.cfg.rotate_period_s) and \
                not self.cfg.ingest_dataset and \
                self.cfg.path_type != BenchPathType.DIR and (
                self.cfg.run_create_files or self.cfg.path_type ==
                BenchPathType.BLOCKDEV):
            # (checkpoint mode prepares its shard files above; its PATH is
            # the shard directory, not a file to create. Serving rotation
            # keeps the standard preparation: its PATH args are the bench
            # files the read phase serves.)
            self.engine.prepare_paths()
        self.engine.prepare()
        if self._native_path is not None and self.cfg.reshard_devices:
            # stage the move units' sources on their src lanes: the "restored
            # onto N lanes" pre-state, untimed (the RESHARD clock measures
            # the reshard, never the pre-state)
            self._native_path.reshard_preload()
        self._prepared = True

    def _staging_path(self):
        return getattr(self._dev_callback, "staging_path", None)

    def start_phase(self, phase: BenchPhase, bench_id: str) -> None:
        assert self.engine is not None
        # tier-engagement deltas are phase-scoped: confirm_engaged_tier()
        # sees only THIS phase's traffic
        self._tier_base = self.tier_counter_snapshot()
        if self._native_path is not None:
            self._fault_base = self._native_path.fault_stats()
        # ingest counters are phase-scoped like every other family: a
        # fresh phase on the same plan starts from zero
        if self._native_path is not None and self.cfg.ingest_dataset and \
                phase == BenchPhase.INGEST:
            self._native_path.ingest_rearm()
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
        self._engaged_stripe_tier = None
        self._engaged_reshard_tier = None
        self._engaged_ingest_tier = None
        self._tier_base = {}
        self._fault_base = {}

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
    # The h2d tier ladder (zero-copy -> transfer-manager -> staged) is
    # CONFIRMED from counter deltas, never from capability alone: a
    # registration that passed the init probe can still fail per buffer,
    # silently dropping the leg to the staged tier. The counters say which
    # path the bytes actually took.

    def tier_counter_snapshot(self) -> dict[str, int]:
        """Cumulative tier counters (zero-copy chunks, transfer-manager
        blocks, h2d/d2h bytes, deferred d2h blocks) — diffed by
        confirm_engaged_tier()."""
        np_ = self._native_path
        if np_ is None:
            return {}
        to_hbm, from_hbm = np_.transferred_bytes
        rs = np_.reshard_stats()
        return {"zero_copy": np_.zero_copy_count,
                "xfer_mgr": np_.xfer_mgr_count,
                "to_hbm": to_hbm,
                "from_hbm": from_hbm,
                "d2h_deferred": np_.d2h_stats()["deferred_count"],
                "stripe_units": np_.stripe_stats()["units_submitted"],
                # reshard move tier: which path the chunk moves settled
                # through since the phase base
                "d2d_moves": rs["d2d_moves"],
                "bounce_moves": rs["bounce_moves"],
                # per-lane h2d byte totals: the stripe tier is confirmed
                # only when units actually landed on >= 2 lanes
                "lanes_to_hbm": [ln["to_hbm"] for ln in np_.lane_stats()]}

    def confirm_engaged_tier(self,
                             base: dict[str, int] | None = None) -> str | None:
        """Which h2d tier the traffic since `base` (default: the last
        start_phase) actually ran: "zero_copy" when copies from registered
        memory happened, else "xfer_mgr" when blocks rode the
        transfer-manager tier, else "staged". Returns the previous
        confirmation (or None) when the window moved no h2d bytes — a write
        phase must not un-confirm the read tier."""
        np_ = self._native_path
        if np_ is None:
            return None
        base = self._tier_base if base is None else base
        now = self.tier_counter_snapshot()
        if now["to_hbm"] - base.get("to_hbm", 0) <= 0:
            return self._engaged_tier
        if now["zero_copy"] - base.get("zero_copy", 0) > 0:
            tier = "zero_copy"
        elif now["xfer_mgr"] - base.get("xfer_mgr", 0) > 0:
            tier = "xfer_mgr"
        else:
            tier = "staged"
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

    def confirm_stripe_tier(self,
                            base: dict[str, int] | None = None) -> str | None:
        """Stripe twin of confirm_engaged_tier: "striped" when
        planner-routed units ran since `base` AND their bytes landed on
        >= 2 lanes, "single" when a stripe plan routed units onto one lane
        (the one-device case, byte-identical to the run without a plan).
        Confirmed from counter deltas, never from the configured policy.
        Returns the previous confirmation when the window moved no stripe
        units."""
        np_ = self._native_path
        if np_ is None or not self.cfg.stripe_policy:
            return None
        base = self._tier_base if base is None else base
        now = self.tier_counter_snapshot()
        if now["stripe_units"] - base.get("stripe_units", 0) <= 0:
            return self._engaged_stripe_tier
        lanes_base = base.get("lanes_to_hbm", [])
        active = sum(
            1 for i, v in enumerate(now["lanes_to_hbm"])
            if v - (lanes_base[i] if i < len(lanes_base) else 0) > 0)
        tier = "striped" if active >= 2 else "single"
        if (self._engaged_stripe_tier is not None
                and tier != self._engaged_stripe_tier):
            LOGGER.info(f"striped-fill tier engagement changed: "
                        f"{self._engaged_stripe_tier} -> {tier}")
        self._engaged_stripe_tier = tier
        return tier

    def confirm_reshard_tier(self,
                             base: dict[str, int] | None = None
                             ) -> str | None:
        """Reshard twin of confirm_engaged_tier: "d2d" when a chunk move
        settled device to device since `base`, "bounce" when moves settled
        only through the host bounce (EBT_D2D_DISABLE=1, a refused copy, or
        fallbacks that caught every move). Confirmed from counter deltas,
        never from d2d_supported alone. Returns the previous confirmation
        when the window settled no moves."""
        np_ = self._native_path
        if np_ is None or not self.cfg.reshard_devices:
            return None
        base = self._tier_base if base is None else base
        now = self.tier_counter_snapshot()
        d2d = now["d2d_moves"] - base.get("d2d_moves", 0)
        bounce = now["bounce_moves"] - base.get("bounce_moves", 0)
        if d2d + bounce <= 0:
            return self._engaged_reshard_tier
        tier = "d2d" if d2d > 0 else "bounce"
        if (self._engaged_reshard_tier is not None
                and tier != self._engaged_reshard_tier):
            LOGGER.info(f"reshard move tier engagement changed: "
                        f"{self._engaged_reshard_tier} -> {tier}")
        self._engaged_reshard_tier = tier
        return tier

    def reshard_tier(self) -> str | None:
        """The engagement-confirmed reshard move tier ("d2d"/"bounce"), or
        None before any settled move (or without a reshard plan / off the
        native path)."""
        return self._engaged_reshard_tier

    def reshard_stats(self) -> dict[str, int] | None:
        """The ReshardStats family plus the per-unit-tag byte pair
        (unit_bytes_submitted/unit_bytes_resident: moves and storage
        reads, equal once every all-resharded barrier returned clean).
        None without a --reshard plan / off the native path."""
        if self._native_path is None or not self.cfg.reshard_devices:
            return None
        stats = self._native_path.reshard_stats()
        sub, res = self._native_path.reshard_byte_totals()
        stats["unit_bytes_submitted"] = sub
        stats["unit_bytes_resident"] = res
        return stats

    def reshard_pairs(self) -> list[dict[str, int]] | None:
        """The src->dst lane-pair move/byte matrix, or None without a
        reshard plan."""
        if self._native_path is None or not self.cfg.reshard_devices:
            return None
        return self._native_path.reshard_pair_matrix()

    def reshard_error(self) -> str | None:
        """First reshard failure ("unit U src A dst B: cause"), or
        None."""
        if self._native_path is None or not self.cfg.reshard_devices:
            return None
        return self._native_path.reshard_error()

    def d2d_supported(self) -> bool | None:
        """Device-to-device copies available and not disabled (the
        capability half of the tier claim; engagement rides
        reshard_tier()). None off the native path."""
        if self._native_path is None:
            return None
        return self._native_path.d2d_supported

    def fault_stats(self) -> dict[str, int] | None:
        """Device-side fault evidence (recovery retries, ejections,
        replanned placements) as deltas against the last start_phase, so
        a clean phase after a faulted one reports none of its recoveries
        (ejection itself stays sticky: ejected_devices()). None off the
        native path."""
        if self._native_path is None:
            return None
        now = self._native_path.fault_stats()
        return {k: v - self._fault_base.get(k, 0) for k, v in now.items()}

    def ejected_devices(self) -> str | None:
        """"device N: cause" of every ejection (newline-joined), or None
        off the native path; empty string when none was ejected."""
        if self._native_path is None:
            return None
        return self._native_path.ejected_devices()

    def stripe_tier(self) -> str | None:
        """The engagement-confirmed stripe tier ("striped"/"single"), or
        None before any planner-routed traffic (or without a plan / off
        the native path)."""
        return self._engaged_stripe_tier

    def stripe_stats(self) -> dict[str, int] | None:
        """Stripe counters (units submitted/awaited, gather-barrier wait,
        barrier count — cumulative), or None off the native path."""
        if self._native_path is None:
            return None
        return self._native_path.stripe_stats()

    def stripe_error(self) -> str | None:
        """First failed stripe unit with its lane, or None off the native
        path."""
        if self._native_path is None:
            return None
        return self._native_path.stripe_error()

    def ckpt_stats(self) -> dict[str, int] | None:
        """Checkpoint-restore evidence (shards_total/shards_resident/
        resident_wait_ns/barriers — cumulative), or None without a restore
        plan / off the native path."""
        if self._native_path is None or not self.cfg.ckpt_shards:
            return None
        return self._native_path.ckpt_stats()

    def ckpt_dev_bytes(self) -> list[int] | None:
        """Resident checkpoint bytes per device, or None without a restore
        plan / off the native path."""
        if self._native_path is None or not self.cfg.ckpt_shards:
            return None
        return self._native_path.ckpt_dev_bytes()

    def serving_stats(self) -> dict[str, int] | None:
        """Serving-rotation evidence (--rotate): the engine-side rotation
        lifecycle/ttr/bg-throttle counters merged with the device-side
        lane-bucket and retained-generation gauges, or None when no
        rotation is configured."""
        if self.engine is None or not self.cfg.rotate_period_s:
            return None
        out = engine_serving_stats(self.engine)
        if self._native_path is not None:
            out.update(self._native_path.rotation_state())
        return out

    def rotation_ttr_ns(self) -> list[int] | None:
        """Per-rotation restore times this phase (ns, completion order),
        or None when no rotation is configured."""
        if self.engine is None or not self.cfg.rotate_period_s:
            return None
        return self.engine.rotation_ttr_ns()

    def rotation_records(self) -> list[dict[str, int]] | None:
        """Per-rotation reconciliation records (one per completed swap),
        or None when no rotation is configured / off the native path."""
        if self._native_path is None or not self.cfg.rotate_period_s:
            return None
        return self._native_path.rotation_records()

    def confirm_ingest_tier(self) -> str | None:
        """Ingest twin of confirm_engaged_tier: "pipelined" when records
        landed resident this phase AND the in-flight prefetch gauge
        peaked at >= 2 batches (epoch reads actually overlapped device
        settles), "serial" when records landed with a peak of <= 1.
        Confirmed from counter deltas, never from --prefetchbatches
        alone. Returns the previous confirmation when no records
        landed."""
        np_ = self._native_path
        if np_ is None or not self.cfg.ingest_dataset:
            return None
        stats = np_.ingest_stats(self.cfg.block_size)
        if stats["records_resident"] <= 0:
            return self._engaged_ingest_tier
        tier = "pipelined" if stats["prefetch_depth_peak"] >= 2 \
            else "serial"
        if (self._engaged_ingest_tier is not None
                and tier != self._engaged_ingest_tier):
            LOGGER.info(f"ingest tier engagement changed: "
                        f"{self._engaged_ingest_tier} -> {tier}")
        self._engaged_ingest_tier = tier
        return tier

    def ingest_tier(self) -> str | None:
        """The engagement-confirmed ingest tier ("pipelined"/"serial"),
        or None before any resident records (or without an ingest plan /
        off the native path)."""
        return self._engaged_ingest_tier

    def ingest_stats(self) -> dict | None:
        """The IngestStats counter family: record totals + the per-epoch
        reconciliation lists from the device ledger, the engine's
        per-epoch wall times, and the configured shuffle window. None
        without an ingest plan / off the native path. Phase-scoped (the
        ledger is re-armed at start_phase)."""
        if self._native_path is None or not self.cfg.ingest_dataset or \
                self.engine is None:
            return None
        stats = self._native_path.ingest_stats(self.cfg.block_size)
        stats["shuffle_window"] = self.cfg.shuffle_window
        stats["epochs"] = [
            self._native_path.ingest_epoch_records(e)
            for e in range(self._native_path.ingest_epochs)]
        stats["epoch_time_ns"] = self.engine.ingest_epoch_ns(
            max(1, self.cfg.ingest_epochs))
        return stats

    def ingest_error(self) -> str | None:
        """First ingest failure ("device N epoch E: cause"), or None."""
        if self._native_path is None or not self.cfg.ingest_dataset:
            return None
        return self._native_path.ingest_error()

    def ckpt_error(self) -> str | None:
        """First restore failure ("device N shard S: cause"), or None."""
        if self._native_path is None or not self.cfg.ckpt_shards:
            return None
        return self._native_path.ckpt_error()

    def plugin_caps(self) -> dict | None:
        """Capability probes of the session's driver library: registration
        (zero-copy tier possible), the transfer-manager tier, the latency
        clock, and whether the driver is the CPU test mock. None off the
        native path."""
        np_ = self._native_path
        if np_ is None:
            return None
        driver = os.path.basename(np_.so_path)
        return {"dma_map": bool(np_.dma_supported),
                "xfer_mgr": bool(np_.xfer_mgr_active),
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
            self.confirm_stripe_tier()
            self.confirm_ingest_tier()
            self.confirm_reshard_tier()
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
                # generic "device copy failed (rc=N)" message; a striped
                # fill adds the per-device attribution ("device N unit U:
                # cause"), a checkpoint restore its "device N shard S:
                # cause", an ingest its "device N epoch E: cause"
                serr = self._native_path.stripe_error()
                if serr and serr not in err:
                    err = f"{err}: {serr}"
                cerr = self._native_path.ckpt_error()
                if cerr and cerr not in err:
                    err = f"{err}: {cerr}"
                rerr = self._native_path.reshard_error() \
                    if self.cfg.reshard_devices else ""
                if rerr and rerr not in err:
                    err = f"{err}: {rerr}"
                ierr = self._native_path.ingest_error() \
                    if self.cfg.ingest_dataset else ""
                if ierr and ierr not in err:
                    err = f"{err}: {ierr}"
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
