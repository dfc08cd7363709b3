"""Coordinator: the benchmark phase state machine.

Rebuild of the reference's source/Coordinator.{h,cpp}: dispatch to service
mode, master-mode consistency checks, synchronized start-time wait
(Coordinator.cpp:111-120), the ordered phase sequence with sync/dropcaches
interleave (runBenchmarks, Coordinator.cpp:190-231), per-phase live-stats wait
(runBenchmarkPhase, Coordinator.cpp:142-164), SIGINT/SIGTERM handling with
graceful-then-hard semantics (Coordinator.cpp:238-253), and error/interrupt
unwinding (Coordinator.cpp:66-104).

The port's coordinator serves local workers, the --hosts master
(workers/remote.py), service mode (service.py) and the --metricsport
listener, and runs the checkpoint-restore scenario's RESTORE phase, the
reshard scenario's RESHARD phase and the ingest scenario's INGEST phase.
"""

from __future__ import annotations

import signal
import sys
import time
import uuid

from . import spans
from .common import BenchPathType, BenchPhase
from .config import Config
from .exceptions import ProgException, ProgInterruptedException
from .liveops import LiveOps
from .logger import LOGGER
from .stats import Statistics, aggregate_results
from .workers.base import WorkerGroup


class Coordinator:
    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg
        self.workers: WorkerGroup | None = None
        self.stats: Statistics | None = None
        self._interrupted = False
        self._current_phase = BenchPhase.IDLE  # what /metrics labels
        self._span_file: spans.SpanFile | None = None  # --spanfile

    # ------------------------------------------------------------- dispatch

    def main(self) -> int:
        cfg = self.cfg
        if cfg.run_as_service:
            from .service import Service
            return Service(cfg).run()
        if cfg.interrupt_services or cfg.quit_services:
            from .workers.remote import send_interrupt_to_hosts
            # nothing here needs the early latch, and the HTTP fan-out can
            # block tens of seconds on dead hosts — let Ctrl-C raise
            from .utils.signals import restore_default_handlers

            restore_default_handlers()
            send_interrupt_to_hosts(cfg.hosts, quit_services=cfg.quit_services)
            return 0
        return self._run_master_or_local()

    def _make_workers(self) -> WorkerGroup:
        if self.cfg.hosts:
            from .workers.remote import RemoteWorkerGroup
            return RemoteWorkerGroup(self.cfg)
        from .workers.local import LocalWorkerGroup
        return LocalWorkerGroup(self.cfg)

    def _run_master_or_local(self) -> int:
        cfg = self.cfg
        self.workers = self._make_workers()
        self.stats = Statistics(cfg, self.workers)
        exit_code = 0
        metrics_srv = None
        if cfg.metrics_port:
            # live observability for the whole run (docs/CAMPAIGNS.md):
            # the master serves the pod-merged counter families (local
            # mode: the local group's) in Prometheus text format — up
            # BEFORE prepare so a soak run is scrapeable end to end
            from .metrics import MetricsServer, render_metrics

            metrics_srv = MetricsServer(
                lambda: render_metrics(
                    self.workers, cfg, self._current_phase, role="master",
                    campaign=((cfg.campaign_name, cfg.campaign_stage, "")
                              if cfg.campaign_name else None)),
                cfg.metrics_port)
            metrics_srv.start()
        if cfg.span_file:
            self._span_file = spans.SpanFile(cfg.span_file)
        try:
            # handlers BEFORE prepare: a SIGINT during the (potentially slow)
            # preparation — CUDA/device init, file preallocation — must set
            # the graceful-stop flag instead of raising KeyboardInterrupt at
            # an arbitrary point
            self._register_interrupt_handlers()
            if self._interrupted:  # Ctrl-C already latched during startup:
                # don't even start side-effectful preparation (device init,
                # directory creation, file truncation/preallocation)
                raise ProgInterruptedException("interrupted during startup")
            self.workers.prepare()
            if self._interrupted:
                raise ProgInterruptedException("interrupted during preparation")
            self._wait_for_start_time()
            self._run_benchmarks()
        except ProgInterruptedException:
            LOGGER.error("benchmark interrupted")
            exit_code = 130
        except ProgException as e:
            LOGGER.error(str(e))
            exit_code = 1
        finally:
            self._restore_interrupt_handlers()
            try:
                self.workers.teardown()
            except Exception as e:  # teardown must never mask the real error
                LOGGER.error(f"worker teardown failed: {e}")
            if metrics_srv is not None:
                try:
                    metrics_srv.stop()
                except Exception as e:
                    LOGGER.error(f"metrics listener shutdown failed: {e}")
            if self._span_file is not None:
                try:
                    self._span_file.write()
                except OSError as e:
                    LOGGER.error(f"--spanfile: {e}")
                    exit_code = exit_code or 1
        return exit_code

    # -------------------------------------------------------------- signals

    def _register_interrupt_handlers(self) -> None:
        from .utils.signals import early_interrupt_pending

        if early_interrupt_pending():  # Ctrl-C already arrived during startup
            self._interrupted = True

        def handler(signum, frame):
            if self._interrupted:
                # second signal: hard exit (reference: Coordinator.cpp:238-244)
                raise KeyboardInterrupt
            self._interrupted = True
            LOGGER.error("interrupt received - stopping gracefully "
                         "(send again to kill)")
            if self.workers is not None:
                self.workers.interrupt()

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread (e.g. under a service)

    def _restore_interrupt_handlers(self) -> None:
        # NOT the previously-installed handler: that was the CLI's early latch,
        # which would silently swallow a Ctrl-C during a hung teardown. Python
        # defaults make Ctrl-C raise KeyboardInterrupt -> cli exits 130.
        from .utils.signals import restore_default_handlers

        restore_default_handlers()

    def _wait_for_start_time(self) -> None:
        """--start epoch-seconds barrier, with a live countdown on a tty
        (reference: Coordinator.cpp:111-120; countdown display
        Statistics.cpp:64-105)."""
        if not self.cfg.start_time:
            return
        now = time.time()
        if now > self.cfg.start_time:
            raise ProgException("given start time is in the past")
        from .terminal import Terminal

        term = Terminal()
        show = (not self.cfg.disable_live_stats and
                term.is_tty(sys.stdout))
        showed = False
        try:
            while time.time() < self.cfg.start_time:
                if self._interrupted:
                    raise ProgInterruptedException("interrupted while waiting")
                remaining = self.cfg.start_time - time.time()
                if show:
                    term.print_transient_line(
                        sys.stdout,
                        f"Waiting for synchronized start time... "
                        f"{remaining:.0f}s left")
                    showed = True
                time.sleep(min(0.2, max(0.0, remaining)))
        finally:
            if showed:
                term.clear_line(sys.stdout)

    # --------------------------------------------------------------- phases

    def _run_benchmarks(self) -> None:
        cfg = self.cfg
        phases = cfg.selected_phases()
        data_phases = {BenchPhase.CREATEFILES, BenchPhase.READFILES,
                       BenchPhase.STATFILES, BenchPhase.CHECKPOINT,
                       BenchPhase.INGEST, BenchPhase.RESHARD}
        if not phases and (cfg.run_sync or cfg.run_drop_caches):
            # standalone sync / dropcaches run
            self._run_sync_and_drop_caches()
            return
        if not phases:
            raise ProgException(
                "no benchmark phase selected (e.g. -w to write, -r to read)")

        self.stats.print_phase_header()
        first_data_phase = True
        for phase in phases:
            if phase in data_phases:
                if not first_data_phase or phase != BenchPhase.CREATEFILES:
                    # caches only need clearing when previous phases may have
                    # polluted them (reference interleave: Coordinator.cpp:190-231)
                    self._run_sync_and_drop_caches()
                first_data_phase = False
            self._run_phase(phase)
            if self.workers.time_limit_hit():
                # a user-defined limit ended the phase: partial results were
                # printed, remaining phases are skipped, and the exit code
                # stays 0 — this is not an error (reference:
                # Coordinator.cpp:77-82 + checkInterruptionBetweenPhases)
                LOGGER.info("Terminating due to phase time limit.")
                break

    def _run_sync_and_drop_caches(self) -> None:
        """(reference: runSyncAndDropCaches, Coordinator.cpp:169-183)"""
        if self.cfg.run_sync:
            self._run_phase(BenchPhase.SYNC, quiet=True)
        if self.cfg.run_drop_caches:
            self._run_phase(BenchPhase.DROPCACHES, quiet=True)

    def _run_phase(self, phase: BenchPhase, quiet: bool = False) -> None:
        """(reference: runBenchmarkPhase, Coordinator.cpp:142-164)"""
        spans.follow_profiler()
        try:
            with spans.span("coord.phase", int(phase)):
                self._phase_steps(phase, quiet)
        finally:
            if self._span_file is not None:
                self._span_file.collect()

    def _phase_steps(self, phase: BenchPhase, quiet: bool) -> None:
        if self._interrupted:
            raise ProgInterruptedException("benchmark interrupted")
        bench_id = str(uuid.uuid4())
        self._current_phase = phase
        self.workers.start_phase(phase, bench_id)
        with spans.span("coord.wait", int(phase)):
            status = self.stats.live_loop(phase, self.expected_totals(phase))
        with spans.span("coord.results", int(phase)):
            self._phase_results(phase, quiet, status)

    def _phase_results(self, phase: BenchPhase, quiet: bool,
                       status: int) -> None:
        results = self.workers.phase_results()
        degraded: list[dict] = []
        if status == 2:
            err = self.workers.first_error()
            if self._interrupted:
                raise ProgInterruptedException(err or "interrupted")
            # host-level degraded completion (--maxerrors + --hosttimeout):
            # when the ONLY failures are dead/hung hosts and at least one
            # host returned a clean result, salvage the live hosts'
            # partials instead of abandoning the whole pod result — the
            # summary then carries the degraded marker with per-host
            # attribution. Any live-host failure keeps today's abort, and
            # so does the --maxerrors 0 default.
            degraded = self.workers.degraded_hosts() \
                if self.cfg.fault_tolerant else []
            dead_hosts = {d["host"] for d in degraded}
            live_ok = [r for r in results if r is not None and not r.error]
            # every error line is framed "service <host>: ..." — match the
            # framing INCLUDING the colon, or host "node1" would substring-
            # match "node11"'s real failure and swallow it as dead-host
            errors_all_dead = bool(dead_hosts) and all(
                (r is None) or (not r.error) or
                any(f"service {h}:" in r.error for h in dead_hosts)
                for r in results)
            if not (errors_all_dead and live_ok):
                raise ProgException(err or "a worker failed")
            results = live_ok
            for d in degraded:
                LOGGER.error(
                    f"DEGRADED: {d['cause'] or d['host'] + ' died'}")
            LOGGER.error(
                f"DEGRADED phase: salvaged partial results from "
                f"{len(live_ok)} live host(s); dead: "
                + ", ".join(sorted(dead_hosts)))
        if not quiet:
            agg = aggregate_results(phase, results)
            self.stats.cpu.update()
            agg.cpu_util_pct = self.stats.cpu.percent()
            self.stats.print_phase_results(agg)
            # master mode: per-host control-plane timing summary — name
            # the stragglers/dead hosts instead of burying them in the
            # aggregate (the timing export itself rides host_timings())
            timings = self.workers.host_timings()
            if timings:
                flagged = [t for t in timings if t["status"] != "ok"]
                worst = max(timings, key=lambda t: t["poll_lag_ns"])
                LOGGER.info(
                    f"control plane: {len(timings)} host(s), start skew "
                    f"max {max(t['start_skew_ns'] for t in timings) / 1e6:.1f}ms, "
                    f"worst poll lag {worst['poll_lag_ns'] / 1e6:.1f}ms "
                    f"({worst['host']})"
                    + (", flagged: " + ", ".join(
                        f"{t['host']}={t['status']}" for t in flagged)
                       if flagged else ""))
        if self._interrupted:
            # first Ctrl-C is a graceful stop: interrupted workers finish
            # cleanly with partial results, which were just printed — the
            # run still terminates with a failure exit code (reference:
            # ProgInterruptedException -> EXIT_FAILURE, Coordinator.cpp:70-75,
            # after the phase's results printed)
            raise ProgInterruptedException("Terminating due to interrupt signal.")

    # ------------------------------------------------------------ %-done calc

    def expected_totals(self, phase: BenchPhase) -> LiveOps | None:
        """Expected entries/bytes for this instance's workers, for the %-done
        live display (reference: getPhaseNumEntriesAndBytes,
        WorkerManager.cpp:310-381)."""
        cfg = self.cfg
        n_local_ranks = cfg.num_threads * max(1, len(cfg.hosts) or 1)
        exp = LiveOps()
        if phase == BenchPhase.CHECKPOINT:
            # the whole manifest is restored once per phase (shards
            # partitioned across ranks; entries = shards, bytes = storage
            # reads — replicated placements re-read nothing)
            exp.entries = len(cfg.ckpt_shards)
            exp.bytes = cfg.ckpt_total_bytes()
            return exp
        if phase == BenchPhase.RESHARD:
            # the whole plan executes once per phase (units partitioned
            # across ranks; entries = plan units, bytes = the data in
            # motion: moved bytes + storage-read bytes — already-resident
            # units move nothing). The plan is diffed at prepare, so
            # before it exists no expectation is set.
            from .checkpoint import reshard_plan_summary

            if not cfg.reshard_units:
                return None
            plan = reshard_plan_summary(cfg.reshard_units)
            exp.entries = plan["units"]
            exp.bytes = plan["move_bytes"] + plan["read_bytes"]
            return exp
        if phase == BenchPhase.INGEST:
            # every epoch reads the whole record-index space once (records
            # partitioned across ranks; bytes = records x record size,
            # iops = record reads); entries (submitted batches) depend on
            # per-rank partition tails, so no expectation is set for them
            exp.bytes = cfg.ingest_total_records() * cfg.record_size * \
                cfg.ingest_epochs
            exp.iops = cfg.ingest_total_records() * cfg.ingest_epochs
            return exp
        if cfg.path_type == BenchPathType.DIR:
            files_per_rank = cfg.num_dirs * cfg.num_files
            if phase in (BenchPhase.CREATEDIRS, BenchPhase.DELETEDIRS):
                exp.entries = cfg.num_dirs * (1 if cfg.do_dir_sharing
                                              else n_local_ranks)
            elif phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES,
                           BenchPhase.STATFILES, BenchPhase.DELETEFILES):
                exp.entries = files_per_rank * n_local_ranks
                if phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES):
                    exp.bytes = exp.entries * cfg.file_size
        else:
            if phase in (BenchPhase.CREATEFILES, BenchPhase.READFILES):
                if cfg.use_random_offsets:
                    per_rank = cfg.random_amount // cfg.num_dataset_threads
                    per_rank -= per_rank % max(1, cfg.block_size)
                    exp.bytes = per_rank * n_local_ranks
                else:
                    blocks_per_file = cfg.file_size // max(1, cfg.block_size)
                    total = blocks_per_file * len(cfg.paths)
                    exp.bytes = (total // cfg.num_dataset_threads) * \
                        n_local_ranks * cfg.block_size
            elif phase in (BenchPhase.DELETEFILES, BenchPhase.STATFILES):
                exp.entries = len(cfg.paths)
        return exp
