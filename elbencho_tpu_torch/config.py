"""Program arguments / central config store.

Rebuild of the reference's source/ProgArgs.{h,cpp}: ~60 CLI options with the
same names and semantics (ProgArgs.h:18-98), defaults separated from help text
(ProgArgs.cpp:305-371), human-unit conversion (ProgArgs.cpp:376-383),
cross-argument validation and auto-correction (ProgArgs.cpp:390-631), bench
path type detection (ProgArgs.cpp:1188-1210), file size auto-detection
(ProgArgs.cpp:833-958), JSON marshalling for the master -> service config
fan-out with per-host dynamic fields (ProgArgs.cpp:1641-1758), CSV label/value
export (ProgArgs.cpp:1763-1810), service-side path override
(ProgArgs.cpp:404-421), and the cross-service consistency check
(ProgArgs.cpp:1867-1954).

TPU adaptation: of the reference's CUDA/cuFile options, --gpuids keeps its
name and selects TPU devices (per BASELINE.json) while --tpubackend picks
none/hostsim/staged/direct/pjrt for the storage->TPU-HBM leg. The GPU-era
flags (--cufile, --gdsbufreg, --cuhostbufreg, --cufiledriveropen) are NOT
accepted: their capability lives in --tpubackend direct/staged, and
tools/gen_completion.py + tools/lint_interfaces.py keep the CLI, the bash
completion, and the docs from drifting apart.

PyTorch/CUDA port: --gpuids selects CUDA device indices and --tpubackend
staged|direct|pjrt moves blocks into GPU memory; --stripe, --tpustripe,
--checkpoint, --checkpoint-shards and --reshard place blocks across the
devices, --retry/--maxerrors arm the native engine's device fault policy,
--rotate and --ingest/--ingestshards run the serving-rotation and
DL-ingestion scenarios on the native engine, EBT_PJRT_XFER_MGR selects its
transfer-manager tier, and --chaos arms the fault seams of the port's mock
driver and of the storage engine (elbencho_tpu_torch/chaos.py). The port
accepts every flag of the original; the original's bench harness and tools
are not part of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import stat as stat_mod
import sys
from dataclasses import dataclass, field

from . import __version__
from .common import (RAND_ALGO_NAMES, TPU_BACKEND_NAMES, BenchPathType,
                     BenchPhase, DevBackend, SERVICE_DEFAULT_PORT)
from .exceptions import ProgException
from .utils.units import parse_size

# helper: options whose values cross the wire to services verbatim
_WIRE_FIELDS = [
    "num_threads", "num_dirs", "num_files", "file_size", "block_size",
    "use_direct_io", "ignore_del_errors", "run_create_dirs", "run_create_files",
    "run_read", "run_delete_files", "run_delete_dirs", "run_sync",
    "run_drop_caches", "run_stat_files", "use_random_offsets",
    "use_random_aligned", "random_amount", "iodepth", "use_io_uring",
    "io_engine", "uring_sqpoll",
    "do_truncate",
    "time_limit_secs", "verify_salt", "do_verify_direct", "block_variance_pct",
    "rwmix_pct", "block_variance_algo", "rand_offset_algo", "do_trunc_to_size",
    "do_prealloc", "do_dir_sharing", "num_dataset_threads", "tpu_backend_name",
    "tpu_stripe", "tpu_host_verify", "start_time", "ignore_0usec_errors",
    "reg_window", "d2h_depth", "stripe_policy",
    "checkpoint_manifest", "checkpoint_shards", "reshard_devices",
    "ingest_manifest", "ingest_shards", "record_size", "shuffle_window",
    "shuffle_seed", "ingest_epochs", "prefetch_batches",
    "arrival_mode", "arrival_rate", "tenants_spec",
    "rate_trace_json", "rotate_period_s", "bg_budget", "bg_adapt_lag_ms",
    "slo_target_ms",
    "retry_max", "retry_backoff_ms", "max_errors_spec",
    "numa_zones",
    "campaign_name", "campaign_stage",
]


@dataclass
class TenantSpec:
    """One parsed --tenants traffic class (docs/OPEN_LOOP.md grammar:
    "name:rate=R[,bs=SIZE][,rwmix=PCT][,slo=MS]", ';'-separated classes).
    Workers map to classes by global rank % K; rate is arrivals/s PER
    WORKER of the class."""

    name: str = ""
    rate: float = 0.0      # 0 = inherit --rate
    block_size: int = 0    # 0 = inherit --block; else must divide --block
    rwmix_pct: int = -1    # -1 = inherit --rwmixpct
    slo_ms: float = 0.0    # per-class SLO latency target in ms (goodput
                           # grading); 0 = inherit --slotarget


def parse_tenant_spec(spec: str) -> list[TenantSpec]:
    """Parse the --tenants grammar, refusing every malformed input with a
    cause (unknown key, bad number, duplicate class name, empty class)."""
    classes: list[TenantSpec] = []
    seen: set[str] = set()
    for i, part in enumerate(p for p in spec.split(";") if p.strip()):
        part = part.strip()
        name, _, body = part.partition(":")
        name = name.strip()
        if not name or not body.strip():
            raise ProgException(
                f"--tenants class {i}: expected 'name:rate=R[,bs=SIZE]"
                f"[,rwmix=PCT]', got {part!r}")
        if name in seen:
            raise ProgException(f"--tenants: duplicate class name {name!r}")
        seen.add(name)
        t = TenantSpec(name=name)
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, _, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            try:
                if key == "rate":
                    t.rate = float(val)
                elif key == "bs":
                    t.block_size = parse_size(val)
                elif key == "rwmix":
                    t.rwmix_pct = int(val)
                elif key == "slo":
                    t.slo_ms = float(val)
                else:
                    raise ProgException(
                        f"--tenants class {name!r}: unknown key {key!r} "
                        "(expected rate, bs, rwmix, slo)")
            except ValueError:
                raise ProgException(
                    f"--tenants class {name!r}: bad value for {key}: "
                    f"{val!r}")
        classes.append(t)
    if not classes:
        raise ProgException("--tenants: no classes parsed")
    return classes


@dataclass
class BenchPathInfo:
    """Service's reply about its local bench paths (consistency checking).

    Reference: BenchPathInfo struct, Common.h:105-113."""

    path_type: int = int(BenchPathType.DIR)
    num_paths: int = 0
    file_size: int = 0

    def to_wire(self) -> dict:
        return {"BenchPathType": self.path_type, "NumBenchPaths": self.num_paths,
                "FileSize": self.file_size}

    @classmethod
    def from_wire(cls, d: dict) -> "BenchPathInfo":
        return cls(int(d.get("BenchPathType", 0)), int(d.get("NumBenchPaths", 0)),
                   int(d.get("FileSize", 0)))


@dataclass
class Config:
    # bench paths
    paths: list[str] = field(default_factory=list)
    path_type: BenchPathType = BenchPathType.DIR

    # workload geometry
    num_threads: int = 1
    num_dataset_threads: int = 1  # threads x hosts when dataset is shared
    num_dirs: int = 1
    num_files: int = 1
    file_size: int = 0
    block_size: int = 1 << 20

    # phases to run
    run_create_dirs: bool = False
    run_create_files: bool = False
    run_read: bool = False
    run_stat_files: bool = False
    run_delete_files: bool = False
    run_delete_dirs: bool = False
    run_sync: bool = False
    run_drop_caches: bool = False

    # I/O behavior
    use_direct_io: bool = False
    iodepth: int = 1
    use_io_uring: bool = False  # legacy --iouring spelling: pins io_engine
                                # to "uring" (kept for compatibility)
    io_engine: str = "auto"  # async block-loop backend (--ioengine):
                             # "auto" probes io_uring at engine init and
                             # falls back to kernel AIO with a logged
                             # cause; "uring"/"aio" pin the backend
    uring_sqpoll: bool = False  # --uringsqpoll: SQPOLL submission (kernel
                                # poller consumes the SQ ring; syscall only
                                # on NEED_WAKEUP)
    use_random_offsets: bool = False
    use_random_aligned: bool = False
    random_amount: int = 0
    do_truncate: bool = False
    do_trunc_to_size: bool = False
    do_prealloc: bool = False
    do_dir_sharing: bool = False
    verify_salt: int = 0
    do_verify_direct: bool = False
    block_variance_pct: int = 0
    rwmix_pct: int = 0
    block_variance_algo: str = "fast"
    rand_offset_algo: str = "balanced"
    ignore_del_errors: bool = False
    ignore_0usec_errors: bool = False  # suppress sub-µs-completion warning
    time_limit_secs: int = 0

    # TPU data path (replaces the reference's CUDA/cuFile block)
    tpu_ids: list[int] = field(default_factory=list)
    tpu_backend_name: str = ""  # "", "hostsim", "staged", "direct", "pjrt"
    assign_tpu_per_service: bool = False
    tpu_stripe: bool = False  # stripe each block's chunks across all devices
    tpu_host_verify: bool = False  # force --verify checks on the host even
                                   # when blocks are staged into HBM
    reg_window: int = 0  # --regwindow: byte budget of the native path's
                         # pinned-registration (DmaMap) LRU window cache;
                         # 0 = auto (a small multiple of iodepth x
                         # block_size, floored for small configs)
    d2h_depth: int = 0  # --d2hdepth: write-phase deferred-D2H fetch depth
                        # on the native pjrt backend. 0 = auto (= iodepth),
                        # 1 = serial fetch-then-write (the A/B control),
                        # > 1 = pipelined (device fetches overlap storage
                        # writes; the await moves to a pre-write barrier)
    checkpoint_manifest: str = ""  # --checkpoint: path to a JSON manifest
                                   # of shard files with explicit
                                   # per-device placement — runs the
                                   # RESTORE phase (native
                                   # kPhaseCheckpointRestore), whose clock
                                   # is time-to-all-devices-resident
    checkpoint_shards: int = 0  # --checkpoint-shards N: generate an
                                # N-shard manifest (ckpt.shard.<i> under
                                # the bench directory, device i % ndev,
                                # -s bytes each; -w creates the files at
                                # prepare)
    # parsed/generated manifest (checkpoint.CheckpointShard list) —
    # derived state, never on the wire (services re-derive it from the
    # two fields above against their local filesystem)
    ckpt_shards: list = field(default_factory=list, repr=False)
    reshard_devices: int = 0  # --reshard M: topology-shift restore — the
                              # manifest's N-device placement is resharded
                              # onto the first M devices of the live
                              # selection (RESHARD phase, native
                              # kPhaseReshard): already-resident units are
                              # no-ops, moves ride the device<->device D2D
                              # HBM tier, sourceless units read storage.
                              # 0 = plain restore (no reshard).
    # the diffed N->M plan (checkpoint.ReshardUnit list) — derived state,
    # never on the wire (services re-plan from the manifest + M against
    # their locally resolved device count, same rule as ckpt_shards)
    reshard_units: list = field(default_factory=list, repr=False)
    # DL-ingestion scenario (docs/INGEST.md): shuffled small-record reads
    # over sharded dataset files, multi-epoch pipelined prefetch — runs
    # the INGEST phase (native kPhaseIngest)
    ingest_manifest: str = ""  # --ingest: record-index manifest path
    ingest_shards: int = 0  # --ingestshards N: generated data.shard.<i>
                            # dataset under the bench directory (-s bytes
                            # each; -w creates the files at prepare)
    record_size: int = 0  # --recordsize: bytes per record; must divide
                          # --block (records batch into blocks) and the
                          # shard size
    shuffle_window: int = 0  # --shufflewindow: bounded per-epoch shuffle
                             # window in records (window-local
                             # Fisher-Yates; 1 = exact sequential order,
                             # the A/B control). 0 = default 1024.
    shuffle_seed: int = 1  # --shuffleseed: run-level shuffle seed (order
                           # is a pure function of seed/epoch/rank)
    ingest_epochs: int = 0  # --epochs: passes over the dataset (0 = 1)
    prefetch_batches: int = 0  # --prefetchbatches: batch-pipeline depth
                               # over the worker's buffer pool (0 = the
                               # whole pool; 1 = serial A/B)
    # parsed/generated dataset (ingest.IngestShard list) — derived state,
    # never on the wire (services re-derive it against their local
    # filesystem, same rule as ckpt_shards)
    ingest_dataset: list = field(default_factory=list, repr=False)
    # open-loop load generation (docs/OPEN_LOOP.md)
    arrival_mode: str = ""  # --arrival: "" = closed loop (default);
                            # "poisson" = exponential inter-arrival times,
                            # "paced" = fixed 1/rate gaps. Open modes issue
                            # ops on a virtual-time schedule and measure
                            # latency from the SCHEDULED arrival, so
                            # queueing delay (coordinated omission) counts.
    arrival_rate: float = 0.0  # --rate: arrivals/s PER WORKER (tenant
                               # class rates override it per class)
    tenants_spec: str = ""  # --tenants: K traffic classes,
                            # "name:rate=R[,bs=SIZE][,rwmix=PCT];..." —
                            # workers map rank % K; separate per-class
                            # latency histograms + TenantStats counters
    # parsed tenant classes (TenantSpec list) — derived state, never on
    # the wire (services re-parse tenants_spec in check_args)
    tenant_classes: list = field(default_factory=list, repr=False)
    # Serving-fleet workload (--arrival trace / --rotate, docs/SERVING.md):
    # rate_trace is the master-local --ratetrace FILE; its VALIDATED
    # canonical JSON (rate_trace_json) is what crosses the wire, so every
    # service host samples the same schedule. trace_schedule is the parsed
    # RateTrace (derived, never wired).
    rate_trace: str = ""
    rate_trace_json: str = ""
    trace_schedule: object = field(default=None, repr=False)
    rotate_period_s: float = 0.0  # --rotate: re-restore the --checkpoint
                                  # manifest every SECS into the inactive
                                  # generation of a double-buffered shard
                                  # set while the read phase serves (swap
                                  # at the all-resident barrier, repeat)
    bg_budget: int = 0  # --bgbudget: background (rotation) byte/s budget —
                        # token buckets at the storage hot loop and the
                        # per-device lanes pace restore I/O under it
                        # (0 = unthrottled)
    bg_adapt_lag_ms: int = 0  # --bgadapt: adaptive mode — halve the
                              # background rate whenever the foreground
                              # accrues more than MS of new sched_lag per
                              # wall second, re-raise toward the --bgbudget
                              # ceiling when it stops (requires --bgbudget)
    slo_target_ms: float = 0.0  # --slotarget: SLO latency target in ms —
                                # per-class goodput = fraction of
                                # completions under it on the scheduled-
                                # arrival clock (per-class slo= overrides)
    # fault tolerance (docs/FAULT_TOLERANCE.md)
    retry_max: int = 0  # --retry: bounded exponential-backoff retries per
                        # block op (storage I/O in the engine; the device
                        # layer walks survivor lanes with the same bound)
    retry_backoff_ms: int = 10  # --retrybackoff: backoff base in ms
                                # (exponential with jitter, capped at 2s)
    max_errors_spec: str = "0"  # --maxerrors: error budget. "0" (default)
                                # keeps the first-error abort; "<n>"
                                # tolerates n failed ops phase-wide; "<p>%"
                                # tolerates failures up to p percent of
                                # attempted ops. Parsed into max_errors /
                                # max_errors_pct by check_args.
    max_errors: int = 0       # derived: absolute budget (0 = none)
    max_errors_pct: int = 0   # derived: percentage budget (0 = none)
    chaos_spec: str = ""  # --chaos: fault-injection campaign spec
                          # ("seam=prob[,seam=prob...][,seed=N]",
                          # elbencho_tpu_torch/chaos.py grammar) — arms the
                          # EBT_MOCK_* fault seams at derived injection
                          # points before the engine/native path start.
                          # Master-local: services are not armed over the
                          # wire (chaos drives in-process mock seams).
    stripe_policy: str = ""  # --stripe: mesh-striped HBM fill. "" = off;
                             # "rr" round-robins stripe units over ALL
                             # selected devices, "contig" gives each device
                             # one contiguous run — a file's block range
                             # fills the whole device set's HBM as one
                             # coordinated transfer (native planner +
                             # scatter + direction-8 gather barrier on
                             # pjrt; device_put-over-a-sharding-tree
                             # fallback on the staged backend)

    # stats / output
    show_latency: bool = False
    show_lat_percentiles: bool = False
    num_latency_percentile_9s: int = 0
    show_lat_histogram: bool = False
    show_all_elapsed: bool = False
    show_cpu_util: bool = False
    disable_live_stats: bool = False
    live_stats_sleep_sec: float = 2.0
    results_file: str = ""
    csv_file: str = ""
    no_csv_labels: bool = False
    span_file: str = ""  # --spanfile: the port's spans as Chrome trace-event
                         # JSON (elbencho_tpu_torch/spans.py); master-local,
                         # never on the wire
    log_level: int = 1

    # distributed / service mode
    hosts: list[str] = field(default_factory=list)
    run_as_service: bool = False
    service_in_foreground: bool = False
    service_port: int = SERVICE_DEFAULT_PORT
    interrupt_services: bool = False
    quit_services: bool = False
    no_shared_service_path: bool = False
    rank_offset: int = 0
    svc_update_interval_ms: int = 500
    start_time: int = 0
    svc_fanout: int = 32  # --svcfanout: bounded parallelism of the
                          # master's prepare/start/status fan-out (pod
                          # scale: hundreds of hosts never spawn hundreds
                          # of concurrent requests/threads)
    host_timeout_secs: float = 30.0  # --hosttimeout: a service host that
                                     # produces no successful status reply
                                     # for this long is declared dead/hung
                                     # with a host-attributed cause instead
                                     # of blocking the whole phase

    # live streaming observability (docs/CAMPAIGNS.md): --metricsport
    # starts a Prometheus-text /metrics listener on the master/local
    # coordinator (the service daemon serves /metrics on its benchmark
    # port without any flag; 0 = off)
    metrics_port: int = 0
    # campaign stage labels (docs/CAMPAIGNS.md): set programmatically by
    # the campaign engine per stage, fanned to service hosts over the
    # wire so every host's /metrics scrape names the campaign + stage it
    # is serving (no CLI flag — stages are declared in the spec file)
    campaign_name: str = ""
    campaign_stage: str = ""

    # misc
    zones: list[int] = field(default_factory=list)  # CPU/NUMA binding request
    # --numazones: worker -> NUMA node binding (local rank % list length),
    # NumaTk-backed — thread affinity + preferred memory policy, buffer
    # pools and regwindow spans mbind-pinned to the worker's node, with
    # NumaStats placement evidence. Unlike --zones (which refuses unknown
    # ids), a node a host doesn't have is an INERT logged-once fallback:
    # one pod-wide zone file must work across heterogeneous hosts.
    numa_zones: list[int] = field(default_factory=list)
    # explicit --datasetthreads override (reference: ARG_NUMDATASETTHREADS,
    # ProgArgs.h:66 — internal wire field, but settable for custom rank math);
    # None = not given (0 is rejected, not treated as unset)
    explicit_dataset_threads: int | None = None

    def __post_init__(self) -> None:
        self._derive()

    # ------------------------------------------------------------------ util

    def _derive(self) -> None:
        if not self.num_dataset_threads:
            self.num_dataset_threads = self.num_threads

    def _derive_dataset_threads(self) -> None:
        """Dataset-thread derivation — master mode spans all service hosts unless
        private (reference: --nosvcshare -> numDataSetThreads = threads x
        hosts or just threads, ProgArgs.cpp:443-444). ONE copy: the shard/
        block partition must never diverge between scenarios."""
        if self.explicit_dataset_threads is not None and \
                self.explicit_dataset_threads < 1:
            raise ProgException("--datasetthreads must be >= 1")
        if self.explicit_dataset_threads:
            self.num_dataset_threads = self.explicit_dataset_threads
        elif self.hosts and not self.no_shared_service_path:
            self.num_dataset_threads = self.num_threads * len(self.hosts)
        else:
            self.num_dataset_threads = self.num_threads

    def _check_io_loop_args(self) -> None:
        """Thread/iodepth normalization + the io_uring backend-selection
        rules, shared by the standard and checkpoint validation paths."""
        if self.num_threads < 1:
            self.num_threads = 1
        if self.iodepth < 1:
            self.iodepth = 1
        # --iouring is the legacy spelling of --ioengine uring
        if self.use_io_uring:
            if self.io_engine == "aio":
                raise ProgException(
                    "--iouring and --ioengine aio contradict each other")
            self.io_engine = "uring"
        if self.io_engine not in ("auto", "uring", "aio"):
            raise ProgException(
                f"unknown --ioengine {self.io_engine!r} "
                "(choices: auto, uring, aio)")
        if self.io_engine == "uring" and self.iodepth <= 1:
            raise ProgException(
                "--ioengine uring (or --iouring) selects the async block "
                "loop backend and needs --iodepth > 1")
        if self.uring_sqpoll and self.io_engine == "aio":
            raise ProgException(
                "--uringsqpoll is an io_uring submission mode and "
                "contradicts --ioengine aio")
        if self.uring_sqpoll and self.iodepth <= 1:
            raise ProgException(
                "--uringsqpoll needs the async block loop (--iodepth > 1)")

    @property
    def fault_tolerant(self) -> bool:
        """True when an error budget is configured (--maxerrors nonzero):
        failures past exhausted retries are counted and attributed instead
        of aborting, and device lanes whose budget trips are ejected with
        the remaining work replanned onto survivors."""
        return self.max_errors > 0 or self.max_errors_pct > 0

    def effective_reg_window(self) -> int:
        """The --regwindow byte budget the pjrt backend will actually use:
        the explicit value, or the default (a small multiple of the
        in-flight window, floored so small configs never thrash)."""
        return self.reg_window or max(
            4 * max(1, self.iodepth) * self.block_size, 64 << 20)

    def _check_fault_args(self) -> None:
        """Fault-tolerance validation (--retry/--retrybackoff/--maxerrors/
        --chaos, docs/FAULT_TOLERANCE.md), shared by the standard and
        checkpoint validation paths. Every malformed spec is refused with
        a cause; the parsed budget lands in max_errors / max_errors_pct."""
        if self.retry_max < 0:
            raise ProgException("--retry must be >= 0")
        if self.retry_backoff_ms < 0:
            raise ProgException("--retrybackoff must be >= 0 ms")
        spec = (self.max_errors_spec or "0").strip()
        self.max_errors = 0
        self.max_errors_pct = 0
        try:
            if spec.endswith("%"):
                pct = int(spec[:-1])
                if not 0 <= pct <= 100:
                    raise ValueError
                self.max_errors_pct = pct
            else:
                n = int(spec)
                if n < 0:
                    raise ValueError
                self.max_errors = n
        except ValueError:
            raise ProgException(
                f"--maxerrors {spec!r}: expected a count >= 0 or a "
                "percentage 0-100 like '5%'")
        if self.chaos_spec:
            # parse for refusal-with-cause at config time; the env arming
            # itself happens at worker-group prepare (chaos.arm_chaos)
            from .chaos import parse_chaos_spec

            parse_chaos_spec(self.chaos_spec)
            if self.hosts:
                # the seams are in-process env reads armed at the LOCAL
                # worker group's prepare; a master cannot arm a service's
                # process, so accepting the flag here would run a "chaos"
                # campaign that injects nothing — refuse instead of
                # silently passing clean
                raise ProgException(
                    "--chaos is master-local (the fault seams are "
                    "in-process env reads) and cannot arm remote "
                    "services; run the campaign on each host")

    def _check_load_args(self) -> None:
        """Open-loop load-generation validation (--arrival/--rate/
        --tenants, docs/OPEN_LOOP.md). Every malformed spec is refused with
        a cause at config time; the parsed classes land in
        self.tenant_classes (services re-parse from tenants_spec, which is
        what crosses the wire)."""
        self.tenant_classes = []
        self.trace_schedule = None
        if self.arrival_mode and self.arrival_mode not in ("poisson",
                                                           "paced",
                                                           "trace"):
            raise ProgException(
                f"unknown --arrival mode: {self.arrival_mode} "
                "(expected poisson, paced or trace)")
        if self.arrival_rate < 0:
            raise ProgException("--rate must be >= 0")
        if (self.arrival_rate or self.tenants_spec) and not self.arrival_mode:
            raise ProgException(
                "--rate/--tenants define an open-loop schedule and need "
                "--arrival poisson|paced|trace")
        if (self.rate_trace or self.rate_trace_json) and \
                self.arrival_mode != "trace":
            raise ProgException(
                "--ratetrace is the --arrival trace schedule; it needs "
                "--arrival trace")
        if self.slo_target_ms < 0:
            raise ProgException("--slotarget must be >= 0")
        if not self.arrival_mode:
            return
        if self.arrival_mode == "trace":
            # the piecewise schedule OWNS the rates: parse + canonicalize
            # the file on the master, re-parse the canonical JSON on
            # service hosts (that is what crossed the wire), and refuse
            # every malformed input with a cause (docs/SERVING.md grammar)
            from .serving import load_rate_trace, parse_rate_trace
            if not (self.rate_trace or self.rate_trace_json):
                raise ProgException(
                    "--arrival trace needs --ratetrace FILE (the "
                    "piecewise rate schedule)")
            if self.rate_trace:
                self.trace_schedule = load_rate_trace(self.rate_trace)
                self.rate_trace_json = self.trace_schedule.to_json()
            else:
                self.trace_schedule = parse_rate_trace(
                    self.rate_trace_json, "wire")
        if self.tenants_spec:
            self.tenant_classes = parse_tenant_spec(self.tenants_spec)
        if self.trace_schedule is not None:
            names = {t.name for t in self.tenant_classes}
            for name in self.trace_schedule.tenants:
                if name not in names:
                    raise ProgException(
                        f"--ratetrace names tenant {name!r} but --tenants "
                        "defines no such class")
        for t in self.tenant_classes:
            if t.rate <= 0 and self.arrival_rate <= 0 and \
                    self.arrival_mode != "trace":
                raise ProgException(
                    f"--tenants class {t.name!r} has no rate and no "
                    "--rate fallback: every class needs a positive "
                    "arrival rate")
            if t.slo_ms < 0:
                raise ProgException(
                    f"--tenants class {t.name!r}: slo must be >= 0")
            if t.block_size:
                if t.block_size > self.block_size or \
                        self.block_size % t.block_size:
                    # classes share the --block-sized buffer pool and the
                    # global block partition grid: a class size must tile
                    # a --block exactly or ranges would overlap/misalign
                    raise ProgException(
                        f"--tenants class {t.name!r}: bs={t.block_size} "
                        f"must divide --block ({self.block_size})")
                if self.use_direct_io and t.block_size % 512:
                    raise ProgException(
                        f"--tenants class {t.name!r}: direct I/O needs a "
                        "block size that is a multiple of 512")
            if t.rwmix_pct >= 0 and not 0 <= t.rwmix_pct <= 100:
                raise ProgException(
                    f"--tenants class {t.name!r}: rwmix must be between "
                    "0 and 100")
            if t.rwmix_pct > 0 and self.verify_salt:
                raise ProgException(
                    "--verify and --tenants rwmix are incompatible (same "
                    "rule as --rwmixpct)")
            if t.rwmix_pct > 0 and self.run_create_files and \
                    self.path_type == BenchPathType.FILE:
                # same auto-correction as the global --rwmixpct: mixed
                # reads during the write phase touch not-yet-written
                # regions, so the file is extended up front
                self.do_trunc_to_size = True
        if not self.tenant_classes and self.arrival_rate <= 0 and \
                self.arrival_mode != "trace":
            raise ProgException(
                "--arrival needs an arrival rate: give --rate (per worker) "
                "or a --tenants spec with per-class rates")
        if self.tenant_classes and \
                len(self.tenant_classes) > self.num_dataset_threads:
            raise ProgException(
                f"--tenants defines {len(self.tenant_classes)} classes "
                f"but only {self.num_dataset_threads} dataset thread(s) "
                "exist to serve them (classes map rank % K; an unserved "
                "class would silently report zero traffic)")

    @property
    def tpu_backend(self) -> DevBackend:
        if not self.tpu_backend_name:
            return DevBackend.NONE
        if self.tpu_backend_name == "hostsim":
            return DevBackend.HOSTSIM
        # staged/direct (PyTorch, cuda/backend.py) and pjrt (native C++
        # CUDA engine, csrc/cuda_path.cpp)
        return DevBackend.CALLBACK

    def selected_phases(self) -> list[BenchPhase]:
        """Ordered phase sequence (reference: Coordinator::runBenchmarks order,
        Coordinator.cpp:190-231)."""
        if (self.checkpoint_manifest or self.checkpoint_shards) and \
                not self.rotate_period_s:
            # the checkpoint scenario is its own ordered sequence: shard
            # creation (generated mode with -w) happens at prepare, and the
            # only measured phase is the restore — or, with --reshard M,
            # the topology-shift RESHARD (the N->M plan executed against
            # the preloaded N-device pre-state). With --rotate the
            # manifest is the rotation payload instead and the measured
            # phase is the ordinary serving READ below.
            if self.reshard_devices:
                return [BenchPhase.RESHARD]
            return [BenchPhase.CHECKPOINT]
        if self.ingest_manifest or self.ingest_shards:
            # same rule for the ingest scenario: dataset creation
            # (generated mode with -w) happens at prepare; the measured
            # phase is the multi-epoch ingest itself
            return [BenchPhase.INGEST]
        phases: list[BenchPhase] = []
        if self.run_sync:
            pass  # sync/dropcache interleave handled by coordinator
        if self.run_create_dirs:
            phases.append(BenchPhase.CREATEDIRS)
        if self.run_create_files:
            phases.append(BenchPhase.CREATEFILES)
        if self.run_stat_files:
            phases.append(BenchPhase.STATFILES)
        if self.run_read:
            phases.append(BenchPhase.READFILES)
        if self.run_delete_files:
            phases.append(BenchPhase.DELETEFILES)
        if self.run_delete_dirs:
            phases.append(BenchPhase.DELETEDIRS)
        return phases

    # ------------------------------------------------------------ validation

    def check_args(self) -> None:
        """Cross-argument validation & auto-correction
        (reference: ProgArgs::checkArgs + checkPathDependentArgs,
        ProgArgs.cpp:390-631)."""
        if not 0 <= self.metrics_port <= 65535:
            raise ProgException(
                f"--metricsport {self.metrics_port}: not a valid TCP port "
                "(0 disables, 1-65535 serve)")
        if self.metrics_port and self.run_as_service:
            raise ProgException(
                "--metricsport is a master/local-mode flag: a service "
                "daemon already serves /metrics on its benchmark port "
                "(--port)")

        if self.run_as_service:
            self.num_dataset_threads = self.num_threads
            return  # full validation happens when the master's config arrives

        if self.interrupt_services or self.quit_services:
            if not self.hosts:
                raise ProgException(
                    "--interrupt/--quit require --hosts to know whom to signal")
            return

        if (self.checkpoint_manifest or self.checkpoint_shards) and \
                (self.ingest_manifest or self.ingest_shards):
            raise ProgException(
                "--checkpoint and --ingest are mutually exclusive "
                "scenarios (each owns the phase sequence)")
        if self.reshard_devices and not (self.checkpoint_manifest or
                                         self.checkpoint_shards):
            # the reshard plan diffs the manifest's placement — without
            # one there is no N-device pre-state to reshard
            raise ProgException(
                "--reshard requires a --checkpoint/--checkpoint-shards "
                "manifest (the N-device placement being resharded)")
        if not (self.ingest_manifest or self.ingest_shards) and (
                self.record_size or self.shuffle_window or
                self.shuffle_seed != 1 or self.ingest_epochs or
                self.prefetch_batches):
            # without the scenario these knobs would be silently ignored —
            # checked BEFORE the scenario dispatches so --checkpoint (or
            # any later scenario) cannot swallow them either
            raise ProgException(
                "--recordsize/--shufflewindow/--shuffleseed/--epochs/"
                "--prefetchbatches require the --ingest/--ingestshards "
                "scenario")
        if self.rotate_period_s < 0:
            raise ProgException("--rotate must be >= 0 seconds")
        if (self.bg_budget or self.bg_adapt_lag_ms) and \
                not self.rotate_period_s:
            raise ProgException(
                "--bgbudget/--bgadapt pace the --rotate background "
                "restore; add --rotate SECS")
        if self.bg_adapt_lag_ms and not self.bg_budget:
            raise ProgException(
                "--bgadapt adapts the background rate BELOW the "
                "--bgbudget ceiling; set --bgbudget too")
        if self.bg_budget < 0 or self.bg_adapt_lag_ms < 0:
            raise ProgException("--bgbudget/--bgadapt must be >= 0")

        if self.rotate_period_s:
            # serving under live model rotation (docs/SERVING.md): the
            # --checkpoint manifest is the ROTATION payload; the measured
            # phase is the ordinary (open-loop) read workload, so
            # validation FALLS THROUGH to the standard file-mode path
            self._check_serving_args()
        elif self.checkpoint_manifest or self.checkpoint_shards:
            self._check_checkpoint_args()
            return

        if self.ingest_manifest or self.ingest_shards:
            self._check_ingest_args()
            return

        if not self.paths:
            raise ProgException("at least one benchmark path is required")

        if self.num_threads < 1:
            self.num_threads = 1
        self._derive_dataset_threads()

        self.detect_path_type()

        if self.path_type != BenchPathType.DIR:
            self._prepare_file_size()
            self._check_file_size_fits()

        if self.block_size > self.file_size and self.file_size:
            # clamp block size to file size (reference auto-correction)
            self.block_size = self.file_size
        if self.file_size and not self.block_size:
            raise ProgException("block size must be > 0 when file size is set")

        if self.use_direct_io and self.block_size % 512:
            raise ProgException(
                "direct I/O requires the block size to be a multiple of 512")
        if self.use_direct_io and self.use_random_offsets and \
                not self.use_random_aligned:
            # O_DIRECT at unaligned offsets returns EINVAL; auto-align like
            # the reference's direct-I/O auto-correction
            self.use_random_aligned = True

        if self.use_random_offsets and self.path_type == BenchPathType.DIR:
            raise ProgException(
                "random offsets are not supported in directory mode")

        if self.use_random_offsets and not self.random_amount:
            self.random_amount = self.file_size * max(1, len(self.paths))

        if self.use_random_offsets and self.random_amount:
            # round the per-rank share down to full blocks; keep at least 1
            per_rank = self.random_amount // self.num_dataset_threads
            per_rank -= per_rank % max(1, self.block_size)
            if not per_rank:
                raise ProgException(
                    "--randamount too small: less than one block per thread")

        if self.verify_salt and self.use_random_offsets and not self.use_random_aligned:
            raise ProgException(
                "--verify requires block-aligned access (use --randalign)")
        if self.verify_salt and self.block_variance_pct:
            raise ProgException("--verify and --blockvarpct are incompatible")
        if self.verify_salt and self.rwmix_pct:
            raise ProgException("--verify and --rwmixpct are incompatible")
        if self.rwmix_pct and not (0 <= self.rwmix_pct <= 100):
            raise ProgException("--rwmixpct must be between 0 and 100")
        if self.rwmix_pct and self.run_create_files and \
                self.path_type == BenchPathType.FILE:
            # mixed reads during the write phase touch not-yet-written regions;
            # extend the file up front so those reads return zeros instead of
            # failing short at EOF
            self.do_trunc_to_size = True
        if self.block_variance_pct and not (0 <= self.block_variance_pct <= 100):
            raise ProgException("--blockvarpct must be between 0 and 100")

        if self.block_variance_algo not in RAND_ALGO_NAMES:
            raise ProgException(f"unknown --blockvaralgo: {self.block_variance_algo}")
        if self.rand_offset_algo not in RAND_ALGO_NAMES:
            raise ProgException(f"unknown --randalgo: {self.rand_offset_algo}")

        if self.tpu_backend_name and \
                self.tpu_backend_name not in TPU_BACKEND_NAMES:
            raise ProgException(
                f"unknown --tpubackend: {self.tpu_backend_name} "
                f"(expected {', '.join(TPU_BACKEND_NAMES)})")
        if self.tpu_ids and not self.tpu_backend_name:
            self.tpu_backend_name = "staged"  # gpuids implies the staged path
        if self.tpu_stripe and self.tpu_backend_name not in ("staged", "direct",
                                                             "pjrt"):
            # hostsim never constructs the staging path, so striping there
            # would be silently ignored - reject instead
            raise ProgException(
                "--tpustripe requires the staged or direct TPU backend "
                "(--gpuids and/or --tpubackend staged|direct)")
        if self.reg_window and self.tpu_backend_name != "pjrt":
            # the registration window governs the native path's pin cache;
            # on any other backend it would be silently ignored
            raise ProgException(
                "--regwindow requires the native pjrt backend "
                "(--tpubackend pjrt)")
        if self.d2h_depth < 0:
            raise ProgException("--d2hdepth must be >= 0 (0 = auto)")
        if self.d2h_depth and self.tpu_backend_name != "pjrt":
            # the deferred fetch engine lives in the native path; any other
            # backend would silently ignore the depth
            raise ProgException(
                "--d2hdepth requires the native pjrt backend "
                "(--tpubackend pjrt)")
        if self.stripe_policy and self.stripe_policy not in ("rr", "contig"):
            raise ProgException(
                f"unknown --stripe policy: {self.stripe_policy} "
                "(expected rr or contig)")
        if self.stripe_policy and self.tpu_backend_name not in ("pjrt",
                                                                "staged"):
            # the planner/scatter/gather subsystem lives in the native
            # path; the staged backend gets the mesh fallback — anywhere
            # else the flag would be silently ignored
            raise ProgException(
                "--stripe requires the native pjrt backend or the staged "
                "mesh fallback (--tpubackend pjrt|staged)")
        if self.stripe_policy and self.tpu_stripe:
            # the per-chunk scatter re-routes each chunk of a planner-placed
            # block to a different device — it would silently break the
            # plan's placement contract
            raise ProgException(
                "--stripe (block-range planner) and --tpustripe "
                "(per-chunk scatter) are mutually exclusive")
        if self.stripe_policy and self.path_type == BenchPathType.DIR:
            raise ProgException(
                "--stripe operates on a file's block range; directory "
                "mode has no block range to stripe")
        if self.stripe_policy and self.tpu_backend_name == "pjrt":
            # alignment refusal: a stripe unit must never split a
            # --regwindow registration span (the unit is sized to whole
            # spans, so the span itself must be a whole multiple of the
            # block — otherwise a window eviction could unpin memory
            # another device's unit still rides)
            span = self.stripe_reg_span_bytes()
            if span % self.block_size:
                raise ProgException(
                    f"--stripe with --block {self.block_size} would split "
                    f"a {span}-byte registration span (span % block != 0); "
                    "choose a block size that divides the span, or adjust "
                    "--regwindow so the span is a whole multiple of the "
                    "block")
        if self.reg_window and self.reg_window < 2 * self.block_size:
            # the window cache keeps the current and next span pinned: a
            # smaller budget would run the whole phase on the staged path
            raise ProgException(
                f"--regwindow ({self.reg_window}) must be at least 2x the "
                f"block size ({self.block_size}): the window cache keeps "
                "the current and next span pinned; a smaller budget would "
                "run the whole phase on the staged path")
        if self.path_type == BenchPathType.DIR and not self.file_size and \
                self.run_create_files:
            raise ProgException("-s/--size is required to write files in dir mode")

        if self.zones:
            # a zone id is valid if it names a NUMA node (preferred; binds
            # CPUs + memory, reference NumaTk.h:40-72) or, on hosts without
            # that node, falls back to a raw CPU id
            ncpus = os.cpu_count() or 1
            bad = [z for z in self.zones
                   if (z < 0 or z >= ncpus) and
                   not os.path.isdir(f"/sys/devices/system/node/node{z}")]
            if bad:
                raise ProgException(
                    f"--zones: id(s) {bad} match neither a NUMA node nor a "
                    f"CPU id (host has {ncpus} CPUs)")

        if self.numa_zones:
            # only structural validation here: negative ids can never name
            # a node, but a node THIS host lacks stays valid — binding is
            # an inert logged-once fallback at runtime (NumaTk), so one
            # pod-wide zone list works across heterogeneous hosts
            bad = [z for z in self.numa_zones if z < 0]
            if bad:
                raise ProgException(
                    f"--numazones: negative node id(s) {bad}")
            if self.zones:
                raise ProgException(
                    "--numazones and --zones are mutually exclusive: both "
                    "bind worker threads, and the last binding would "
                    "silently win")

        self._check_io_loop_args()
        if self.iodepth > 1 and self.path_type == BenchPathType.DIR and \
                self.use_random_offsets:
            raise ProgException("iodepth > 1 with random dir-mode is unsupported")
        # after block-size clamping and dataset-thread derivation: tenant
        # class geometry validates against the final --block / rank count
        self._check_load_args()
        self._check_fault_args()

    # ------------------------------------------- serving-rotation scenario

    def _check_serving_args(self) -> None:
        """Validation for the --rotate serving scenario (docs/SERVING.md):
        the --checkpoint manifest re-restored every period into a
        double-buffered shard set while the (open-loop) read phase serves.
        Deliberately NOT an early-return scenario: the serving workload IS
        an ordinary read phase, so check_args' standard file-mode
        validation still runs after this."""
        from .checkpoint import load_manifest, validate_placement

        if not self.checkpoint_manifest:
            raise ProgException(
                "--rotate re-restores a checkpoint and needs --checkpoint "
                "MANIFEST (the generated --checkpoint-shards mode owns the "
                "PATH argument, which serving needs for its bench files — "
                "write an explicit manifest instead)")
        if self.checkpoint_shards:
            raise ProgException(
                "--rotate needs an explicit --checkpoint MANIFEST; "
                "--checkpoint-shards (generated mode) owns the PATH "
                "argument, which serving needs for its bench files")
        if self.reshard_devices:
            raise ProgException(
                "--rotate and --reshard are mutually exclusive scenarios "
                "(each owns the checkpoint manifest's placement)")
        if not self.run_read:
            raise ProgException(
                "--rotate races a serving READ phase; add -r/--read")
        if self.run_create_dirs or self.run_delete_dirs or \
                self.run_stat_files or self.run_delete_files:
            raise ProgException(
                "--rotate serves the read phase only; drop the dir/stat/"
                "delete phases")
        if self.tpu_backend_name != "pjrt":
            # the rotation ledger (directions 16/17, double-buffered
            # retained generations, lane-side bg bucket) lives in the
            # native path
            raise ProgException(
                "--rotate requires the native pjrt backend "
                "(--tpubackend pjrt)")
        if self.verify_salt or self.do_verify_direct:
            raise ProgException(
                "--rotate restores arbitrary shard content; --verify/"
                "--verifydirect do not apply")
        if self.stripe_policy or self.tpu_stripe:
            raise ProgException(
                "--rotate and --stripe/--tpustripe are mutually "
                "exclusive: the manifest owns rotation placement")
        self.ckpt_shards = load_manifest(self.checkpoint_manifest)
        ndev = len(self.tpu_ids) or None
        if ndev:
            validate_placement(self.ckpt_shards, ndev,
                               self.checkpoint_manifest)

    # ------------------------------------------- checkpoint-restore scenario

    def _check_checkpoint_args(self) -> None:
        """Validation for the --checkpoint / --checkpoint-shards restore
        scenario (docs/CHECKPOINT.md). Every malformed manifest input is
        refused here with a cause string — fail fast at config time, never
        mid-restore — and the parsed shard list lands in self.ckpt_shards
        (device-range placement re-checked at prepare against the native
        path's resolved device count)."""
        from .checkpoint import (generated_shards, load_manifest,
                                 validate_placement)

        if self.checkpoint_manifest and self.checkpoint_shards:
            raise ProgException(
                "--checkpoint (explicit manifest) and --checkpoint-shards "
                "(generated manifest) are mutually exclusive")
        self._check_io_loop_args()
        if self.tpu_backend_name != "pjrt":
            # the restore ledger (direction 9/10, per-shard reconciliation,
            # the all-resident barrier) lives in the native path; any other
            # backend would time storage reads, not time-to-resident
            raise ProgException(
                "--checkpoint requires the native pjrt backend "
                "(--tpubackend pjrt)")
        other_phases = [flag for flag, on in (
            ("-d/--mkdirs", self.run_create_dirs),
            ("-r/--read", self.run_read),
            ("--stat", self.run_stat_files),
            ("-F/--delfiles", self.run_delete_files),
            ("-D/--deldirs", self.run_delete_dirs)) if on]
        if other_phases:
            raise ProgException(
                "--checkpoint runs the RESTORE phase only; drop "
                + ", ".join(other_phases))
        if self.run_create_files and not self.checkpoint_shards:
            raise ProgException(
                "-w with --checkpoint would overwrite real checkpoint "
                "shards; shard creation (-w) is only supported with the "
                "generated --checkpoint-shards manifest")
        if self.use_random_offsets:
            raise ProgException(
                "--checkpoint restores shards as sequential reads; --rand "
                "does not apply")
        if self.stripe_policy or self.tpu_stripe:
            # the manifest owns direction-0 placement; a stripe planner
            # re-routing restore blocks would silently break it
            raise ProgException(
                "--checkpoint and --stripe/--tpustripe are mutually "
                "exclusive: the manifest owns block->device placement")
        if self.verify_salt or self.do_verify_direct:
            raise ProgException(
                "--checkpoint restores arbitrary shard content; --verify/"
                "--verifydirect do not apply")
        if self.arrival_mode or self.arrival_rate or self.tenants_spec:
            # the restore phase's clock is time-to-all-devices-resident,
            # not per-op latency; pacing shard reads would just distort it
            raise ProgException(
                "--checkpoint and --arrival/--rate/--tenants are mutually "
                "exclusive: the restore clock measures residency, not "
                "paced arrivals")
        if self.d2h_depth < 0:
            raise ProgException("--d2hdepth must be >= 0 (0 = auto)")
        self._check_fault_args()

        # dataset threads span service hosts (shards partition by global
        # rank % num_dataset_threads, like file-mode block ranges)
        self._derive_dataset_threads()

        ndev = len(self.tpu_ids) or None  # None = resolved at prepare
        if self.checkpoint_manifest:
            if self.paths:
                raise ProgException(
                    "--checkpoint MANIFEST takes its shard paths from the "
                    "manifest; drop the PATH argument(s)")
            self.ckpt_shards = load_manifest(self.checkpoint_manifest)
        else:
            if len(self.paths) != 1 or not os.path.isdir(self.paths[0]):
                raise ProgException(
                    "--checkpoint-shards needs exactly one existing "
                    "directory PATH for the generated shard files")
            self.ckpt_shards = generated_shards(
                self.paths[0], self.checkpoint_shards, self.file_size,
                ndev, must_exist=not self.run_create_files)
        if ndev and not self.reshard_devices:
            # under --reshard a manifest placing shards beyond the live
            # selection is the topology-shift input (the checkpoint's
            # slice was wider than this one): plan_reshard classifies
            # those sourceless shards as storage-read units
            validate_placement(
                self.ckpt_shards, ndev,
                self.checkpoint_manifest or "--checkpoint-shards")
        if self.reshard_devices:
            # structural --reshard checks at config time; the N->M plan is
            # diffed at prepare against the lanes the native path resolves
            if self.reshard_devices < 1:
                raise ProgException("--reshard must target >= 1 device")
            if ndev and self.reshard_devices > ndev:
                raise ProgException(
                    f"--reshard {self.reshard_devices} targets more "
                    f"devices than --gpuids selects ({ndev}); every "
                    "target lane must be live")
        self.path_type = BenchPathType.FILE
        if not self.block_size:
            raise ProgException("block size must be > 0 for --checkpoint")
        if self.reg_window and self.reg_window < 2 * self.block_size:
            raise ProgException(
                f"--regwindow ({self.reg_window}) must be at least 2x the "
                f"block size ({self.block_size}): the window cache keeps "
                "the current and next span pinned")

    def ckpt_total_bytes(self) -> int:
        """Total manifest bytes (each shard counted once — storage reads;
        replicated shards still read storage once per restore)."""
        return sum(s.bytes for s in self.ckpt_shards)

    # ------------------------------------------------- DL-ingestion scenario

    def _check_ingest_args(self) -> None:
        """Validation for the --ingest / --ingestshards training-input
        scenario (docs/INGEST.md). Every malformed spec is refused with a
        cause at config time — never mid-epoch — and the parsed dataset
        lands in self.ingest_dataset."""
        from .ingest import generated_dataset_shards, load_record_manifest

        if self.ingest_manifest and self.ingest_shards:
            raise ProgException(
                "--ingest (explicit manifest) and --ingestshards "
                "(generated dataset) are mutually exclusive")
        self._check_io_loop_args()
        if self.tpu_backend_name != "pjrt":
            # the ingest ledger (direction 11/12, per-epoch record
            # reconciliation, the all-resident barrier) lives in the
            # native path; any other backend would time storage reads,
            # not records-to-HBM
            raise ProgException(
                "--ingest requires the native pjrt backend "
                "(--tpubackend pjrt)")
        other_phases = [flag for flag, on in (
            ("-d/--mkdirs", self.run_create_dirs),
            ("-r/--read", self.run_read),
            ("--stat", self.run_stat_files),
            ("-F/--delfiles", self.run_delete_files),
            ("-D/--deldirs", self.run_delete_dirs)) if on]
        if other_phases:
            raise ProgException(
                "--ingest runs the INGEST phase only; drop "
                + ", ".join(other_phases))
        if self.run_create_files and not self.ingest_shards:
            raise ProgException(
                "-w with --ingest would overwrite real dataset shards; "
                "dataset creation (-w) is only supported with the "
                "generated --ingestshards dataset")
        if self.use_random_offsets:
            raise ProgException(
                "--ingest owns its access pattern (the seeded shuffle "
                "window); --rand does not apply")
        if self.stripe_policy or self.tpu_stripe:
            # ingest batches keep the rank-derived device routing so the
            # per-epoch per-device attribution stays meaningful; a stripe
            # planner re-routing them would silently break it
            raise ProgException(
                "--ingest and --stripe/--tpustripe are mutually "
                "exclusive: ingest batches keep the rank-derived device "
                "routing")
        if self.verify_salt or self.do_verify_direct:
            raise ProgException(
                "--ingest reads arbitrary dataset content; --verify/"
                "--verifydirect do not apply")
        self._check_fault_args()
        # open loop IS supported — ingestion runs as a tenant class so
        # epoch prefetch competes with other traffic under --arrival
        # (per-class bs/rwmix do not apply to the record loop; rates do)
        self._check_load_args()

        # dataset threads span service hosts (records partition by global
        # rank, contiguous ranges like file-mode block grids)
        self._derive_dataset_threads()

        if self.ingest_manifest:
            if self.paths:
                raise ProgException(
                    "--ingest MANIFEST takes its shard paths from the "
                    "manifest; drop the PATH argument(s)")
            shards, manifest_rs = load_record_manifest(self.ingest_manifest)
            if manifest_rs:
                if self.record_size and self.record_size != manifest_rs:
                    raise ProgException(
                        f"--recordsize ({self.record_size}) contradicts "
                        f"the manifest's record_size ({manifest_rs})")
                self.record_size = self.record_size or manifest_rs
            self.file_size = shards[0].bytes
        else:
            if len(self.paths) != 1 or not os.path.isdir(self.paths[0]):
                raise ProgException(
                    "--ingestshards needs exactly one existing directory "
                    "PATH for the generated dataset shard files")
            shards = generated_dataset_shards(
                self.paths[0], self.ingest_shards, self.file_size,
                must_exist=not self.run_create_files)
        self.ingest_dataset = shards
        self.path_type = BenchPathType.FILE

        if not self.record_size:
            raise ProgException(
                "--ingest needs --recordsize (or a manifest record_size): "
                "records are the workload's unit")
        if not self.block_size:
            raise ProgException("block size must be > 0 for --ingest")
        if self.record_size > self.block_size or \
                self.block_size % self.record_size:
            raise ProgException(
                f"--recordsize ({self.record_size}) must divide --block "
                f"({self.block_size}): records are batched into "
                "block-sized device submissions exactly")
        if self.file_size % self.record_size:
            raise ProgException(
                f"--ingest shard size ({self.file_size}) must be a whole "
                f"multiple of --recordsize ({self.record_size})")
        if self.use_direct_io and self.record_size % 512:
            # O_DIRECT preads need 512-aligned offsets/lengths; record
            # offsets and batch-buffer slots are record_size-strided, so
            # the record size itself must carry the alignment — refused
            # here (fail fast) instead of EINVAL-ing mid-epoch
            raise ProgException(
                "direct I/O requires --recordsize to be a multiple of "
                f"512 (got {self.record_size})")
        if self.shuffle_window < 0:
            raise ProgException("--shufflewindow must be >= 1")
        self.shuffle_window = self.shuffle_window or 1024
        self.ingest_epochs = self.ingest_epochs or 1
        if self.ingest_epochs < 1:
            raise ProgException("--epochs must be >= 1")
        if self.prefetch_batches < 0:
            raise ProgException(
                "--prefetchbatches must be >= 0 (0 = the whole buffer "
                "pool, 1 = serial A/B)")
        if self.reg_window and self.reg_window < 2 * self.block_size:
            raise ProgException(
                f"--regwindow ({self.reg_window}) must be at least 2x the "
                f"block size ({self.block_size}): the window cache keeps "
                "the current and next span pinned")

    @property
    def ingest_active(self) -> bool:
        """True when the --ingest/--ingestshards scenario is selected."""
        return bool(self.ingest_manifest or self.ingest_shards)

    def ingest_records_per_shard(self) -> int:
        return self.file_size // self.record_size if self.record_size else 0

    def ingest_total_records(self) -> int:
        """Records per epoch over the whole dataset (shards x
        records_per_shard) — the offered-work unit the bench grades."""
        return self.ingest_records_per_shard() * len(self.ingest_dataset)

    def ingest_paths(self) -> list[str]:
        """The dataset shard file paths the engine reads (ingest mode
        replaces the CLI PATH — a directory in generated mode, nothing in
        manifest mode — with the resolved shard list)."""
        return [sh.path for sh in self.ingest_dataset]

    # ------------------------------------------- striped-fill geometry
    #
    # Single source of truth for the numbers the native stripe planner is
    # configured with (workers/local.py) AND the alignment validation above
    # — a divergence between the two would validate one geometry and run
    # another.

    def stripe_reg_span_bytes(self) -> int:
        """The engine's registration-span size under this config (mirrors
        regSpanBytesFor in engine.cpp: at most half the --regwindow
        budget, at least one block, 16 MiB default, page-aligned). The
        mirror is pinned against the native formula by a test
        (ebt_reg_span_bytes) — a silent divergence would re-admit stripe
        units that split registration spans."""
        span = 16 << 20
        span = min(span, self.effective_reg_window() // 2)
        span = max(span, self.block_size)
        page = os.sysconf("SC_PAGE_SIZE")
        return (span + page - 1) & ~(page - 1)

    def stripe_unit_blocks(self, spans_active: bool = True) -> int:
        """Stripe-unit size in blocks: whole registration spans when the
        pin-cache span grid is in play (so a unit never splits a span),
        one block otherwise (staged fallback, or a driver without host
        registration — no spans exist to split)."""
        if not spans_active or self.tpu_backend_name != "pjrt":
            return 1
        return max(1, self.stripe_reg_span_bytes() // self.block_size)

    def stripe_total_blocks(self) -> int:
        """The striped fill's PER-FILE block range: the engine hands the
        planner file-LOCAL offsets (fileModeSeq: off = block-in-file x
        bs), so each bench path's range is striped across the full device
        set independently."""
        if not self.block_size:
            return 0
        return self.file_size // self.block_size

    def detect_path_type(self) -> None:
        """Classify bench paths (reference: findBenchPathType,
        ProgArgs.cpp:1188-1210). All paths must be of one type."""
        types = set()
        for p in self.paths:
            try:
                st = os.stat(p)
            except FileNotFoundError:
                # nonexistent: parent must exist; treat as a file to create
                parent = os.path.dirname(os.path.abspath(p)) or "."
                if not os.path.isdir(parent):
                    raise ProgException(f"bench path parent does not exist: {p}")
                types.add(BenchPathType.FILE)
                continue
            if stat_mod.S_ISDIR(st.st_mode):
                types.add(BenchPathType.DIR)
            elif stat_mod.S_ISBLK(st.st_mode):
                types.add(BenchPathType.BLOCKDEV)
            elif stat_mod.S_ISREG(st.st_mode):
                types.add(BenchPathType.FILE)
            else:
                raise ProgException(f"unsupported bench path type: {p}")
        if len(types) > 1:
            raise ProgException("all bench paths must have the same type")
        if types:
            self.path_type = types.pop()

    def _prepare_file_size(self) -> None:
        """Auto-detect file size for existing files/blockdevs when -s was not
        given (reference: prepareFileSize, ProgArgs.cpp:833-958)."""
        if self.file_size:
            return
        sizes = []
        for p in self.paths:
            try:
                if self.path_type == BenchPathType.BLOCKDEV:
                    with open(p, "rb") as f:
                        sizes.append(f.seek(0, os.SEEK_END))
                else:
                    sizes.append(os.stat(p).st_size)
            except OSError:
                sizes.append(0)
        detected = min(sizes) if sizes else 0
        if not detected:
            if self.run_create_files:
                raise ProgException(
                    "-s/--size is required to create new bench files")
            raise ProgException("could not detect file size; use -s/--size")
        self.file_size = detected

    def _check_file_size_fits(self) -> None:
        """Reject a given -s larger than an existing target that this run will
        not grow (reference: 'Given size to use is larger than detected size',
        ProgArgs.cpp:862,951). Write runs truncate/extend files to -s during
        preparation, so only read-only runs and block devices are checked.
        Without this, readers fail mid-phase (or fault on mapped pages past
        EOF in the zero-copy device path) instead of failing fast."""
        if not self.file_size:
            return
        grows_files = self.run_create_files and \
            self.path_type == BenchPathType.FILE
        if grows_files:
            return
        for p in self.paths:
            try:
                if self.path_type == BenchPathType.BLOCKDEV:
                    with open(p, "rb") as f:
                        detected = f.seek(0, os.SEEK_END)
                else:
                    detected = os.stat(p).st_size
            except OSError:
                continue  # missing file: surfaced at open time
            if detected < self.file_size:
                raise ProgException(
                    f"given -s/--size is larger than the detected size of "
                    f"'{p}' ({detected} bytes)")

    # ----------------------------------------------------- service marshalling

    def to_wire(self, host_index: int = 0) -> dict:
        """Serialize for the master -> service /preparephase fan-out.

        Per-host dynamic fields (reference: ProgArgs.cpp:1703-1758): rankoffset
        is host_index * num_threads (+ global rank_offset); TPU ids can be
        assigned round-robin per service with --gpuperservice."""
        d = {f: getattr(self, f) for f in _WIRE_FIELDS}
        d["paths"] = list(self.paths)
        d["rank_offset"] = self.rank_offset + host_index * self.num_threads
        if self.assign_tpu_per_service and self.tpu_ids:
            d["tpu_ids"] = [self.tpu_ids[host_index % len(self.tpu_ids)]]
        else:
            d["tpu_ids"] = list(self.tpu_ids)
        return d

    def apply_wire(self, d: dict) -> None:
        """Apply a master's config on the service side, honoring local path and
        TPU-id overrides (reference: setFromPropertyTree + the override rules in
        ProgArgs.cpp:404-421), then re-validate."""
        local_paths = list(self.paths)
        local_tpu_ids = list(self.tpu_ids)
        for f in _WIRE_FIELDS:
            if f in d:
                setattr(self, f, type(getattr(self, f))(d[f]))
        self.rank_offset = int(d.get("rank_offset", 0))
        self.paths = local_paths if local_paths else list(d.get("paths", []))
        self.tpu_ids = local_tpu_ids if local_tpu_ids else [
            int(x) for x in d.get("tpu_ids", [])]
        self.hosts = []
        self.run_as_service = False
        saved_ndt = int(d.get("num_dataset_threads", self.num_threads))
        # validate against the MASTER's pod-wide dataset-thread count, not
        # this host's local thread count: rank-%-K surfaces (tenant
        # classes, shard/block partitions) span the pod, and a service
        # re-deriving from its own num_threads would refuse configs the
        # master correctly validated (e.g. more --tenants classes than one
        # host's threads)
        self.explicit_dataset_threads = saved_ndt
        self.check_args()
        self.num_dataset_threads = saved_ndt  # master's value wins over local calc

    def bench_path_info(self) -> BenchPathInfo:
        return BenchPathInfo(int(self.path_type), len(self.paths), self.file_size)

    def check_service_bench_path_infos(self, infos: list[BenchPathInfo],
                                       hosts: list[str]) -> None:
        """Cross-service consistency check (reference: ProgArgs.cpp:1867-1954)."""
        if not infos:
            return
        first = infos[0]
        for host, info in zip(hosts[1:], infos[1:]):
            if info.path_type != first.path_type:
                raise ProgException(
                    f"service {host}: bench path type differs from {hosts[0]}")
            if info.num_paths != first.num_paths:
                raise ProgException(
                    f"service {host}: number of bench paths differs from {hosts[0]}")
            if info.file_size != first.file_size:
                raise ProgException(
                    f"service {host}: file size differs from {hosts[0]}")

    # --------------------------------------------------------------- CSV

    def csv_labels(self) -> list[str]:
        """Config columns for CSV export (reference: ProgArgs.cpp:1763-1810)."""
        return ["ISO date", "paths", "hosts", "threads", "dirs", "files",
                "file size", "block size", "direct IO", "random", "random aligned",
                "IO depth", "shared paths", "truncate", "TPU IDs", "TPU backend",
                "verify salt", "block variance pct", "rwmix pct"]

    def csv_values(self, iso_date: str) -> list[str]:
        return [iso_date, ";".join(self.paths), ";".join(self.hosts),
                str(self.num_threads), str(self.num_dirs), str(self.num_files),
                str(self.file_size), str(self.block_size),
                str(int(self.use_direct_io)), str(int(self.use_random_offsets)),
                str(int(self.use_random_aligned)), str(self.iodepth),
                str(int(not self.no_shared_service_path)),
                str(int(self.do_truncate)),
                ";".join(map(str, self.tpu_ids)), self.tpu_backend_name,
                str(self.verify_salt), str(self.block_variance_pct),
                str(self.rwmix_pct)]


# Task-oriented help pages (reference: the four-section help system,
# ProgArgs.cpp:1256-1589: basic, bench workflow, distributed, all options).
_HELP_BASIC = """\
elbencho-tpu-torch - storage benchmark with a storage->GPU memory data path

Usage: elbencho-tpu-torch [OPTIONS] PATH [MORE_PATHS]

Test types (pick the paths):
  Large files / block devices:  give file or device paths
  Many files (metadata):        give a directory path with -n/-N

Most used options:
  -w / -r              write / read phase       -t NUM   worker threads
  -s SIZE              file size (e.g. 4G)      -b SIZE  block size (e.g. 1M)
  -n NUM / -N NUM      dirs per thread / files per dir (dir mode)
  -d / -F / -D         create dirs / delete files / delete dirs
  --rand [--randalign] random offsets           --iodepth N   kernel AIO depth
  --direct             O_DIRECT                 --verify SALT integrity check
  --gpuids IDS         stage blocks into GPU memory (see --tpubackend)
  --hosts H1,H2        drive remote --service instances

Examples:
  elbencho-tpu -w -r -t 4 -b 1M -s 4G /mnt/store/file1
  elbencho-tpu -d -w --stat -r -F -D -t 16 -n 25 -N 250 -s 4k /mnt/store/dir
  elbencho-tpu-torch -r -b 8M --gpuids 0 --tpubackend direct /mnt/store/file1

More help:
  --help-bench   benchmark workflow and phase details
  --help-bdev    block device & large shared file testing
  --help-multi   many-files (metadata) testing
  --help-dist    multi-host benchmarking
  --help-all     every option
"""

_HELP_BDEV = """\
elbencho-tpu block device & large shared file testing

Usage: elbencho-tpu [OPTIONS] PATH [MORE_PATHS]

Basic options:
  -w / -r          write to / read from the given device(s) or file(s)
  -s SIZE          device or file size to use (e.g. 100G)
  -b SIZE          bytes per I/O operation (e.g. 4K)
  -t NUM           worker threads

Frequently used:
  --direct         direct I/O (bypass page cache) — usual for device tests
  --iodepth N      async I/O queue depth per thread (>1 enables kernel AIO)
  --ioengine E     async-loop backend: auto (probe io_uring, AIO fallback),
                   uring, or aio; --uringsqpoll opts into SQPOLL submission
  --iouring        legacy spelling of --ioengine uring
  --rand           random offsets    --randalign  block-align them
  --randamount N   total bytes for random I/O (default: aggregate size)
  --lat            min/avg/max latency per operation
  --gpuids IDS     stage every block into TPU HBM (--tpubackend direct for
                   the zero-copy deferred-DMA path)

Multiple PATHS are used round-robin per thread; with --rand the random
amount is split across threads. Results are comparable across runs with
the same thread/geometry settings.

Examples:
  Sequential write & read, 8 threads, direct I/O:
    elbencho-tpu -w -r -t 8 -b 1M --direct /dev/nvme0n1
  4K random-read IOPS, 16 threads, iodepth 16:
    elbencho-tpu -r -t 16 -b 4K --iodepth 16 --rand --direct /dev/nvme0n1
  Random-read latency percentiles into TPU HBM:
    elbencho-tpu -r -b 4K --rand --lat --latpercent --gpuids 0 /dev/nvme0n1
"""

_HELP_MULTI = """\
elbencho-tpu many-files (metadata) testing

Usage: elbencho-tpu [OPTIONS] DIRECTORY [MORE_DIRECTORIES]

Each of the -t threads works on its own subtree: -n directories per thread
with -N files each, laid out as r{rank}/d{dir}/r{rank}-f{file} (identical to
the reference layout, so results are comparable). --dirsharing makes all
threads share one namespace instead.

Basic options:
  -d / -D          create / delete the per-thread directories
  -w / -r          write/create / read the files
  --stat / -F      stat files / delete files
  -n NUM, -N NUM   dirs per thread, files per dir
  -s SIZE, -b SIZE file size and I/O block size
  -t NUM           worker threads

Frequently used:
  --verify SALT    write an offset+salt pattern, verify it on read
  --nodelerr       ignore not-found errors in delete phases
  --gpuids IDS     stage file contents into TPU HBM

Example: full cycle over 16 threads, 25 dirs x 250 files of 4KiB:
  elbencho-tpu -d -w --stat -r -F -D -t 16 -n 25 -N 250 -s 4k -b 4k /data/dir
"""

_HELP_BENCH = """\
elbencho-tpu benchmark workflow

Phases run in a fixed order, each over all worker threads with a condvar
barrier: MKDIRS (-d) -> WRITE (-w) -> STAT (--stat) -> READ (-r) ->
RMFILES (-F) -> RMDIRS (-D). --sync/--dropcache interleave between phases.

Results show two columns: FIRST DONE (all threads' progress when the fastest
thread finished - the contention-free number) and LAST DONE (totals when the
slowest finished). Add --lat/--latpercent/--lathisto for latency detail,
--csvfile for machine-readable output (chart with elbencho-tpu-chart).

Data integrity: --verify SALT writes each 8-byte word as (offset+salt) and
checks it on read, reporting the exact corrupt offset. --verifydirect reads
each block back immediately after writing. With a staged/direct/pjrt TPU backend
the verify check runs ON DEVICE against the staged HBM copy, so it validates
the full storage->HBM pipeline rather than just the host buffer, still
reporting the exact corrupt byte offset (pjrt compiles the check through the
PJRT C API - no Python in the loop); --hostverify forces the host check.

The TPU data path (--gpuids, --tpubackend hostsim|staged|direct|pjrt) stages
every read block into TPU HBM and sources write blocks from HBM, measuring the full
storage->accelerator pipeline. Latency histograms cover the whole per-block
pipeline including the device leg.
"""

_HELP_DIST = """\
elbencho-tpu distributed benchmarking

Start a service on every host (e.g. every TPU-pod worker host):
  elbencho-tpu --service [--foreground] [--port N]

Then drive them all from one master; the given benchmark options fan out to
all services, ranks are offset per host, and results aggregate live:
  elbencho-tpu --hosts host1,host2[:port] -w -r -t 8 -b 1M -s 4G /mnt/shared/f

All services see one shared dataset by default (ranks partition it); use
--nosvcshare for per-host private datasets. Service-side path and TPU-id
overrides: pass PATH/--gpuids when starting the service. --gpuperservice
assigns one TPU id per service instead of per thread.

Synchronize load across hosts with --start EPOCHSECS. Stop/quit services:
  elbencho-tpu --hosts host1,host2 --interrupt      # stop current phase
  elbencho-tpu --hosts host1,host2 --quit           # shut services down

Every service serves Prometheus-text live metrics at GET /metrics on its
benchmark port; the master mirrors the pod-merged families when started
with --metricsport N (docs/CAMPAIGNS.md has the name/label reference).

Master and services enforce an exact protocol-version match.
"""


# ============================================================ CLI parsing


class _HelpFormatter(argparse.HelpFormatter):
    def __init__(self, prog):
        super().__init__(prog, max_help_position=28, width=100)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="elbencho-tpu-torch", add_help=False,
        formatter_class=_HelpFormatter,
        description="elbencho-tpu-torch - storage benchmark with a "
                    "storage→GPU memory data path (PyTorch/CUDA).",
        epilog="Use --help-all for the full option list; see README.md for "
               "examples.")

    g = p.add_argument_group("general")
    g.add_argument("-h", "--help", action="store_true", help="Show basic help.")
    g.add_argument("--help-all", action="store_true", help="Show all options.")
    g.add_argument("--help-bench", action="store_true", dest="help_bench",
                   help="Show benchmark workflow help with examples.")
    g.add_argument("--help-bdev", action="store_true", dest="help_bdev",
                   help="Show block device & large shared file help.")
    g.add_argument("--help-multi", action="store_true", dest="help_multi",
                   help="Show many-files (metadata) testing help.")
    g.add_argument("--help-dist", action="store_true", dest="help_dist",
                   help="Show distributed benchmarking help.")
    g.add_argument("--version", action="store_true",
                   help="Show version and feature flags.")
    g.add_argument("paths", nargs="*", metavar="PATH",
                   help="Benchmark dir(s), file(s) or block device(s).")
    g.add_argument("--path", action="append", default=[], dest="path_flags",
                   metavar="PATH",
                   help="Benchmark path (explicit flag form of the "
                        "positional argument; may be given multiple times).")

    w = p.add_argument_group("benchmark phases")
    w.add_argument("-d", "--mkdirs", action="store_true", dest="run_create_dirs",
                   help="Create directories (dir mode).")
    w.add_argument("-w", "--write", action="store_true", dest="run_create_files",
                   help="Write/create files.")
    w.add_argument("-r", "--read", action="store_true", dest="run_read",
                   help="Read files.")
    w.add_argument("--stat", action="store_true", dest="run_stat_files",
                   help="Stat files (dir mode).")
    w.add_argument("-F", "--delfiles", action="store_true",
                   dest="run_delete_files", help="Delete files.")
    w.add_argument("-D", "--deldirs", action="store_true",
                   dest="run_delete_dirs", help="Delete directories (dir mode).")
    w.add_argument("--sync", action="store_true", dest="run_sync",
                   help="Sync write caches before/between phases.")
    w.add_argument("--dropcache", action="store_true", dest="run_drop_caches",
                   help="Drop page/dentry/inode caches before/between phases "
                        "(needs privileges).")

    geo = p.add_argument_group("workload geometry")
    geo.add_argument("-t", "--threads", type=int, default=1, dest="num_threads",
                     help="Number of I/O worker threads. (Default: 1)")
    geo.add_argument("--datasetthreads", type=int, default=None,
                     dest="explicit_dataset_threads", metavar="NUM",
                     help="Override the number of ranks the dataset is "
                          "partitioned across (default: threads x hosts for "
                          "a shared dataset; mainly internal, like the "
                          "reference's wire-only datasetthreads field).")
    geo.add_argument("-n", "--dirs", type=str, default="1", dest="num_dirs",
                     help="Directories per thread (dir mode). (Default: 1)")
    geo.add_argument("-N", "--files", type=str, default="1", dest="num_files",
                     help="Files per directory (dir mode). (Default: 1)")
    geo.add_argument("-s", "--size", type=str, default="0", dest="file_size",
                     help="File size, human units allowed (e.g. 10M). (Default: 0)")
    geo.add_argument("-b", "--block", type=str, default="1M", dest="block_size",
                     help="Read/write block size (e.g. 4K). (Default: 1M)")

    io = p.add_argument_group("I/O behavior")
    io.add_argument("--direct", action="store_true", dest="use_direct_io",
                    help="Use O_DIRECT (bypass page cache).")
    io.add_argument("--iodepth", type=int, default=1,
                    help="Async I/O queue depth per thread; >1 enables kernel "
                         "AIO. (Default: 1)")
    io.add_argument("--iouring", action="store_true", dest="use_io_uring",
                    help="Drive the async block loop (--iodepth > 1) through "
                         "io_uring submission/completion rings instead of "
                         "kernel AIO (legacy spelling of --ioengine uring).")
    io.add_argument("--ioengine", type=str, default="auto", dest="io_engine",
                    choices=["auto", "uring", "aio"],
                    help="Kernel backend of the async block loop: 'auto' "
                         "(default) probes io_uring at engine init and falls "
                         "back to kernel AIO with a logged cause; 'uring'/"
                         "'aio' pin the backend. io_uring rides fixed files "
                         "+ fixed buffers through the unified registration "
                         "authority (one pin serving both kernel and PJRT "
                         "DMA; see docs/IO_BACKENDS.md). EBT_URING_DISABLE=1 "
                         "forces the AIO shape (A/B control).")
    io.add_argument("--uringsqpoll", action="store_true", dest="uring_sqpoll",
                    help="Opt into io_uring SQPOLL submission: a kernel "
                         "poller thread consumes the SQ ring, so flushes "
                         "only syscall when the poller slept (counted as "
                         "uring_sqpoll_wakeups). Needs privileges on older "
                         "kernels; falls back to plain submission with a "
                         "logged cause.")
    io.add_argument("--rand", action="store_true", dest="use_random_offsets",
                    help="Random offsets instead of sequential.")
    io.add_argument("--randalign", action="store_true",
                    dest="use_random_aligned",
                    help="Block-align random offsets.")
    io.add_argument("--randamount", type=str, default="0", dest="random_amount",
                    help="Total random-I/O byte amount across all threads. "
                         "(Default: full file size)")
    io.add_argument("--trunc", action="store_true", dest="do_truncate",
                    help="Truncate files to 0 on write-phase open.")
    io.add_argument("--trunctosize", action="store_true", dest="do_trunc_to_size",
                    help="Truncate files to the given --size on write open.")
    io.add_argument("--preallocfile", action="store_true", dest="do_prealloc",
                    help="Preallocate file disk space on write open.")
    io.add_argument("--dirsharing", action="store_true", dest="do_dir_sharing",
                    help="Threads share the dir-mode directory namespace.")
    io.add_argument("--verify", type=str, default="0", dest="verify_salt",
                    metavar="SALT",
                    help="Write a verifiable offset+salt pattern and check it "
                         "on reads. SALT is any nonzero integer.")
    io.add_argument("--verifydirect", action="store_true",
                    dest="do_verify_direct",
                    help="Read back and verify each block right after writing.")
    io.add_argument("--blockvarpct", type=int, default=0,
                    dest="block_variance_pct", metavar="PCT",
                    help="Percent of write blocks refilled with fresh random "
                         "data. (Default: 0)")
    io.add_argument("--blockvaralgo", type=str, default="fast",
                    dest="block_variance_algo",
                    help="Block variance fill algorithm: fast, balanced, "
                         "strong. (Default: fast)")
    io.add_argument("--randalgo", type=str, default="balanced",
                    dest="rand_offset_algo",
                    help="Random offset algorithm: fast, balanced, strong. "
                         "(Default: balanced)")
    io.add_argument("--rwmixpct", type=int, default=0, dest="rwmix_pct",
                    metavar="PCT",
                    help="Percent of reads mixed into the write phase. "
                         "(Default: 0)")
    io.add_argument("--timelimit", type=int, default=0, dest="time_limit_secs",
                    metavar="SECS", help="Per-phase time limit in seconds.")
    io.add_argument("--arrival", type=str, default="", dest="arrival_mode",
                    metavar="MODE",
                    help="Open-loop arrival process for the block hot "
                         "loops: poisson (exponential inter-arrival times) "
                         "or paced (fixed 1/rate gaps). Ops are issued on a "
                         "virtual-time schedule and latency is measured "
                         "from the SCHEDULED arrival, so queueing delay is "
                         "measured instead of masked (coordinated "
                         "omission). (Default: closed loop)")
    io.add_argument("--rate", type=float, default=0.0, dest="arrival_rate",
                    metavar="IOPS",
                    help="Open-loop arrival rate in ops/s PER WORKER "
                         "(requires --arrival; --tenants class rates "
                         "override it per class).")
    io.add_argument("--tenants", type=str, default="", dest="tenants_spec",
                    metavar="SPEC",
                    help="Multi-tenant traffic classes for the open-loop "
                         "schedule: 'name:rate=R[,bs=SIZE][,rwmix=PCT]' "
                         "entries joined by ';'. Workers map to classes by "
                         "rank %% K; each class gets its own latency "
                         "histogram and TenantStats counters. bs must "
                         "divide --block. (Requires --arrival)")
    io.add_argument("--ratetrace", type=str, default="", dest="rate_trace",
                    metavar="FILE",
                    help="Piecewise rate schedule for --arrival trace: a "
                         "JSON file of start-sorted step/ramp/burst "
                         "segments ({'at': secs, 'kind': ..., 'rate': "
                         "ops/s[, 'rate_end': ops/s]}), optionally "
                         "overridden per --tenants class. Sampled as a "
                         "non-homogeneous Poisson process, rank-seeded — "
                         "every host offers the same schedule. (See "
                         "docs/SERVING.md)")
    io.add_argument("--slotarget", type=float, default=0.0,
                    dest="slo_target_ms", metavar="MS",
                    help="SLO latency target in milliseconds: per-class "
                         "goodput is the fraction of completions under it "
                         "on the scheduled-arrival clock (--tenants "
                         "slo=MS overrides per class). Grading only — "
                         "never gates issue.")
    io.add_argument("--retry", type=int, default=0, dest="retry_max",
                    metavar="NUM",
                    help="Retry a failed block operation up to NUM times "
                         "with exponential backoff + jitter before it "
                         "counts as an error (storage I/O retried in "
                         "place; device transfers retried against "
                         "survivor devices). 0 = no retries (default).")
    io.add_argument("--retrybackoff", type=int, default=10,
                    dest="retry_backoff_ms", metavar="MS",
                    help="Base backoff in milliseconds for --retry "
                         "(exponential per attempt, jittered, capped at "
                         "2s; interrupt wakes all backoff waits). "
                         "(Default: 10)")
    io.add_argument("--maxerrors", type=str, default="0",
                    dest="max_errors_spec", metavar="N|PCT%",
                    help="Error budget: keep the phase running past "
                         "exhausted retries until N failed ops (or PCT%% "
                         "of attempted ops, e.g. '5%%') accumulated, "
                         "counting and attributing each failure instead "
                         "of aborting; device lanes that keep failing are "
                         "EJECTED with their remaining work replanned "
                         "onto survivors. 0 = abort on the first error "
                         "(default).")
    io.add_argument("--chaos", type=str, default="", dest="chaos_spec",
                    metavar="SPEC",
                    help="Fault-injection campaign: arm the built-in mock "
                         "fault seams at the given probabilities, e.g. "
                         "'stripe=0.05,uring=0.05,seed=7' (seams: see "
                         "docs/FAULT_TOLERANCE.md; master-local, mock "
                         "backends only). Combine with --retry/--maxerrors "
                         "to exercise the recovery machinery.")
    io.add_argument("--nodelerr", action="store_true", dest="ignore_del_errors",
                    help="Ignore not-found errors in delete phases.")
    io.add_argument("--no0usecerr", action="store_true",
                    dest="ignore_0usec_errors",
                    help="Do not warn when the fastest thread completes in "
                         "less than a microsecond.")

    tpu = p.add_argument_group("GPU data path")
    tpu.add_argument("--gpuids", "--tpuids", type=str, default="",
                     dest="tpu_ids", metavar="IDS",
                     help="Comma-separated CUDA device indices for the "
                          "storage→GPU memory data path, assigned "
                          "round-robin to threads (the port runs on the CPU "
                          "only when EBT_TORCH_DEVICE=cpu).")
    tpu.add_argument("--tpubackend", type=str, default="",
                     dest="tpu_backend_name", metavar="KIND",
                     help="Device path backend: hostsim (host-memory "
                          "stand-in), staged (host buffer → GPU copy, "
                          "waited for per block), direct (copies on a side "
                          "stream, waited for at the engine's buffer-reuse "
                          "barrier; overlap depth follows --iodepth, so use "
                          "--iodepth > 1), pjrt (native C++ transfer engine "
                          "over the CUDA driver API — no Python on the hot "
                          "path; driver library libcuda.so.1, or the one "
                          "EBT_CUDA_DRIVER names). "
                          "(Default: staged when --gpuids is given)")
    tpu.add_argument("--gpuperservice", "--tpuperservice", action="store_true",
                     dest="assign_tpu_per_service",
                     help="Assign TPU IDs round-robin per service instead of "
                          "per thread.")
    tpu.add_argument("--tpustripe", action="store_true", dest="tpu_stripe",
                     help="Stripe each block's transfer chunks across ALL "
                          "assigned TPU devices (parallel DMA queues) instead "
                          "of one device per thread.")
    tpu.add_argument("--regwindow", type=str, default="0",
                     dest="reg_window", metavar="SIZE",
                     help="Pinned-registration window budget for the native "
                          "pjrt backend: at most SIZE bytes of host memory "
                          "are pinned (cuMemHostRegister) at once (an LRU "
                          "cache of "
                          "registration windows replaces whole-file "
                          "pinning, so the zero-copy tier engages even for "
                          "files far larger than pinnable memory). "
                          "(Default: a small multiple of iodepth x "
                          "block size)")
    tpu.add_argument("--d2hdepth", type=int, default=0,
                     dest="d2h_depth", metavar="NUM",
                     help="Write-phase D2H pipeline depth for the native "
                          "pjrt backend: device→host fetches for up to NUM "
                          "blocks stay in flight while earlier blocks' "
                          "storage writes run (fetch depth decoupled from "
                          "--iodepth). 1 = serial fetch-then-write (A/B "
                          "control). (Default: 0 = match --iodepth)")
    tpu.add_argument("--stripe", type=str, default="",
                     dest="stripe_policy", metavar="POLICY",
                     help="Mesh-striped HBM fill: spread the file's block "
                          "range across ALL selected devices' HBM as one "
                          "coordinated transfer. POLICY is rr (round-robin "
                          "stripe units over the device set) or contig "
                          "(one contiguous run per device). Native "
                          "planner + scatter + gather barrier on "
                          "--tpubackend pjrt; jax.device_put sharding-tree "
                          "fallback on staged. Stripe units are whole "
                          "multiples of --block and never split a "
                          "--regwindow registration span.")
    tpu.add_argument("--checkpoint", type=str, default="",
                     dest="checkpoint_manifest", metavar="MANIFEST",
                     help="Checkpoint-restore cold-start scenario: restore "
                          "the JSON manifest's shard files into the "
                          "selected devices' HBM (explicit per-device "
                          "placement; see docs/CHECKPOINT.md) and measure "
                          "time-to-all-devices-resident as the RESTORE "
                          "phase. Requires --tpubackend pjrt.")
    tpu.add_argument("--checkpoint-shards", type=int, default=0,
                     dest="checkpoint_shards", metavar="NUM",
                     help="Generated-manifest form of --checkpoint: NUM "
                          "shard files (ckpt.shard.<i> under the bench "
                          "directory, -s bytes each, device i modulo the "
                          "selected device count). With -w the shards are "
                          "created at prepare; without it they must "
                          "already exist.")
    tpu.add_argument("--rotate", type=float, default=0.0,
                     dest="rotate_period_s", metavar="SECS",
                     help="Serving under live model rotation: re-restore "
                          "the --checkpoint MANIFEST every SECS into the "
                          "inactive generation of a double-buffered shard "
                          "set while the read phase serves against the "
                          "active one (atomic swap at the all-resident "
                          "barrier, repeat; see docs/SERVING.md). "
                          "Rotation I/O is a BACKGROUND QoS class — pace "
                          "it with --bgbudget. Requires -r and "
                          "--tpubackend pjrt.")
    tpu.add_argument("--bgbudget", type=str, default="0",
                     dest="bg_budget", metavar="BYTES/S",
                     help="Background byte/s budget for --rotate restore "
                          "I/O: token buckets at the storage hot loop and "
                          "the per-device lanes keep rotation reads/H2D "
                          "submits under the budget so restore traffic "
                          "cannot trample foreground p99. Size suffixes "
                          "accepted (e.g. 64M). 0 = unthrottled "
                          "(default).")
    tpu.add_argument("--bgadapt", type=int, default=0,
                     dest="bg_adapt_lag_ms", metavar="MS",
                     help="Adaptive background mode: halve the rotation "
                          "budget whenever the foreground accrues more "
                          "than MS of new scheduled-arrival lag per wall "
                          "second, re-raise toward the --bgbudget ceiling "
                          "when it stops. Requires --bgbudget.")
    tpu.add_argument("--reshard", type=int, default=0,
                     dest="reshard_devices", metavar="M",
                     help="Topology-shift restore: reshard the "
                          "--checkpoint/--checkpoint-shards manifest's "
                          "N-device placement onto the first M devices of "
                          "the live selection (RESHARD phase, clocked as "
                          "time-to-all-M-resident; see docs/RESHARD.md). "
                          "Already-resident shards are no-ops, displaced "
                          "shards move device->device through HBM (the "
                          "D2D data-path tier, host-bounce fallback via "
                          "EBT_D2D_DISABLE=1), shards with no live source "
                          "restore from storage. Requires a manifest and "
                          "M <= the selected device count.")
    tpu.add_argument("--ingest", type=str, default="",
                     dest="ingest_manifest", metavar="MANIFEST",
                     help="DL-ingestion scenario: shuffled small-record "
                          "reads over the JSON manifest's sharded dataset "
                          "files (records batched into blocks, seeded "
                          "bounded shuffle window, multi-epoch pipelined "
                          "prefetch; see docs/INGEST.md), measured as the "
                          "INGEST phase. Requires --tpubackend pjrt.")
    tpu.add_argument("--ingestshards", type=int, default=0,
                     dest="ingest_shards", metavar="NUM",
                     help="Generated-dataset form of --ingest: NUM shard "
                          "files (data.shard.<i> under the bench "
                          "directory, -s bytes each). With -w the shards "
                          "are created at prepare; without it they must "
                          "already exist.")
    tpu.add_argument("--recordsize", type=str, default="0",
                     dest="record_size", metavar="SIZE",
                     help="Record size for --ingest (e.g. 4K): the "
                          "workload's unit, much smaller than --block; "
                          "must divide --block and the shard size.")
    tpu.add_argument("--shufflewindow", type=int, default=0,
                     dest="shuffle_window", metavar="NUM",
                     help="Bounded per-epoch shuffle window for --ingest, "
                          "in records (window-local Fisher-Yates over the "
                          "record-index stream; 1 = exact sequential "
                          "order, the A/B control). (Default: 1024)")
    tpu.add_argument("--shuffleseed", type=int, default=1,
                     dest="shuffle_seed", metavar="NUM",
                     help="Run-level shuffle seed for --ingest: the record "
                          "order is a pure function of seed/epoch/rank, "
                          "so runs are reproducible across hosts. "
                          "(Default: 1)")
    tpu.add_argument("--epochs", type=int, default=0,
                     dest="ingest_epochs", metavar="NUM",
                     help="Passes over the dataset for --ingest; epoch "
                          "N+1's reads overlap epoch N's device settles "
                          "through the prefetch pipeline. (Default: 1)")
    tpu.add_argument("--prefetchbatches", type=int, default=0,
                     dest="prefetch_batches", metavar="NUM",
                     help="Batch-pipeline depth of the --ingest prefetch: "
                          "up to NUM block-sized record batches stay in "
                          "flight to the devices while later records are "
                          "read from storage. 1 = serial (A/B control). "
                          "(Default: 0 = the worker's whole buffer pool)")
    tpu.add_argument("--hostverify", action="store_true",
                     dest="tpu_host_verify",
                     help="Run --verify integrity checks on the host even "
                          "when blocks are staged into GPU memory. (Default: "
                          "with a staged/direct backend the check runs on "
                          "device, against the GPU copy.)")

    st = p.add_argument_group("statistics and output")
    st.add_argument("--lat", action="store_true", dest="show_latency",
                    help="Show min/avg/max latency.")
    st.add_argument("--latpercent", action="store_true",
                    dest="show_lat_percentiles", help="Show latency percentiles.")
    st.add_argument("--latpercent9s", type=int, default=0,
                    dest="num_latency_percentile_9s",
                    help="Number of nines after p99 (e.g. 2 -> p99.99).")
    st.add_argument("--lathisto", action="store_true", dest="show_lat_histogram",
                    help="Show the full latency histogram.")
    st.add_argument("--allelapsed", action="store_true", dest="show_all_elapsed",
                    help="Show per-thread elapsed times.")
    st.add_argument("--cpu", action="store_true", dest="show_cpu_util",
                    help="Show CPU utilization per phase.")
    st.add_argument("--metricsport", type=int, default=0,
                    dest="metrics_port",
                    help="Serve Prometheus-text /metrics on this port for "
                         "the duration of the run (master/local mode; "
                         "service daemons always serve /metrics on their "
                         "benchmark port). 0 disables. (Default: 0)")
    st.add_argument("--nolive", action="store_true", dest="disable_live_stats",
                    help="Disable live statistics.")
    st.add_argument("--refresh", type=float, default=2.0,
                    dest="live_stats_sleep_sec", metavar="SECS",
                    help="Live stats refresh interval. (Default: 2)")
    st.add_argument("--resfile", type=str, default="", dest="results_file",
                    help="Append human-readable results to this file.")
    st.add_argument("--csvfile", type=str, default="", dest="csv_file",
                    help="Append CSV results to this file.")
    st.add_argument("--nocsvlabels", action="store_true", dest="no_csv_labels",
                    help="Do not print the CSV label header line.")
    st.add_argument("--spanfile", type=str, default="", dest="span_file",
                    metavar="PATH",
                    help="Write the run's spans (device path: block copies, "
                         "staging, verify waits, window registration, pins; "
                         "coordinator: phases) to this file as Chrome "
                         "trace-event JSON on the realtime clock, for "
                         "Perfetto beside a torch.profiler or Nsight trace. "
                         "(Port only.)")
    st.add_argument("--log", type=int, default=1, dest="log_level",
                    help="Log level: 0 error, 1 normal, 2 verbose, 3 debug.")

    dist = p.add_argument_group("distributed mode")
    dist.add_argument("--hosts", type=str, default="",
                      help="Comma-separated service hosts (host[:port]) to run "
                           "the benchmark on; this instance becomes the master.")
    dist.add_argument("--hostsfile", type=str, default="",
                      help="File with one service host per line.")
    dist.add_argument("--service", action="store_true", dest="run_as_service",
                      help="Run as a benchmark service for a remote master.")
    dist.add_argument("--foreground", "--nodetach", action="store_true",
                      dest="service_in_foreground",
                      help="Keep the service in the foreground (no daemonize).")
    dist.add_argument("--port", type=int, default=SERVICE_DEFAULT_PORT,
                      dest="service_port",
                      help=f"Service TCP port. (Default: {SERVICE_DEFAULT_PORT})")
    dist.add_argument("--interrupt", action="store_true",
                      dest="interrupt_services",
                      help="Interrupt the current phase on the given --hosts.")
    dist.add_argument("--quit", action="store_true", dest="quit_services",
                      help="Tell the given --hosts services to quit.")
    dist.add_argument("--nosvcshare", action="store_true",
                      dest="no_shared_service_path",
                      help="Service hosts use private datasets instead of "
                           "sharing one.")
    dist.add_argument("--rankoffset", type=int, default=0, dest="rank_offset",
                      help="Offset for worker rank numbers. (Default: 0)")
    dist.add_argument("--svcupint", type=int, default=500,
                      dest="svc_update_interval_ms",
                      help="Master poll interval for service status in ms. "
                           "(Default: 500)")
    dist.add_argument("--svcfanout", type=int, default=32,
                      dest="svc_fanout", metavar="N",
                      help="Bounded parallelism of the master's prepare/"
                           "start/status fan-out to service hosts: at most "
                           "N concurrent requests, however many hosts the "
                           "pod has. (Default: 32)")
    dist.add_argument("--hosttimeout", type=float, default=30.0,
                      dest="host_timeout_secs", metavar="SECS",
                      help="Declare a service host dead/hung (host-"
                           "attributed cause, phase interrupted on the "
                           "others) when it produces no successful status "
                           "reply for SECS seconds. (Default: 30)")
    dist.add_argument("--start", type=int, default=0, dest="start_time",
                      metavar="EPOCHSECS",
                      help="Synchronized start time (epoch seconds) across "
                           "hosts.")
    dist.add_argument("--zones", type=str, default="",
                      help="Comma-separated CPU/NUMA zones to bind threads to.")
    dist.add_argument("--numazones", type=str, default="",
                      dest="numa_zones",
                      help="Comma-separated NUMA node ids; worker threads "
                           "bind round-robin (rank %% list length) and their "
                           "buffer pools + registration-window spans are "
                           "pinned node-local (NumaTk; inert logged-once "
                           "fallback on single-node/container hosts).")

    return p


def config_from_args(argv: list[str] | None = None) -> Config:
    """Parse argv into a validated Config (reference: ProgArgs constructor flow,
    ProgArgs.cpp:36-84)."""
    parser = build_parser()
    try:
        ns = parser.parse_args(argv)
    except ValueError as e:
        raise ProgException(str(e))

    if ns.help:
        print(_HELP_BASIC)
        sys.exit(0)
    if ns.help_all:
        parser.print_help()
        sys.exit(0)
    if ns.help_bench:
        print(_HELP_BENCH)
        sys.exit(0)
    if ns.help_bdev:
        print(_HELP_BDEV)
        sys.exit(0)
    if ns.help_multi:
        print(_HELP_MULTI)
        sys.exit(0)
    if ns.help_dist:
        print(_HELP_DIST)
        sys.exit(0)
    if ns.version:
        print(f"elbencho-tpu-torch {__version__}")
        # probe the runtime instead of hardcoding (reference prints its
        # actual build features, ProgArgs.cpp printVersionAndBuildInfo):
        # features the pure-Python layer always provides, plus what this
        # host/installation actually offers
        features = []
        if os.path.exists("/proc/sys/fs/aio-max-nr"):
            features.append("AIO")
        try:
            from .engine import load_lib

            if load_lib().ebt_uring_supported():
                features.append("IOURING")
        except Exception:
            pass
        if sys.platform.startswith("linux"):
            features.append("DIRECTIO")
        features += ["VERIFY", "RWMIX", "HOSTSIM", "DISTRIBUTED"]
        try:
            import torch

            if torch.cuda.is_available():
                features += ["GPU-STAGED", "GPU-DIRECT"]
        except Exception:
            pass
        try:
            nodes = [d for d in os.listdir("/sys/devices/system/node")
                     if d.startswith("node")]
            if nodes:
                features.append("NUMA")
        except OSError:
            pass
        print("Features: " + " ".join(features))
        sys.exit(0)

    hosts: list[str] = []
    if ns.hostsfile:
        with open(ns.hostsfile) as f:
            hosts = [ln.strip() for ln in f if ln.strip() and
                     not ln.strip().startswith("#")]
    if ns.hosts:
        hosts += [h.strip() for h in ns.hosts.split(",") if h.strip()]

    try:
        cfg = _config_from_namespace(ns, hosts)
    except ValueError as e:
        raise ProgException(f"invalid argument value: {e}")
    cfg.check_args()
    return cfg


def _config_from_namespace(ns, hosts: list[str]) -> Config:
    return Config(
        paths=list(ns.paths) + list(ns.path_flags),
        num_threads=ns.num_threads,
        num_dirs=parse_size(ns.num_dirs),
        num_files=parse_size(ns.num_files),
        file_size=parse_size(ns.file_size),
        block_size=parse_size(ns.block_size),
        run_create_dirs=ns.run_create_dirs,
        run_create_files=ns.run_create_files,
        run_read=ns.run_read,
        run_stat_files=ns.run_stat_files,
        run_delete_files=ns.run_delete_files,
        run_delete_dirs=ns.run_delete_dirs,
        run_sync=ns.run_sync,
        run_drop_caches=ns.run_drop_caches,
        use_direct_io=ns.use_direct_io,
        iodepth=ns.iodepth,
        use_io_uring=ns.use_io_uring,
        io_engine=ns.io_engine,
        uring_sqpoll=ns.uring_sqpoll,
        use_random_offsets=ns.use_random_offsets,
        use_random_aligned=ns.use_random_aligned,
        random_amount=parse_size(ns.random_amount),
        do_truncate=ns.do_truncate,
        do_trunc_to_size=ns.do_trunc_to_size,
        do_prealloc=ns.do_prealloc,
        do_dir_sharing=ns.do_dir_sharing,
        verify_salt=int(ns.verify_salt, 0) if isinstance(ns.verify_salt, str)
        else int(ns.verify_salt),
        do_verify_direct=ns.do_verify_direct,
        block_variance_pct=ns.block_variance_pct,
        rwmix_pct=ns.rwmix_pct,
        block_variance_algo=ns.block_variance_algo,
        rand_offset_algo=ns.rand_offset_algo,
        ignore_del_errors=ns.ignore_del_errors,
        ignore_0usec_errors=ns.ignore_0usec_errors,
        explicit_dataset_threads=ns.explicit_dataset_threads,
        time_limit_secs=ns.time_limit_secs,
        tpu_ids=[int(x) for x in ns.tpu_ids.split(",") if x.strip()]
        if ns.tpu_ids else [],
        tpu_backend_name=ns.tpu_backend_name,
        assign_tpu_per_service=ns.assign_tpu_per_service,
        tpu_stripe=ns.tpu_stripe,
        tpu_host_verify=ns.tpu_host_verify,
        reg_window=parse_size(ns.reg_window),
        d2h_depth=ns.d2h_depth,
        stripe_policy=ns.stripe_policy,
        arrival_mode=ns.arrival_mode,
        arrival_rate=ns.arrival_rate,
        tenants_spec=ns.tenants_spec,
        rate_trace=ns.rate_trace,
        slo_target_ms=ns.slo_target_ms,
        rotate_period_s=ns.rotate_period_s,
        bg_budget=parse_size(ns.bg_budget),
        bg_adapt_lag_ms=ns.bg_adapt_lag_ms,
        retry_max=ns.retry_max,
        retry_backoff_ms=ns.retry_backoff_ms,
        max_errors_spec=ns.max_errors_spec,
        chaos_spec=ns.chaos_spec,
        checkpoint_manifest=ns.checkpoint_manifest,
        checkpoint_shards=ns.checkpoint_shards,
        reshard_devices=ns.reshard_devices,
        ingest_manifest=ns.ingest_manifest,
        ingest_shards=ns.ingest_shards,
        record_size=parse_size(ns.record_size),
        shuffle_window=ns.shuffle_window,
        shuffle_seed=ns.shuffle_seed,
        ingest_epochs=ns.ingest_epochs,
        prefetch_batches=ns.prefetch_batches,
        show_latency=ns.show_latency,
        show_lat_percentiles=ns.show_lat_percentiles,
        num_latency_percentile_9s=ns.num_latency_percentile_9s,
        show_lat_histogram=ns.show_lat_histogram,
        show_all_elapsed=ns.show_all_elapsed,
        show_cpu_util=ns.show_cpu_util,
        disable_live_stats=ns.disable_live_stats,
        metrics_port=ns.metrics_port,
        live_stats_sleep_sec=ns.live_stats_sleep_sec,
        results_file=ns.results_file,
        csv_file=ns.csv_file,
        span_file=ns.span_file,
        no_csv_labels=ns.no_csv_labels,
        log_level=ns.log_level,
        hosts=hosts,
        run_as_service=ns.run_as_service,
        service_in_foreground=ns.service_in_foreground,
        service_port=ns.service_port,
        interrupt_services=ns.interrupt_services,
        quit_services=ns.quit_services,
        no_shared_service_path=ns.no_shared_service_path,
        rank_offset=ns.rank_offset,
        svc_update_interval_ms=ns.svc_update_interval_ms,
        svc_fanout=ns.svc_fanout,
        host_timeout_secs=ns.host_timeout_secs,
        start_time=ns.start_time,
        zones=[int(z) for z in ns.zones.split(",") if z.strip()]
        if ns.zones else [],
        numa_zones=[int(z) for z in ns.numa_zones.split(",") if z.strip()]
        if ns.numa_zones else [],
    )
