"""Remote worker group: master-side HTTP proxies for service hosts.

Port of the original package's workers/remote.py, unchanged in what it
sends and reads (protocol 1.18.0), so a port master drives the original's
services and the port's alike. The SliceOps self-check compares a
service's mesh-reduced slice totals (workers/local.py slice_stats over
parallel/mesh.py MeshStatsReducer) with its per-worker totals.

The original is a rebuild of the reference's source/workers/RemoteWorker.{h,cpp}: one client per
service host that mirrors a local worker's stats interface while aggregating
the N remote threads behind it — config fan-out via POST /preparephase
(RemoteWorker.cpp:243-295), phase start (300-326), /status polling at the
svcupint interval with error surfacing and cross-host error fan-out
(335-410), final fan-in of per-thread elapsed lists and latency histograms
via /benchresult (146-237), and interrupt/quit propagation (418-454). Errors
are framed with the originating host (461-499).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from ..common import PROTOCOL_VERSION, BenchPhase, Endpoint, SERVICE_DEFAULT_PORT
from ..config import BenchPathInfo, Config
from ..exceptions import ProgException
from ..histogram import LatencyHistogram
from ..liveops import LiveOps
from ..logger import LOGGER
from .base import WorkerGroup, WorkerPhaseResult, WorkerSnapshot

# per-host control-plane timing export (host_timings()): the key authority
# the golden protocol schema pins — prepare_ns (wall time of the host's
# /preparephase), start_skew_ns (this host's /startphase completion minus
# the pod's earliest), poll_lag_ns (peak delay of a status poll behind its
# schedule) and the straggler/dead status word.
HOST_TIMING_FIELDS = ("host", "prepare_ns", "start_skew_ns", "poll_lag_ns",
                      "status")


def merge_first_host_error(a: tuple[int, str] | None,
                           b: tuple[int, str] | None
                           ) -> tuple[int, str] | None:
    """Binary merge for first_host_framed_error fields: of two
    (host_rank, framed_message) partials, keep the LOWEST-ranked host's.
    Selection by rank (not poll/iteration order) is what makes the merge
    commutative and associative, so a relay tier can merge partial
    merges — the mergecheck tree-safety requirement."""
    if a is None:
        return b
    if b is None:
        return a
    return a if a[0] <= b[0] else b


def merge_host_keyed(a: dict[int, str] | None,
                     b: dict[int, str] | None) -> dict[int, str]:
    """Binary merge for concat_host_sorted fields: host-rank-keyed
    fragments union by key (each rank contributes its own fragment, so
    the union is disjoint and order-free); renderers join the values in
    rank order. Dict-union is the associative/commutative law behind
    what used to be an iteration-order string concat."""
    out = dict(a) if a else {}
    if b:
        out.update(b)
    return out


class ServiceUnreachable(ProgException):
    """Connection-level failure talking to a service (refused, no route,
    socket timeout). The status poller RETRIES these until --hosttimeout
    declares the host dead with a host-attributed cause — a transient
    network blip must not abort a hundred-host phase, and a hung host must
    not block it. Protocol-level failures (HTTP errors, bench-ID mismatch,
    non-JSON replies) stay immediately fatal."""


def _host_url(host: str) -> str:
    if ":" not in host:
        host = f"{host}:{SERVICE_DEFAULT_PORT}"
    return f"http://{host}"


def _request(host: str, endpoint: str, params: dict | None = None,
             body: dict | None = None, timeout: float = 20.0) -> dict:
    url = _host_url(host) + endpoint
    if params:
        url += "?" + urllib.parse.urlencode(params)
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    if data:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read() or b"{}"
            try:
                return json.loads(raw)
            except ValueError:
                raise ProgException(
                    f"service {host}: non-JSON reply (not an elbencho-tpu "
                    f"service?): {raw[:80]!r}")
    except urllib.error.HTTPError as e:
        try:
            payload = json.loads(e.read() or b"{}")
        except Exception:
            payload = {}
        msg = payload.get("Error", f"HTTP {e.code}")
        history = payload.get("ErrorHistory") or []
        framed = f"service {host}: {msg}"
        if history:
            framed += "\n" + "\n".join(f"  [{host}] {ln}" for ln in history)
        raise ProgException(framed)
    except OSError as e:
        raise ServiceUnreachable(f"service {host}: connection failed: {e}")


def send_interrupt_to_hosts(hosts: list[str], quit_services: bool) -> None:
    """--interrupt / --quit fan-out (reference: RemoteWorker.cpp:418-454)."""
    for host in hosts:
        try:
            params = {"quit": 1} if quit_services else {}
            _request(host, Endpoint.INTERRUPT_PHASE, params)
            LOGGER.info(f"service {host}: "
                        f"{'quit' if quit_services else 'interrupt'} sent")
        except ProgException as e:
            LOGGER.error(str(e))


class RemoteHostProxy:
    """Mirrors one service host; polled by a dedicated thread during phases."""

    def __init__(self, cfg: Config, host: str, host_index: int) -> None:
        self.cfg = cfg
        self.host = host
        self.host_index = host_index
        self.path_info: BenchPathInfo | None = None
        # live state (written by the poll thread, read by the master's stats)
        self.live = LiveOps()
        self.workers_done = 0
        self.workers_error = 0
        self.error = ""
        # per-chip transfer latency fan-in (filled by fetch_result)
        self.dev_lat_histos: dict[str, LatencyHistogram] = {}
        self.dev_lat_clock: dict[str, str] = {}  # label -> clock source
        # the service's --timelimit ended its phase (filled by fetch_result)
        self.time_limit_hit = False
        # engagement-confirmed h2d tier + registration-cache counters as
        # reported by the service's result tree (filled by fetch_result)
        self.data_path_tier: str | None = None
        self.reg_cache: dict[str, int] | None = None
        # write-direction twin: confirmed D2H tier + deferred-engine stats
        self.d2h_tier: str | None = None
        self.d2h_stats: dict[str, int] | None = None
        # per-device transfer lanes (submit/await/lock-wait evidence)
        self.lane_stats: list[dict[str, int]] | None = None
        # storage backend: resolved --ioengine + fallback cause + the
        # unified-registration evidence counters
        self.io_engine: str | None = None
        self.io_engine_cause: str | None = None
        self.uring_stats: dict[str, int] | None = None
        # mesh-striped fill: confirmed tier + counters + first failure
        self.stripe_tier: str | None = None
        self.stripe_stats: dict[str, int] | None = None
        self.stripe_error: str | None = None
        # checkpoint restore: reconciliation counters + per-device
        # resident bytes + first "device N shard S" failure
        self.ckpt_stats: dict[str, int] | None = None
        self.ckpt_dev_bytes: list[int] | None = None
        self.ckpt_error: str | None = None
        # topology-shift reshard: confirmed move tier + the ReshardStats
        # family + the lane-pair matrix + first "unit U src A dst B"
        # failure
        self.reshard_tier: str | None = None
        self.reshard_stats: dict[str, int] | None = None
        self.reshard_pairs: list[dict[str, int]] | None = None
        self.reshard_error: str | None = None
        # DL ingestion: confirmed tier + the IngestStats counter family
        # + first "device N epoch E" failure
        self.ingest_tier: str | None = None
        self.ingest_stats: dict | None = None
        self.ingest_error: str | None = None
        # open-loop load generation: resolved arrival mode + per-tenant-
        # class accounting + per-class latency histograms
        self.arrival_mode: str | None = None
        self.tenant_stats: list[dict[str, int]] | None = None
        self.tenant_lat_histos: dict[str, LatencyHistogram] = {}
        # serving rotation (--rotate): lifecycle/throttle counters,
        # per-rotation ttr list, per-rotation reconciliation records
        self.serving_stats: dict[str, int] | None = None
        self.rotation_ttr_ns: list[int] | None = None
        self.rotation_records: list[dict[str, int]] | None = None
        # completion reactor: engagement + cause + wakeup counter family
        self.reactor_enabled: bool | None = None
        self.reactor_cause: str | None = None
        self.reactor_stats: dict[str, int] | None = None
        # NumaTk placement evidence (--numazones)
        self.numa_stats: dict[str, int] | None = None
        # fault tolerance: device/engine counter families + attributions
        self.fault_stats: dict[str, int] | None = None
        self.engine_fault_stats: dict[str, int] | None = None
        self.fault_causes: str | None = None
        self.ejected_devices: str | None = None
        # control-plane timing (master-side; see HOST_TIMING_FIELDS)
        self.prepare_ns = 0
        self.start_skew_ns = 0
        self.poll_lag_ns = 0
        self.status = "ok"  # ok | straggler | dead
        self.last_ok = 0.0  # monotonic time of the last successful poll

    def prepare(self) -> None:
        wire = self.cfg.to_wire(self.host_index)
        reply = _request(self.host, Endpoint.PREPARE_PHASE,
                         {"ProtocolVersion": PROTOCOL_VERSION}, body=wire,
                         timeout=120.0)
        self.path_info = BenchPathInfo.from_wire(reply.get("BenchPathInfo", {}))

    def start_phase(self, phase: BenchPhase, bench_id: str) -> None:
        _request(self.host, Endpoint.START_PHASE,
                 {"PhaseCode": int(phase), "BenchID": bench_id})

    def poll_status(self, bench_id: str, timeout: float = 20.0) -> None:
        reply = _request(self.host, Endpoint.STATUS, timeout=timeout)
        if bench_id and reply.get("BenchID") not in ("", bench_id):
            # phase-generation mismatch: another master took over the service
            # (reference: RemoteWorker.cpp:368-370)
            raise ProgException(
                f"service {self.host}: bench ID mismatch - service was "
                "claimed by another master")
        self.live = LiveOps.from_wire(reply.get("LiveOps", {}))
        self.workers_done = int(reply.get("NumWorkersDone", 0))
        self.workers_error = int(reply.get("NumWorkersDoneWithError", 0))

    def fetch_result(self) -> WorkerPhaseResult:
        reply = _request(self.host, Endpoint.BENCH_RESULT, timeout=60.0)
        res = WorkerPhaseResult(
            ops=LiveOps.from_wire(reply.get("Ops", {})),
            elapsed_us_list=[int(x) for x in reply.get("ElapsedUSecsList", [])],
            iops_histo=LatencyHistogram.from_wire(reply.get("LatHistoIOPS", {})),
            entries_histo=LatencyHistogram.from_wire(
                reply.get("LatHistoEntries", {})),
            stonewall_us=int(reply.get("StoneWallUSecs", 0)),
            cpu_stonewall_pct=float(reply.get("CPUUtilStoneWall", -1.0)),
        )
        sw = reply.get("StoneWall")
        if sw is not None:
            res.stonewall_ops = LiveOps.from_wire(sw)
            res.have_stonewall = True
        if int(reply.get("NumWorkersDoneWithError", 0)) > 0:
            errs = reply.get("ErrorHistory") or []
            res.error = (f"service {self.host}: worker failed" +
                         ("\n" + "\n".join(f"  [{self.host}] {ln}"
                                           for ln in errs) if errs else ""))
        self.dev_lat_histos = {
            label: LatencyHistogram.from_wire(wire)
            for label, wire in (reply.get("DevLatHistos") or {}).items()}
        self.dev_lat_clock = dict(reply.get("DevLatClock") or {})
        self.time_limit_hit = bool(reply.get("TimeLimitHit", False))
        self.data_path_tier = reply.get("DataPathTier")
        rc = reply.get("RegCache")
        self.reg_cache = ({k: int(v) for k, v in rc.items()}
                          if rc is not None else None)
        self.d2h_tier = reply.get("D2HTier")
        ds = reply.get("D2HStats")
        self.d2h_stats = ({k: int(v) for k, v in ds.items()}
                          if ds is not None else None)
        ls = reply.get("LaneStats")
        self.lane_stats = ([{k: int(v) for k, v in lane.items()}
                            for lane in ls] if ls is not None else None)
        self.io_engine = reply.get("IoEngine")
        self.io_engine_cause = reply.get("IoEngineCause") or None
        us = reply.get("UringStats")
        self.uring_stats = ({k: int(v) for k, v in us.items()}
                            if us is not None else None)
        self.stripe_tier = reply.get("StripeTier")
        ss = reply.get("StripeStats")
        self.stripe_stats = ({k: int(v) for k, v in ss.items()}
                             if ss is not None else None)
        self.stripe_error = reply.get("StripeError") or None
        cs = reply.get("CkptStats")
        self.ckpt_stats = ({k: int(v) for k, v in cs.items()}
                           if cs is not None else None)
        cb = reply.get("CkptBytesPerDevice")
        self.ckpt_dev_bytes = ([int(v) for v in cb]
                               if cb is not None else None)
        self.ckpt_error = reply.get("CkptError") or None
        self.reshard_tier = reply.get("ReshardTier")
        rst = reply.get("ReshardStats")
        self.reshard_stats = ({k: int(v) for k, v in rst.items()}
                              if rst is not None else None)
        rp = reply.get("ReshardPairs")
        self.reshard_pairs = ([{k: int(v) for k, v in pair.items()}
                               for pair in rp] if rp is not None else None)
        self.reshard_error = reply.get("ReshardError") or None
        self.ingest_tier = reply.get("IngestTier")
        ist = reply.get("IngestStats")
        if ist is not None:
            self.ingest_stats = {
                k: ([{ek: int(ev) for ek, ev in e.items()} for e in v]
                    if k == "epochs" else
                    [int(t) for t in v] if k == "epoch_time_ns"
                    else int(v))
                for k, v in ist.items()}
        else:
            self.ingest_stats = None
        self.ingest_error = reply.get("IngestError") or None
        self.arrival_mode = reply.get("ArrivalMode")
        ts = reply.get("TenantStats")
        self.tenant_stats = ([{k: int(v) for k, v in cls.items()}
                              for cls in ts] if ts is not None else None)
        svs = reply.get("ServingStats")
        self.serving_stats = ({k: int(v) for k, v in svs.items()}
                              if svs is not None else None)
        rt = reply.get("RotationTtrNs")
        self.rotation_ttr_ns = ([int(v) for v in rt]
                                if rt is not None else None)
        rr = reply.get("RotationRecords")
        self.rotation_records = ([{k: int(v) for k, v in rec.items()}
                                  for rec in rr] if rr is not None else None)
        self.tenant_lat_histos = {
            label: LatencyHistogram.from_wire(wire)
            for label, wire in (reply.get("TenantLatHistos") or {}).items()}
        re_ = reply.get("ReactorEnabled")
        self.reactor_enabled = bool(re_) if re_ is not None else None
        self.reactor_cause = reply.get("ReactorCause") or None
        rs = reply.get("ReactorStats")
        self.reactor_stats = ({k: int(v) for k, v in rs.items()}
                              if rs is not None else None)
        ns = reply.get("NumaStats")
        self.numa_stats = ({k: int(v) for k, v in ns.items()}
                           if ns is not None else None)
        fs = reply.get("FaultStats")
        self.fault_stats = ({k: int(v) for k, v in fs.items()}
                            if fs is not None else None)
        efs = reply.get("EngineFaultStats")
        self.engine_fault_stats = ({k: int(v) for k, v in efs.items()}
                                   if efs is not None else None)
        self.fault_causes = reply.get("FaultCauses") or None
        self.ejected_devices = reply.get("EjectedDevices") or None
        sl = reply.get("SliceOps")
        if sl and not res.error:
            # self-check of the mesh-reduction tier: both values originate
            # from the same engine counters, so a mismatch means the
            # device reduction itself (placement, gather, reduction kernel;
            # the original's limbs and psum) mangled the stats — a result whose stats path is broken must
            # not be reported as valid (same hard-fail spirit as the
            # reference's consistency checks, ProgArgs.cpp:1867-1954)
            mesh_ops = LiveOps.from_wire(sl.get("Ops", {}))
            if mesh_ops.to_wire() != res.ops.to_wire():
                res.error = (
                    f"service {self.host}: mesh-reduced slice stats disagree "
                    f"with per-worker totals (psum {mesh_ops.to_wire()} vs "
                    f"{res.ops.to_wire()})")
        return res

    def interrupt(self) -> None:
        try:
            _request(self.host, Endpoint.INTERRUPT_PHASE, timeout=5.0)
        except ProgException as e:
            LOGGER.error(str(e))


class RemoteWorkerGroup(WorkerGroup):
    """Drives all service hosts at pod scale: every control-plane leg
    (prepare / start / status polling / result fetch) fans out with
    BOUNDED parallelism (--svcfanout) instead of one thread per host —
    hundreds of hosts never spawn hundreds of concurrent requests — with
    an incrementally merged live-stats total, straggler/dead-host
    detection with host-attributed causes, and a per-host timing export
    (prepare_ns / start_skew_ns / poll_lag_ns via host_timings()).
    (reference: WorkerManager.cpp:161-171 + RemoteWorker::run, reworked
    for pod scale)"""

    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg
        self.proxies = [RemoteHostProxy(cfg, h, i)
                        for i, h in enumerate(cfg.hosts)]
        self._threads: list[threading.Thread] = []
        self._phase_over = threading.Event()
        self._bench_id = ""
        self._results_cache: list[WorkerPhaseResult] | None = None
        # incremental live-stats merge: per-host deltas fold into one
        # running total at poll time, so the master's live/status surface
        # is O(1) per refresh regardless of pod size
        self._live_lock = threading.Lock()
        self._live_total = LiveOps()
        self._live_prev: dict[str, LiveOps] = {}

    # ------------------------------------------------------------- lifecycle

    def _fanout_limit(self) -> int:
        return max(1, min(int(self.cfg.svc_fanout or 1),
                          len(self.proxies) or 1))

    def _fanout(self, fn, what: str) -> list[str]:
        """Run fn(proxy) over every host with bounded parallelism;
        returns the host-framed error strings, host-sorted (every line is
        framed "service <host>: ...", so the sort is deterministic for
        multi-host failures regardless of completion order)."""
        errors: list[str] = []
        lock = threading.Lock()

        def run(p: RemoteHostProxy) -> None:
            try:
                fn(p)
            except Exception as e:  # any failure must surface, host-framed
                msg = str(e) if isinstance(e, ProgException) \
                    else f"service {p.host}: {what} failed: {e}"
                with lock:
                    errors.append(msg)

        with ThreadPoolExecutor(max_workers=self._fanout_limit(),
                                thread_name_prefix=f"svc-{what}") as ex:
            list(ex.map(run, self.proxies))
        return sorted(errors)

    def prepare(self) -> None:
        def prep(p: RemoteHostProxy) -> None:
            t0 = time.monotonic_ns()
            try:
                p.prepare()
            finally:
                p.prepare_ns = time.monotonic_ns() - t0

        errors = self._fanout(prep, "prepare")
        if errors or any(p.path_info is None for p in self.proxies):
            raise ProgException("\n".join(errors)
                                or "service prepare failed")
        # cross-service consistency (reference: WorkerManager.cpp:390-402)
        self.cfg.check_service_bench_path_infos(
            [p.path_info for p in self.proxies], self.cfg.hosts)

    def time_limit_hit(self) -> bool:
        return any(p.time_limit_hit for p in self.proxies)

    def data_path_tier(self) -> str | None:
        """Pod-wide engagement-confirmed tier: the LOWEST tier any service
        actually rode (staged < xfer_mgr < zero_copy). One host silently
        falling back must downgrade the pod's claim — reporting the best
        host's tier would reintroduce per-leg mispricing for everyone
        below it."""
        ladder = {"staged": 0, "xfer_mgr": 1, "zero_copy": 2}
        tiers = [p.data_path_tier for p in self.proxies
                 if p.data_path_tier is not None]
        if not tiers:
            return None
        return min(tiers, key=lambda t: ladder.get(t, -1))

    def reg_cache_stats(self) -> dict[str, int] | None:
        """Registration-cache counters summed across services (gauges too:
        pinned bytes are pod-wide pinned memory; the peak sum is an upper
        bound, not a simultaneous pod peak)."""
        stats = [p.reg_cache for p in self.proxies if p.reg_cache]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def d2h_tier(self) -> str | None:
        """Pod-wide confirmed D2H tier: the LOWEST tier any service rode
        (serial < deferred) — one host silently running the serial path
        must downgrade the pod's claim, same rule as data_path_tier()."""
        ladder = {"serial": 0, "deferred": 1}
        tiers = [p.d2h_tier for p in self.proxies if p.d2h_tier is not None]
        if not tiers:
            return None
        return min(tiers, key=lambda t: ladder.get(t, -1))

    def d2h_stats(self) -> dict[str, int] | None:
        """Deferred-D2H counters summed across services (await-wait sums
        are pod-aggregate blocked time, not wall time)."""
        stats = [p.d2h_stats for p in self.proxies if p.d2h_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def stripe_tier(self) -> str | None:
        """Pod-wide confirmed striped-fill tier: the LOWEST tier any
        service rode (single < striped) — one host's plan degenerating to
        a single lane must downgrade the pod's claim, same rule as
        data_path_tier()/d2h_tier()."""
        ladder = {"single": 0, "striped": 1}
        tiers = [p.stripe_tier for p in self.proxies
                 if p.stripe_tier is not None]
        if not tiers:
            return None
        return min(tiers, key=lambda t: ladder.get(t, -1))

    def stripe_stats(self) -> dict[str, int] | None:
        """Striped-fill counters summed across services (barrier-wait sums
        are pod-aggregate blocked time, not wall time)."""
        stats = [p.stripe_stats for p in self.proxies if p.stripe_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def _first_error(self, attr: str) -> str | None:
        """First-host framed error: the LOWEST-ranked host's framed
        message, folded through the commutative binary merge (NOT first
        match in poll order — rank selection keeps the fold
        associative, so a relay tier can merge partial merges)."""
        best: tuple[int, str] | None = None
        for p in self.proxies:
            val = getattr(p, attr, None)
            if val:
                best = merge_first_host_error(
                    best, (p.host_index, f"service {p.host}: {val}"))
        return best[1] if best else None

    def stripe_error(self) -> str | None:
        """First stripe-unit failure across the pod, host-framed."""
        return self._first_error("stripe_error")

    def ckpt_stats(self) -> dict[str, int] | None:
        """Checkpoint-restore counters fanned in pod-wide: every host
        restores ITS shard partition (rank % num_dataset_threads), so
        shards_resident / resident_wait_ns / barriers SUM across hosts
        while shards_total — each host reports the full manifest count —
        takes the max. The summed shards_resident reconciling with the
        manifest count is the pod-level all-resident confirmation."""
        stats = [p.ckpt_stats for p in self.proxies if p.ckpt_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                if k == "shards_total":
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def ckpt_dev_bytes(self) -> list[int] | None:
        """Per-device resident checkpoint bytes summed index-wise across
        services (device i of every host is that host's selected device
        i — the pod aggregate says how much checkpoint data device-i
        slots hold pod-wide)."""
        per_host = [p.ckpt_dev_bytes for p in self.proxies
                    if p.ckpt_dev_bytes]
        if not per_host:
            return None
        out: list[int] = []
        for devs in per_host:
            while len(out) < len(devs):
                out.append(0)
            for i, v in enumerate(devs):
                out[i] += v
        return out

    def ckpt_error(self) -> str | None:
        """First restore failure across the pod, host-framed."""
        return self._first_error("ckpt_error")

    def reshard_tier(self) -> str | None:
        """Pod-wide confirmed reshard move tier: the LOWEST tier any
        service rode (bounce < d2d) — one host whose moves all bounced
        must downgrade the pod's D2D claim, same pod-lowest rule as
        data_path_tier()."""
        ladder = {"bounce": 0, "d2d": 1}
        tiers = [p.reshard_tier for p in self.proxies
                 if p.reshard_tier is not None]
        if not tiers:
            return None
        return min(tiers, key=lambda t: ladder.get(t, -1))

    def reshard_stats(self) -> dict[str, int] | None:
        """ReshardStats fanned in pod-wide: every host executes ITS unit
        partition (unit % num_dataset_threads spans hosts), so the
        executed outcome/byte/move counters SUM, while the PLAN-derived
        counts — units_total and units_resident (action-0 units need no
        execution, so every host reports the full plan's counts) — take
        the max. The combined unit outcomes reconciling with the plan
        count is the pod-level all-resharded confirmation, like ckpt
        shards_resident."""
        stats = [p.reshard_stats for p in self.proxies if p.reshard_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                if k in ("units_total", "units_resident"):
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def reshard_pairs(self) -> list[dict[str, int]] | None:
        """The src->dst lane-pair matrix summed pair-wise across services
        (pair (s, d) of every host is that host's selected lanes s/d —
        the pod aggregate says how much reshard traffic each lane pair
        carried pod-wide)."""
        per_host = [p.reshard_pairs for p in self.proxies
                    if p.reshard_pairs]
        if not per_host:
            return None
        acc: dict[tuple[int, int], dict[str, int]] = {}
        for pairs in per_host:
            for pair in pairs:
                key = (int(pair.get("src", -1)), int(pair.get("dst", -1)))
                slot = acc.setdefault(key, {"src": key[0], "dst": key[1],
                                            "moves": 0, "bytes": 0})
                slot["moves"] += int(pair.get("moves", 0))
                slot["bytes"] += int(pair.get("bytes", 0))
        return [acc[k] for k in sorted(acc)]

    def reshard_error(self) -> str | None:
        """First reshard failure across the pod, host-framed."""
        return self._first_error("reshard_error")

    def ingest_tier(self) -> str | None:
        """Pod-wide confirmed ingest tier: the LOWEST tier any service
        confirmed (serial < pipelined) — one host whose prefetch never
        overlapped downgrades the pod's claim, same pod-lowest rule as
        the data-path tiers. None until a host confirms one."""
        ladder = {"serial": 0, "pipelined": 1}
        tiers = [p.ingest_tier for p in self.proxies
                 if p.ingest_tier is not None]
        if not tiers:
            return None
        return min(tiers, key=lambda t: ladder.get(t, -1))

    def ingest_stats(self) -> dict | None:
        """IngestStats fanned in pod-wide: every host ingests ITS record
        partition, so the record counters SUM (overall and per epoch)
        while prefetch_depth_peak and shuffle_window take the max and
        each epoch's time is the SLOWEST host's (the epoch ends when the
        last rank finishes, like a training step's all-reduce)."""
        stats = [p.ingest_stats for p in self.proxies if p.ingest_stats]
        if not stats:
            return None
        out: dict = {}
        for st in stats:
            for k, v in st.items():
                if k in ("prefetch_depth_peak", "shuffle_window"):
                    out[k] = max(out.get(k, 0), v)
                elif k == "epochs":
                    epochs = out.setdefault("epochs", [])
                    for i, e in enumerate(v):
                        while len(epochs) <= i:
                            epochs.append({})
                        for ek, ev in e.items():
                            epochs[i][ek] = epochs[i].get(ek, 0) + ev
                elif k == "epoch_time_ns":
                    times = out.setdefault("epoch_time_ns", [])
                    for i, t in enumerate(v):
                        while len(times) <= i:
                            times.append(0)
                        times[i] = max(times[i], t)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def ingest_error(self) -> str | None:
        """First ingest failure across the pod, host-framed."""
        return self._first_error("ingest_error")

    def arrival_mode(self) -> str | None:
        """Pod-wide resolved arrival mode: the LOWEST mode any service
        actually ran (closed < poisson/paced) — one host whose
        EBT_LOAD_CLOSED_LOOP (or missing open-loop config) downgraded it
        to closed must downgrade the pod's claim, same pod-lowest rule as
        the data-path tiers."""
        ladder = {"closed": 0, "poisson": 1, "paced": 2}
        modes = [p.arrival_mode for p in self.proxies
                 if p.arrival_mode is not None]
        if not modes:
            return None
        return min(modes, key=lambda m: ladder.get(m, -1))

    def tenant_stats(self) -> list[dict[str, int]] | None:
        """Per-tenant-class accounting fanned in pod-wide: classes are
        global (rank % K spans hosts), so arrivals/completions/lag/dropped
        SUM index-wise while backlog_peak takes the max (a pod backlog
        peak is the worst single-worker backlog, not a sum of
        non-simultaneous peaks)."""
        per_host = [p.tenant_stats for p in self.proxies if p.tenant_stats]
        if not per_host:
            return None
        out: list[dict[str, int]] = []
        for classes in per_host:
            for cls in classes:
                i = int(cls.get("tenant", 0))
                while len(out) <= i:
                    out.append({"tenant": len(out)})
                for k, v in cls.items():
                    if k == "tenant":
                        continue
                    if k == "backlog_peak":
                        out[i][k] = max(out[i].get(k, 0), v)
                    else:
                        out[i][k] = out[i].get(k, 0) + v
        return out

    def tenant_latency(self) -> dict[str, LatencyHistogram]:
        """Per-tenant-class latency histograms merged across services by
        class label (classes are pod-global, so same-label histograms
        merge rather than staying host-prefixed like per-chip rows)."""
        out: dict[str, LatencyHistogram] = {}
        for p in self.proxies:
            for label, histo in p.tenant_lat_histos.items():
                if label in out:
                    out[label] += histo
                else:
                    merged = LatencyHistogram()
                    merged += histo
                    out[label] = merged
        return out

    def serving_stats(self) -> dict[str, int] | None:
        """ServingStats fanned in pod-wide: every host rotates its OWN
        manifest restore, so the lifecycle/throttle/byte counters SUM;
        the gauges take the pod's worst/latest view — rotation_generation
        and bg rates take the MIN (the pod is only as rotated as its
        slowest host; a budget gauge summed across hosts would claim a
        pod-wide rate no single lane enforces), ttr_last/ttr_max take the
        MAX, and rotation_restoring is 1 when ANY host is mid-restore."""
        stats = [p.serving_stats for p in self.proxies if p.serving_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        mins = ("rotation_generation", "bg_rate_bps", "bg_lane_rate_bps")
        maxs = ("ttr_last_ns", "ttr_max_ns")
        anys = ("rotation_restoring",)
        for st in stats:
            for k, v in st.items():
                if k in mins:
                    out[k] = min(out.get(k, v), v)
                elif k in maxs:
                    out[k] = max(out.get(k, 0), v)
                elif k in anys:
                    out[k] = max(out.get(k, 0), 1 if v else 0)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def rotation_ttr_ns(self) -> list[int] | None:
        """Per-rotation restore times fanned in pod-wide, keyed by
        GENERATION through each host's rotation records (ttr entry i and
        record i are the host's i-th COMPLETED rotation, in order — a
        host whose rotation g failed has neither, and index-zipping
        would mix times of different rotations): a generation every
        reporting host swapped takes the MAX of its hosts' times (the
        pod's rotation is only as fast as its slowest host — the ingest
        epoch-time rule)."""
        hosts = [(p.rotation_ttr_ns, p.rotation_records or [])
                 for p in self.proxies if p.rotation_ttr_ns]
        if not hosts:
            return None
        by_gen: list[dict[int, int]] = []
        for ttrs, recs in hosts:
            if len(recs) == len(ttrs):
                by_gen.append({int(r["generation"]): t
                               for r, t in zip(recs, ttrs)})
            else:  # no records to key on: fall back to completion order
                by_gen.append(dict(enumerate(ttrs, start=1)))
        common = set(by_gen[0])
        for host in by_gen[1:]:
            common &= set(host)
        return [max(host[gen] for host in by_gen)
                for gen in sorted(common)]

    def rotation_records(self) -> list[dict[str, int]] | None:
        """Per-rotation reconciliation records fanned in pod-wide, keyed
        by GENERATION (a host whose rotation g failed has no record for
        g — zipping by list index would sum records of different
        rotations): shard/byte counters SUM per generation (every host
        restored its own manifest copy), and only generations every
        reporting host swapped count (the pod swapped a generation only
        when all its hosts did)."""
        lists = [p.rotation_records for p in self.proxies
                 if p.rotation_records]
        if not lists:
            return None
        by_gen = [{int(r["generation"]): r for r in recs}
                  for recs in lists]
        common = set(by_gen[0])
        for host in by_gen[1:]:
            common &= set(host)
        out: list[dict[str, int]] = []
        for gen in sorted(common):
            merged: dict[str, int] = {"generation": gen}
            for host in by_gen:
                for k, v in host[gen].items():
                    if k != "generation":
                        merged[k] = merged.get(k, 0) + v
            out.append(merged)
        return out

    def reactor_stats(self) -> dict[str, int] | None:
        """Reactor wakeup counters summed across services (pod-aggregate
        wait/wakeup counts; the engagement confirmation is the DELTA a
        consumer records around its phase)."""
        stats = [p.reactor_stats for p in self.proxies if p.reactor_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def reactor_enabled(self) -> bool | None:
        """Pod-wide reactor engagement: the LOWEST claim any service made
        (one host falling back to the polling shape downgrades the pod,
        the same pod-lowest rule as the data-path tiers). None when no
        service reported."""
        vals = [p.reactor_enabled for p in self.proxies
                if p.reactor_enabled is not None]
        if not vals:
            return None
        return all(vals)

    def reactor_cause(self) -> str | None:
        """First reactor-inactive cause across the pod, host-framed."""
        return self._first_error("reactor_cause")

    def numa_stats(self) -> dict[str, int] | None:
        """NumaTk placement counters: byte/fallback totals summed across
        services, numa_nodes MAXED (hosts report their own detected
        topology; the pod figure is the widest box, not a sum)."""
        stats = [p.numa_stats for p in self.proxies if p.numa_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                if k == "numa_nodes":
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def fault_stats(self) -> dict[str, int] | None:
        """Device-side fault counters summed across services (ejections
        and replans are pod-aggregate counts; backoff sums are aggregate
        blocked time, not wall time)."""
        stats = [p.fault_stats for p in self.proxies if p.fault_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def engine_fault_stats(self) -> dict[str, int] | None:
        """Engine-side retry/budget counters summed across services."""
        stats = [p.engine_fault_stats for p in self.proxies
                 if p.engine_fault_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def fault_causes(self) -> str | None:
        """Per-cause attributions fanned in host-framed ('; '-joined) so
        a pod-level cause list still names where each family failed.
        Folded through the rank-keyed dict union and rendered in rank
        order, so the pod string is poll-order-independent."""
        frames: dict[int, str] = {}
        for p in self.proxies:
            if p.fault_causes:
                frames = merge_host_keyed(
                    frames, {p.host_index: f"[{p.host}] {p.fault_causes}"})
        if not frames:
            return None
        return "; ".join(frames[i] for i in sorted(frames))

    def ejected_devices(self) -> str | None:
        """Ejection attributions fanned in host-framed, newline-joined —
        "service H: device N: cause" per ejected lane pod-wide. Same
        rank-keyed union + rank-order render as fault_causes()."""
        frames: dict[int, str] = {}
        for p in self.proxies:
            if not p.ejected_devices:
                continue
            framed = "\n".join(f"service {p.host}: {ln}"
                               for ln in p.ejected_devices.splitlines())
            frames = merge_host_keyed(frames, {p.host_index: framed})
        if not frames:
            return None
        return "\n".join(frames[i] for i in sorted(frames))

    def degraded_hosts(self) -> list[dict]:
        """Hosts that died/hung mid-phase (--hosttimeout) with their
        host-attributed causes — the pod summary's `degraded` evidence.
        Empty when every host stayed reachable."""
        return [{"host": p.host, "cause": p.error}
                for p in self.proxies if p.status == "dead"]

    def host_timings(self) -> list[dict]:
        """Per-host control-plane timing export (HOST_TIMING_FIELDS):
        prepare wall time, start skew vs the pod's earliest host, peak
        status-poll schedule lag, and the ok/straggler/dead status word —
        the straggler/dead attribution surface of the bounded fan-out."""
        return [{"host": p.host, "prepare_ns": p.prepare_ns,
                 "start_skew_ns": p.start_skew_ns,
                 "poll_lag_ns": p.poll_lag_ns, "status": p.status}
                for p in self.proxies]

    def io_engine(self) -> str | None:
        """Pod-wide resolved storage backend: the LOWEST engine any
        service rode (aio < uring) — one host falling back to kernel AIO
        must downgrade the pod's claim, the same pod-lowest rule as the
        data-path tiers. None when no service reported one."""
        ladder = {"aio": 0, "uring": 1}
        engines = [p.io_engine for p in self.proxies
                   if p.io_engine is not None]
        if not engines:
            return None
        return min(engines, key=lambda e: ladder.get(e, -1))

    def io_engine_cause(self) -> str | None:
        """First AIO-fallback cause across the pod, host-framed."""
        return self._first_error("io_engine_cause")

    def uring_stats(self) -> dict[str, int] | None:
        """Unified-registration counters summed across services
        (register-time sums are pod-aggregate time, not wall time)."""
        stats = [p.uring_stats for p in self.proxies if p.uring_stats]
        if not stats:
            return None
        out: dict[str, int] = {}
        for st in stats:
            for k, v in st.items():
                out[k] = out.get(k, 0) + v
        return out

    def lane_stats(self) -> list[dict[str, int]] | None:
        """Per-lane counters summed index-wise across services (lane i of
        every host is that host's device i — the pod aggregate says how
        device-i lanes behaved pod-wide; lock-wait sums are aggregate
        blocked time, not wall time)."""
        per_host = [p.lane_stats for p in self.proxies if p.lane_stats]
        if not per_host:
            return None
        out: list[dict[str, int]] = []
        for lanes in per_host:
            for lane in lanes:
                i = int(lane.get("lane", 0))
                while len(out) <= i:
                    out.append({"lane": len(out)})
                for k, v in lane.items():
                    if k == "lane":
                        continue
                    out[i][k] = out[i].get(k, 0) + v
        return out

    def device_latency(self) -> dict[str, LatencyHistogram]:
        """Master-side fan-in: each service's per-chip histograms, prefixed
        with the host so chips stay distinguishable across the pod."""
        out: dict[str, LatencyHistogram] = {}
        for p in self.proxies:
            for label, histo in p.dev_lat_histos.items():
                out[f"{p.host}:{label}"] = histo
        return out

    def device_latency_clock(self) -> dict[str, str]:
        """Per-chip clock sources fanned in from the services (hosts in a
        pod can run different backends, so provenance stays per label)."""
        out: dict[str, str] = {}
        for p in self.proxies:
            for label, clock in p.dev_lat_clock.items():
                out[f"{p.host}:{label}"] = clock
        return out

    def start_phase(self, phase: BenchPhase, bench_id: str) -> None:
        self._bench_id = bench_id
        self._results_cache = None
        self._phase_over.clear()
        with self._live_lock:
            self._live_total = LiveOps()
            self._live_prev = {}
        start_ns: dict[str, int] = {}
        ns_lock = threading.Lock()

        def start(p: RemoteHostProxy) -> None:
            p.error = ""
            p.workers_done = 0
            p.workers_error = 0
            p.live = LiveOps()
            p.status = "ok"
            p.poll_lag_ns = 0
            p.start_skew_ns = 0
            p.start_phase(phase, bench_id)
            with ns_lock:
                start_ns[p.host] = time.monotonic_ns()

        errors = self._fanout(start, "start")
        if errors:
            # hosts whose start succeeded are now running the phase with no
            # master attached - stop them before reporting (host-sorted by
            # the fan-out helper, so multi-host failures read
            # deterministically)
            for p in self.proxies:
                p.interrupt()
            raise ProgException("\n".join(errors))
        # start skew: each host's /startphase completion vs the pod's
        # earliest — the pod-scale ragged-start evidence. With bounded
        # fan-out the tail hosts START later by design; the export makes
        # that cost visible instead of folding it into phase time.
        if start_ns:
            first = min(start_ns.values())
            for p in self.proxies:
                p.start_skew_ns = start_ns.get(p.host, first) - first
                p.last_ok = time.monotonic()

        # status polling: a bounded pool of pollers, each owning a static
        # partition of the hosts (hosts[k::n]) — at most --svcfanout
        # threads/requests however large the pod is
        n = self._fanout_limit()
        self._threads = [threading.Thread(target=self._poll_partition,
                                          args=(self.proxies[k::n],),
                                          daemon=True) for k in range(n)]
        for t in self._threads:
            t.start()

    def _merge_live(self, proxy: RemoteHostProxy) -> None:
        """Fold one host's fresh live counters into the running pod total
        (incremental merge: one delta per poll, no per-refresh rescan)."""
        with self._live_lock:
            prev = self._live_prev.get(proxy.host)
            self._live_total += (proxy.live - prev) if prev is not None \
                else proxy.live
            self._live_prev[proxy.host] = proxy.live

    def live_total(self) -> LiveOps:
        """The incrementally merged pod-wide live total."""
        with self._live_lock:
            return LiveOps() + self._live_total

    def _poll_partition(self, hosts: list[RemoteHostProxy]) -> None:
        """Status polling for one static host partition at the svcupint
        interval (reference: RemoteWorker.cpp:335-410, reworked from one
        thread per host to a bounded poller pool). Per-host schedule
        bookkeeping feeds the straggler detector: a host whose replies
        peak-lag behind schedule is flagged by name, and a host that
        produces NO successful reply for --hosttimeout is declared
        dead/hung with a host-attributed cause and the phase is
        interrupted on the remaining hosts instead of blocking forever."""
        interval = max(0.05, self.cfg.svc_update_interval_ms / 1000.0)
        # short per-request timeout: one hung connection must not starve
        # the partition-mates for urlopen's default 20s
        poll_timeout = max(1.0, min(10.0,
                                    float(self.cfg.host_timeout_secs) / 3.0))
        straggler_lag_s = max(2.0 * interval, 1.0)
        active = list(hosts)
        due = {p.host: time.monotonic() + interval for p in active}
        while active and not self._phase_over.is_set():
            now = time.monotonic()
            for p in list(active):
                if self._phase_over.is_set():
                    return
                host_due = due[p.host]
                if time.monotonic() < host_due:
                    continue
                req_t0 = time.monotonic()
                try:
                    p.poll_status(self._bench_id, timeout=poll_timeout)
                except ServiceUnreachable as e:
                    silent = time.monotonic() - p.last_ok
                    if silent >= float(self.cfg.host_timeout_secs):
                        p.status = "dead"
                        p.error = (
                            f"service {p.host}: no status reply for "
                            f"{silent:.1f}s (--hosttimeout "
                            f"{self.cfg.host_timeout_secs:g}s) - declared "
                            f"dead/hung ({e}); interrupting the phase on "
                            "the remaining hosts")
                        self._on_host_error(p)
                        return
                    due[p.host] = time.monotonic() + interval
                    continue
                except ProgException as e:
                    p.error = str(e)
                    self._on_host_error(p)
                    return
                except Exception as e:
                    # a malformed reply (non-numeric field, wrong shape)
                    # raises outside the ProgException taxonomy; letting
                    # it kill this poller would silently stop polling the
                    # WHOLE partition and hang the phase with no cause
                    p.error = (f"service {p.host}: status poll failed: "
                               f"{type(e).__name__}: {e}")
                    self._on_host_error(p)
                    return
                done_t = time.monotonic()
                p.last_ok = done_t
                # schedule lag of this poll (reply completion vs due time):
                # the peak is the exported per-host poll_lag_ns evidence
                lag_ns = int(max(0.0, done_t - host_due) * 1e9)
                if lag_ns > p.poll_lag_ns:
                    p.poll_lag_ns = lag_ns
                # straggler attribution keys on the host's OWN reply time,
                # not the schedule lag: a slow partition-mate delays
                # everyone's schedule (head-of-line), and blaming the
                # victims would bury the actual straggler's name
                own_ns = int((done_t - req_t0) * 1e9)
                if own_ns > straggler_lag_s * 1e9 and p.status == "ok":
                    p.status = "straggler"
                    LOGGER.warning(
                        f"service {p.host}: status reply took "
                        f"{own_ns / 1e6:.0f}ms against the "
                        f"{interval * 1000:.0f}ms poll schedule "
                        "(straggler)")
                self._merge_live(p)
                if p.workers_error > 0:
                    p.error = f"service {p.host}: worker failed"
                    self._on_host_error(p)
                    return
                if p.workers_done >= self.cfg.num_threads:
                    active.remove(p)
                    continue
                # keep the nominal cadence; after a stall, resume from now
                # instead of burst-draining the missed polls
                nxt = host_due + interval
                due[p.host] = nxt if nxt > done_t else done_t + interval
            if active:
                soonest = min(due[p.host] for p in active)
                self._phase_over.wait(
                    min(interval, max(0.005, soonest - time.monotonic())))

    def _on_host_error(self, failed: RemoteHostProxy) -> None:
        """One failed host interrupts the phase on all others immediately
        (reference error fan-out: WorkerManager.cpp:44-57 applied to the
        remote tier), and wakes the master's wait loop."""
        self._phase_over.set()
        for p in self.proxies:
            if p is not failed:
                p.interrupt()

    def wait_done(self, timeout_ms: int) -> int:
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            if any(p.error for p in self.proxies):
                # error fan-out already interrupted the other hosts; report
                # promptly instead of waiting for their full phase
                self._phase_over.set()
                for t in self._threads:
                    t.join(timeout=5.0)
                return 2
            alive = [t for t in self._threads if t.is_alive()]
            if not alive:
                self._phase_over.set()
                return 2 if any(p.error or p.workers_error
                                for p in self.proxies) else 1
            if time.monotonic() >= deadline:
                return 0
            alive[0].join(timeout=min(0.1, max(0.0,
                                               deadline - time.monotonic())))

    def interrupt(self) -> None:
        self._phase_over.set()
        for p in self.proxies:
            p.interrupt()

    def teardown(self) -> None:
        phase_active = any(t.is_alive() for t in self._threads)
        self._phase_over.set()
        if phase_active:
            # master going away mid-phase: stop the remote workers too
            for p in self.proxies:
                p.interrupt()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    # ----------------------------------------------------------------- stats

    slot_label = "Host"

    def slot_names(self) -> list[str]:
        return [p.host for p in self.proxies]

    def num_slots(self) -> int:
        return len(self.proxies)

    def live_snapshot(self) -> list[WorkerSnapshot]:
        return [WorkerSnapshot(ops=p.live,
                               done=p.workers_done >= self.cfg.num_threads,
                               has_error=bool(p.error or p.workers_error))
                for p in self.proxies]

    def phase_results(self) -> list[WorkerPhaseResult]:
        if self._results_cache is not None:
            return self._results_cache
        out: list[WorkerPhaseResult | None] = [None] * len(self.proxies)

        def fetch(p: RemoteHostProxy):
            i = p.host_index
            if p.status == "dead":
                # a host --hosttimeout declared dead gets NO result fetch:
                # a 60s HTTP timeout against a hung host would stall the
                # whole pod's fan-in, and its partial results are
                # unreachable anyway. The live hosts' results are fetched
                # normally — the pod result is SALVAGED from them, with
                # this host named (the coordinator's degraded summary).
                out[i] = WorkerPhaseResult(
                    error=p.error or f"service {p.host}: declared dead "
                                     "(--hosttimeout); results abandoned")
                return
            try:
                res = p.fetch_result()
            except Exception as e:
                res = WorkerPhaseResult(
                    error=str(e) if isinstance(e, ProgException)
                    else f"service {p.host}: result fetch failed: {e}")
            if p.error and not res.error:
                res.error = p.error
            out[i] = res

        # bounded fan-out like prepare/start/status: the result fetch is
        # the fourth pod-scale control-plane leg
        self._fanout(fetch, "result-fetch")
        self._results_cache = out
        return out

    def first_error(self) -> str:
        for p in self.proxies:
            if p.error:
                return p.error
        return super().first_error()
