"""Live streaming observability: the Prometheus-text-format /metrics surface.

Port of the original package's metrics.py. Every benchmark process exposes
the same scrape surface: the service daemon serves `GET /metrics` on its
HTTP listener (service.py), and a master or local run serves the same
families from the merged totals via `--metricsport` (MetricsServer below).
Everything rides the WorkerGroup accessor surface (workers/base.py), so the
exported numbers are exactly the counter families the result tree is built
from, under the original's names.

Every family of the original is carried, the stripe, checkpoint, reshard,
ingest and serving-rotation ones included. METRIC_FAMILIES lists what the
port emits.

Consistency rules (the scrape-during-phase-transition contract):
  - each counter family is read through ONE accessor call, so the samples
    inside a family are mutually consistent (e.g. a tenant class's
    arrivals/completions/dropped come from the same snapshot);
  - a family whose accessor fails mid-transition (engine being torn down,
    group not yet prepared) is dropped WHOLE for that scrape — a scrape
    never contains a partial family;
  - `ebt_scrape_ok` says whether a prepared benchmark backed the scrape;
    a service with no prepared benchmark still answers 200 with the
    static families (build info, scrape_ok 0) so pollers see "up".

The module also ships the strict text-format parser the tests use to
assert every scrape is valid Prometheus exposition text.
"""

from __future__ import annotations

import re
import threading

from .common import PROTOCOL_VERSION, BenchPhase, phase_name
from .exceptions import ProgException
from .logger import LOGGER

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# The exported metric name set: (family, type, help). THE registry — the
# renderer may only emit families listed here; every name is the
# original's.
METRIC_FAMILIES = (
    ("ebt_build_info", "gauge",
     "Constant 1; labels carry version, protocol and role (master/service/"
     "campaign)."),
    ("ebt_scrape_ok", "gauge",
     "1 when a prepared benchmark backed this scrape, 0 otherwise."),
    ("ebt_phase_code", "gauge",
     "Active phase code, labelled with the phase name."),
    ("ebt_workers_total", "gauge", "Worker slots in the group."),
    ("ebt_workers_done", "gauge", "Worker slots finished with the phase."),
    ("ebt_workers_errored", "gauge", "Worker slots finished in error."),
    ("ebt_bytes_done_total", "counter",
     "Bytes moved in the current/last phase (live merged total)."),
    ("ebt_entries_done_total", "counter",
     "Entries processed in the current/last phase."),
    ("ebt_ops_done_total", "counter",
     "I/O operations completed in the current/last phase."),
    ("ebt_tenant_arrivals_total", "counter",
     "Open-loop scheduled arrivals that came due, per tenant class."),
    ("ebt_tenant_completions_total", "counter",
     "Open-loop completions, per tenant class."),
    ("ebt_tenant_dropped_total", "counter",
     "Open-loop due arrivals never issued (timelimit/interrupt/budget), "
     "per tenant class; arrivals == completions + dropped."),
    ("ebt_tenant_backlog_peak", "gauge",
     "Peak due-but-unissued arrivals, per tenant class."),
    ("ebt_tenant_sched_lag_seconds_total", "counter",
     "Issue-behind-schedule time per tenant class (coordinated omission "
     "measured, not masked)."),
    ("ebt_tenant_latency_seconds", "summary",
     "Per-tenant-class op latency clocked from the SCHEDULED arrival "
     "(p50/p90/p99 quantile series + _count/_sum)."),
    ("ebt_device_xfer_latency_seconds", "summary",
     "Per-chip transfer latency (enqueue -> data-on-device), quantile "
     "series + _count/_sum per device label."),
    ("ebt_fault_io_retries_total", "counter",
     "Engine-side storage-op retry attempts (--retry)."),
    ("ebt_fault_dev_retries_total", "counter",
     "Device-side recovery resubmit attempts."),
    ("ebt_fault_errors_tolerated_total", "counter",
     "Failures absorbed by the --maxerrors budget."),
    ("ebt_fault_ejected_devices", "gauge",
     "Devices ejected by tripped per-lane error budgets (sticky for the "
     "session)."),
    ("ebt_fault_replanned_units_total", "counter",
     "Placements re-routed through survivor lanes after an ejection."),
    ("ebt_reactor_waits_total", "counter",
     "Unified completion-reactor ppoll waits."),
    ("ebt_reactor_wakeups_total", "counter",
     "Reactor wakeups by cause (cq/onready/arrival/timeout/interrupt/"
     "coalesced); the five primary causes sum to the waits."),
    ("ebt_backlog_gauge", "gauge",
     "Max per-class backlog peak over the group (due-but-unissued "
     "arrivals) — the saturation gauge for open-loop soaks."),
    ("ebt_stripe_units_total", "counter",
     "Mesh-striped fill units by state (submitted/awaited); the two "
     "states reconcile exactly at the gather barrier."),
    ("ebt_ckpt_shards_total", "gauge",
     "Checkpoint-restore shards in the manifest plan."),
    ("ebt_ckpt_shards_resident", "gauge",
     "Shards whose resident bytes reconciled at the all-resident "
     "barrier."),
    ("ebt_ingest_records_total", "counter",
     "DL-ingestion records by outcome (read/resident/dropped); "
     "read == resident + dropped."),
    ("ebt_reshard_units_total", "gauge",
     "Reshard plan units (N->M topology shift)."),
    ("ebt_reshard_units_settled_total", "counter",
     "Reshard units settled by action (resident/moved/read)."),
    ("ebt_reshard_moves_total", "counter",
     "Reshard chunk moves by tier (d2d/bounce)."),
    ("ebt_serving_sched_rate", "gauge",
     "CURRENT scheduled offered rate (arrivals/s per worker) per tenant "
     "class — the --arrival trace schedule's instantaneous rate, or the "
     "static class rate."),
    ("ebt_serving_goodput_fraction", "gauge",
     "Fraction of completions under the class's SLO latency target on "
     "the scheduled-arrival clock (--slotarget / slo=), per tenant "
     "class."),
    ("ebt_rotation_generation", "gauge",
     "Published (swapped) model-rotation generation (--rotate)."),
    ("ebt_rotation_restoring", "gauge",
     "1 while a rotation restore generation is in flight (unswapped)."),
    ("ebt_rotation_bg_rate_bytes", "gauge",
     "Current background byte/s budget of the rotation token bucket "
     "(the adaptive controller moves it under the --bgbudget ceiling)."),
    ("ebt_rotation_ttr_seconds", "gauge",
     "Last completed rotation's restore time (begin -> all-resident "
     "swap)."),
    ("ebt_rotation_bg_throttle_seconds_total", "counter",
     "Time rotation I/O spent throttled by the background token buckets "
     "(storage-side + lane-side)."),
    ("ebt_rotations_total", "counter",
     "Model rotations by outcome (complete = restored, reconciled and "
     "swapped; failed = aborted before the swap)."),
    ("ebt_pod_hosts_total", "gauge",
     "Service hosts fanned in by this master (master role only)."),
    ("ebt_pod_degraded_hosts", "gauge",
     "Hosts declared dead/hung and salvaged around (DEGRADED summaries "
     "still scrape; master role only)."),
    ("ebt_campaign_stage_info", "gauge",
     "Constant 1 while a campaign stage runs; labels carry the campaign "
     "name, stage name and phase family (docs/CAMPAIGNS.md)."),
)

_FAMILY_BY_NAME = {f[0]: f for f in METRIC_FAMILIES}

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Renderer:
    """Accumulates exposition lines; HELP/TYPE emitted once per family,
    families appended atomically (see render_metrics)."""

    def __init__(self) -> None:
        self._lines: list[str] = []
        self._declared: set[str] = set()

    def sample(self, family: str, labels: dict | None, value,
               suffix: str = "") -> None:
        fam = _FAMILY_BY_NAME.get(family)
        if fam is None:  # registry is the contract; never invent names
            raise ValueError(f"metric family {family!r} is not in "
                             "METRIC_FAMILIES")
        if family not in self._declared:
            self._declared.add(family)
            self._lines.append(f"# HELP {family} {fam[2]}")
            self._lines.append(f"# TYPE {family} {fam[1]}")
        label_txt = ""
        if labels:
            label_txt = ("{" + ",".join(
                f'{k}="{_escape_label(v)}"'
                for k, v in sorted(labels.items())) + "}")
        if isinstance(value, float):
            txt = repr(value)
        else:
            txt = str(int(value))
        self._lines.append(f"{family}{suffix}{label_txt} {txt}")

    def merge(self, other: "_Renderer") -> None:
        self._lines.extend(other._lines)
        self._declared.update(other._declared)

    def text(self) -> str:
        return "\n".join(self._lines) + "\n"


def _summary(out: _Renderer, family: str, labels: dict, histo) -> None:
    """Quantile series + _count/_sum for one LatencyHistogram (seconds)."""
    if not histo.count:
        return
    for q, p in (("0.5", 50.0), ("0.9", 90.0), ("0.99", 99.0)):
        out.sample(family, {**labels, "quantile": q},
                   histo.percentile_us(p) / 1e6)
    out.sample(family, labels, histo.count, suffix="_count")
    out.sample(family, labels, histo.sum_us / 1e6, suffix="_sum")


def render_metrics(workers, cfg=None, phase: BenchPhase = BenchPhase.IDLE,
                   role: str = "service",
                   campaign: tuple[str, str, str] | None = None) -> str:
    """One scrape of the full metric surface from a WorkerGroup (local or
    remote/pod-merged) — or the static families alone when `workers` is
    None (nothing prepared). Never raises: a family whose accessor fails
    mid-transition is dropped whole for this scrape."""
    from . import __version__

    out = _Renderer()
    out.sample("ebt_build_info",
               {"version": __version__, "protocol": PROTOCOL_VERSION,
                "role": role}, 1)
    out.sample("ebt_scrape_ok", None, 1 if workers is not None else 0)
    if campaign:
        name, stage, fam = campaign
        out.sample("ebt_campaign_stage_info",
                   {"campaign": name, "stage": stage, "phase": fam}, 1)
    if workers is None:
        return out.text()

    rwmix = getattr(cfg, "rwmix_pct", 0) if cfg is not None else 0

    def family(build) -> None:
        # atomic append: build into a scratch renderer sharing the
        # declared set, merge only on success
        scratch = _Renderer()
        scratch._declared = set(out._declared)
        try:
            build(scratch)
        except Exception as e:  # mid-transition accessor failure
            LOGGER.debug(f"metrics: family dropped for this scrape: {e!r}")
            return
        out.merge(scratch)

    def phase_block(o: _Renderer) -> None:
        o.sample("ebt_phase_code", {"phase": phase_name(phase, rwmix)},
                 int(phase))

    def workers_block(o: _Renderer) -> None:
        snaps = workers.live_snapshot()
        o.sample("ebt_workers_total", None, len(snaps))
        o.sample("ebt_workers_done", None,
                 sum(1 for s in snaps if s.done))
        o.sample("ebt_workers_errored", None,
                 sum(1 for s in snaps if s.has_error))

    def totals_block(o: _Renderer) -> None:
        total = workers.live_total()
        o.sample("ebt_bytes_done_total", None, total.bytes)
        o.sample("ebt_entries_done_total", None, total.entries)
        o.sample("ebt_ops_done_total", None, total.iops)

    def tenants_block(o: _Renderer) -> None:
        tstats = workers.tenant_stats()
        if not tstats:
            return
        tlat = workers.tenant_latency()
        labels = list(tlat)
        backlog_max = 0
        for st in tstats:
            cls = int(st.get("tenant", 0))
            label = labels[cls] if cls < len(labels) else str(cls)
            lab = {"tenant": label}
            o.sample("ebt_tenant_arrivals_total", lab,
                     st.get("arrivals", 0))
            o.sample("ebt_tenant_completions_total", lab,
                     st.get("completions", 0))
            o.sample("ebt_tenant_dropped_total", lab, st.get("dropped", 0))
            o.sample("ebt_tenant_backlog_peak", lab,
                     st.get("backlog_peak", 0))
            o.sample("ebt_tenant_sched_lag_seconds_total", lab,
                     st.get("sched_lag_ns", 0) / 1e9)
            backlog_max = max(backlog_max, st.get("backlog_peak", 0))
        o.sample("ebt_backlog_gauge", None, backlog_max)
        for label, histo in tlat.items():
            _summary(o, "ebt_tenant_latency_seconds", {"tenant": label},
                     histo)

    def device_block(o: _Renderer) -> None:
        for label, histo in sorted(workers.device_latency().items()):
            _summary(o, "ebt_device_xfer_latency_seconds",
                     {"device": label}, histo)

    def faults_block(o: _Renderer) -> None:
        efs = workers.engine_fault_stats() or {}
        dfs = workers.fault_stats() or {}
        if not efs and not dfs:
            return
        o.sample("ebt_fault_io_retries_total", None,
                 efs.get("io_retry_attempts", 0))
        o.sample("ebt_fault_dev_retries_total", None,
                 dfs.get("dev_retry_attempts", 0))
        o.sample("ebt_fault_errors_tolerated_total", None,
                 efs.get("errors_tolerated", 0))
        o.sample("ebt_fault_ejected_devices", None,
                 dfs.get("ejected_devices", 0))
        o.sample("ebt_fault_replanned_units_total", None,
                 dfs.get("replanned_units", 0))

    def reactor_block(o: _Renderer) -> None:
        rs = workers.reactor_stats() if hasattr(workers, "reactor_stats") \
            else None
        if not rs:
            return
        o.sample("ebt_reactor_waits_total", None,
                 rs.get("reactor_waits", 0))
        for cause in ("cq", "onready", "arrival", "timeout", "interrupt",
                      "coalesced"):
            o.sample("ebt_reactor_wakeups_total", {"cause": cause},
                     rs.get(f"reactor_wakeups_{cause}", 0))

    def stripe_block(o: _Renderer) -> None:
        st = workers.stripe_stats()
        if not st:
            return
        o.sample("ebt_stripe_units_total", {"state": "submitted"},
                 st.get("units_submitted", 0))
        o.sample("ebt_stripe_units_total", {"state": "awaited"},
                 st.get("units_awaited", 0))

    def ckpt_block(o: _Renderer) -> None:
        cs = workers.ckpt_stats()
        if not cs:
            return
        o.sample("ebt_ckpt_shards_total", None, cs.get("shards_total", 0))
        o.sample("ebt_ckpt_shards_resident", None,
                 cs.get("shards_resident", 0))

    def reshard_block(o: _Renderer) -> None:
        rs = workers.reshard_stats()
        if not rs:
            return
        o.sample("ebt_reshard_units_total", None, rs.get("units_total", 0))
        for action in ("resident", "moved", "read"):
            o.sample("ebt_reshard_units_settled_total", {"action": action},
                     rs.get(f"units_{action}", 0))
        o.sample("ebt_reshard_moves_total", {"tier": "d2d"},
                 rs.get("d2d_moves", 0))
        o.sample("ebt_reshard_moves_total", {"tier": "bounce"},
                 rs.get("bounce_moves", 0))

    def ingest_block(o: _Renderer) -> None:
        ist = workers.ingest_stats()
        if not ist:
            return
        for outcome in ("read", "resident", "dropped"):
            o.sample("ebt_ingest_records_total", {"outcome": outcome},
                     ist.get(f"records_{outcome}", 0))

    def serving_block(o: _Renderer) -> None:
        # scheduled-rate + SLO-goodput gauges ride the tenant classes
        # (open-loop only); the rotation gauges ride --rotate
        tstats = workers.tenant_stats() or []
        if tstats:
            tlat = workers.tenant_latency()
            labels = list(tlat)
            slo_armed = any(st.get("slo_ok", 0) for st in tstats) or bool(
                cfg is not None
                and (getattr(cfg, "slo_target_ms", 0)
                     or any(getattr(t, "slo_ms", 0)
                            for t in getattr(cfg, "tenant_classes", [])
                            or [])))
            for st in tstats:
                cls = int(st.get("tenant", 0))
                label = labels[cls] if cls < len(labels) else str(cls)
                rate = workers.sched_rate(cls)
                if rate is not None:
                    o.sample("ebt_serving_sched_rate", {"tenant": label},
                             float(rate))
                if slo_armed:
                    comp = st.get("completions", 0)
                    frac = st.get("slo_ok", 0) / comp if comp else 1.0
                    o.sample("ebt_serving_goodput_fraction",
                             {"tenant": label}, float(frac))
        svs = workers.serving_stats()
        if not svs:
            return
        o.sample("ebt_rotation_generation", None,
                 svs.get("rotation_generation", 0))
        o.sample("ebt_rotation_restoring", None,
                 svs.get("rotation_restoring", 0))
        o.sample("ebt_rotation_bg_rate_bytes", None,
                 svs.get("bg_rate_bps", 0))
        o.sample("ebt_rotation_ttr_seconds", None,
                 svs.get("ttr_last_ns", 0) / 1e9)
        o.sample("ebt_rotation_bg_throttle_seconds_total", None,
                 (svs.get("bg_throttle_ns", 0) +
                  svs.get("bg_lane_throttle_ns", 0)) / 1e9)
        o.sample("ebt_rotations_total", {"outcome": "complete"},
                 svs.get("rotations_complete", 0))
        o.sample("ebt_rotations_total", {"outcome": "failed"},
                 svs.get("rotations_failed", 0))

    def pod_block(o: _Renderer) -> None:
        timings = workers.host_timings()
        if timings is None:  # local group: no pod fan-in tier
            return
        o.sample("ebt_pod_hosts_total", None, len(timings))
        o.sample("ebt_pod_degraded_hosts", None,
                 len(workers.degraded_hosts()))

    for block in (phase_block, workers_block, totals_block, tenants_block,
                  device_block, faults_block, reactor_block, stripe_block,
                  ckpt_block, ingest_block, reshard_block, serving_block,
                  pod_block):
        family(block)
    return out.text()


# ----------------------------------------------------------- HTTP server

class MetricsServer:
    """Tiny /metrics-only HTTP listener for the master or local
    coordinator (--metricsport; the service daemon instead serves /metrics
    on its existing benchmark port). render_cb is called per scrape and
    must return exposition text."""

    def __init__(self, render_cb, port: int) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                LOGGER.debug(f"metrics http: {fmt % args}")

            def do_GET(self):  # noqa: N802
                if self.path.split("?", 1)[0] != "/metrics":
                    body = b"only /metrics lives here\n"
                    self.send_response(404)
                else:
                    try:
                        body = render_cb().encode()
                        self.send_response(200)
                    except Exception as e:
                        body = f"scrape failed: {e}\n".encode()
                        self.send_response(500)
                self.send_header("Content-Type", PROM_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self._server = ThreadingHTTPServer(("0.0.0.0", port), _H)
        except OSError as e:
            raise ProgException(
                f"metrics endpoint: cannot bind port {port}: {e}")
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="ebt-metrics", daemon=True)
        self._thread.start()
        LOGGER.info(f"metrics endpoint listening on :{self.port}/metrics")

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ------------------------------------------------------------ the parser

_SAMPLE_RE = re.compile(
    # the label block must be matched quote-aware: a '}' INSIDE a quoted
    # label value (legal exposition — the renderer escapes only \ " \n)
    # must not close it
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^"}]|"(?:[^"\\]|\\.)*")*)\})?'
    r"\s+(?P<value>[^\s]+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\["\\n])*)"$')


def parse_prometheus_text(text: str) -> dict:
    """Strict exposition-format validation. Returns
    {(family_sample_name, sorted-label-tuple): float}. Raises ValueError
    with a line-attributed cause on ANY deviation: unknown line shape,
    bad metric/label name, unquoted/misescaped label value, duplicate
    sample, non-float value, a sample before its family's TYPE line, or
    a TYPE naming an unknown type."""
    samples: dict = {}
    types: dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ValueError(f"line {i}: malformed {parts[1]} line")
            name = parts[2]
            if not _NAME_RE.match(name):
                raise ValueError(f"line {i}: bad metric name {name!r}")
            if parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                   "summary", "untyped"):
                    raise ValueError(
                        f"line {i}: unknown metric type {parts[3]!r}")
                types[name] = parts[3]
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: not a valid sample line: {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_count", "_sum", "_bucket"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
        if base not in types:
            raise ValueError(
                f"line {i}: sample {name!r} has no preceding TYPE line")
        labels = []
        raw = m.group("labels")
        if raw:
            for part in _split_labels(raw, i):
                lm = _LABEL_RE.match(part)
                if not lm:
                    raise ValueError(
                        f"line {i}: malformed label pair {part!r}")
                labels.append((lm.group("k"), lm.group("v")))
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {i}: non-numeric value {m.group('value')!r}")
        key = (name, tuple(sorted(labels)))
        if key in samples:
            raise ValueError(f"line {i}: duplicate sample {key}")
        samples[key] = value
    return samples


def _split_labels(raw: str, lineno: int) -> list[str]:
    """Split 'a="x",b="y"' respecting escaped quotes inside values."""
    out, cur, in_str, esc = [], [], False, False
    for ch in raw:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\" and in_str:
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_str = not in_str
            cur.append(ch)
            continue
        if ch == "," and not in_str:
            out.append("".join(cur).strip())
            cur = []
            continue
        cur.append(ch)
    if in_str:
        raise ValueError(f"line {lineno}: unterminated label value")
    if cur:
        out.append("".join(cur).strip())
    return [p for p in out if p]


def metric_value(samples: dict, name: str, **labels) -> float | None:
    """Convenience lookup: the sample whose labels CONTAIN the given
    pairs (the tests use it to reconcile scraped values against the result
    tree)."""
    want = set(labels.items())
    for (sname, slabels), v in samples.items():
        if sname == name and want <= set(slabels):
            return v
    return None
