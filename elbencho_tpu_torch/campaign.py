"""Scenario campaign engine for the port: declarative multi-stage benchmark
runs (docs/CAMPAIGNS.md).

A campaign spec (JSON always; TOML when the interpreter ships tomllib)
composes *stages*, each naming a phase family the port ships, its flag
overrides, optional chaos-seam arming (elbencho_tpu_torch/chaos.py's seeded
geometric bridge), and the *invariant assertions* evaluated when the stage
ends: byte reconciliation, `arrivals == completions + dropped`, leak gauges
zero, expected ejections, per-epoch ledgers, and a live /metrics scrape that
must parse and reconcile (elbencho_tpu_torch/metrics.py).

This is the original package's engine (elbencho_tpu/campaign.py) over the
port's modules: the same spec grammar and refusals, the same invariant
catalog, the same report fields and fingerprint projection. What differs is
where it meets the port's own seams and mock:

  - A stage's `env` key is the env of a seam in the port's SEAMS, or the
    original's env name of a seam the port registers under the same
    campaign name (ORIGINAL_SEAM_ENVS in chaos.py); the parser rewrites the
    latter to the port's env, so the shipped specs run unmodified and the
    stage report's chaos_env names what was armed.
  - The mock gauges are the mock CUDA driver's (build/torch_core/
    libebtcudamock.so, loaded through EBT_CUDA_DRIVER by the same path the
    engine dlopens, so ebt_mock_reset reaches the gauges a stage reads):
    ebt_mock_hostreg_active stands for the original's DmaMap-active gauge,
    and ebt_mock_live_buffers is signed, so a double free reads negative.
    On the real driver the mock-only invariants record themselves as
    skipped, never as passed.

Design contract:

  - REFUSAL WITH CAUSE: every malformed spec input — unknown key, bad
    type, unknown phase family / invariant / chaos seam, duplicate stage
    name, escaping path, missing required flags — raises CampaignError
    naming the stage and the cause. A campaign that cannot mean what it
    says never runs.
  - SEEDED AND REPRODUCIBLE: stage chaos injection points derive from
    `campaign.seed` + the stage index (same math as --chaos), and the
    stage-level report separates deterministic evidence (byte/unit/record
    counters, invariant outcomes) from timing so `fingerprint(report)` is
    identical across two runs of the same spec + seed.
  - STAGE-SCOPED SNAPSHOTS: each stage report carries the full counter
    families of its own run (the mock gauges are reset per stage), so a
    campaign report can be regression-gated leg by leg.

The campaign runner executes stages on a LocalWorkerGroup (master-side
fan-out stays the coordinator's job; campaign stage labels still reach
service /metrics scrapes through the campaign_name/campaign_stage wire
fields when a campaign config is pointed at --hosts by the operator).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import time
from dataclasses import dataclass, field

from .chaos import ORIGINAL_SEAM_ENVS, SEAMS, ChaosSpec, derive_env
from .common import PROTOCOL_VERSION, BenchPhase
from .exceptions import ProgException
from .logger import LOGGER


class CampaignError(ProgException):
    """A campaign spec or stage refused, with the cause."""


# phase family -> the BenchPhase the stage runs + the flags that must be
# present for the family to mean anything (refused otherwise)
PHASE_FAMILIES: dict[str, tuple[BenchPhase, tuple[str, ...]]] = {
    "write": (BenchPhase.CREATEFILES, ("-w", "--write")),
    "read": (BenchPhase.READFILES, ("-r", "--read")),
    "stripe": (BenchPhase.READFILES, ("--stripe",)),
    "load": (BenchPhase.READFILES, ("--arrival",)),
    "checkpoint": (BenchPhase.CHECKPOINT,
                   ("--checkpoint", "--checkpoint-shards")),
    "restore": (BenchPhase.CHECKPOINT,
                ("--checkpoint", "--checkpoint-shards")),
    "ingest": (BenchPhase.INGEST, ("--ingest", "--ingestshards")),
    "reshard": (BenchPhase.RESHARD, ("--reshard",)),
    # serving under live model rotation (docs/SERVING.md): an open-loop
    # read phase racing the --rotate background restore
    "serving": (BenchPhase.READFILES, ("--rotate",)),
}

# flags a stage may not override: the runner owns them (or they change
# the execution model under the spec's feet)
_FORBIDDEN_FLAGS = {
    "--hosts": "campaign stages run a local worker group (point a master "
               "at services outside the campaign engine)",
    "--hostsfile": "campaign stages run a local worker group",
    "--service": "a campaign is a driver, not a daemon",
    "--chaos": "declare chaos in the stage's 'chaos' table (seeded from "
               "the campaign seed), not via the flag",
    "--metricsport": "the campaign runner owns the metrics listener "
                     "(tools/campaign.py --metricsport)",
    "--nolive": "the runner appends it",
    "--start": "stages start when their turn comes",
}

_CREATE_MODES = ("", "random", "dir", "model")
# create="model": the serving fixture kit — a random bench file at `path`
# plus, next to it, `<path>.model/` shard files with a `<path>.manifest.json`
# placement manifest and a `<path>.trace.json` diurnal rate schedule
# (ramp -> steady -> flash-crowd burst -> cooldown). Stage flags reference
# them through the {workdir} substitution.
_MODEL_SHARDS = 4
_MODEL_TRACE = {
    "segments": [
        {"at": 0, "kind": "ramp", "rate": 60, "rate_end": 220},
        {"at": 1.5, "kind": "step", "rate": 220},
        {"at": 3.0, "kind": "burst", "rate": 500},
        {"at": 3.6, "kind": "step", "rate": 150},
    ]
}

# the campaign report / stage report field sets — pinned by the audit
# suite's protocol golden (tools/audit/schema_registry.py) like the wire
# surfaces: downstream gating tools key on these names
REPORT_FIELDS = ("campaign", "description", "spec_version", "seed",
                 "spec_sha256", "protocol", "workdir", "stages", "ok",
                 "fingerprint", "violations")
STAGE_REPORT_FIELDS = ("stage", "phase", "bench_phase", "argv",
                       "chaos_env", "error", "invariants", "stats",
                       "timing", "ok")


@dataclass
class StageSpec:
    name: str
    phase: str
    start_at: float = 0.0   # wall-clock offset from campaign t0 (seconds):
                            # the stage does not start before it — diurnal
                            # soaks compose schedules on one clock
    flags: list[str] = field(default_factory=list)
    path: str = ""          # workdir-relative benchmark path
    create: str = ""        # "" | "random" (pre-create file) | "dir"
    chaos: dict[str, float] = field(default_factory=dict)
    env: dict[str, str] = field(default_factory=dict)
    invariants: list[dict] = field(default_factory=list)


@dataclass
class CampaignSpec:
    name: str
    description: str = ""
    seed: int = 1
    spec_version: int = 1
    stages: list[StageSpec] = field(default_factory=list)
    source: str = ""        # where the spec came from (report provenance)
    sha256: str = ""        # hash of the spec file bytes


# ------------------------------------------------------------ spec parsing

def load_campaign(path: str) -> CampaignSpec:
    """Load + validate a campaign spec file. JSON always; .toml gated on
    the interpreter shipping tomllib (Python >= 3.11) — refused with the
    cause, never a silent fallback."""
    try:
        raw = open(path, "rb").read()
    except OSError as e:
        raise CampaignError(f"campaign spec {path}: unreadable ({e})")
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError:
            raise CampaignError(
                f"campaign spec {path}: TOML specs need Python >= 3.11 "
                "(tomllib); this interpreter has none — use the JSON "
                "form of the same grammar")
        try:
            data = tomllib.loads(raw.decode())
        except Exception as e:
            raise CampaignError(f"campaign spec {path}: TOML parse "
                                f"error: {e}")
    else:
        try:
            data = json.loads(raw)
        except ValueError as e:
            raise CampaignError(f"campaign spec {path}: JSON parse "
                                f"error: {e}")
    spec = parse_campaign(data, source=path)
    spec.sha256 = hashlib.sha256(raw).hexdigest()
    return spec


def _require(cond: bool, cause: str) -> None:
    if not cond:
        raise CampaignError(cause)


def parse_campaign(data, source: str = "<inline>") -> CampaignSpec:
    """Validate the spec dict (shared by the JSON and TOML forms),
    refusing every malformed input with a stage-attributed cause."""
    _require(isinstance(data, dict),
             f"campaign spec {source}: top level must be a table/object, "
             f"got {type(data).__name__}")
    unknown = set(data) - {"campaign", "stages"}
    _require(not unknown,
             f"campaign spec {source}: unknown top-level key(s) "
             f"{sorted(unknown)} (expected: campaign, stages)")
    head = data.get("campaign")
    _require(isinstance(head, dict),
             f"campaign spec {source}: missing [campaign] table")
    unknown = set(head) - {"name", "description", "seed", "spec_version"}
    _require(not unknown,
             f"campaign spec {source}: unknown [campaign] key(s) "
             f"{sorted(unknown)}")
    name = head.get("name")
    _require(isinstance(name, str) and name != "",
             f"campaign spec {source}: campaign.name must be a non-empty "
             "string")
    seed = head.get("seed", 1)
    _require(isinstance(seed, int) and not isinstance(seed, bool),
             f"campaign spec {source}: campaign.seed must be an integer, "
             f"got {seed!r}")
    spec_version = head.get("spec_version", 1)
    _require(spec_version == 1,
             f"campaign spec {source}: spec_version {spec_version!r} "
             "is not supported (this engine speaks spec_version 1)")
    description = head.get("description", "")
    _require(isinstance(description, str),
             f"campaign spec {source}: campaign.description must be a "
             "string")

    raw_stages = data.get("stages")
    _require(isinstance(raw_stages, list) and raw_stages,
             f"campaign spec {source}: 'stages' must be a non-empty list")
    stages: list[StageSpec] = []
    seen: set[str] = set()
    for i, rs in enumerate(raw_stages):
        stages.append(_parse_stage(rs, i, seen, source))
    # wall-clock offsets run on ONE campaign clock: stages execute in
    # order, so a stage scheduled before its predecessor could never
    # honor its offset — refuse the contradiction instead of drifting
    for a, b in zip(stages, stages[1:]):
        _require(b.start_at >= a.start_at,
                 f"campaign spec {source}: stage {b.name!r} start_at "
                 f"({b.start_at}) is earlier than stage {a.name!r}'s "
                 f"({a.start_at}); stages run in order on one clock")
    return CampaignSpec(name=name, description=description, seed=seed,
                        spec_version=spec_version, stages=stages,
                        source=source)


def _parse_stage(rs, i: int, seen: set[str], source: str) -> StageSpec:
    where = f"campaign spec {source}: stage {i}"
    _require(isinstance(rs, dict), f"{where}: must be a table/object")
    unknown = set(rs) - {"name", "phase", "start_at", "flags", "path",
                         "create", "chaos", "env", "invariants"}
    _require(not unknown, f"{where}: unknown key(s) {sorted(unknown)}")
    name = rs.get("name")
    _require(isinstance(name, str) and name != "",
             f"{where}: 'name' must be a non-empty string")
    where = f"campaign spec {source}: stage {name!r}"
    _require(name not in seen, f"{where}: duplicate stage name")
    seen.add(name)

    fam = rs.get("phase")
    _require(fam in PHASE_FAMILIES,
             f"{where}: unknown phase family {fam!r} (known: "
             f"{', '.join(sorted(PHASE_FAMILIES))})")
    flags = rs.get("flags", [])
    _require(isinstance(flags, list)
             and all(isinstance(f, str) for f in flags),
             f"{where}: 'flags' must be a list of strings")
    for f in flags:
        bare = f.split("=", 1)[0]
        if bare in _FORBIDDEN_FLAGS:
            raise CampaignError(
                f"{where}: flag {bare} is not stage-settable — "
                f"{_FORBIDDEN_FLAGS[bare]}")
    _, marker_flags = PHASE_FAMILIES[fam]
    _require(any(f.split("=", 1)[0] in marker_flags for f in flags),
             f"{where}: phase family {fam!r} needs one of "
             f"{'/'.join(marker_flags)} in 'flags' (the family names the "
             "workload; the flags configure it)")

    start_at = rs.get("start_at", 0)
    _require(isinstance(start_at, (int, float))
             and not isinstance(start_at, bool) and float(start_at) >= 0,
             f"{where}: 'start_at' must be a number >= 0 (seconds from "
             f"campaign start), got {start_at!r}")

    path = rs.get("path", "")
    _require(isinstance(path, str), f"{where}: 'path' must be a string")
    norm = os.path.normpath(path) if path else ""
    _require(not os.path.isabs(path) and not norm.startswith(".."),
             f"{where}: 'path' must stay inside the campaign workdir "
             f"(got {path!r})")
    create = rs.get("create", "")
    _require(create in _CREATE_MODES,
             f"{where}: 'create' must be one of {_CREATE_MODES}, got "
             f"{create!r}")

    chaos = rs.get("chaos", {})
    _require(isinstance(chaos, dict), f"{where}: 'chaos' must be a table "
             "of seam -> probability")
    for k, v in chaos.items():
        _require(k in SEAMS, f"{where}: unknown chaos seam {k!r} (known: "
                 f"{', '.join(sorted(SEAMS))})")
        _require(isinstance(v, (int, float))
                 and not isinstance(v, bool) and 0.0 <= float(v) <= 1.0,
                 f"{where}: chaos probability for {k!r} must be a number "
                 f"in [0, 1], got {v!r}")
    env = rs.get("env", {})
    _require(isinstance(env, dict) and all(
        isinstance(k, str) and isinstance(v, str) for k, v in env.items()),
        f"{where}: 'env' must be a table of string -> string")
    seam_envs = {s.env for s in SEAMS.values()}
    for k in env:
        _require(k in seam_envs or k in ORIGINAL_SEAM_ENVS,
                 f"{where}: env key {k!r} is not a registered fault seam "
                 "(elbencho_tpu_torch/chaos.py SEAMS) — campaigns may only "
                 "arm declared seams")
    # the original's name of a seam the port has arms the port's env
    env = {SEAMS[ORIGINAL_SEAM_ENVS[k]].env if k in ORIGINAL_SEAM_ENVS
           else k: v for k, v in env.items()}

    invs = []
    for inv in rs.get("invariants", []):
        if isinstance(inv, str):
            inv = {"name": inv}
        _require(isinstance(inv, dict) and isinstance(inv.get("name"), str),
                 f"{where}: each invariant is a name or a table with "
                 f"'name', got {inv!r}")
        iname = inv["name"]
        _require(iname in INVARIANTS,
                 f"{where}: unknown invariant {iname!r} (catalog: "
                 f"{', '.join(sorted(INVARIANTS))})")
        allowed = INVARIANTS[iname][2]
        bad = set(inv) - {"name"} - set(allowed)
        _require(not bad,
                 f"{where}: invariant {iname!r} takes no parameter(s) "
                 f"{sorted(bad)} (allowed: {sorted(allowed) or 'none'})")
        invs.append(dict(inv))
    return StageSpec(name=name, phase=fam, start_at=float(start_at),
                     flags=list(flags), path=path,
                     create=create,
                     chaos={k: float(v) for k, v in chaos.items()},
                     env=dict(env), invariants=invs)


# -------------------------------------------------------- invariant catalog

@dataclass
class StageContext:
    """What an invariant sees: the stage's group (live before teardown),
    its collected stats snapshot, the chaos env that was armed, and the
    mock gauge handles when the CPU mock driver is loaded."""

    spec: StageSpec
    cfg: object = None
    group: object = None
    stats: dict = field(default_factory=dict)
    error: str = ""
    chaos_env: dict = field(default_factory=dict)
    mock: object = None           # ctypes CDLL of the mock driver, or None
    lib: object = None            # the native core (uring gauge), or None
    src_files: list[str] = field(default_factory=list)


def _inv_phase_clean(ctx: StageContext, params: dict) -> list[str]:
    return [] if not ctx.error else [f"phase failed: {ctx.error}"]


def _inv_stripe(ctx: StageContext, params: dict) -> list[str]:
    st = ctx.stats.get("stripe") or {}
    if not st:
        return ["no stripe counter family (is --stripe in the stage "
                "flags and the native path active?)"]
    if st.get("units_awaited") != st.get("units_submitted"):
        return [f"stripe units leaked: awaited {st.get('units_awaited')} "
                f"!= submitted {st.get('units_submitted')}"]
    return []


def _inv_ckpt(ctx: StageContext, params: dict) -> list[str]:
    cs = ctx.stats.get("ckpt") or {}
    if not cs:
        return ["no checkpoint counter family"]
    out = []
    efs = ctx.stats.get("engine_faults") or {}
    if ctx.error == "" and not efs.get("errors_tolerated", 0):
        if cs.get("shards_resident") != cs.get("shards_total"):
            out.append(f"{cs.get('shards_resident')}/"
                       f"{cs.get('shards_total')} shards resident at the "
                       "all-resident barrier")
        totals = ctx.stats.get("ckpt_byte_totals")
        if totals and totals[0] != totals[1]:
            out.append(f"ckpt bytes submitted {totals[0]} != resident "
                       f"{totals[1]}")
    return out


def _inv_ingest(ctx: StageContext, params: dict) -> list[str]:
    st = ctx.stats.get("ingest") or {}
    if not st:
        return ["no ingest counter family"]
    out = []
    if not st.get("records_read", 0):
        out.append("no records read")
    if st.get("records_read") != st.get("records_resident", 0) + \
            st.get("records_dropped", 0):
        out.append(f"record ledger broken: read {st.get('records_read')} "
                   f"!= resident {st.get('records_resident')} + dropped "
                   f"{st.get('records_dropped')}")
    for i, e in enumerate(st.get("epochs", [])):
        if e.get("read") != e.get("resident", 0) + e.get("dropped", 0):
            out.append(f"epoch {i} reconciliation broken: {e}")
    if st.get("records_dropped", 0):
        fs = ctx.stats.get("faults") or {}
        efs = ctx.stats.get("engine_faults") or {}
        if not (ctx.stats.get("ingest_error")
                or fs.get("ejected_devices", 0)
                or efs.get("errors_tolerated", 0)):
            out.append(f"{st.get('records_dropped')} records dropped "
                       "with no attribution/ejection/absorption recorded")
    return out


def _inv_reshard(ctx: StageContext, params: dict) -> list[str]:
    st = ctx.stats.get("reshard") or {}
    if not st:
        return ["no reshard counter family"]
    out = []
    settled = (st.get("units_resident", 0) + st.get("units_moved", 0)
               + st.get("units_read", 0))
    if settled != st.get("units_total", 0):
        out.append(f"{settled}/{st.get('units_total')} units settled at "
                   "the all-resharded barrier")
    if st.get("unit_bytes_submitted") != st.get("unit_bytes_resident"):
        out.append(f"unit bytes submitted {st.get('unit_bytes_submitted')}"
                   f" != resident {st.get('unit_bytes_resident')}")
    pairs = ctx.stats.get("reshard_pairs") or []
    if sum(p["bytes"] for p in pairs) != st.get("d2d_resident_bytes", 0):
        out.append(f"pair-matrix bytes {sum(p['bytes'] for p in pairs)} "
                   f"!= d2d resident {st.get('d2d_resident_bytes')}")
    return out


def _inv_open_loop(ctx: StageContext, params: dict) -> list[str]:
    tstats = ctx.stats.get("tenants")
    if not tstats:
        return ["no tenant-class accounting (is --arrival in the stage "
                "flags?)"]
    out = []
    for st in tstats:
        if st["arrivals"] != st["completions"] + st["dropped"]:
            out.append(f"class {st['tenant']} ledger broken: arrivals "
                       f"{st['arrivals']} != completions "
                       f"{st['completions']} + dropped {st['dropped']}")
    return out


def _inv_backlog(ctx: StageContext, params: dict) -> list[str]:
    out = []
    for st in ctx.stats.get("tenants") or []:
        if st["arrivals"] and st["backlog_peak"] < 1:
            out.append(f"class {st['tenant']}: backlog_peak not reported")
    return out


def _inv_reactor(ctx: StageContext, params: dict) -> list[str]:
    if not ctx.stats.get("reactor_enabled"):
        return []
    rs = ctx.stats.get("reactor") or {}
    out = []
    if not rs.get("reactor_waits", 0):
        out.append("reactor enabled but never engaged (reactor_waits 0)")
    wakes = sum(rs.get(k, 0) for k in (
        "reactor_wakeups_cq", "reactor_wakeups_onready",
        "reactor_wakeups_arrival", "reactor_wakeups_timeout",
        "reactor_wakeups_interrupt"))
    if rs.get("reactor_waits", 0) != wakes:
        out.append(f"reactor wait/wakeup counters do not reconcile: {rs}")
    return out


def _file_checksum(path: str) -> int:
    total = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            total += sum(chunk)
    return total & ((1 << 64) - 1)


def _inv_byte_exact(ctx: StageContext, params: dict) -> list[str]:
    if ctx.mock is None:
        return ["skipped: byte_exact_landing needs the CI mock plugin's "
                "additive checksum gauge"]
    efs = ctx.stats.get("engine_faults") or {}
    if ctx.error or efs.get("errors_tolerated", 0):
        return []  # dropped ops legitimately didn't land
    if not ctx.src_files:
        return ["no source file to checksum (stage has no file path)"]
    want = 0
    for p in ctx.src_files:
        want = (want + _file_checksum(p)) & ((1 << 64) - 1)
    got = ctx.mock.ebt_mock_checksum()
    if got != want:
        return [f"landed bytes not byte-exact: mock checksum {got} != "
                f"source {want}"]
    return []


def _inv_injection_visible(ctx: StageContext, params: dict) -> list[str]:
    """An armed in-window injection must be VISIBLE — a device error, a
    recovery, an ejection or a budget absorption — never silent. The
    window is the op count the injected counter can reach this stage
    (spec-declared for nth/dev_nth seams; for the d2d seam the settled
    move count is the window)."""
    seam_name = params.get("seam")
    if seam_name not in SEAMS:
        return [f"injection_visible: unknown seam {seam_name!r}"]
    env_key = SEAMS[seam_name].env
    armed = ctx.chaos_env.get(env_key, "")
    if not armed:
        return []  # nothing fired this draw — vacuously fine
    n = int(armed.rsplit(":", 1)[-1])
    if seam_name == "d2d":
        st = ctx.stats.get("reshard") or {}
        window = st.get("d2d_moves", 0) + st.get("bounce_moves", 0)
        visible = (st.get("move_recovered", 0)
                   + st.get("move_fallback_reads", 0))
    else:
        window = int(params.get("window_ops", 0))
        fs = ctx.stats.get("faults") or {}
        efs = ctx.stats.get("engine_faults") or {}
        visible = (fs.get("dev_errors", 0) + fs.get("ejected_devices", 0)
                   + efs.get("errors_tolerated", 0))
    if window and n <= window and visible < 1:
        return [f"armed injection {env_key}={armed} (#{n} in a "
                f"{window}-op window) fired silently — no device error, "
                "recovery, ejection or absorption recorded"]
    return []


def _inv_ejections(ctx: StageContext, params: dict) -> list[str]:
    fs = ctx.stats.get("faults") or {}
    got = fs.get("ejected_devices", 0)
    out = []
    if "equals" in params and got != params["equals"]:
        out.append(f"ejected_devices {got} != expected {params['equals']}")
    if "min" in params and got < params["min"]:
        out.append(f"ejected_devices {got} < expected minimum "
                   f"{params['min']}")
    if "max" in params and got > params["max"]:
        out.append(f"ejected_devices {got} > allowed maximum "
                   f"{params['max']}")
    return out


def _inv_max_tolerated(ctx: StageContext, params: dict) -> list[str]:
    efs = ctx.stats.get("engine_faults") or {}
    got = efs.get("errors_tolerated", 0)
    limit = params.get("max", 0)
    if got > limit:
        return [f"errors_tolerated {got} exceeds the stage budget "
                f"{limit}"]
    return []


def _inv_metrics(ctx: StageContext, params: dict) -> list[str]:
    """The live observability tie-in: a /metrics scrape of the stage's
    group must be valid Prometheus text AND reconcile with the counter
    families the stage just collected."""
    from .metrics import metric_value, parse_prometheus_text, render_metrics

    if ctx.group is None:
        return ["no live group to scrape"]
    text = render_metrics(ctx.group, ctx.cfg,
                          PHASE_FAMILIES[ctx.spec.phase][0],
                          role="campaign",
                          campaign=("<campaign>", ctx.spec.name,
                                    ctx.spec.phase))
    try:
        samples = parse_prometheus_text(text)
    except ValueError as e:
        return [f"/metrics scrape is not valid Prometheus text: {e}"]
    out = []
    ops = ctx.stats.get("ops") or {}
    got = metric_value(samples, "ebt_bytes_done_total")
    if got is not None and ops and int(got) != ops.get("bytes"):
        out.append(f"scraped ebt_bytes_done_total {int(got)} != live "
                   f"total {ops.get('bytes')}")
    for st in ctx.stats.get("tenants") or []:
        lbl = str(st.get("label", st.get("tenant", 0)))
        arr = metric_value(samples, "ebt_tenant_arrivals_total",
                           tenant=lbl)
        dn = metric_value(samples, "ebt_tenant_completions_total",
                          tenant=lbl)
        dr = metric_value(samples, "ebt_tenant_dropped_total", tenant=lbl)
        if None in (arr, dn, dr):
            out.append(f"tenant class {lbl} missing from the scrape")
        elif arr != dn + dr:
            out.append(f"scraped tenant {lbl} ledger broken: "
                       f"{arr} != {dn} + {dr}")
    fs = ctx.stats.get("faults") or {}
    ej = metric_value(samples, "ebt_fault_ejected_devices")
    if fs and ej is not None and int(ej) != fs.get("ejected_devices", 0):
        out.append(f"scraped ebt_fault_ejected_devices {int(ej)} != "
                   f"fault stats {fs.get('ejected_devices', 0)}")
    return out


def _inv_no_leaks(ctx: StageContext, params: dict) -> list[str]:
    """Post-teardown: the mock live-buffer and host-registration (the
    original's DmaMap) gauges and the uring in-flight-op holds must have
    drained to zero."""
    if ctx.mock is None:
        return ["skipped: no_leaks needs the CI mock plugin's gauges"]
    out = []
    if ctx.mock.ebt_mock_live_buffers() != 0:
        out.append("mock live-buffer gauge != 0 (leaked device buffers)")
    if ctx.mock.ebt_mock_hostreg_active() != 0:
        out.append("DmaMap-active gauge != 0 (leaked pins)")
    if ctx.lib is not None:
        state = (ctypes.c_uint64 * 3)()
        ctx.lib.ebt_uring_reg_state(state)
        if state[2] != 0:
            out.append(f"{state[2]} uring slot(s) still hold in-flight "
                       "ops")
    return out


# name -> (fn, when, allowed-params); when is "stage" (live group) or
# "teardown" (after the group released everything)
def _inv_serving(ctx: StageContext, params: dict) -> list[str]:
    """Every completed rotation reconciled at its swap: shards resident ==
    expected and submitted == resident bytes, per record — and at least
    min_rotations completed (rotation under chaos may legitimately FAIL
    rotations; failed ones never swap, so they never appear here)."""
    svs = ctx.group.serving_stats() if ctx.group else None
    recs = ctx.group.rotation_records() if ctx.group else None
    if not svs:
        return ["no serving stats (is --rotate in the stage flags?)"]
    out = []
    recs = recs or []
    if len(recs) != svs.get("rotations_complete", 0):
        out.append(
            f"rotation records ({len(recs)}) != rotations_complete "
            f"({svs.get('rotations_complete', 0)})")
    for r in recs:
        if r["shards_resident"] != r["shards_total"]:
            out.append(
                f"rotation gen {r['generation']}: {r['shards_resident']}"
                f"/{r['shards_total']} shards resident")
        if r["bytes_submitted"] != r["bytes_resident"]:
            out.append(
                f"rotation gen {r['generation']}: submitted "
                f"{r['bytes_submitted']} != resident "
                f"{r['bytes_resident']} bytes")
    need = int(params.get("min_rotations", 1))
    if len(recs) < need:
        out.append(f"only {len(recs)} completed rotation(s); "
                   f"min_rotations={need}")
    return out


INVARIANTS: dict[str, tuple] = {
    "phase_clean": (_inv_phase_clean, "stage", ()),
    "stripe_reconciliation": (_inv_stripe, "stage", ()),
    "ckpt_reconciliation": (_inv_ckpt, "stage", ()),
    "ingest_ledger": (_inv_ingest, "stage", ()),
    "reshard_reconciliation": (_inv_reshard, "stage", ()),
    "open_loop_ledger": (_inv_open_loop, "stage", ()),
    "backlog_reported": (_inv_backlog, "stage", ()),
    "reactor_reconciles": (_inv_reactor, "stage", ()),
    "byte_exact_landing": (_inv_byte_exact, "stage", ()),
    "injection_visible": (_inv_injection_visible, "stage",
                          ("seam", "window_ops")),
    "expected_ejections": (_inv_ejections, "stage",
                           ("min", "max", "equals")),
    "max_tolerated": (_inv_max_tolerated, "stage", ("max",)),
    "metrics_consistent": (_inv_metrics, "stage", ()),
    "serving_reconciliation": (_inv_serving, "stage", ("min_rotations",)),
    "no_leaks": (_inv_no_leaks, "teardown", ()),
}

# "skipped: ..." notes are recorded, not failures — but ONLY for the
# invariants that legitimately need the mock driver
_SKIPPABLE = {"byte_exact_landing", "no_leaks"}

# what the mock CUDA driver's file name carries (libebtcudamock.so)
MOCK_LIB_TAG = "ebtcudamock"


# ---------------------------------------------------------------- running

def _load_mock():
    """The mock CUDA driver's gauges, when EBT_CUDA_DRIVER names it (by the
    path the engine dlopens, so both hold one copy of its state); None on
    any other driver."""
    driver = os.environ.get("EBT_CUDA_DRIVER", "")
    if MOCK_LIB_TAG not in os.path.basename(driver):
        return None
    try:
        mock = ctypes.CDLL(driver)
    except OSError:
        return None
    for fn in ("ebt_mock_checksum", "ebt_mock_hostreg_active",
               "ebt_mock_total_bytes"):
        getattr(mock, fn).restype = ctypes.c_uint64
    mock.ebt_mock_live_buffers.restype = ctypes.c_int64
    return mock


def stage_seed(campaign_seed: int, index: int) -> int:
    """Per-stage chaos seed: a pure function of (campaign seed, stage
    index) so a campaign reproduces stage by stage."""
    return (campaign_seed * 1_000_003 + index * 7919 + 1) & 0x7FFFFFFF


class CampaignRunner:
    """Executes a validated CampaignSpec in `workdir` and produces the
    machine-readable campaign report."""

    def __init__(self, spec: CampaignSpec, workdir: str,
                 metrics_port: int = 0) -> None:
        self.spec = spec
        self.workdir = workdir
        self.metrics_port = metrics_port
        self.mock = _load_mock()
        try:
            from .engine import load_lib
            self.lib = load_lib()
        except Exception as e:
            LOGGER.warning(f"campaign: native core unavailable ({e}); "
                           "uring leak gauge not checked")
            self.lib = None
        self._metrics_srv = None
        self._live = {"group": None, "cfg": None,
                      "phase": BenchPhase.IDLE, "stage": ""}

    # -- live /metrics for the whole campaign (soak-watchability)

    def _start_metrics(self) -> None:
        if not self.metrics_port:
            return
        from .metrics import MetricsServer, render_metrics

        def scrape() -> str:
            live = self._live
            return render_metrics(
                live["group"], live["cfg"], live["phase"], role="campaign",
                campaign=(self.spec.name, live["stage"], ""))

        try:
            self._metrics_srv = MetricsServer(scrape, self.metrics_port)
        except ProgException as e:
            raise CampaignError(f"campaign {self.spec.name!r}: {e}")
        self._metrics_srv.start()

    def run(self) -> dict:
        os.makedirs(self.workdir, exist_ok=True)
        self._start_metrics()
        stages = []
        violations: list[str] = []
        t0 = time.monotonic()
        try:
            for i, st in enumerate(self.spec.stages):
                if st.start_at > 0:
                    # wall-clock stage scheduling: the stage starts at
                    # campaign t0 + start_at (a stage running long eats
                    # into the next offset — the clock never drifts)
                    wait = st.start_at - (time.monotonic() - t0)
                    if wait > 0:
                        LOGGER.info(
                            f"campaign {self.spec.name!r}: stage "
                            f"{st.name!r} waits {wait:.1f}s for its "
                            f"start_at={st.start_at}s slot")
                        time.sleep(wait)
                rep = self._run_stage(i, st)
                stages.append(rep)
                if rep["error"]:
                    # a phase error fails the campaign even when the
                    # stage declared no phase_clean invariant — ok=false
                    # stage reports must never yield an ok=true campaign
                    violations.append(
                        f"stage {st.name!r}: phase error: {rep['error']}")
                for inv in rep["invariants"]:
                    for v in inv["violations"]:
                        violations.append(
                            f"stage {st.name!r} [{inv['name']}]: {v}")
        finally:
            if self._metrics_srv is not None:
                self._metrics_srv.stop()
        report = {
            "campaign": self.spec.name,
            "description": self.spec.description,
            "spec_version": self.spec.spec_version,
            "seed": self.spec.seed,
            "spec_sha256": self.spec.sha256,
            "protocol": PROTOCOL_VERSION,
            "workdir": self.workdir,
            "stages": stages,
            "ok": not violations,
            "violations": violations,
        }
        report["fingerprint"] = fingerprint(report)
        return report

    def _create_model_kit(self, st: StageSpec, path: str) -> None:
        """create="model": write `<path>.model/shard.<i>` files, the
        `<path>.manifest.json` placement manifest (device i per shard)
        and the `<path>.trace.json` diurnal schedule — the serving
        stages' fixtures, referenced via {workdir} flags."""
        from .checkpoint import CheckpointShard, write_manifest

        block = _size_from_flags(st.flags, st.name, key="-b",
                                 default=256 << 10)
        model_dir = path + ".model"
        os.makedirs(model_dir, exist_ok=True)
        shards = []
        for i in range(_MODEL_SHARDS):
            sp = os.path.join(model_dir, f"shard.{i}")
            with open(sp, "wb") as fh:
                fh.write(os.urandom(block))
            shards.append(CheckpointShard(path=sp, bytes=block,
                                          devices=[i % _MODEL_SHARDS]))
        write_manifest(path + ".manifest.json", shards)
        with open(path + ".trace.json", "w") as fh:
            json.dump(_MODEL_TRACE, fh)

    # -- one stage

    def _run_stage(self, index: int, st: StageSpec) -> dict:
        from .config import config_from_args
        from .workers.local import LocalWorkerGroup

        LOGGER.info(f"campaign {self.spec.name!r}: stage {index} "
                    f"{st.name!r} ({st.phase})")
        chaos_env: dict[str, str] = {}
        if st.chaos:
            chaos_env.update(derive_env(ChaosSpec(
                probs=dict(st.chaos),
                seed=stage_seed(self.spec.seed, index))))
        chaos_env.update(st.env)  # explicit pins win over the draw

        path = os.path.join(self.workdir, st.path) if st.path \
            else self.workdir
        src_files: list[str] = []
        try:
            if st.create == "dir" or (not st.create and
                                      st.phase in ("checkpoint", "restore",
                                                   "ingest", "reshard")):
                os.makedirs(path, exist_ok=True)
            elif st.create == "random":
                size = _size_from_flags(st.flags, st.name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(os.urandom(size))
                src_files.append(path)
            elif st.create == "model":
                # the serving fixture kit: bench file + model shard set +
                # placement manifest + diurnal trace (see _MODEL_TRACE)
                size = _size_from_flags(st.flags, st.name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(os.urandom(size))
                src_files.append(path)
                self._create_model_kit(st, path)
            elif os.path.isfile(path):
                src_files.append(path)
        except OSError as e:
            raise CampaignError(
                f"campaign {self.spec.name!r} stage {st.name!r}: fixture "
                f"create failed: {e}")

        # {workdir} substitution: fixture-referencing flags (--checkpoint/
        # --ratetrace paths of the model kit) resolve against the campaign
        # workdir, keeping specs relocatable
        argv = [f.replace("{workdir}", self.workdir)
                for f in st.flags] + ["--nolive", path]
        try:
            cfg = config_from_args(argv)
        except ProgException as e:
            raise CampaignError(
                f"campaign {self.spec.name!r} stage {st.name!r}: config "
                f"refused: {e}")
        cfg.campaign_name = self.spec.name
        cfg.campaign_stage = st.name

        phase = PHASE_FAMILIES[st.phase][0]
        ctx = StageContext(spec=st, cfg=cfg, chaos_env=dict(chaos_env),
                           mock=self.mock, lib=self.lib,
                           src_files=src_files)
        for k, v in chaos_env.items():
            os.environ[k] = v
        if self.mock is not None:
            self.mock.ebt_mock_reset()
        t0 = time.monotonic()
        inv_results: list[dict] = []
        group = None
        try:
            group = LocalWorkerGroup(cfg)
            group.prepare()
            ctx.group = group
            self._live.update(group=group, cfg=cfg, phase=phase,
                              stage=st.name)
            group.start_phase(phase, f"campaign-{self.spec.name}-{index}")
            while not group.wait_done(1000):
                pass
            ctx.error = group.first_error()
            ctx.stats = _snapshot(group)
            self._eval(st, ctx, "stage", inv_results)
        except ProgException as e:
            raise CampaignError(
                f"campaign {self.spec.name!r} stage {st.name!r}: {e}")
        finally:
            self._live.update(group=None, cfg=None,
                              phase=BenchPhase.IDLE, stage="")
            if group is not None:
                try:
                    group.teardown()
                except Exception as e:
                    # never mask the stage's real error or skip the
                    # chaos-env cleanup; the no_leaks teardown invariant
                    # still reports gauges a failed teardown left behind
                    LOGGER.error(f"campaign stage {st.name!r}: teardown "
                                 f"failed: {e}")
            ctx.group = None
            for k in chaos_env:
                os.environ.pop(k, None)
        self._eval(st, ctx, "teardown", inv_results)
        elapsed = time.monotonic() - t0
        ok = all(r["ok"] for r in inv_results)
        return {
            "stage": st.name,
            "phase": st.phase,
            "bench_phase": int(phase),
            "argv": argv[:-1] + [os.path.relpath(path, self.workdir)
                                 if path != self.workdir else "."],
            "chaos_env": dict(sorted(chaos_env.items())),
            "error": ctx.error,
            "invariants": inv_results,
            "stats": ctx.stats,
            "timing": {"wall_s": round(elapsed, 3),
                       "elapsed_us": ctx.stats.get("elapsed_us", 0)},
            "ok": ok and not ctx.error,
        }

    @staticmethod
    def _eval(st: StageSpec, ctx: StageContext, when: str,
              out: list[dict]) -> None:
        for inv in st.invariants:
            fn, inv_when, _ = INVARIANTS[inv["name"]]
            if inv_when != when:
                continue
            violations = fn(ctx, inv)
            skipped = [v for v in violations if v.startswith("skipped: ")
                       and inv["name"] in _SKIPPABLE]
            violations = [v for v in violations if v not in skipped]
            out.append({"name": inv["name"],
                        "ok": not violations,
                        "violations": violations,
                        "skipped": skipped})
            for v in violations:
                LOGGER.error(f"campaign stage {st.name!r} "
                             f"[{inv['name']}]: {v}")


def _size_from_flags(flags: list[str], stage: str, key: str = "-s",
                     default: int = 0) -> int:
    from .utils.units import parse_size

    names = ("-s", "--size") if key == "-s" else (key, "--block")
    long_eq = "--size=" if key == "-s" else "--block="
    for i, f in enumerate(flags):
        if f in names and i + 1 < len(flags):
            return parse_size(flags[i + 1])
        if f.startswith(long_eq):
            return parse_size(f.split("=", 1)[1])
    if default:
        return default
    raise CampaignError(
        f"stage {stage!r}: create=random/model needs -s/--size in "
        "'flags' to know how much to create")


# ------------------------------------------------- snapshots + fingerprint

def _snapshot(group) -> dict:
    """Stage-scoped stats snapshot: every counter family the group can
    report, under stable keys (the stage report's 'stats' tree)."""
    total = group.live_total()
    results = group.phase_results()
    snap = {
        "ops": {"bytes": total.bytes, "entries": total.entries,
                "iops": total.iops},
        "elapsed_us": max((r.elapsed_us for r in results), default=0),
        "stripe": group.stripe_stats(),
        "stripe_error": group.stripe_error(),
        "ckpt": group.ckpt_stats(),
        "ckpt_error": group.ckpt_error(),
        "ingest": group.ingest_stats(),
        "ingest_error": group.ingest_error(),
        "reshard": group.reshard_stats(),
        "reshard_pairs": group.reshard_pairs(),
        "reshard_error": group.reshard_error(),
        "tenants": None,
        "arrival_mode": group.arrival_mode(),
        "serving": group.serving_stats(),
        "rotation_records": group.rotation_records(),
        "faults": group.fault_stats(),
        "engine_faults": group.engine_fault_stats(),
        "fault_causes": group.fault_causes(),
        "ejected": group.ejected_devices(),
        "reactor": group.reactor_stats()
        if hasattr(group, "reactor_stats") else None,
        "reactor_enabled": group.reactor_enabled()
        if hasattr(group, "reactor_enabled") else None,
    }
    tstats = group.tenant_stats()
    if tstats:
        labels = list(group.tenant_latency())
        snap["tenants"] = [
            {**st, "label": labels[int(st.get("tenant", 0))]
             if int(st.get("tenant", 0)) < len(labels)
             else str(st.get("tenant", 0))}
            for st in tstats]
    try:
        native = getattr(group, "_native_path", None)
        if native is not None and group.ckpt_stats():
            snap["ckpt_byte_totals"] = list(native.ckpt_byte_totals())
    except Exception:
        pass
    return snap


# counter keys that are pure functions of (spec, seed) — what two runs of
# the same campaign must reproduce exactly. Timing/backoff/lag/peak
# counters are deliberately NOT here (docs/CAMPAIGNS.md "Reproducibility")
_DET_KEYS = {
    "stripe": ("units_submitted", "units_awaited"),
    "ckpt": ("shards_total", "shards_resident"),
    "ingest": ("records_read", "records_resident", "records_dropped",
               "shuffle_window"),
    "reshard": ("units_total", "units_resident", "units_moved",
                "units_read"),
    "faults": ("ejected_devices",),
}


def _stage_view(rep: dict) -> dict:
    """The deterministic projection of one stage report (what the
    campaign fingerprint hashes)."""
    stats = rep.get("stats", {})
    view = {
        "stage": rep.get("stage"),
        "phase": rep.get("phase"),
        "bench_phase": rep.get("bench_phase"),
        "argv": rep.get("argv"),
        "chaos_env": rep.get("chaos_env"),
        "error": rep.get("error"),
        "ok": rep.get("ok"),
        "ops": stats.get("ops"),
        "invariants": [{"name": r["name"], "ok": r["ok"],
                        "violations": r["violations"]}
                       for r in rep.get("invariants", [])],
    }
    for fam, keys in _DET_KEYS.items():
        d = stats.get(fam)
        if d:
            view[fam] = {k: d.get(k) for k in keys}
    if stats.get("tenants"):
        view["tenants"] = [
            {"label": t.get("label"), "arrivals": t.get("arrivals"),
             "completions": t.get("completions"),
             "dropped": t.get("dropped")}
            for t in stats["tenants"]]
    return view


def fingerprint(report: dict) -> str:
    """SHA-256 over the deterministic projection of the campaign report:
    same spec + same seed => same fingerprint, run to run (the
    acceptance gate for 'identical stage-level reports')."""
    view = {
        "campaign": report.get("campaign"),
        "seed": report.get("seed"),
        "spec_version": report.get("spec_version"),
        "spec_sha256": report.get("spec_sha256"),
        "protocol": report.get("protocol"),
        "ok": report.get("ok"),
        "violations": report.get("violations"),
        "stages": [_stage_view(s) for s in report.get("stages", [])],
    }
    return hashlib.sha256(
        json.dumps(view, sort_keys=True).encode()).hexdigest()
