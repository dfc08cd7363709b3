#!/usr/bin/env python3
"""Static audit gate over the PyTorch/CUDA port's native engine.

The port's C++ (elbencho_tpu_torch/csrc/) runs beside the shared storage
engine (core/) in one library, and its C ABI is bound through ctypes. This
driver holds both to the same analyzers that gate the original engine
(tools/audit, tools/lint_interfaces.py), retargeted at the port's sources:

  lockcheck        lock order against the port's ```lockhierarchy``` fence
                   (elbencho_tpu_torch/csrc/CONCURRENCY.md), the annotated
                   Mutex/MutexLock/CondLock discipline, explicit cv loops,
                   over the sources the port's library is built from
  pathcheck        every EBT_PAIR_BEGIN in csrc/cuda_path.cpp (and the
                   shared engine's) reaches its END or HOLDER on every exit
                   path; each pair the port declares (PORT_PAIRS) must have
                   a BEGIN there, so an unannotated engine cannot pass
  hotcheck         the hot-path ratchet over the EBT_HOT roots, with the
                   port's ```hotlanes``` fence and its own baseline
                   (csrc/hotpath_baseline.json)
  interfaces-port  the C ABI against its ctypes bindings: csrc/cuda_capi.cpp
                   against engine._declare_cuda's table, core/src/capi.cpp
                   against engine.py and engine_stats.py, and the kernels'
                   C entries (csrc/*.cu) against ops/*_kernel.py: missing
                   and stale bindings, arg counts, pointer-ness, widths and
                   restypes
  schema           the port's wire (stats.py, workers/remote.py, bench.py,
                   metrics.py, campaign.py) and its engine counter readers
                   (engine_stats.py with cuda/native.py, read as one
                   module) against the original's golden protocol schema
                   (tools/audit/schemas/): the port emits the same wire
  counters         every counter group from its C++ struct (csrc/
                   cuda_path.h) through the C ABI (the ebt_cuda_* exports
                   of csrc/cuda_capi.cpp, the shared engine's of
                   core/src/capi.cpp) and the ctypes readers to the fan-in,
                   the result tree and the docs; the port's /metrics
                   families against their renderers
  mergecheck       the merge laws the original declares, classified on the
                   port's fan-in (workers/remote.py, stats.py); report in
                   build/torch_merge_report.txt

The analyzers are imported, not copied (but for two extractors whose
regexes name PjrtPath inside the function: _direction_cases, _d2h_fields):
each runs with its module constants patched for the duration of the call
and restored after it, so the original's gate (python3 -m tools.audit)
sees its own sources whatever ran before it in the same process. The port's binding tables are run from
their source files, not imported: neither package nor torch is loaded.

    python3 tools/torch_audit.py                        # all seven
    python3 tools/torch_audit.py --only lockcheck,pathcheck
    python3 tools/torch_audit.py --skip hotcheck
    python3 tools/torch_audit.py --write-hotpath-baseline

Findings print as `audit:<analyzer>: <file>:<line>: <cause>` on stderr and
go to --report (default build/torch_audit_report.txt); the hot-path scan
goes to build/torch_hotpath_report.txt. Exit 0 = clean, 1 = findings,
2 = unknown analyzer.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import ctypes
import glob
import os
import re
import sys
import threading
import types
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import lint_interfaces  # noqa: E402
from tools.audit import (Finding, counter_coverage, hotcheck,  # noqa: E402
                         lockcheck, mergecheck, pathcheck,
                         schema_registry, strip_cpp_comments_and_strings)
from tools.audit.cppmodel import strip_preproc  # noqa: E402

_j = os.path.join
CSRC = _j("elbencho_tpu_torch", "csrc")
FENCE_DOC = _j(CSRC, "CONCURRENCY.md")

# the sources of the port's library (engine._CORE_SRCS) that carry its
# concurrency, as tools/audit/lockcheck.py audits the original's: the
# shared engine with its uring/reactor/numa shims, and the CUDA engine with
# its C ABI and driver loader. The mock driver, the selftest and the probe
# stay out, as the original leaves out its mock plugin.
LOCK_SOURCES = (
    _j("core", "include", "ebt", "engine.h"),
    _j("core", "include", "ebt", "uring.h"),
    _j("core", "include", "ebt", "reactor.h"),
    _j("core", "include", "ebt", "numa.h"),
    _j("core", "src", "engine.cpp"),
    _j("core", "src", "uring.cpp"),
    _j("core", "src", "reactor.cpp"),
    _j("core", "src", "numa.cpp"),
    _j(CSRC, "cuda_path.h"),
    _j(CSRC, "cuda_path.cpp"),
    _j(CSRC, "cuda_capi.cpp"),
    _j(CSRC, "cuda_api.h"),
    _j(CSRC, "cuda_api.cpp"),
    _j(CSRC, "span_log.h"),
    _j(CSRC, "span_log.cpp"),
)
# the annotated translation units: the shared engine's, with the CUDA
# engine in place of pjrt_path.cpp
PATH_SOURCES = (
    _j("core", "src", "engine.cpp"),
    _j("core", "src", "uring.cpp"),
    _j("core", "src", "reactor.cpp"),
    _j(CSRC, "cuda_path.cpp"),
)
HOT_SOURCES = PATH_SOURCES
HOT_BASELINE = _j(CSRC, "hotpath_baseline.json")
HOT_REPORT = _j("build", "torch_hotpath_report.txt")
REPORT = _j("build", "torch_audit_report.txt")

# the resource pairs CudaPath declares (csrc/CONCURRENCY.md lists what
# each one pairs); each must keep at least one BEGIN in cuda_path.cpp
PORT_PAIRS = ("tracker", "reg_intransit", "copy_hold", "dev_buf", "rot_buf",
              "bounce_scratch", "xfer_mgr", "stage_ring", "stripe_unit",
              "ckpt_shard", "ingest_epoch", "reshard_unit")

CORE_CAPI = _j("core", "src", "capi.cpp")
CUDA_CAPI = _j(CSRC, "cuda_capi.cpp")
CORE_BINDINGS = (_j("elbencho_tpu_torch", "engine.py"),
                 _j("elbencho_tpu_torch", "engine_stats.py"))
KERNEL_SOURCES = tuple(_j(CSRC, f"{k}.cu") for k in (
    "verify", "fill", "ingest", "mesh_reduce"))
# the CUDA engine's binding table (engine._declare_cuda), and the modules
# whose load_lib() declares the kernel library's C entries
CUDA_BINDING = _j("elbencho_tpu_torch", "engine.py")
KERNEL_BINDINGS = tuple(_j("elbencho_tpu_torch", "ops", f"{k}_kernel.py")
                        for k in ("verify", "fill", "ingest"))

_PAIR_BEGIN_RE = re.compile(r"\bEBT_PAIR_BEGIN\s*\(\s*(\w+)\s*\)")
_SYM_RE = re.compile(r"\bebt_[a-z0-9_]+")


@contextlib.contextmanager
def retargeted(module, **constants):
    """`module`'s constants set to `constants` inside the block, the
    original values back after it (also on an exception)."""
    with contextlib.ExitStack() as stack:
        for name, value in constants.items():
            stack.enter_context(mock.patch.object(module, name, value))
        yield


# ------------------------------------------------------------- C++ analyzers

def lockcheck_collect(root: str) -> list[Finding]:
    with retargeted(lockcheck, AUDIT_SOURCES=LOCK_SOURCES,
                    HIERARCHY_DOC=FENCE_DOC):
        return lockcheck.collect(root)


def pathcheck_collect(root: str) -> list[Finding]:
    with retargeted(pathcheck, PATH_SOURCES=PATH_SOURCES):
        findings = pathcheck.collect(root)
    rel = _j(CSRC, "cuda_path.cpp")
    try:
        with open(_j(root, rel), encoding="utf-8", errors="replace") as f:
            text = strip(f.read())
    except OSError:
        return findings  # pathcheck reported the missing source
    begun = set(_PAIR_BEGIN_RE.findall(text))
    for pair in PORT_PAIRS:
        if pair not in begun:
            findings.append(Finding(
                "pathcheck", rel, 0,
                f"pair '{pair}' has no EBT_PAIR_BEGIN in the CUDA engine - "
                "an unannotated resource is one pathcheck cannot see, "
                "refusing to certify the port's pairing"))
    return findings


def hotcheck_constants() -> dict:
    return dict(HOT_SOURCES=HOT_SOURCES, BASELINE=HOT_BASELINE,
                LANES_DOC=FENCE_DOC, REPORT=HOT_REPORT)


def hotcheck_collect(root: str) -> list[Finding]:
    with retargeted(hotcheck, **hotcheck_constants()):
        return hotcheck.collect(root)


def write_hotpath_baseline(root: str) -> str:
    with retargeted(hotcheck, **hotcheck_constants()):
        return hotcheck.write_baseline(root)


def strip(text: str) -> str:
    """C++ text with comments, strings and preprocessor lines blanked, line
    numbers kept (what every analyzer reads)."""
    return strip_preproc(strip_cpp_comments_and_strings(text))


# ------------------------------------------------------ the C ABI and ctypes

# ctypes types by identity: on LP64 c_uint64 IS c_ulong and c_int64 IS
# c_long, so a name would misreport the width
_SCALAR_CLASSES = ((ctypes.c_int, "i32"), (ctypes.c_uint, "u32"),
                   (ctypes.c_double, "double"), (ctypes.c_uint64, "u64"),
                   (ctypes.c_int64, "i64"))
_POINTER_TYPES = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_wchar_p)


def ctype_class(t) -> str:
    """The shape class lint_interfaces gives the C type this ctypes type
    stands for ("none", "i32", "u64", ..., "ptr")."""
    if t is None:
        return "none"
    for ct, cls in _SCALAR_CLASSES:
        if t is ct:
            return cls
    if t in _POINTER_TYPES or (isinstance(t, type) and issubclass(
            t, (ctypes._Pointer, ctypes._CFuncPtr))):
        return "ptr"
    return f"?{getattr(t, '__name__', t)}"


class _RecordedFn:
    """Stands for one foreign function: records what is declared on it."""

    def __init__(self):
        object.__setattr__(self, "declared", {})

    def __setattr__(self, attr, value):
        self.declared[attr] = value


class RecordingLib:
    """Stands for a loaded ctypes.CDLL: every ebt_* attribute is a
    _RecordedFn, so a binding table run against it leaves its declarations
    behind."""

    def __init__(self):
        self.fns: dict[str, _RecordedFn] = {}

    def __getattr__(self, name):
        if not name.startswith("ebt_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, _RecordedFn())

    def decls(self) -> dict[str, set[str]]:
        return {s: {a for a in fn.declared if a in ("restype", "argtypes")}
                for s, fn in self.fns.items()}

    def shapes(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for sym, fn in self.fns.items():
            sh = out.setdefault(sym, {})
            if "argtypes" in fn.declared:
                sh["argtypes"] = [ctype_class(t)
                                  for t in fn.declared["argtypes"]]
            if "restype" in fn.declared:
                sh["restype"] = ctype_class(fn.declared["restype"])
        return out


def load_def(root: str, rel: str, name: str, namespace: dict):
    """The module-level function `name` of the Python file `rel` under
    `root`, defined alone in `namespace` (its module is not imported, so a
    tree other than this checkout is read as it stands)."""
    path = _j(root, rel)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            exec(compile(ast.Module(body=[node], type_ignores=[]), path,
                         "exec"), namespace)
            return namespace[name]
    raise LookupError(f"{rel} defines no {name}()")


def record_cuda_table(root: str) -> RecordingLib:
    """engine._declare_cuda's table, run against a recording stand-in."""
    lib = RecordingLib()
    load_def(root, CUDA_BINDING, "_declare_cuda", {"ctypes": ctypes})(lib)
    return lib


def record_kernel_bindings(root: str) -> RecordingLib:
    """Each kernel module's load_lib(), run with the build skipped and the
    CDLL replaced by one recording stand-in."""
    lib = RecordingLib()
    fake_ctypes = types.SimpleNamespace(**vars(ctypes))
    fake_ctypes.CDLL = lambda *_a, **_k: lib
    for rel in KERNEL_BINDINGS:
        load_def(root, rel, "load_lib", {
            "ctypes": fake_ctypes, "_lib": None,
            "_lib_lock": threading.Lock(), "library": lambda: ""})()
    return lib


def _c_exports(text: str) -> str:
    """A C source with its `extern "C"` linkage prefixes dropped, in the
    shape lint_interfaces' signature parser reads (one definition per line
    start, as in capi.cpp)."""
    return re.sub(r'^extern\s+"C"\s+', "", text, flags=re.M)


def _port_uses(root: str) -> set[str]:
    """ebt_* symbols the port's Python reaches on a loaded library."""
    paths = [_j(root, "chip_smoke.py")]
    paths += glob.glob(_j(root, "tools", "torch_*.py"))
    for dirpath, _dirs, files in os.walk(_j(root, "elbencho_tpu_torch")):
        paths += [_j(dirpath, f) for f in files if f.endswith(".py")]
    uses: set[str] = set()
    for path in paths:
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                uses |= lint_interfaces.parse_ctypes_uses(f.read())
    return uses


def _lint_seam(label: str, sources: dict[str, str], decls: dict,
              shapes: dict, uses: set[str],
              binding_rel: str) -> list[Finding]:
    """lint_interfaces' binding and shape checks of one C ABI (`sources`:
    repo path -> text, named `label` in the causes) against its bindings.
    Each finding is anchored at its symbol's definition in the C sources,
    else (a symbol they lack) at the binding file."""
    c_text = "\n".join(_c_exports(t) for t in sources.values())
    with retargeted(lint_interfaces, CAPI=label):
        exports = lint_interfaces.parse_capi_exports(c_text)
        errors = lint_interfaces.lint_native_bindings(exports, decls, uses)
        errors += lint_interfaces.lint_binding_shapes(
            lint_interfaces.parse_capi_signatures(c_text), shapes)
    code = {rel: strip(t) for rel, t in sources.items()}
    findings = []
    for msg in errors:
        rel, line = binding_rel, 0
        sym = _SYM_RE.search(msg)
        for src, text in code.items():
            d = sym and re.search(rf"\b{sym.group(0)}\s*\(", text)
            if d:
                rel, line = src, text.count("\n", 0, d.start()) + 1
                break
        findings.append(Finding("interfaces-port", rel, line, msg))
    return findings


def interfaces_collect(root: str) -> list[Finding]:
    findings: list[Finding] = []
    texts: dict[str, str] = {}
    for rel in (CORE_CAPI, CUDA_CAPI, *KERNEL_SOURCES, *CORE_BINDINGS):
        try:
            with open(_j(root, rel), encoding="utf-8") as f:
                texts[rel] = f.read()
        except OSError:
            findings.append(Finding("interfaces-port", rel, 0,
                                    "audited source missing or unreadable"))
    if findings:
        return findings
    kernel_exports = lint_interfaces.parse_capi_exports("\n".join(
        _c_exports(texts[r]) for r in KERNEL_SOURCES))
    uses = _port_uses(root)
    cuda_uses = {u for u in uses if u.startswith("ebt_cuda_")}
    kernel_uses = uses & kernel_exports
    core_uses = uses - cuda_uses - kernel_uses
    try:
        cuda = record_cuda_table(root)
        kernels = record_kernel_bindings(root)
    except (OSError, SyntaxError, LookupError) as e:
        return [Finding("interfaces-port", "", 0,
                        f"cannot read a ctypes binding table: {e}")]

    # 1. the CUDA engine's C ABI against engine._declare_cuda
    findings += _lint_seam(CUDA_CAPI, {CUDA_CAPI: texts[CUDA_CAPI]},
                           cuda.decls(), cuda.shapes(), cuda_uses,
                           CUDA_BINDING)

    # 2. the shared engine's C ABI against the port's own bindings
    decls: dict[str, set[str]] = {}
    shapes: dict[str, dict] = {}
    for rel in CORE_BINDINGS:
        for sym, attrs in lint_interfaces.parse_ctypes_decls(
                texts[rel]).items():
            decls.setdefault(sym, set()).update(attrs)
        for sym, sh in lint_interfaces.parse_ctypes_shapes(
                texts[rel]).items():
            shapes.setdefault(sym, {}).update(sh)
    findings += _lint_seam(CORE_CAPI, {CORE_CAPI: texts[CORE_CAPI]}, decls,
                           shapes, core_uses, CORE_BINDINGS[0])

    # 3. the kernels' C entries against the kernel modules' load_lib()
    findings += _lint_seam(_j(CSRC, "*.cu"),
                           {r: texts[r] for r in KERNEL_SOURCES},
                           kernels.decls(), kernels.shapes(), kernel_uses,
                           KERNEL_BINDINGS[0])
    return findings


# ------------------------------------------------ the Python-seam analyzers

PORT = "elbencho_tpu_torch"
# schema_registry's seam constants (which mergecheck and counter_coverage
# copy) -> the port's files
SEAM = {
    "COMMON": _j(PORT, "common.py"),
    "STATS": _j(PORT, "stats.py"),
    "REMOTE": _j(PORT, "workers", "remote.py"),
    "METRICS": _j(PORT, "metrics.py"),
    "CAMPAIGN": _j(PORT, "campaign.py"),
    "BENCH": _j(PORT, "bench.py"),
}
# The analyzers read every engine counter reader from one file (the
# original's tpu/native.py). The port splits them between NativeCudaPath's
# module and engine_stats.py; NATIVE parses as one module of both, with
# engine_stats.py's lines shifted past _NATIVE_SHIFT so that a finding is
# anchored back in the file it came from (_relabel).
NATIVE = _j(PORT, "cuda", "native.py")
ENGINE_STATS = _j(PORT, "engine_stats.py")
_NATIVE_SHIFT = 1_000_000
CUDA_H = _j(CSRC, "cuda_path.h")
CUDA_CPP = _j(CSRC, "cuda_path.cpp")
URING_H = _j("core", "include", "ebt", "pjrt_path.h")
MERGE_REPORT = _j("build", "torch_merge_report.txt")
# the counter groups with the port's C ABI names (ebt_pjrt_* -> ebt_cuda_*;
# the shared engine's ebt_engine_* and ebt_uring_stats stay)
PORT_GROUPS = tuple(
    dict(g, capi_fn=g["capi_fn"].replace("ebt_pjrt_", "ebt_cuda_"))
    for g in counter_coverage.GROUPS)

# What the three analyzers still read of the original's sources, each with
# its cause. Nothing else of theirs is exempt: every other finding on the
# port's tree is a fault to fix.
SHARED_SOURCES = {
    _j("core", "include", "ebt", "engine.h"):
        "the DevCopyFn direction docs and the engine-side counter structs "
        "(TenantStats, EngineFaultStats, NumaStats, ServingStats): the port "
        "builds the shared engine into its own library",
    _j("core", "include", "ebt", "reactor.h"): "ReactorStats, likewise",
    URING_H:
        "UringStats: ebt_uring_stats reads PjrtPath::uringStats, the "
        "process-wide fixed-buffer slot table the port's library carries "
        "with the shared engine (engine._CORE_SRCS); its lines anchor at "
        "csrc/cuda_path.h",
    CORE_CAPI:
        "the shared engine's C ABI (ebt_engine_*, ebt_uring_stats); the "
        "ebt_cuda_* groups are read from csrc/cuda_capi.cpp",
    **{doc: "the docs name the counters, tiers, exit codes and /metrics "
            "families, which the port keeps under the original's names"
       for doc in (*counter_coverage.DOCS, schema_registry.TIER_DOC)},
}


def _joined_parse(root: str):
    """schema_registry._parse, with NATIVE read as one module of the port's
    two counter-reader files."""
    parse = schema_registry._parse
    native = os.path.normpath(_j(root, NATIVE))

    def joined(path: str):
        if os.path.normpath(path) != native:
            return parse(path)
        tree = parse(native)
        extra = parse(_j(root, ENGINE_STATS))
        ast.increment_lineno(extra, _NATIVE_SHIFT)
        tree.body += extra.body
        return tree
    return joined


def _direction_cases(root: str) -> dict[int, int]:
    """case labels of the direction switch in CudaPath::copy. A copy of
    schema_registry.extract_direction_cases, whose regex names
    PjrtPath::copy inside the function, where no patch reaches."""
    text = open(_j(root, CUDA_CPP)).read()
    m = re.search(r"int CudaPath::copy\(.*?\n}", text, re.S)
    body = m.group(0) if m else ""
    off = text[:m.start()].count("\n") if m else 0
    out: dict[int, int] = {}
    for cm in re.finditer(r"case (\d+):", body):
        out.setdefault(int(cm.group(1)),
                       off + body[:cm.start()].count("\n") + 1)
    return out


def _read_stripped(root: str, rel: str) -> str:
    with open(_j(root, rel), encoding="utf-8", errors="replace") as f:
        return strip_cpp_comments_and_strings(f.read())


def _capi_marshalled(root: str):
    """counter_coverage._capi_marshalled over cuda_capi.cpp for the port's
    ebt_cuda_* exports, over the shared engine's capi.cpp for the rest."""
    marshalled = counter_coverage._capi_marshalled
    cuda = _read_stripped(root, CUDA_CAPI)
    return lambda capi, fn: marshalled(
        cuda if fn.startswith("ebt_cuda_") else capi, fn)


def _struct_fields(root: str):
    """counter_coverage._struct_fields, with UringStats read from the
    shared pjrt_path.h (SHARED_SOURCES says why)."""
    fields = counter_coverage._struct_fields
    uring = _read_stripped(root, URING_H)
    return lambda header, struct: fields(
        uring if struct == "UringStats" else header, struct)


def _d2h_fields(root: str):
    """The deferred-D2H counters: out[i] = <name>_.load assignments in
    CudaPath::d2hStats, which the port defines in cuda_path.cpp (the
    original's regex wants the body inline in pjrt_path.h with a pointer
    parameter, inside the function, where no patch reaches). Lines are
    cuda_path.cpp's."""
    text = _read_stripped(root, CUDA_CPP)

    def d2h(_header: str) -> dict[str, int]:
        m = re.search(r"void CudaPath::d2hStats\(uint64_t out\[\d+\]\) "
                      r"const \{(.*?)\}", text, re.S)
        if not m:
            return {}
        off = text[:m.start(1)].count("\n")
        out: dict[str, int] = {}
        for i, line in enumerate(m.group(1).split("\n")):
            fm = re.search(r"out\[\d+\]\s*=\s*(\w+?)_\.load", line)
            if fm:
                out[fm.group(1)] = off + i + 1
        return out
    return d2h


@contextlib.contextmanager
def seam_retargeted(root: str):
    """schema_registry, counter_coverage and mergecheck pointed at the
    port's Python seam and its C++ counter sources inside the block."""
    with contextlib.ExitStack() as stack:
        enter = stack.enter_context
        enter(retargeted(schema_registry, NATIVE=NATIVE, PJRT_CPP=CUDA_CPP,
                         _parse=_joined_parse(root),
                         extract_direction_cases=_direction_cases, **SEAM))
        enter(retargeted(
            counter_coverage, NATIVE=NATIVE, REMOTE=SEAM["REMOTE"],
            STATS=SEAM["STATS"], BENCH=SEAM["BENCH"],
            METRICS_PY=SEAM["METRICS"], PJRT_H=CUDA_H, GROUPS=PORT_GROUPS,
            _capi_marshalled=_capi_marshalled(root),
            _struct_fields=_struct_fields(root),
            _d2h_fields=_d2h_fields(root)))
        enter(retargeted(mergecheck, NATIVE=NATIVE, REPORT=MERGE_REPORT,
                         **{k: SEAM[k] for k in ("REMOTE", "STATS", "METRICS",
                                                 "BENCH", "COMMON")}))
        yield


def _relabel(findings: list[Finding]) -> list[Finding]:
    """Findings in NATIVE's engine_stats.py part anchored in that file."""
    return [Finding(f.analyzer, ENGINE_STATS, f.line - _NATIVE_SHIFT, f.cause)
            if f.file == NATIVE and f.line > _NATIVE_SHIFT else f
            for f in findings]


def _seam_collect(name: str, collect):
    def run(root: str) -> list[Finding]:
        for rel in (CUDA_CAPI, CUDA_H, CUDA_CPP, NATIVE, ENGINE_STATS,
                    *SEAM.values(), *SHARED_SOURCES):
            if not os.path.exists(_j(root, rel)):
                return [Finding(name, rel, 0, "audited source missing")]
        with seam_retargeted(root):
            return _relabel(collect(root))
    return run


schema_collect = _seam_collect("schema", schema_registry.collect)
counters_collect = _seam_collect("counters", counter_coverage.collect)
mergecheck_collect = _seam_collect("mergecheck", mergecheck.collect)


def property_plan() -> list[tuple[str, str, str, str]]:
    """mergecheck's property plan over the port's seam
    (tests/test_torch_merge_law.py proves each entry on the port)."""
    with seam_retargeted(REPO):
        return mergecheck.property_plan()


# -------------------------------------------------------------------- driver

def analyzers() -> dict:
    return {
        "lockcheck": lockcheck_collect,
        "pathcheck": pathcheck_collect,
        "hotcheck": hotcheck_collect,
        "interfaces-port": interfaces_collect,
        "schema": schema_collect,
        "counters": counters_collect,
        "mergecheck": mergecheck_collect,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="torch_audit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--only", help="comma-separated analyzer subset")
    ap.add_argument("--skip", help="comma-separated analyzers to skip")
    ap.add_argument("--report", default=REPORT,
                    help=f"also write findings to this file (default "
                         f"{REPORT}, under --root)")
    ap.add_argument("--root", default=REPO,
                    help="tree to audit (default: this checkout)")
    ap.add_argument("--write-hotpath-baseline", action="store_true",
                    help=f"ratchet {HOT_BASELINE} to the current hot-path "
                         "violation set (intentional)")
    args = ap.parse_args(argv)

    if args.write_hotpath_baseline:
        print(f"audit: wrote {write_hotpath_baseline(args.root)}")
        return 0

    table = analyzers()
    names = list(table)
    if args.only:
        names = [n for n in args.only.split(",") if n]
    if args.skip:
        names = [n for n in names if n not in set(args.skip.split(","))]
    unknown = [n for n in names if n not in table]
    if unknown:
        print(f"audit: unknown analyzer(s): {', '.join(unknown)} "
              f"(have: {', '.join(table)})", file=sys.stderr)
        return 2

    findings: list[Finding] = []
    clean: list[str] = []
    for name in names:
        got = table[name](args.root)
        findings.extend(got)
        if not got:
            clean.append(name)

    lines = [f.format() for f in findings]
    for ln in lines:
        print(ln, file=sys.stderr)
    report = os.path.join(args.root, args.report)
    os.makedirs(os.path.dirname(report) or ".", exist_ok=True)
    with open(report, "w") as f:
        if lines:
            f.write("\n".join(lines) + "\n")
        else:
            f.write(f"audit: clean ({', '.join(names)})\n")
    if findings:
        print(f"audit: {len(findings)} finding(s) across "
              f"{len(names) - len(clean)} analyzer(s)", file=sys.stderr)
        return 1
    print(f"audit: clean ({', '.join(names)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
