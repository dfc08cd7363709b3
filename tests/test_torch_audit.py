"""Mutation tests for the port's static audit gate (tools/torch_audit.py).

Each test copies the port's audited surface into a tmp tree, injects one
drift of the class an analyzer exists to catch - a completion tracker
leaked on a fault path (C4), a lock taken against the port's documented
hierarchy, a raw std::mutex, a predicate-lambda wait, doc drift, a ctypes
width mismatch, an export without a binding, a counter key dropped at
the ctypes seam, a result-tree field renamed in the fan-in, a summed field
merged by max - and asserts that the named analyzer flags it with its
cause and a file:line anchor. The real tree audits clean through the
driver, and the driver leaves the original analyzers' constants as it
found them, so the original's gate (tests/test_audit.py, python3 -m
tools.audit) never sees the port's sources.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import lint_interfaces, torch_audit  # noqa: E402
from tools.audit import (counter_coverage, hotcheck,  # noqa: E402
                         lockcheck, mergecheck, pathcheck, schema_registry)
from tools.audit.__main__ import analyzers as original_analyzers  # noqa: E402

PATH_CPP = "elbencho_tpu_torch/csrc/cuda_path.cpp"
PATH_H = "elbencho_tpu_torch/csrc/cuda_path.h"
CAPI = "elbencho_tpu_torch/csrc/cuda_capi.cpp"
ENGINE_PY = "elbencho_tpu_torch/engine.py"
FENCE = "elbencho_tpu_torch/csrc/CONCURRENCY.md"
REMOTE_PY = "elbencho_tpu_torch/workers/remote.py"
ENGINE_STATS_PY = "elbencho_tpu_torch/engine_stats.py"
NATIVE_PY = "elbencho_tpu_torch/cuda/native.py"
CLEAN = ("audit: clean (lockcheck, pathcheck, hotcheck, interfaces-port, "
         "schema, counters, mergecheck)")
SEAM_ANALYZERS = ("schema", "counters", "mergecheck")

# the original analyzers' constants, as they stand before any driver call
ORIGINAL = {
    (lockcheck, "AUDIT_SOURCES"): lockcheck.AUDIT_SOURCES,
    (lockcheck, "HIERARCHY_DOC"): lockcheck.HIERARCHY_DOC,
    (pathcheck, "PATH_SOURCES"): pathcheck.PATH_SOURCES,
    (hotcheck, "HOT_SOURCES"): hotcheck.HOT_SOURCES,
    (hotcheck, "BASELINE"): hotcheck.BASELINE,
    (hotcheck, "LANES_DOC"): hotcheck.LANES_DOC,
    (hotcheck, "REPORT"): hotcheck.REPORT,
    (lint_interfaces, "CAPI"): lint_interfaces.CAPI,
    **{(schema_registry, k): getattr(schema_registry, k) for k in (
        "COMMON", "STATS", "REMOTE", "NATIVE", "METRICS", "CAMPAIGN",
        "BENCH", "PJRT_CPP", "_parse", "extract_direction_cases")},
    **{(counter_coverage, k): getattr(counter_coverage, k) for k in (
        "NATIVE", "REMOTE", "STATS", "BENCH", "METRICS_PY", "PJRT_H",
        "GROUPS", "_capi_marshalled", "_struct_fields", "_d2h_fields")},
    **{(mergecheck, k): getattr(mergecheck, k) for k in (
        "NATIVE", "REPORT", "REMOTE", "STATS", "METRICS", "BENCH",
        "COMMON")},
}


def _audited_files():
    """Every file the driver reads: its C++ and fence sources, the C ABIs
    and kernel sources, and every Python file of the port it scans for
    ebt_* uses."""
    rels = set(torch_audit.LOCK_SOURCES) | set(torch_audit.PATH_SOURCES)
    rels |= {torch_audit.FENCE_DOC, torch_audit.HOT_BASELINE,
             torch_audit.CORE_CAPI, torch_audit.CUDA_CAPI,
             *torch_audit.KERNEL_SOURCES, "chip_smoke.py",
             *torch_audit.SHARED_SOURCES}
    for dirpath, _dirs, files in os.walk(os.path.join(
            REPO, "elbencho_tpu_torch")):
        rels |= {os.path.relpath(os.path.join(dirpath, f), REPO)
                 for f in files if f.endswith(".py")}
    rels |= {os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tools", "torch_*.py"))}
    return sorted(rels)


@pytest.fixture()
def tree(tmp_path):
    """A copy of the port's audited surface."""
    for rel in _audited_files():
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    return tmp_path


def _edit(tree, rel, old, new, count=1):
    p = tree / rel
    text = p.read_text()
    assert text.count(old) == count, f"mutation anchor {old!r} in {rel}"
    p.write_text(text.replace(old, new))


def _line_with(tree, rel, needle, nth=1):
    """1-based line of the nth line holding `needle`: anchors are computed
    from the source, never hardcoded."""
    hits = [i for i, ln in enumerate(
        (tree / rel).read_text().splitlines(), 1) if needle in ln]
    assert len(hits) >= nth, f"{needle!r} x{nth} not in {rel}"
    return hits[nth - 1]


def _at(findings, rel, line):
    return [f for f in findings if f.file == rel and f.line == line]


# ------------------------------------------------------------- clean trees

def test_real_tree_runs_clean_through_the_driver(tmp_path, capsys):
    """(h) the shipped port passes all seven analyzers, exit 0."""
    report = tmp_path / "report.txt"
    assert torch_audit.main(["--root", REPO, "--report", str(report)]) == 0
    assert CLEAN in capsys.readouterr().out
    assert report.read_text().strip() == CLEAN


def test_fixture_tree_audits_clean(tree):
    """The unmutated copy is clean too: a failing mutation test means the
    mutation was caught, never fixture noise."""
    for name, collect in torch_audit.analyzers().items():
        assert collect(str(tree)) == [], name


def test_driver_restores_the_original_constants(tmp_path):
    """(i) after the driver ran in this process, every constant it patched
    is the original's again, and the original's gate sees its own
    sources (pytest-xdist runs tests/test_audit.py in the same workers)."""
    torch_audit.main(["--root", REPO, "--report",
                      str(tmp_path / "r.txt")])
    for (module, name), value in ORIGINAL.items():
        assert getattr(module, name) == value, (module.__name__, name)
    assert lockcheck.HIERARCHY_DOC == os.path.join("docs", "CONCURRENCY.md")
    assert os.path.join("core", "src", "pjrt_path.cpp") in \
        pathcheck.PATH_SOURCES
    assert lockcheck.collect(REPO) == []
    assert pathcheck.collect(REPO) == []


def test_retargeting_is_undone_on_an_exception():
    with pytest.raises(RuntimeError):
        with torch_audit.retargeted(lockcheck, AUDIT_SOURCES=("x",),
                                    HIERARCHY_DOC="y"):
            assert lockcheck.AUDIT_SOURCES == ("x",)
            raise RuntimeError("analyzer failed")
    assert lockcheck.AUDIT_SOURCES == ORIGINAL[(lockcheck, "AUDIT_SOURCES")]
    assert lockcheck.HIERARCHY_DOC == ORIGINAL[(lockcheck, "HIERARCHY_DOC")]


def test_driver_only_skip_and_unknown(tmp_path, capsys):
    report = str(tmp_path / "r.txt")
    assert torch_audit.main(["--root", REPO, "--report", report,
                             "--only", "lockcheck,interfaces-port"]) == 0
    assert "audit: clean (lockcheck, interfaces-port)" in \
        capsys.readouterr().out
    assert torch_audit.main(["--root", REPO, "--report", report,
                             "--skip", "hotcheck,pathcheck,schema,counters,"
                                       "mergecheck"]) == 0
    assert "audit: clean (lockcheck, interfaces-port)" in \
        capsys.readouterr().out
    assert torch_audit.main(["--root", REPO, "--report", report,
                             "--only", "interfaces"]) == 2
    assert "unknown analyzer(s): interfaces" in capsys.readouterr().err


def test_findings_exit_1_in_the_original_report_format(tree, capsys):
    _edit(tree, PATH_CPP, "void CudaPath::releaseScratch(char* p) {\n",
          "void CudaPath::releaseScratch(char* p) {\n  std::mutex raw;\n")
    report = tree / "build" / "torch_audit_report.txt"
    assert torch_audit.main(["--root", str(tree)]) == 1
    err = capsys.readouterr().err
    line = _line_with(tree, PATH_CPP, "std::mutex raw;")
    want = f"audit:lockcheck: {PATH_CPP}:{line}: raw std::mutex"
    assert want in err
    assert want in report.read_text()
    assert (tree / "build" / "torch_hotpath_report.txt").exists()


# ------------------------------------------------ pathcheck: resource pairs

def test_pathcheck_flags_c4_tracker_leak(tree):
    """(a) C4 put back: the dropped branch of the tracker wait frees
    nothing, so the tracker taken off the pending leaks to the return."""
    _edit(tree, PATH_CPP, """    rc = 1;
    delete t;
    EBT_PAIR_END(tracker);
""", """    rc = 1;
""")
    findings = torch_audit.pathcheck_collect(str(tree))
    begin = _line_with(tree, PATH_CPP, "EBT_PAIR_BEGIN(tracker);  // taken")
    hit = _at(findings, PATH_CPP, begin)
    assert hit and all(f.analyzer == "pathcheck" for f in hit), findings
    assert "pair 'tracker' begun here can reach the return" in hit[0].cause
    assert "CudaPath::awaitTracker" in hit[0].cause


def test_pathcheck_flags_a_write_source_leak(tree):
    """A write source whose upload failed is returned from without its
    free."""
    _edit(tree, PATH_CPP, """    syncStream(li, lane.h2d);
    api_.cuMemFree(p);
    EBT_PAIR_END(dev_buf);
    return 0;
""", """    syncStream(li, lane.h2d);
    return 0;
""")
    findings = torch_audit.pathcheck_collect(str(tree))
    fn = _line_with(tree, PATH_CPP, "cu::CUdeviceptr CudaPath::deviceSource(")
    begins = [f for f in findings if "'dev_buf'" in f.cause
              and "CudaPath::deviceSource" in f.cause]
    assert begins and begins[0].line > fn, findings


def test_pathcheck_flags_a_copy_hold_kept_on_an_early_return(tree):
    """An early return between holdForCopy and releaseHold keeps the
    in-flight hold, which blocks window eviction for good."""
    _edit(tree, PATH_CPP, """  const bool held = holdForCopy(buf, len, lane);
  EBT_PAIR_BEGIN(copy_hold);  // the hold, where one was taken
  int rc = 0;
""", """  const bool held = holdForCopy(buf, len, lane);
  EBT_PAIR_BEGIN(copy_hold);  // the hold, where one was taken
  int rc = 0;
  if (!len) return 1;
""")
    findings = torch_audit.pathcheck_collect(str(tree))
    assert any("'copy_hold'" in f.cause and "submitH2DXferMgr" in f.cause
               for f in findings), findings


def test_pathcheck_flags_an_orphaned_tier_block(tree):
    """The orphaned tier buffer, the class pathcheck was built for: a
    transfer-manager block whose copies failed mid-way is neither parked on
    the last pending nor freed."""
    _edit(tree, PATH_CPP, """    submitted.back().xm_buf = block;
    EBT_PAIR_HOLDER(xfer_mgr);
""", "")
    findings = torch_audit.pathcheck_collect(str(tree))
    begin = _line_with(tree, PATH_CPP, "EBT_PAIR_BEGIN(xfer_mgr);")
    hit = _at(findings, PATH_CPP, begin)
    assert hit and "pair 'xfer_mgr' begun here can reach" in hit[0].cause \
        and "CudaPath::submitH2DXferMgr" in hit[0].cause, findings


def test_pathcheck_flags_a_displaced_generation_kept(tree):
    """The original's aborted-rotation class: a swap takes the displaced
    generation out of the ledger and never frees it."""
    _edit(tree, PATH_CPP, "  rotFree(old);\n", "")
    findings = torch_audit.pathcheck_collect(str(tree))
    begin = _line_with(tree, PATH_CPP,
                       "EBT_PAIR_BEGIN(rot_buf);  // the displaced")
    hit = _at(findings, PATH_CPP, begin)
    assert hit and "pair 'rot_buf' begun here" in hit[0].cause \
        and "CudaPath::rotateSwap" in hit[0].cause, findings


def test_pathcheck_on_the_port_is_not_empty():
    """(j) every pair the port declares has a BEGIN in cuda_path.cpp, so a
    clean pathcheck speaks of the CUDA engine, not only the shared one."""
    text = torch_audit.strip(open(os.path.join(REPO, PATH_CPP)).read())
    begun = set(re.findall(r"\bEBT_PAIR_BEGIN\s*\(\s*(\w+)\s*\)", text))
    for pair in ("tracker", "reg_intransit", "dev_buf", "rot_buf",
                 "bounce_scratch", "xfer_mgr", "stripe_unit", "ckpt_shard",
                 "ingest_epoch", "reshard_unit"):
        assert pair in torch_audit.PORT_PAIRS
        assert pair in begun, pair


def test_pathcheck_refuses_an_unannotated_pair(tree):
    p = tree / PATH_CPP
    p.write_text(re.sub(r"EBT_PAIR_BEGIN\(rot_buf\);", "(void)0;",
                        p.read_text()))
    findings = torch_audit.pathcheck_collect(str(tree))
    assert any("pair 'rot_buf' has no EBT_PAIR_BEGIN in the CUDA engine"
               in f.cause for f in findings), findings


# ------------------------------------------------ lockcheck: lock discipline

def test_lockcheck_flags_err_mutex_under_a_sibling(tree):
    """(b) err_mutex_ taken under Lane::histo_m, which the port's fence
    ranks beside it (the teardown nestings' class)."""
    _edit(tree, PATH_CPP, """  MutexLock lk(lane.histo_m);
  lane.histo.add(us);
""", """  MutexLock lk(lane.histo_m);
  lane.histo.add(us);
  latchXferError("latency sample dropped");
""")
    findings = torch_audit.lockcheck_collect(str(tree))
    line = _line_with(tree, PATH_CPP, 'latchXferError("latency sample')
    hit = _at(findings, PATH_CPP, line)
    assert hit and "CudaPath::err_mutex_ acquired while holding " \
        "Lane::histo_m: violates the documented order" in hit[0].cause, \
        findings


def test_lockcheck_flags_a_raw_mutex(tree):
    """(c) a raw std::mutex in the CUDA engine."""
    _edit(tree, PATH_CPP, "void CudaPath::releaseScratch(char* p) {\n",
          "void CudaPath::releaseScratch(char* p) {\n"
          "  static std::mutex m2;\n  std::lock_guard<std::mutex> g(m2);\n")
    findings = torch_audit.lockcheck_collect(str(tree))
    line = _line_with(tree, PATH_CPP, "static std::mutex m2;")
    causes = [f.cause for f in _at(findings, PATH_CPP, line)]
    assert any(c.startswith("raw std::mutex") for c in causes), findings
    causes = [f.cause for f in _at(findings, PATH_CPP, line + 1)]
    assert any(c.startswith("raw std::lock_guard") for c in causes)


def test_lockcheck_flags_a_predicate_lambda_wait(tree):
    """(d) the raw ceiling's start gate waiting on a predicate lambda."""
    _edit(tree, PATH_CPP,
          "while (!gate.go) gate.cv.wait(lk.native());",
          "gate.cv.wait(lk.native(), [&] { return gate.go; });")
    findings = torch_audit.lockcheck_collect(str(tree))
    line = _line_with(tree, PATH_CPP, "[&] { return gate.go; }")
    hit = _at(findings, PATH_CPP, line)
    assert hit and "gate.cv.wait uses a predicate lambda" in hit[0].cause


@pytest.mark.parametrize("drift", ["undocumented_member", "stale_entry"])
def test_lockcheck_flags_fence_drift(tree, drift):
    """(e) doc drift both ways: a Mutex the fence does not rank, and a
    fence entry no member declares."""
    if drift == "undocumented_member":
        _edit(tree, PATH_H, "  mutable Mutex rank_mutex_;\n",
              "  mutable Mutex rank_mutex_;\n  mutable Mutex probe_mutex_;\n")
        findings = torch_audit.lockcheck_collect(str(tree))
        line = _line_with(tree, PATH_H, "mutable Mutex probe_mutex_;")
        hit = _at(findings, PATH_H, line)
        assert hit and "ebt::Mutex CudaPath::probe_mutex_ is not placed in " \
            f"the {FENCE} hierarchy table" in hit[0].cause, findings
    else:
        _edit(tree, FENCE, "StartGate::gate_m\n",
              "StartGate::gate_m\nCudaPath::ghost_mutex_\n")
        findings = torch_audit.lockcheck_collect(str(tree))
        line = _line_with(tree, FENCE, "CudaPath::ghost_mutex_")
        hit = _at(findings, FENCE, line)
        assert hit and "names 'CudaPath::ghost_mutex_' but no such " \
            "ebt::Mutex is declared" in hit[0].cause, findings


def test_lockcheck_flags_a_call_into_an_excluded_lock(tree):
    """latchXferError is EBT_EXCLUDES(err_mutex_): calling it with the
    error latch held is a self-deadlock."""
    _edit(tree, PATH_CPP, """    for (ReadyTracker* t : orphan_trackers_) delete t;
""", """    for (ReadyTracker* t : orphan_trackers_) delete t;
    latchXferError("teardown");
""")
    findings = torch_audit.lockcheck_collect(str(tree))
    line = _line_with(tree, PATH_CPP, 'latchXferError("teardown");')
    causes = [f.cause for f in _at(findings, PATH_CPP, line)]
    assert any("calls latchXferError while holding CudaPath::err_mutex_"
               in c and "(self-deadlock)" in c for c in causes), findings


def test_lockcheck_flags_an_unresolvable_lock(tree):
    """The tracker lock reached through a type the resolver cannot name."""
    _edit(tree, PATH_CPP, "  ReadyTracker* t = static_cast<ReadyTracker*>(arg);",
          "  auto* t = static_cast<ReadyTracker*>(arg);")
    findings = torch_audit.lockcheck_collect(str(tree))
    assert any("cannot resolve mutex expression 't->m'" in f.cause
               for f in findings), findings


# ------------------------------------------------- hotcheck: the ratchet

def test_hotcheck_flags_growth_over_the_port_baseline(tree):
    """A heap allocation added to a measured loop grows the port's ratchet
    (its own baseline, its own report)."""
    text = (tree / "core/src/engine.cpp").read_text()
    first = text.index("EBT_HOT;")
    (tree / "core/src/engine.cpp").write_text(
        text[:first] + "EBT_HOT;\n  std::string hot_probe(\"x\");" +
        text[first + len("EBT_HOT;"):])
    findings = torch_audit.hotcheck_collect(str(tree))
    assert any("hot-path violations in" in f.cause and "grew" in f.cause
               for f in findings), findings
    assert (tree / torch_audit.HOT_REPORT).exists()


# ---------------------------------------------- interfaces-port: the C ABI

def test_interfaces_flags_a_width_mismatch(tree):
    """(f) raw_h2d's u64 total_bytes declared as an int in the table."""
    _edit(tree, ENGINE_PY,
          '("raw_h2d", [vp, u64, i32, i32, u64, i32, i32], ctypes.c_double)',
          '("raw_h2d", [vp, i32, i32, i32, u64, i32, i32], ctypes.c_double)')
    findings = torch_audit.interfaces_collect(str(tree))
    line = _line_with(tree, CAPI, "double ebt_cuda_raw_h2d(")
    hit = _at(findings, CAPI, line)
    assert hit and "ebt_cuda_raw_h2d: argtypes[1] is i32 but " \
        f"{CAPI} takes u64 (pointer-ness/width mismatch)" == hit[0].cause, \
        findings


def test_interfaces_flags_an_export_without_binding(tree):
    """(g) a new ebt_cuda_* export with no entry in the table."""
    _edit(tree, CAPI, '}  // extern "C"',
          'int ebt_cuda_new_probe(void* p) { return p != nullptr; }\n\n'
          '}  // extern "C"')
    findings = torch_audit.interfaces_collect(str(tree))
    line = _line_with(tree, CAPI, "int ebt_cuda_new_probe(")
    hit = _at(findings, CAPI, line)
    assert hit and f"{CAPI} exports ebt_cuda_new_probe but no ctypes " \
        "binding declares its restype/argtypes" in hit[0].cause, findings


def test_interfaces_flags_a_call_the_abi_lacks(tree):
    """The port's Python calls an ebt_cuda_* symbol the C ABI does not
    export (ctypes would fail only when the line runs)."""
    p = tree / "elbencho_tpu_torch/cuda/native.py"
    p.write_text(p.read_text() + "\n\ndef _probe(lib, h):\n"
                 "    return lib.ebt_cuda_vanished(h)\n")
    causes = [f.cause for f in torch_audit.interfaces_collect(str(tree))]
    assert "ctypes binding uses ebt_cuda_vanished but " \
        f"{CAPI} does not export it" in causes, causes


def test_interfaces_flags_a_stale_binding_and_restype(tree):
    """A table entry for a symbol the C ABI lost, and a restype that
    truncates a u64 counter."""
    _edit(tree, ENGINE_PY, '            ("zero_copy_count", [vp], u64),\n',
          '            ("zero_copy_count", [vp], i32),\n'
          '            ("gone_export", [vp], None),\n')
    causes = [f.cause for f in torch_audit.interfaces_collect(str(tree))]
    assert "stale ctypes declaration: ebt_cuda_gone_export is not exported " \
        f"by {CAPI}" in causes, causes
    assert f"ebt_cuda_zero_copy_count: restype is i32 but {CAPI} returns " \
        "u64 (a mis-declared restype truncates on LP64)" in causes, causes


def test_interfaces_checks_the_kernel_entries(tree):
    """The kernels' C entries against the kernel modules' load_lib()."""
    _edit(tree, "elbencho_tpu_torch/ops/fill_kernel.py",
          "ctypes.c_uint64, ctypes.c_void_p]",
          "ctypes.c_void_p]")
    findings = torch_audit.interfaces_collect(str(tree))
    cu = "elbencho_tpu_torch/csrc/fill.cu"
    hit = _at(findings, cu, _line_with(tree, cu, "ebt_fill_u64("))
    assert hit and "ebt_fill_u64: argtypes declares 3 argument(s) but " \
        "elbencho_tpu_torch/csrc/*.cu takes 4" in hit[0].cause, findings


def test_ctypes_classes_go_by_identity():
    """On LP64 c_uint64 is c_ulong: the class is its width, not its name."""
    import ctypes

    if ctypes.sizeof(ctypes.c_ulong) == 8:
        assert torch_audit.ctype_class(ctypes.c_ulong) == "u64"
    assert torch_audit.ctype_class(ctypes.c_uint64) == "u64"
    assert torch_audit.ctype_class(ctypes.c_int) == "i32"
    assert torch_audit.ctype_class(ctypes.c_double) == "double"
    assert torch_audit.ctype_class(ctypes.POINTER(ctypes.c_int)) == "ptr"
    assert torch_audit.ctype_class(ctypes.c_char_p) == "ptr"
    assert torch_audit.ctype_class(None) == "none"


# ------------------------------------- schema, counters, mergecheck: seam

@pytest.mark.parametrize("name", SEAM_ANALYZERS)
def test_seam_analyzer_is_clean_on_the_port(name):
    assert torch_audit.analyzers()[name](REPO) == []


def test_seam_analyzers_read_the_port():
    """Inside the retargeting the extractors see the port's files: its
    wire, both halves of its counter readers, the CUDA engine's direction
    switch and its counter structs."""
    with torch_audit.seam_retargeted(REPO):
        native = schema_registry.extract_native_dicts(REPO)
        directions = schema_registry.extract_direction_cases(REPO)
        reg = counter_coverage._struct_fields(
            open(os.path.join(REPO, PATH_H)).read(), "RegCacheStats")
        uring = counter_coverage._struct_fields("", "UringStats")
        d2h = counter_coverage._d2h_fields("")
        assert schema_registry.STATS == "elbencho_tpu_torch/stats.py"
    assert schema_registry.STATS == "elbencho_tpu/stats.py"
    # reg_cache_stats is NativeCudaPath's, tenant_stats engine_stats.py's
    assert "misses" in native["reg_cache_stats"]
    assert "tenant" in native["tenant_stats"]
    assert sorted(directions) == list(range(18))
    assert set(reg) == {"hits", "misses", "evictions", "pinned_bytes",
                        "pinned_peak_bytes", "staged_fallbacks"}
    assert "uring_fixed_hits" in uring
    assert set(d2h) == {"d2h_deferred_count", "d2h_await_wait_ns",
                        "d2h_overlap_bytes"}
    assert all(g["capi_fn"].startswith(("ebt_cuda_", "ebt_engine_",
                                        "ebt_uring_"))
               for g in torch_audit.PORT_GROUPS)


def test_counters_flags_a_key_dropped_from_engine_stats(tree):
    """A key dropped from a counter dict in engine_stats.py is caught at
    the ctypes seam, anchored in engine_stats.py (not in cuda/native.py,
    with which it parses as one module)."""
    _edit(tree, ENGINE_STATS_PY, '"io_retry_success": raw[1],', "")
    found = torch_audit.counters_collect(str(tree))
    hits = [f for f in found if "io_retry_success" in f.cause]
    assert hits, [f.cause for f in found]
    assert any("ctypes seam" in f.cause for f in hits)
    mergecheck_hits = [f for f in torch_audit.mergecheck_collect(str(tree))
                       if "io_retry_success" in f.cause]
    assert all(f.file in (ENGINE_STATS_PY, NATIVE_PY)
               for f in hits + mergecheck_hits)


def test_counters_flags_a_dropped_ebt_cuda_marshalling(tree):
    """A counter the CUDA engine's C ABI no longer marshals is dropped at
    the C ABI: the ebt_cuda_* groups are read from cuda_capi.cpp."""
    text = (tree / CAPI).read_text()
    hit = re.search(r"\n(\s*out\[\d+\] = s\.staged_fallbacks;)", text)
    assert hit, "anchor: staged_fallbacks marshalling in cuda_capi.cpp"
    _edit(tree, CAPI, hit.group(1), "")
    line = _line_with(tree, PATH_H, "uint64_t staged_fallbacks = 0;")
    found = torch_audit.counters_collect(str(tree))
    hits = [f for f in found if "staged_fallbacks" in f.cause
            and "never marshalled by ebt_cuda_reg_cache_stats" in f.cause]
    assert hits, [f.cause for f in found]
    assert (hits[0].file, hits[0].line) == (PATH_H, line)


def test_schema_flags_a_fanin_field_renamed(tree):
    """A result-tree field renamed in the port's fan-in drifts from the
    golden protocol schema and leaves the published field unread."""
    _edit(tree, REMOTE_PY, 'us = reply.get("UringStats")',
          'us = reply.get("UringStat")')
    line = _line_with(tree, REMOTE_PY, 'reply.get("UringStat")')
    found = torch_audit.schema_collect(str(tree))
    causes = [f.cause for f in found]
    added = [f for f in found if "'UringStat'" in f.cause]
    assert added and (added[0].file, added[0].line) == (REMOTE_PY, line)
    assert any("'UringStats'" in c and "never read" in c for c in causes)


def test_schema_flags_a_direction_the_cuda_engine_lacks(tree):
    """A DevCopyFn direction CudaPath::copy no longer handles differs from
    the golden and from the engine's documented set."""
    text = (tree / PATH_CPP).read_text()
    body = text[text.index("int CudaPath::copy("):]
    assert "    case 17:" in body
    _edit(tree, PATH_CPP, "    case 17:", "    case 71:")
    causes = [f.cause for f in torch_audit.schema_collect(str(tree))]
    assert any("direction 71 is handled" in c for c in causes), causes
    assert any("direction 17 is documented" in c for c in causes), causes


def test_mergecheck_flags_a_summed_field_merged_by_max(tree):
    """UringStats is declared per-key sum; its fan-in merging by max is a
    class mismatch, anchored at the merge site."""
    old = ("        stats = [p.uring_stats for p in self.proxies "
           "if p.uring_stats]\n"
           "        if not stats:\n"
           "            return None\n"
           "        out: dict[str, int] = {}\n"
           "        for st in stats:\n"
           "            for k, v in st.items():\n"
           "                out[k] = out.get(k, 0) + v\n")
    _edit(tree, REMOTE_PY, old,
          old.replace("out[k] = out.get(k, 0) + v",
                      "out[k] = max(out.get(k, 0), v)"))
    found = torch_audit.mergecheck_collect(str(tree))
    hits = [f for f in found if "'UringStats'" in f.cause]
    assert hits, [f.cause for f in found]
    assert hits[0].file == REMOTE_PY and hits[0].line > 0
    assert "max" in hits[0].cause
    assert (tree / "build" / "torch_merge_report.txt").exists()


def test_original_gate_unchanged_after_the_port_tool(tmp_path):
    """python3 -m tools.audit's analyzers, run in the same process after
    the port's seven, report what they report before it."""
    before = {n: c(REPO) for n, c in original_analyzers().items()}
    assert torch_audit.main(["--root", REPO, "--report",
                             str(tmp_path / "r.txt")]) == 0
    after = {n: c(REPO) for n, c in original_analyzers().items()}
    assert after == before
    for (module, name), value in ORIGINAL.items():
        assert getattr(module, name) == value, (module.__name__, name)
    r = subprocess.run([sys.executable, "-m", "tools.audit"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert (r.returncode == 0) == (before == {n: [] for n in before})
