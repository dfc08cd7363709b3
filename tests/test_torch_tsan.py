"""The port's pytest-under-TSAN gate (tools/torch_test_tsan.py) and the
library overrides it rests on (EBT_TORCH_CORE_LIB, EBT_TORCH_MOCK_LIB in
elbencho_tpu_torch/engine.py).

The gate's files are the port's counterparts of the original's make
test-tsan list; the overrides are honoured, each in a child process, and
never fall back; no suppression can hide a report in the port's own code;
a racy program built here and run under the gate's environment exits 66,
which shows the preload and the options are live; the reactor file runs
clean under TSAN within 300 s. The whole gate over all eight files is the
slow case.

The gate's --examples-dist mode (make torch-test-examples-dist-tsan, the
counterpart of Makefile:438-443): its harness flags and EBT_TEST_EB wrapper
against the Makefile's recipe, the no-runtime notice, the exit codes, a
report of any wrapped process counted from its log file (a racy program
under the wrapper's TSAN_OPTIONS); the whole run is its slow case.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

import pytest

from elbencho_tpu_torch import engine
from test_torch_worker_state import worker_state  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import torch_test_tsan as gate  # noqa: E402

CSRC = os.path.join(REPO, "elbencho_tpu_torch", "csrc")

RACY = r"""
#include <pthread.h>
static int shared;
static void* bump(void*) { for (int i = 0; i < 100000; ++i) ++shared;
                           return nullptr; }
int main() {
  pthread_t a, b;
  pthread_create(&a, nullptr, bump, nullptr);
  pthread_create(&b, nullptr, bump, nullptr);
  pthread_join(a, nullptr);
  pthread_join(b, nullptr);
  return shared == 0;
}
"""


def _child(code: str, env: dict[str, str]) -> subprocess.CompletedProcess:
    """`code` in a fresh interpreter with `env` over this one's (a
    variable set to None is removed)."""
    full = {**os.environ, "EBT_TORCH_DEVICE": "cpu"}
    for k, v in env.items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=120)


def _runtime() -> str:
    runtime = gate.tsan_runtime()
    if runtime is None:
        pytest.skip(gate.SKIP_NOTICE)
    return runtime


# ------------------------------------------------------------- file list


def test_gate_files_are_the_makefiles_counterparts():
    """The tool's files are the port names of the Makefile's test-tsan
    list, in its order, and every one of them exists."""
    text = open(os.path.join(REPO, "Makefile")).read()
    recipe = re.search(r"^test-tsan: tsan\n((?:\t.*\n)+)", text, re.M)
    listed = re.findall(r"tests/test_\w+\.py", recipe.group(1))
    assert len(listed) == 8
    assert list(gate.ORIGINAL_FILES) == listed
    assert gate.FILES == tuple(gate.ORIGINAL_FILES[f] for f in listed)
    for f in gate.FILES:
        assert re.fullmatch(r"tests/test_torch_\w+\.py", f)
        assert os.path.isfile(os.path.join(REPO, f)), f


def test_no_runtime_skips_with_the_makefiles_notice(monkeypatch, capsys):
    monkeypatch.setattr(gate, "TSAN_RT_GLOBS", ("/nonexistent/libtsan.so.*",))
    assert gate.main([]) == 0
    assert capsys.readouterr().out.strip() == gate.SKIP_NOTICE


# --------------------------------------------------------- the overrides

_LOADED = ("from elbencho_tpu_torch import engine\n"
           "print(engine.load_lib()._name)")
_MOCK = ("from elbencho_tpu_torch import engine\n"
         "print(engine.build_mock())")


def test_core_lib_override_honoured(tmp_path):
    """Unset, the port loads build/torch_core/libebtcore.so as before; set,
    the library it names; set to a missing path, it raises with the path
    and loads nothing else."""
    engine.load_lib()
    copy = tmp_path / "libcopy.so"
    shutil.copy(engine._LIB_PATH, copy)
    unset = _child(_LOADED, {engine.CORE_LIB_ENV: None})
    named = _child(_LOADED, {engine.CORE_LIB_ENV: str(copy)})
    missing = _child(_LOADED, {engine.CORE_LIB_ENV: str(tmp_path / "no.so")})
    assert unset.stdout.strip() == engine._LIB_PATH, unset.stderr
    assert named.stdout.strip() == str(copy), named.stderr
    assert missing.returncode != 0 and missing.stdout == ""
    assert f"EBT_TORCH_CORE_LIB={tmp_path / 'no.so'}: no such library" in \
        missing.stderr


def test_core_lib_that_does_not_load_is_named(tmp_path):
    bad = tmp_path / "libbad.so"
    bad.write_bytes(b"not an ELF file")
    r = _child(_LOADED, {engine.CORE_LIB_ENV: str(bad)})
    assert r.returncode != 0 and f"{bad}: cannot load" in r.stderr


def test_mock_lib_override_honoured(tmp_path):
    """Unset, build_mock() hands out the plain mock; set, the library it
    names; set to a missing path, it raises with the path."""
    plain = engine.build_mock()
    copy = tmp_path / "libmockcopy.so"
    shutil.copy(plain, copy)
    unset = _child(_MOCK, {engine.MOCK_LIB_ENV: None})
    named = _child(_MOCK, {engine.MOCK_LIB_ENV: str(copy)})
    missing = _child(_MOCK, {engine.MOCK_LIB_ENV: str(tmp_path / "no.so")})
    assert unset.stdout.strip() == plain, unset.stderr
    assert named.stdout.strip() == str(copy), named.stderr
    assert missing.returncode != 0 and \
        f"EBT_TORCH_MOCK_LIB={tmp_path / 'no.so'}: no such library" in \
        missing.stderr


def test_gate_refuses_uninstrumented_libraries():
    """The tool's pre-run check fails on the plain engine and mock."""
    engine.load_lib()
    ok, out = gate.check_instrumented({
        engine.CORE_LIB_ENV: engine._LIB_PATH,
        engine.MOCK_LIB_ENV: engine.build_mock(),
        "EBT_TORCH_DEVICE": "cpu"})
    assert not ok
    assert f"engine {engine._LIB_PATH} is not instrumented" in out


# ---------------------------------------------------------- suppressions


def _entries() -> list[tuple[str, str]]:
    out = []
    for line in open(gate.SUPPRESSIONS):
        line = line.strip()
        if line and not line.startswith("#"):
            kind, _, pattern = line.partition(":")
            out.append((kind, pattern))
    return out


def _matches(pattern: str, text: str) -> bool:
    """TSAN's suppression match: a substring, with '*' for any run and
    '^'/'$' anchoring the ends."""
    rx = re.escape(pattern.strip("^$")).replace(r"\*", ".*")
    rx = ("^" if pattern.startswith("^") else "") + rx + \
        ("$" if pattern.endswith("$") else "")
    return re.search(rx, text) is not None


def _port_names() -> list[str]:
    """What a report in the port's code names: its libraries' paths, its
    sources' paths and names, and the functions they define."""
    names = [engine._LIB_PATH, engine.MOCK_DRIVER_PATH, engine.TSAN_LIB_PATH,
             engine.TSAN_MOCK_PATH]
    for f in sorted(os.listdir(CSRC)):
        path = os.path.join(CSRC, f)
        names += [path, f]
        src = open(path, errors="replace").read()
        names += [f"ebt::{c}::{m}" for c, m in
                  re.findall(r"\b(\w+)::(~?\w+)\s*\(", src)]
        names += re.findall(r"^[\w:<>*& ]+?\b(\w+)\s*\([^;{]*\)\s*\{",
                            src, re.M)
    return names


def test_no_suppression_matches_port_code():
    entries = _entries()
    assert entries
    names = _port_names()
    assert any("CudaPath::hostFnTrampoline" in n for n in names)
    for kind, pattern in entries:
        hit = [n for n in names if _matches(pattern, n)]
        assert not hit, f"{kind}:{pattern} matches {hit[:3]}"
    # the one entry for the original's engine still names that library
    original = os.path.join(REPO, "elbencho_tpu", "libebtcore.so")
    assert any(_matches(p, original) for _, p in entries)


def test_suppressions_copy_the_originals_class_1():
    """Each runtime entry of tests/tsan.supp's class 1 is in the port's
    file; nothing of its class 2 (the engine's phase-control frames) is."""
    text = open(os.path.join(REPO, "tests", "tsan.supp")).read()
    class1 = text.split("# Class 2")[0]
    want = set(re.findall(r"^(race:\S+)$", class1, re.M))
    have = {f"{k}:{p}" for k, p in _entries()}
    assert want and want <= have
    assert not any(p.startswith("ebt::") for _, p in _entries())


# ------------------------------------------------------------ under TSAN


def test_positive_control_exits_66(tmp_path):
    """A racy program, instrumented and run under the gate's environment,
    reports and exits 66: the preload and the options are live."""
    env = gate.environment(_runtime())
    src = tmp_path / "racy.cpp"
    src.write_text(RACY)
    exe = tmp_path / "racy"
    subprocess.run([os.environ.get("CXX", "g++"), "-O1", "-g", "-pthread",
                    "-fsanitize=thread", str(src), "-o", str(exe)],
                   check=True, capture_output=True)
    r = subprocess.run([str(exe)], env={**os.environ, **env},
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 66, r.stderr
    assert gate.REPORT in r.stderr


def test_reactor_file_runs_clean_under_tsan():
    """tests/test_torch_reactor.py under the gate: every case passes and
    ThreadSanitizer reports nothing, within 300 s (the libraries are built
    first, outside the limit; the plain ones before the instrumented, so
    no first use of the plain engine waits behind the longer build)."""
    runtime = _runtime()
    engine.load_lib()
    engine.build_mock()
    gate.environment(runtime)
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "torch_test_tsan.py"),
                        "tests/test_torch_reactor.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "pytest rc 0, 0 ThreadSanitizer report(s)" in r.stdout
    assert gate.REPORT not in r.stderr


@pytest.mark.slow
def test_whole_gate_runs_clean_under_tsan():
    """python3 tools/torch_test_tsan.py: all eight files, zero reports."""
    _runtime()
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "torch_test_tsan.py")],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=3600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "pytest rc 0, 0 ThreadSanitizer report(s)" in r.stdout


# ------------------------------------------------ the distributed tiers

_FAKE = {"LD_PRELOAD": "/rt/libtsan.so.2",
         engine.CORE_LIB_ENV: "/b/libebtcore_tsan.so",
         engine.MOCK_LIB_ENV: "/b/libebtcudamock_tsan.so"}


def _dist_recipe() -> tuple[list[str], list[str]]:
    """Makefile:438-443: the EBT_TEST_EB words and the harness flags."""
    text = open(os.path.join(REPO, "Makefile")).read()
    recipe = re.search(r"^test-examples-dist-tsan: tsan\n((?:\t.*\n)+)",
                       text, re.M).group(1).replace("\\\n", " ")
    wrapper = re.search(r'EBT_TEST_EB="([^"]*)"', recipe).group(1).split()
    flags = re.search(r"tools/test-examples\.sh((?: -\w)+)",
                      recipe).group(1).split()
    return wrapper, flags


def test_examples_dist_mode_is_the_makefiles():
    """The harness's flags are the recipe's; the wrapper sets what the
    recipe's sets, on the port's names (TSAN_OPTIONS with the port's
    suppressions and a log_path, the two library overrides), plus
    OMP_NUM_THREADS=1, PYTHONPATH cleared and the port's CLI."""
    wrapper, flags = _dist_recipe()
    argv, extra = gate.examples_dist_command(_FAKE, "/logs")
    assert argv == ["bash", gate.HARNESS, *flags]
    assert tuple(flags) == gate.EXAMPLES_DIST_FLAGS == ("-b", "-m", "-t")
    assert os.path.isfile(gate.HARNESS)
    assert set(extra) == {"EBT_TEST_EB", engine.MOCK_LIB_ENV}
    assert extra[engine.MOCK_LIB_ENV] == _FAKE[engine.MOCK_LIB_ENV]
    words = extra["EBT_TEST_EB"].split()
    assert wrapper[0] == words[0] == "env"
    assert wrapper[-3:] == ["python", "-m", "elbencho_tpu.cli"]
    assert words[-3:] == ["python", "-m", "elbencho_tpu_torch.cli"]
    want, got = dict(w.split("=", 1) for w in wrapper[1:-3]), \
        dict(w.split("=", 1) for w in words[1:-3])
    assert want["TSAN_OPTIONS"].replace("$(CURDIR)/tests/tsan.supp",
                                        gate.SUPPRESSIONS) + \
        ":log_path=/logs/tsan" == got.pop("TSAN_OPTIONS")
    assert want["LD_PRELOAD"] == "$(TSAN_RT)" and \
        got.pop("LD_PRELOAD") == _FAKE["LD_PRELOAD"]
    assert "EBT_CORE_LIB" in want and \
        got.pop(engine.CORE_LIB_ENV) == _FAKE[engine.CORE_LIB_ENV]
    assert got.pop(engine.MOCK_LIB_ENV) == _FAKE[engine.MOCK_LIB_ENV]
    assert want["PYTHONPATH"] == got.pop("PYTHONPATH") == ""
    assert got == {"OMP_NUM_THREADS": "1"}
    make = open(os.path.join(REPO, "Makefile")).read()
    assert re.search(r"^torch-test-examples-dist-tsan:\n\t\$\(PYTHON\) "
                     r"tools/torch_test_tsan\.py --examples-dist$", make, re.M)


def test_examples_dist_without_runtime_prints_the_notice(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(gate, "TSAN_RT_GLOBS", ("/nonexistent/libtsan.so.*",))
    assert gate.main(["--examples-dist"]) == 0
    assert capsys.readouterr().out.strip() == gate.SKIP_NOTICE


def test_examples_dist_takes_no_files():
    with pytest.raises(SystemExit) as e:
        gate.main(["--examples-dist", "tests/test_torch_reactor.py"])
    assert e.value.code == 2


@pytest.mark.parametrize("harness_rc,reports,want", [
    (0, 0, 0), (0, 1, 66), (1, 2, 66), (1, 0, 1)])
def test_examples_dist_exit_codes(monkeypatch, capsys, harness_rc, reports,
                                  want):
    """66 on a report, else the harness's code (0 when every tier
    passed)."""
    monkeypatch.setattr(gate, "tsan_runtime", lambda: "/rt/libtsan.so.2")
    monkeypatch.setattr(gate, "environment", lambda rt: dict(_FAKE))
    monkeypatch.setattr(gate, "check_instrumented",
                        lambda env: (True, "/b/core\n/b/mock"))
    monkeypatch.setattr(gate, "run_examples_dist",
                        lambda env: (harness_rc, reports))
    assert gate.main(["--examples-dist"]) == want
    assert f"harness rc {harness_rc}, {reports} ThreadSanitizer report(s)" \
        in capsys.readouterr().out


def test_examples_dist_counts_a_wrapped_processs_logged_report(tmp_path):
    """A racy program under the wrapper's TSAN_OPTIONS writes its report to
    the log directory (not to the output a harness may discard) and
    exits 66; the tool counts it there."""
    runtime = _runtime()
    src = tmp_path / "racy.cpp"
    src.write_text(RACY)
    exe = tmp_path / "racy"
    subprocess.run([os.environ.get("CXX", "g++"), "-O1", "-g", "-pthread",
                    "-fsanitize=thread", str(src), "-o", str(exe)],
                   check=True, capture_output=True)
    logs = tmp_path / "logs"
    logs.mkdir()
    words = gate.examples_dist_wrapper(
        {**_FAKE, "LD_PRELOAD": runtime}, str(logs)).split()
    opts = dict(w.split("=", 1) for w in words[1:-3])["TSAN_OPTIONS"]
    r = subprocess.run([str(exe)], env={**os.environ, "TSAN_OPTIONS": opts},
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 66
    assert gate.REPORT not in r.stderr
    text, reports = gate.logged_reports(str(logs))
    assert reports == 1 and gate.REPORT in text


@pytest.mark.slow
def test_examples_dist_runs_clean_under_tsan():
    """python3 tools/torch_test_tsan.py --examples-dist: the dist2, dist4
    and mesh tiers pass with zero reports."""
    _runtime()
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "torch_test_tsan.py"),
                        "--examples-dist"], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert dict(re.findall(r"^TIER (\w+) (\w+) ", r.stdout, re.M)) == {
        t: "pass" for t in ("dist2", "dist4", "mesh")}
    assert "harness rc 0, 0 ThreadSanitizer report(s)" in r.stdout
