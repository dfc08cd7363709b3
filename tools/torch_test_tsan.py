#!/usr/bin/env python3
"""The port's pytest under ThreadSanitizer: the counterpart of the original's
`make test-tsan` (Makefile:407-417).

It builds the port's engine library (core/src plus the native CUDA engine,
elbencho_tpu_torch/csrc) and the mock CUDA driver with -fsanitize=thread
(engine.build_tsan, engine.build_tsan_mock), finds the libtsan runtime the
way the Makefile does, and runs

    python -m pytest <files> -x -q

with that runtime preloaded (LD_PRELOAD avoids libtsan's static-TLS dlopen
limit), the Makefile's TSAN_OPTIONS with the port's suppressions
(tests/torch_tsan.supp), EBT_TORCH_DEVICE=cpu and the two library overrides
(EBT_TORCH_CORE_LIB, EBT_TORCH_MOCK_LIB), so the ctypes bindings, the
Python device callbacks the engine calls from its worker threads and the
engine driven the way the CLI drives it all run instrumented.
OMP_NUM_THREADS=1: libgomp's thread team inside libtorch_cpu.so (not
instrumented) reports a race at `import torch` otherwise.

The files are the port's counterparts of the eight the Makefile lists
(FILES, in ORIGINAL_FILES order). The faults, ingest and serving files stay
out for the Makefile's reason (Makefile:418-430): one engine handle per
end-to-end test, which hits libtsan's documented loss of mutex metadata on
heap reuse (tests/tsan.supp, class 2); the native selftest covers those
ledgers under TSAN from C++ (python -m elbencho_tpu_torch.selftest --mock
--sanitizer tsan).

Before the run a child process under the same environment checks that the
engine and the mock it loads are the instrumented builds (each resolves
__tsan_init through its own CDLL handle) and the tool refuses otherwise.

    python3 tools/torch_test_tsan.py                   # all eight files
    python3 tools/torch_test_tsan.py tests/test_torch_reactor.py

Every ThreadSanitizer report is echoed and counted. Exit 0 = the files
passed with no report; otherwise pytest's exit code, or 66 when pytest
passed but a report was printed (TSAN's exitcode=66), or 2 when the
loaded libraries are not the instrumented ones. Without a libtsan runtime
it prints the Makefile's notice and exits 0.

    python3 tools/torch_test_tsan.py --examples-dist   # make torch-test-examples-dist-tsan

is the counterpart of the original's `make test-examples-dist-tsan`
(Makefile:438-443): tools/torch_test_examples.sh -b -m -t (the dist2,
dist4 and mesh tiers on the mock driver) with the benchmark processes
wrapped through EBT_TEST_EB (examples_dist_wrapper): the Makefile's
TSAN_OPTIONS with the port's suppressions, libtsan preloaded, the
instrumented engine and mock (EBT_TORCH_CORE_LIB, EBT_TORCH_MOCK_LIB; the
harness's own environment names the mock too, which its DEV_ENV takes
through engine.build_mock()), OMP_NUM_THREADS=1, PYTHONPATH cleared, then
python -m elbencho_tpu_torch.cli. TSAN_OPTIONS also carries log_path: the
services write to log files the harness removes, so every process's
reports go to files of their own, which the tool echoes and counts after
the run. Exit 66 on a report, 0 when every tier passed with none, the
harness's exit code otherwise (2 when the libraries are not the
instrumented ones; the notice and 0 without libtsan).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the original's make test-tsan files -> the port's counterparts
ORIGINAL_FILES = {
    "tests/test_engine.py": "tests/test_torch_engine.py",
    "tests/test_regressions.py": "tests/test_torch_regressions.py",
    "tests/test_pjrt_native.py": "tests/test_torch_native.py",
    "tests/test_matrix.py": "tests/test_torch_matrix.py",
    "tests/test_d2h_pipeline.py": "tests/test_torch_d2h.py",
    "tests/test_uring.py": "tests/test_torch_uring.py",
    "tests/test_load.py": "tests/test_torch_load.py",
    "tests/test_reactor.py": "tests/test_torch_reactor.py",
}
FILES = tuple(ORIGINAL_FILES.values())
SUPPRESSIONS = os.path.join(REPO, "tests", "torch_tsan.supp")
# the Makefile's TSAN_RT search (Makefile:403-406), first match wins
TSAN_RT_GLOBS = ("/usr/lib/*-linux-gnu/libtsan.so.*",
                 "/lib/*-linux-gnu/libtsan.so.*",
                 "/usr/lib64/libtsan.so.*", "/usr/lib/libtsan.so.*")
SKIP_NOTICE = "test-tsan: libtsan runtime not found - skipping"
REPORT = "WARNING: ThreadSanitizer:"
HARNESS = os.path.join(REPO, "tools", "torch_test_examples.sh")
# the Makefile's harness flags: skip the blockdev, multi-file and tooling
# tiers, so the distributed ones run
EXAMPLES_DIST_FLAGS = ("-b", "-m", "-t")

# run in a child under the gate's environment: the engine and the mock
# must be the instrumented builds (an uninstrumented library has no
# __tsan_init in its own dependency tree)
_CHECK = r"""
import ctypes, os
from elbencho_tpu_torch import engine
lib = engine.load_lib()
mock = ctypes.CDLL(engine.build_mock())
maps = open("/proc/self/maps").read()
for name, handle, path in (("engine", lib, lib._name),
                           ("mock", mock, mock._name)):
    try:
        handle.__tsan_init
    except AttributeError:
        raise SystemExit(f"{name} {path} is not instrumented "
                         "(no __tsan_init)")
    if path not in maps:
        raise SystemExit(f"{name} {path} is not mapped")
print(lib._name)
print(mock._name)
"""


def tsan_runtime() -> str | None:
    """The libtsan runtime, found as the Makefile finds it."""
    for pattern in TSAN_RT_GLOBS:
        hits = sorted(glob.glob(pattern))
        if hits:
            return hits[0]
    return None


def environment(runtime: str) -> dict[str, str]:
    """The gate's environment entries (building both instrumented
    libraries)."""
    from elbencho_tpu_torch import engine
    return {
        "TSAN_OPTIONS": "report_bugs=1 exitcode=66 detect_deadlocks=0 "
                        f"suppressions={SUPPRESSIONS}",
        "LD_PRELOAD": runtime,
        "OMP_NUM_THREADS": "1",
        "EBT_TORCH_DEVICE": "cpu",
        engine.CORE_LIB_ENV: engine.build_tsan(),
        engine.MOCK_LIB_ENV: engine.build_tsan_mock(),
    }


def check_instrumented(env: dict[str, str]) -> tuple[bool, str]:
    """Whether a child under `env` loads the instrumented engine and mock;
    its output (the two paths, or the cause)."""
    r = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                       env={**os.environ, **env}, capture_output=True,
                       text=True)
    return r.returncode == 0, (r.stdout + r.stderr).strip()


def run(files, env: dict[str, str]) -> tuple[int, int]:
    """pytest over `files` under `env`: (its exit code, the number of
    ThreadSanitizer reports printed on its standard error)."""
    p = subprocess.Popen(
        [sys.executable, "-m", "pytest", *files, "-x", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, env={**os.environ, **env}, stderr=subprocess.PIPE,
        text=True, errors="replace")
    reports = 0
    for line in p.stderr:
        sys.stderr.write(line)
        reports += REPORT in line
    return p.wait(), reports


def examples_dist_wrapper(env: dict[str, str], log_dir: str) -> str:
    """EBT_TEST_EB for the distributed tiers: Makefile:439-442's wrapper
    over the port's CLI, with the gate's libraries from `env`
    (environment()) and each process's reports logged under `log_dir`."""
    from elbencho_tpu_torch import engine
    return (f"env TSAN_OPTIONS=report_bugs=1:exitcode=66:suppressions="
            f"{SUPPRESSIONS}:log_path={os.path.join(log_dir, 'tsan')} "
            f"LD_PRELOAD={env['LD_PRELOAD']} "
            f"{engine.CORE_LIB_ENV}={env[engine.CORE_LIB_ENV]} "
            f"{engine.MOCK_LIB_ENV}={env[engine.MOCK_LIB_ENV]} "
            "OMP_NUM_THREADS=1 PYTHONPATH= python -m elbencho_tpu_torch.cli")


def examples_dist_command(env: dict[str, str],
                          log_dir: str) -> tuple[list[str], dict[str, str]]:
    """The harness's argv and the environment entries it runs with."""
    from elbencho_tpu_torch import engine
    return (["bash", HARNESS, *EXAMPLES_DIST_FLAGS],
            {"EBT_TEST_EB": examples_dist_wrapper(env, log_dir),
             engine.MOCK_LIB_ENV: env[engine.MOCK_LIB_ENV]})


def logged_reports(log_dir: str) -> tuple[str, int]:
    """What TSAN wrote under `log_dir` (one file per process that
    reported), and the number of reports in it."""
    text = "".join(open(p, errors="replace").read() for p in
                   sorted(glob.glob(os.path.join(log_dir, "tsan*"))))
    return text, sum(REPORT in line for line in text.splitlines())


def run_examples_dist(env: dict[str, str]) -> tuple[int, int]:
    """The distributed tiers under `env`'s libraries: (the harness's exit
    code, the number of ThreadSanitizer reports); the harness's output is
    passed through and every report echoed on standard error."""
    log_dir = tempfile.mkdtemp(prefix="ebt-torch-tsan-dist.")
    try:
        argv, extra = examples_dist_command(env, log_dir)
        r = subprocess.run(argv, cwd=REPO, env={**os.environ, **extra},
                           stdout=subprocess.PIPE, text=True,
                           errors="replace")
        sys.stdout.write(r.stdout)
        text, reports = logged_reports(log_dir)
        sys.stderr.write(text)
        return r.returncode, reports
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tools/torch_test_tsan.py",
        description="the port's pytest files under ThreadSanitizer")
    ap.add_argument("files", nargs="*", default=list(FILES),
                    help="test files (default: the eight of the gate)")
    ap.add_argument("--examples-dist", action="store_true",
                    help="run the examples harness's distributed tiers "
                         "(make torch-test-examples-dist-tsan) instead")
    args = ap.parse_args(argv)
    if args.examples_dist and args.files != list(FILES):
        ap.error("--examples-dist takes no test files")
    runtime = tsan_runtime()
    if runtime is None:
        print(SKIP_NOTICE)
        return 0
    env = environment(runtime)
    ok, out = check_instrumented(env)
    if not ok:
        print(f"torch test-tsan: refused: {out}", file=sys.stderr)
        return 2
    print(f"torch test-tsan: {runtime}; instrumented: "
          + ", ".join(out.splitlines()[-2:]), flush=True)
    if args.examples_dist:
        rc, reports = run_examples_dist(env)
        print(f"torch test-examples-dist-tsan: harness rc {rc}, {reports} "
              "ThreadSanitizer report(s)", flush=True)
        return 66 if reports else rc
    rc, reports = run(args.files, env)
    print(f"torch test-tsan: pytest rc {rc}, {reports} ThreadSanitizer "
          "report(s)", flush=True)
    if rc == 0 and reports:
        return 66
    return rc


if __name__ == "__main__":
    sys.exit(main())
