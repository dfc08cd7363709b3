"""The native selftest of the port's CUDA engine, built and run under a
sanitizer: the port's counterpart of the original package's native selftest
and its make tsan / test-asan / test-ubsan targets.

    python -m elbencho_tpu_torch.selftest [--mock]
        [--sanitizer none|tsan|asan|ubsan] [--scope S]

csrc/cuda_selftest.cpp is compiled with the engine's compiler and include
flags at -O1 -g, with the sanitizer's -fsanitize= (UBSAN adds
-fno-sanitize-recover=all, so the first report fails the run), together
with the core/src sources the storage engine needs and csrc/cuda_api.cpp
and csrc/cuda_path.cpp, into build/torch_core/cuda_selftest[_SAN]. Under
TSAN the mock driver is built instrumented as well
(build/torch_core/libebtcudamock_tsan.so), so races inside it are seen.
The runtime options are the Makefile's: TSAN_OPTIONS="report_bugs=1
exitcode=66" and ASAN_OPTIONS=detect_leaks=1.

--mock runs against the mock driver, whose own kernel entries serve as the
kernel library for the paths' verify and fill (the kernels scope needs the
card). Without it the selftest runs on the card, against
libcuda.so.1 and the nvcc-built kernel library, and refuses without one
("no CUDA device found"). The exit code is the selftest's: 0 when every
check passed ("cuda selftest: all checks passed"), non-zero on a failed
check ("FAIL: ..." lines on stderr) or a sanitizer report.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from . import engine

SCOPES = ("path", "regwindow", "d2h", "lanes", "stripe", "ckpt", "serving",
          "reshard", "ingest", "faults", "reactor", "xfermgr", "kernels")
SANITIZERS = {
    "none": (),
    "tsan": ("-fsanitize=thread",),
    "asan": ("-fsanitize=address",),
    "ubsan": ("-fsanitize=undefined", "-fno-sanitize-recover=all"),
}
RUNTIME_ENV = {
    "tsan": {"TSAN_OPTIONS": "report_bugs=1 exitcode=66"},
    "asan": {"ASAN_OPTIONS": "detect_leaks=1"},
}
CARD_DRIVER = "libcuda.so.1"
_SRCS = tuple(f"core/src/{s}.cpp" for s in (
    "engine", "uring", "reactor", "numa")) + tuple(
    f"elbencho_tpu_torch/csrc/{s}.cpp" for s in (
        "cuda_api", "cuda_path", "span_log", "cuda_selftest"))
_CXXFLAGS = ("-O1", "-g", "-std=c++17", "-Wall", "-Wextra", "-pthread")


def _suffix(sanitizer: str) -> str:
    return "" if sanitizer == "none" else f"_{sanitizer}"


def build(sanitizer: str = "none") -> str:
    """The selftest executable for `sanitizer` (built on first use);
    returns its path."""
    san = SANITIZERS[sanitizer]
    out = os.path.join(engine._BUILD_DIR, f"cuda_selftest{_suffix(sanitizer)}")
    return engine._built(out, _SRCS, ("-pthread", "-ldl", *san),
                         cxxflags=(*_CXXFLAGS, *san))


def build_mock(sanitizer: str = "none") -> str:
    """The mock driver the selftest loads: the plain one, or under TSAN an
    instrumented copy."""
    if sanitizer != "tsan":
        return engine.build_mock()
    return engine.build_tsan_mock()


def command(mock: bool, sanitizer: str = "none",
            scope: str = "all") -> tuple[list[str], dict[str, str]]:
    """The selftest's argv and the environment entries it runs with
    (building what it needs). On the card: libcuda.so.1 and the kernel
    library, built with nvcc; refused without a CUDA device."""
    if sanitizer not in SANITIZERS:
        raise ValueError(f"unknown sanitizer {sanitizer!r}")
    if scope != "all" and scope not in SCOPES:
        raise ValueError(f"unknown scope {scope!r}")
    if mock:
        driver = kernels = build_mock(sanitizer)
    else:
        from .cuda.devices import resolve_devices
        from .ops import kernel_build
        resolve_devices([], device="cuda")
        driver, kernels = CARD_DRIVER, kernel_build.library()
    return [build(sanitizer), driver, kernels, scope], \
        dict(RUNTIME_ENV.get(sanitizer, {}))


def run(mock: bool, sanitizer: str = "none", scope: str = "all",
        env: dict[str, str] | None = None, timeout: float | None = None,
        capture: bool = True) -> subprocess.CompletedProcess:
    """Build and run the selftest at a low priority, so its hammer threads
    do not disturb work beside it (as the builds do not); its output is
    captured as text unless `capture` is false."""
    argv, extra = command(mock, sanitizer, scope)
    full = {**os.environ, **extra, **(env or {})}
    return subprocess.run(["nice", "-n", "10", *argv], env=full,
                          capture_output=capture, text=True, timeout=timeout)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m elbencho_tpu_torch.selftest",
        description="Build and run the native selftest of the port's CUDA "
                    "engine under a sanitizer.")
    ap.add_argument("--mock", action="store_true",
                    help="run against the mock CUDA driver (on the CPU)")
    ap.add_argument("--sanitizer", choices=tuple(SANITIZERS), default="none")
    ap.add_argument("--scope", choices=("all",) + SCOPES, default="all")
    args = ap.parse_args(argv)
    from .exceptions import ProgException
    try:
        return run(args.mock, args.sanitizer, args.scope,
                   capture=False).returncode
    except ProgException as e:
        print(f"selftest: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
