"""The native selftest of the port's CUDA engine (csrc/cuda_selftest.cpp)
on the mock driver, through its driver elbencho_tpu_torch.selftest: every
scope plain, every scope of CudaPath under ThreadSanitizer (with the mock
instrumented too), the whole selftest under AddressSanitizer with leak
detection and under UndefinedBehaviorSanitizer with
-fno-sanitize-recover=all, and a failed check reaching the exit code. The selftest is the port's
counterpart of the original's core/test/native_selftest.cpp and its make
tsan / test-asan / test-ubsan targets; its header maps every check of the
original's CudaPath-relevant hammers to the port's."""

import os
import re

import pytest

from elbencho_tpu_torch import selftest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "elbencho_tpu_torch", "csrc", "cuda_selftest.cpp")
SCOPE_LINE = re.compile(
    r"^scope (\w+): (\d+) checks passed, (\d+) failed, (\d+) need the mock",
    re.M)
SANITIZER_REPORTS = ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer",
                     "ERROR: LeakSanitizer", "runtime error:")
# the kernels scope holds the kernel library's entries against host loops:
# on the mock, whose entries are host loops, it says it needs the card
CARD_ONLY = ("kernels",)
PATH_SCOPES = tuple(s for s in selftest.SCOPES if s not in CARD_ONLY)
# ASAN and UBSAN over every scope: each build takes about 30 s of one core,
# which would carry the file past 150 s on one worker, so they run with
# the slow tests (pytest -m slow) and build on first use
WHOLE = [pytest.param(s, "all", marks=pytest.mark.slow)
         for s in ("asan", "ubsan")]
CASES = ([("none", s) for s in selftest.SCOPES] +
         [("tsan", s) for s in PATH_SCOPES] + WHOLE)


@pytest.fixture(scope="module")
def built():
    """The plain and TSAN variants and both mocks, built one after another
    under the engine's build lock: one compiler at a time keeps the load
    beside the other test files low."""
    for sanitizer in ("none", "tsan"):
        selftest.build(sanitizer)
        selftest.build_mock(sanitizer)


@pytest.mark.parametrize("sanitizer,scope", CASES, ids=lambda v: v)
def test_selftest_scope_passes(built, sanitizer, scope):
    r = selftest.run(mock=True, sanitizer=sanitizer, scope=scope,
                     timeout=240)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-4000:]
    assert "cuda selftest: all checks passed" in r.stdout, out[-4000:]
    assert "FAIL:" not in r.stderr, out[-4000:]
    for report in SANITIZER_REPORTS:
        assert report not in out, out[-4000:]
    rows = SCOPE_LINE.findall(r.stdout)
    want = list(selftest.SCOPES) if scope == "all" else [scope]
    assert [row[0] for row in rows] == want
    for name, passed, failed, need_mock in rows:
        # on the mock every check runs, and every scope but the card's
        # checks something
        assert failed == "0" and need_mock == "0", name
        assert (int(passed) == 0) == (name in CARD_ONLY), name
    assert ("needs the card: the four kernel entries" in r.stdout) == \
        (scope in ("all",) + CARD_ONLY)


def test_failed_check_reaches_the_exit_code(built):
    """EBT_MOCK_CUDA_FAIL_AT=1 set from outside fails the path's warm-up
    copy: the path scope's checks fail, each with a FAIL: line, and the
    exit code is non-zero."""
    r = selftest.run(mock=True, scope="path",
                     env={"EBT_MOCK_CUDA_FAIL_AT": "1"}, timeout=120)
    assert r.returncode != 0
    assert "FAIL: path init: warmup transfer failed" in r.stderr
    assert "cuda selftest: all checks passed" not in r.stdout
    assert re.search(r"cuda selftest: \d+ FAILURES", r.stdout)


def test_selftest_is_written_for_the_port():
    """The selftest is the port's own: built from the engine's core/src
    sources and the port's CUDA engine, never from the original's
    selftest, and it names every scope the driver offers."""
    assert not any(s.startswith("core/test") for s in selftest._SRCS)
    assert "elbencho_tpu_torch/csrc/cuda_selftest.cpp" in selftest._SRCS
    text = open(SOURCE).read()
    assert "native_selftest.cpp\"" not in text
    for scope in selftest.SCOPES:
        assert '{"%s", scope' % scope in text, scope


def test_selftest_refuses_unknown_scope_and_sanitizer():
    with pytest.raises(ValueError):
        selftest.command(mock=True, scope="bogus")
    with pytest.raises(ValueError):
        selftest.command(mock=True, sanitizer="msan")
