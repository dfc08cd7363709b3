"""What the port's comparison tests share with the original's tests in one
pytest-xdist worker, and how each of their cases starts clean of it.

Two things reach a comparison test from tests that ran before it, in its
worker or beside it (ROADMAP.md, known trap C9):

- Seam variables. The mocks of both packages read their fault seams from
  the environment (EBT_MOCK_*). The original's
  tests/test_faults.py::test_chaos_flag_arms_env_at_prepare lets --chaos
  arm EBT_MOCK_STRIPE_FAIL_AT=0:2 through os.environ and hands it to
  monkeypatch only after the fact, so its teardown puts the variable back:
  it stays set in that worker until
  tests/test_faults.py::test_bench_faults_leg_on_mock pops it, and every
  test between fails the second copy to device 0 on the original's mock.
- The original's libraries. Its tests and its engine.load_lib() run
  `make core` when a library is missing, and the Makefile links in place,
  so another worker can find elbencho_tpu/libebtpjrtmock.so or
  libebtcore.so half written ("invalid ELF header").

Every comparison file imports the autouse fixture worker_state: each of
its tests starts with both libraries built and whole (original_libs(),
which builds them once, under a file lock, into a temporary directory and
renames them into place) and with no EBT_MOCK_* variable set (monkeypatch
puts a leaked value back after the test, so the original's own tests see
what they saw before).
"""

from __future__ import annotations

import fcntl
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAKING_TEST = "tests/test_faults.py::test_chaos_flag_arms_env_at_prepare"
# the Makefile's CORE_LIB and MOCK_LIB (make core)
ORIGINAL_LIBS = {"CORE_LIB": os.path.join("elbencho_tpu", "libebtcore.so"),
                 "MOCK_LIB": os.path.join("elbencho_tpu", "libebtpjrtmock.so")}
WRITER_WAIT_S = 300


def elf_complete(path: str) -> bool:
    """`path` is a whole 64-bit ELF file: its header is there and its
    section header table, which the linker writes last, lies inside it."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
        size = os.path.getsize(path)
    except OSError:
        return False
    if len(head) < 64 or head[:5] != b"\x7fELF\x02":
        return False
    shoff, = struct.unpack_from("<Q", head, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
    return shoff > 0 and shoff + shentsize * shnum <= size


def original_libs(root: str = REPO) -> str:
    """The original's engine library and mock PJRT plugin under `root`,
    built once by `make core` under a file lock into a temporary directory
    and renamed into place, so no reader finds one half written. A library
    that an unlocked `make core` (the original's tests, its load_lib) is
    writing is waited for. Returns the mock plugin's path."""
    paths = {var: os.path.join(root, rel) for var, rel in ORIGINAL_LIBS.items()}
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "original_libs.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + WRITER_WAIT_S
        while any(os.path.exists(p) and not elf_complete(p)
                  for p in paths.values()):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{sorted(paths.values())}: still being "
                                   f"written after {WRITER_WAIT_S} s")
            time.sleep(0.2)
        if not all(os.path.exists(p) for p in paths.values()):
            tmp = tempfile.mkdtemp(dir=build)
            try:
                out = {var: os.path.join(tmp, os.path.basename(p))
                       for var, p in paths.items()}
                subprocess.run(["make", "core"] + [
                    f"{var}={p}" for var, p in out.items()], cwd=root,
                    check=True, capture_output=True)
                for var, p in paths.items():
                    if not os.path.exists(p):
                        os.replace(out[var], p)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return paths["MOCK_LIB"]


@pytest.fixture(autouse=True)
def worker_state(monkeypatch):
    """The original's libraries whole, and no mock seam variable set."""
    original_libs()
    for k in [k for k in os.environ if k.startswith("EBT_MOCK_")]:
        monkeypatch.delenv(k)


def test_comparisons_pass_after_the_leaking_test():
    """The leaking test, then the io_uring and transfer-manager comparison
    files, in one process: every comparison passes (without worker_state,
    nine failed on the original's side)."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", LEAKING_TEST,
         "tests/test_torch_uring.py", "tests/test_torch_xfer_mgr.py",
         "-q", "-m", "not slow", "-p", "no:xdist", "-p", "no:cacheprovider",
         "-p", "no:randomly"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert " failed" not in r.stdout


def test_a_half_written_library_is_waited_for(tmp_path):
    """A library another process is linking in place is not handed out
    until it is whole (on the parent, the fixtures loaded it as soon as it
    existed)."""
    root = tmp_path
    whole = {var: open(os.path.join(REPO, rel), "rb").read()
             for var, rel in ORIGINAL_LIBS.items()}
    for var, rel in ORIGINAL_LIBS.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(whole[var])
    mock = root / ORIGINAL_LIBS["MOCK_LIB"]
    mock.write_bytes(whole["MOCK_LIB"][:len(whole["MOCK_LIB"]) // 2])
    assert not elf_complete(str(mock))
    finish = threading.Timer(0.5, mock.write_bytes,
                             args=(whole["MOCK_LIB"],))
    finish.start()
    try:
        t0 = time.monotonic()
        assert original_libs(str(root)) == str(mock)
        assert time.monotonic() - t0 >= 0.4
    finally:
        finish.join()
    assert elf_complete(str(mock))
    assert mock.read_bytes() == whole["MOCK_LIB"]


def test_a_missing_library_is_built_aside_and_renamed(tmp_path, monkeypatch):
    """make core writes into a temporary directory; only whole files are
    renamed into the package, and a library already there is kept."""
    root = tmp_path
    core = root / ORIGINAL_LIBS["CORE_LIB"]
    core.parent.mkdir(parents=True)
    core.write_bytes(open(os.path.join(REPO, ORIGINAL_LIBS["CORE_LIB"]),
                          "rb").read())
    calls = []

    def make(argv, cwd, check, capture_output):
        calls.append(argv)
        for arg in argv[2:]:
            var, path = arg.split("=", 1)
            assert os.path.dirname(path) != str(core.parent), argv
            shutil.copy(os.path.join(REPO, ORIGINAL_LIBS[var]), path)
    monkeypatch.setattr(subprocess, "run", make)
    got = original_libs(str(root))
    assert got == str(root / ORIGINAL_LIBS["MOCK_LIB"])
    assert len(calls) == 1 and calls[0][:2] == ["make", "core"]
    assert all(elf_complete(str(root / rel)) for rel in ORIGINAL_LIBS.values())
    # nothing left behind in build/ but the lock
    assert sorted(os.listdir(root / "build")) == ["original_libs.lock"]
    assert original_libs(str(root)) == got and len(calls) == 1
