"""The config-interaction matrix of the original (tests/test_matrix.py)
held against the port: the same parameter grid, under the same ids,
through both packages' native engines (see test_torch_engine.py for the
harness), each in a directory of its own.

Each combination must complete cleanly in both with exact byte
accounting, and both must agree on every phase's status, the bytes and
ops each worker counted (rwmix reads included), the bytes left on storage
and the error text.

Held by invariants, not by equality, in both packages:
- with rwmix on an async loop (iodepth 8: aio or io_uring), whether an op
  is a read or a write follows how many ops have completed when it is
  submitted (Engine::rwmixPickRead reads the live counters), so each
  worker's read/write split, and with it the bytes left on storage,
  follows the completions' timing: each worker's reads plus writes are
  compared exactly, and each worker mixes some reads in;
- the order of the device callback's calls in the multi-path deferred
  case follows when the worker's copies complete: both must keep the
  buffer pool's rotation (a barrier rarely waits on the transfer submitted
  just before it) and make the same number of submits.

Every case of tests/test_matrix.py has a counterpart here under the same
name and ids.
"""

from __future__ import annotations

import os
import shutil

import pytest

from test_torch_engine import (digest, make_engine, ops_tuple,  # noqa: F401
                               pkgs, same)
from test_torch_worker_state import worker_state  # noqa: F401

FILE_SIZE = 1 << 19  # 512 KiB
BLOCK = 1 << 14      # 16 KiB

MATRIX = [
    # (iodepth, use_io_uring, random, verify_salt, rwmix_pct, dev_backend,
    #  block_variance_pct)
    (1, 0, 0, 0, 0, 0, 0),
    (1, 0, 0, 7, 0, 0, 0),
    (1, 0, 1, 0, 0, 0, 0),
    (1, 0, 0, 0, 30, 0, 0),
    (1, 0, 0, 7, 0, 1, 0),
    (8, 0, 0, 0, 0, 0, 0),
    (8, 0, 1, 0, 0, 0, 0),
    (8, 0, 0, 7, 0, 0, 0),
    (8, 0, 0, 0, 30, 0, 0),
    (8, 0, 1, 7, 0, 1, 0),
    (8, 1, 0, 0, 0, 0, 0),
    (8, 1, 1, 0, 0, 0, 0),
    (8, 1, 0, 7, 0, 0, 0),
    (8, 1, 0, 0, 30, 0, 0),
    (8, 1, 1, 7, 0, 1, 0),
    # --blockvarpct through the device write path: the refill -> device
    # round trip (direction 3 then 1) across the sync, AIO and io_uring
    # loops
    (1, 0, 0, 0, 0, 1, 100),
    (8, 0, 0, 0, 0, 1, 100),
    (8, 1, 0, 0, 0, 1, 100),
    (8, 0, 1, 0, 30, 1, 50),
]


def run_phase(pkg, e, phase: str, timeout_s: float = 30.0) -> int:
    e.start_phase(int(getattr(pkg.Phase, phase)))
    waited = 0.0
    while True:
        st = e.wait_done(500)
        if st:
            return st
        waited += 0.5
        assert waited < timeout_s, f"{pkg.name}: phase {phase} timed out"


def worker_ops(e) -> list[tuple[int, ...]]:
    return [ops_tuple(e.live(i).ops) for i in range(e.num_workers)]


def uring_ok(pkgs) -> bool:
    return all(p.engine.load_lib().ebt_uring_supported() for p in pkgs)


def build_engine(pkg, path, iodepth, uring, random_, salt, rwmix, dev,
                 blockvar=0):
    kw = dict(path_type=1, num_threads=2, num_dataset_threads=2,
              block_size=BLOCK, file_size=FILE_SIZE, do_trunc_to_size=1,
              iodepth=iodepth, use_io_uring=uring, rwmix_pct=rwmix)
    if random_:
        kw.update(random_offsets=1, rand_aligned=1, rand_amount=FILE_SIZE)
    if salt:
        kw.update(verify_enabled=1, verify_salt=salt)
    if dev:
        kw.update(dev_backend=dev, num_devices=1, dev_write_path=1)
    if blockvar:
        kw.update(block_variance_pct=blockvar)
    return make_engine(pkg, [path], **kw)


@pytest.mark.parametrize(
    "iodepth,uring,random_,salt,rwmix,dev,blockvar", MATRIX,
    ids=[f"d{d}-u{u}-r{r}-v{v}-m{m}-b{b}-bv{bv}"
         for d, u, r, v, m, b, bv in MATRIX])
def test_file_mode_combo(pkgs, tmp_path, iodepth, uring, random_, salt,
                         rwmix, dev, blockvar):
    if uring and not uring_ok(pkgs):
        pytest.skip("kernel/seccomp without io_uring")

    def sc(pkg, d):
        path = d / "f"
        if random_ and salt:
            # random writes sample offsets with replacement, so a verified
            # random read needs a sequential verified write first
            pre = build_engine(pkg, path, iodepth, uring, 0, salt, 0, dev)
            try:
                pre.prepare_paths()
                pre.prepare()
                assert run_phase(pkg, pre, "CREATEFILES") == 1, pre.error()
            finally:
                pre.close()
        e = build_engine(pkg, path, iodepth, uring, random_, salt, rwmix,
                         dev, blockvar)
        out = []
        try:
            e.prepare_paths()
            e.prepare()
            if not (random_ and salt):
                st = run_phase(pkg, e, "CREATEFILES")
                ops = worker_ops(e)
                if rwmix and iodepth > 1:
                    # which op becomes a read follows the completions seen
                    # at submit time: held by the sums of reads and writes
                    assert all(o[4] > 0 for o in ops), (pkg.name, ops)
                    ops = [(o[0], o[1] + o[3], o[2] + o[4]) for o in ops]
                out.append((st, ops))
            written = None if rwmix and iodepth > 1 else digest(path)
            out.append((run_phase(pkg, e, "READFILES"), worker_ops(e)))
            out.append((run_phase(pkg, e, "DELETEFILES"), e.error()))
            return out, written, path.exists()
        finally:
            e.close()
    out, _, exists = same(pkgs, tmp_path, sc)
    assert all(st == 1 for st, _ in out), out
    if not (random_ and salt):
        # write bytes plus rwmix-interleaved read bytes cover the dataset
        w = out.pop(0)[1]
        assert sum(o[1] + (o[3] if len(o) > 3 else 0) for o in w) == \
            FILE_SIZE
    assert sum(o[1] for o in out[0][1]) == FILE_SIZE
    assert not exists


@pytest.mark.parametrize("iodepth,uring", [(1, 0), (8, 0), (8, 1)])
def test_dir_mode_combo(pkgs, tmp_path, iodepth, uring):
    """Dir-mode trees drive the same block loops per file. One io_setup
    per file draws from the machine-wide aio-max-nr pool, which a loaded
    test host can refuse transiently: one retry on a fresh engine, in
    either package, as the original does."""
    if uring and not uring_ok(pkgs):
        pytest.skip("kernel/seccomp without io_uring")

    def attempt(pkg, d):
        e = make_engine(pkg, [d], path_type=0, num_threads=2,
                        num_dataset_threads=2, num_dirs=2, num_files=4,
                        block_size=4096, file_size=16384, iodepth=iodepth,
                        use_io_uring=uring, verify_enabled=1,
                        verify_salt=99)
        try:
            e.prepare()
            out = [run_phase(pkg, e, ph)
                   for ph in ("CREATEDIRS", "CREATEFILES")]
            wrote = sum(o[1] for o in worker_ops(e))
            files = sorted(os.path.relpath(os.path.join(r, f), d)
                           for r, _, fs in os.walk(d) for f in fs)
            out += [run_phase(pkg, e, ph)
                    for ph in ("READFILES", "DELETEFILES", "DELETEDIRS")]
            return out, wrote, files, e.error()
        finally:
            e.close()

    def sc(pkg, d):
        got = attempt(pkg, d)
        if "io_setup failed" in got[3]:
            print(f"dir_mode_combo ({pkg.name}): io_setup refused, "
                  f"retrying once (cause: {got[3]})")
            for sub in d.iterdir():  # a fresh tree for the retry
                shutil.rmtree(sub, ignore_errors=True)
            got = attempt(pkg, d)
        return got
    sts, wrote, files, err = same(pkgs, tmp_path, sc)
    assert sts == [1] * 5, err
    # 2 ranks x 2 dirs x 4 files x 16 KiB
    assert wrote == 2 * 2 * 4 * 16384 and len(files) == 16


def test_sync_random_multipath_device_overlap(pkgs, tmp_path):
    """sync + random + multi-path + deferred device transfers: the fd
    round-robin threads through one hot-loop invocation, so the buffer
    pool's rotation survives across blocks and a barrier rarely waits on
    the transfer submitted just before it (reference: one hot loop over
    round-robin FDs, LocalWorker.cpp:1586-1624)."""
    data = [os.urandom(FILE_SIZE) for _ in range(2)]

    def sc(pkg, d):
        events = []  # (direction, buf_ptr) in engine call order
        paths = []
        for name, blob in zip(("f1", "f2"), data):
            (d / name).write_bytes(blob)
            paths.append(d / name)

        def cb(rank, dev_idx, direction, buf, length, off):
            events.append((direction, buf))
            return 0

        e = make_engine(pkg, paths, path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=BLOCK,
                        file_size=FILE_SIZE, iodepth=1, random_offsets=1,
                        rand_aligned=1, rand_amount=FILE_SIZE,
                        dev_backend=2, dev_deferred=1, num_devices=1)
        try:
            e.set_dev_callback(cb)
            e.prepare()
            st = run_phase(pkg, e, "READFILES")
        finally:
            e.close()
        # pair every barrier with the submit before it on the same buffer
        # and count the submits on other buffers in between
        last_submit = {}
        matched = violations = 0
        for i, (direction, buf) in enumerate(events):
            if direction == 0:
                last_submit[buf] = i
            elif direction == 2 and buf in last_submit:
                matched += 1
                between = sum(1 for dd, b in events[last_submit[buf] + 1:i]
                              if dd == 0 and b != buf)
                violations += between == 0
        # end-of-phase drain barriers may sit next to the final submits
        assert matched >= 8, (pkg.name, matched)
        assert violations <= 2, (pkg.name, violations, matched)
        bufs = {b for _, b in events}
        return st, sorted(sum(1 for dd, b in events if b == x and dd == 0)
                          for x in bufs), \
            sum(1 for dd, _ in events if dd == 0)
    st, per_buffer, submits = same(pkgs, tmp_path, sc)
    assert st == 1 and submits == FILE_SIZE // BLOCK
