"""The port's native storage engine (elbencho_tpu_torch.engine.NativeEngine,
built by the port into build/torch_core/libebtcore.so) against the
original's (elbencho_tpu/libebtcore.so), on the same inputs: the
counterparts of tests/test_engine.py.

Each case runs one scenario in both packages, each in a directory of its
own with the same arguments and the same seeded files, and compares what
both must agree on: bytes and ops counted per worker and in total, bytes
on storage, the directory layout, the callback's byte tallies, phase
status codes and error texts. The original's own assertions are then held
on both.

Held by invariants, not by equality (both follow the clock or the
scheduler, in either package):
- the bytes an interrupted or time-limited phase got through before it
  stopped (below the file size, in both);
- the stonewall time of each worker (present and positive, in both);
- the read share of an rwmix phase (its reads and writes add up to the
  block count exactly; the share is within 15% of 30%, in both);
- the order of device-callback calls of the mmap and deferred paths
  (no pointer in flight twice, in both).

Every case of tests/test_engine.py has a counterpart here under the same
name; none is left out.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import time
from types import SimpleNamespace

import pytest

import elbencho_tpu.common as jax_common
import elbencho_tpu.engine as jax_engine
import elbencho_tpu.liveops as jax_liveops
import elbencho_tpu_torch.common as torch_common
import elbencho_tpu_torch.engine as torch_engine
import elbencho_tpu_torch.liveops as torch_liveops
from test_torch_worker_state import worker_state  # noqa: F401


def _pkg(name, engine, common, liveops) -> SimpleNamespace:
    return SimpleNamespace(name=name, engine=engine,
                           NativeEngine=engine.NativeEngine,
                           EngineError=engine.EngineError,
                           Phase=common.BenchPhase,
                           PathType=common.BenchPathType,
                           LiveOps=liveops.LiveOps)


JAX = _pkg("jax", jax_engine, jax_common, jax_liveops)
TORCH = _pkg("torch", torch_engine, torch_common, torch_liveops)


@pytest.fixture
def pkgs():
    """(original, port): each package's engine binding and enums."""
    return JAX, TORCH


def make_engine(pkg, paths, **kw):
    e = pkg.NativeEngine()
    for p in paths:
        e.add_path(str(p))
    for k, v in kw.items():
        e.set(k, v)
    return e


def run_phase(pkg, e, phase: str, timeout_s: float = 60.0) -> int:
    """Run phase `phase` (a BenchPhase name) to its end; its status."""
    e.start_phase(int(getattr(pkg.Phase, phase)))
    waited = 0.0
    while True:
        st = e.wait_done(500)
        if st:
            return st
        waited += 0.5
        assert waited < timeout_s, f"{pkg.name}: phase {phase} timed out"


def total_ops(pkg, e):
    tot = pkg.LiveOps()
    for i in range(e.num_workers):
        tot += e.live(i).ops
    return tot


def ops_tuple(ops) -> tuple[int, ...]:
    return (ops.entries, ops.bytes, ops.iops, ops.read_bytes, ops.read_iops)


def digest(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def same(pkgs, base, scenario):
    """Run `scenario(pkg, dir)` for each package in a directory of its own
    under `base`; the outcome, after checking the port's equals the
    original's."""
    outs = []
    for pkg in pkgs:
        d = base / pkg.name
        d.mkdir(exist_ok=True)
        outs.append(scenario(pkg, d))
    assert outs[1] == outs[0]
    return outs[0]


# ---------------------------------------------------------------- file mode


def test_seq_write_read_totals(pkgs, bench_dir):
    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=1 << 16,
                        file_size=1 << 22, do_trunc_to_size=1)
        try:
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES"), ops_tuple(total_ops(pkg, e))
            size = os.path.getsize(path)
            r = run_phase(pkg, e, "READFILES"), ops_tuple(total_ops(pkg, e))
            return w, size, digest(path), r, e.error()
        finally:
            e.close()
    w, size, _, r, err = same(pkgs, bench_dir, sc)
    assert w[0] == 1 and r[0] == 1, err
    assert w[1][1] == r[1][1] == size == 1 << 22


def test_seq_partitioning_remainder(pkgs, bench_dir):
    """13 blocks over 4 dataset threads: ranks get 3,3,3,4."""
    bs = 1 << 16

    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=4,
                        num_dataset_threads=4, block_size=bs,
                        file_size=13 * bs, do_trunc_to_size=1)
        try:
            e.prepare_paths()
            e.prepare()
            st = run_phase(pkg, e, "CREATEFILES")
            return st, [e.live(i).ops.bytes for i in range(4)]
        finally:
            e.close()
    st, per_worker = same(pkgs, bench_dir, sc)
    assert st == 1
    assert per_worker == [3 * bs, 3 * bs, 3 * bs, 4 * bs]


def test_random_aligned_amount(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=4096,
                        file_size=1 << 20, do_trunc_to_size=1,
                        random_offsets=1, rand_aligned=1,
                        rand_amount=1 << 20)
        try:
            e.prepare_paths()
            e.prepare()
            st = run_phase(pkg, e, "CREATEFILES")
            return st, [ops_tuple(e.live(i).ops) for i in range(2)]
        finally:
            e.close()
    st, per_worker = same(pkgs, bench_dir, sc)
    assert st == 1
    # each rank does rand_amount / ndt bytes
    assert [w[1] for w in per_worker] == [(1 << 20) // 2] * 2


def test_multifile_seq(pkgs, bench_dir):
    bs = 1 << 16

    def sc(pkg, d):
        paths = [d / f"f{i}" for i in range(3)]
        e = make_engine(pkg, paths, path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=bs,
                        file_size=4 * bs, do_trunc_to_size=1)
        try:
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES")
            wrote = total_ops(pkg, e).bytes
            sizes = [os.path.getsize(p) for p in paths]
            dl = run_phase(pkg, e, "DELETEFILES")
            return w, wrote, sizes, dl, [p.exists() for p in paths]
        finally:
            e.close()
    w, wrote, sizes, dl, exist = same(pkgs, bench_dir, sc)
    assert (w, dl) == (1, 1)
    assert wrote == 3 * 4 * bs and sizes == [4 * bs] * 3
    assert exist == [False] * 3


def test_aio_matches_sync_bytes(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 21, do_trunc_to_size=1, iodepth=8)
        try:
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES"), total_ops(pkg, e).bytes
            r = run_phase(pkg, e, "READFILES"), total_ops(pkg, e).bytes
            return w, r, e.histogram(0, 0).count, digest(d / "f")
        finally:
            e.close()
    w, r, count, _ = same(pkgs, bench_dir, sc)
    assert w == r == (1, 1 << 21)
    assert count == (1 << 21) // (1 << 16)


def test_verify_roundtrip_and_corruption(pkgs, bench_dir):
    kw = dict(path_type=1, num_threads=1, num_dataset_threads=1,
              block_size=4096, file_size=1 << 16, do_trunc_to_size=1,
              verify_enabled=1, verify_salt=4242)

    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], **kw)
        e.prepare_paths()
        e.prepare()
        clean = run_phase(pkg, e, "CREATEFILES"), run_phase(pkg, e,
                                                            "READFILES")
        e.close()
        written = digest(path)
        # corrupt a byte in the middle -> read must fail with the offset
        with open(path, "r+b") as f:
            f.seek(10000)
            b = f.read(1)
            f.seek(10000)
            f.write(bytes([b[0] ^ 0xFF]))
        e = make_engine(pkg, [path], **kw)
        try:
            e.prepare()
            return clean, written, run_phase(pkg, e, "READFILES"), e.error()
        finally:
            e.close()
    clean, _, st, err = same(pkgs, bench_dir, sc)
    assert clean == (1, 1)
    assert st == 2 and "verification failed" in err and "10000" in err


# ----------------------------------------------------------------- dir mode


def _tree(d) -> list[str]:
    return sorted(os.path.relpath(os.path.join(r, n), d)
                  for r, dirs, files in os.walk(d) for n in dirs + files)


def test_full_cycle_counts(pkgs, bench_dir):
    phases = ("STATFILES", "READFILES", "DELETEFILES", "DELETEDIRS")

    def sc(pkg, d):
        e = make_engine(pkg, [d], path_type=0, num_threads=3,
                        num_dataset_threads=3, block_size=4096,
                        file_size=8192, num_dirs=2, num_files=5)
        try:
            e.prepare()
            out = [(run_phase(pkg, e, "CREATEDIRS"),
                    ops_tuple(total_ops(pkg, e)))]
            out.append((run_phase(pkg, e, "CREATEFILES"),
                        ops_tuple(total_ops(pkg, e))))
            tree = _tree(d)
            out += [(run_phase(pkg, e, ph), ops_tuple(total_ops(pkg, e)))
                    for ph in phases]
            return out, tree, _tree(d)
        finally:
            e.close()
    out, tree, after = same(pkgs, bench_dir, sc)
    assert [st for st, _ in out] == [1] * 6
    assert out[0][1][0] == 3 * 2
    assert out[1][1][:2] == (3 * 2 * 5, 3 * 2 * 5 * 8192)
    # layout parity: r<rank>/d<dir>/r<rank>-f<file>
    assert "r0/d0/r0-f0" in tree and "r2/d1/r2-f4" in tree
    assert after == []


def test_shared_dirs(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d], path_type=0, num_threads=2,
                        num_dataset_threads=2, block_size=4096,
                        file_size=4096, num_dirs=2, num_files=3,
                        dirs_shared=1)
        try:
            e.prepare()
            sts = [run_phase(pkg, e, ph)
                   for ph in ("CREATEDIRS", "CREATEFILES")]
            tree = _tree(d)
            sts += [run_phase(pkg, e, ph)
                    for ph in ("DELETEFILES", "DELETEDIRS")]
            return sts, tree
        finally:
            e.close()
    sts, tree = same(pkgs, bench_dir, sc)
    assert sts == [1] * 4
    assert "d0/r0-f0" in tree and "d1/r1-f2" in tree


def test_rank_offset_namespaces(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d], path_type=0, num_threads=2,
                        num_dataset_threads=4, rank_offset=2,
                        block_size=4096, file_size=4096, num_dirs=1,
                        num_files=1)
        try:
            e.prepare()
            return [run_phase(pkg, e, ph)
                    for ph in ("CREATEDIRS", "CREATEFILES")], _tree(d)
        finally:
            e.close()
    sts, tree = same(pkgs, bench_dir, sc)
    assert sts == [1, 1]
    assert tree == ["r2", "r2/d0", "r2/d0/r2-f0", "r3", "r3/d0",
                    "r3/d0/r3-f0"]


# ------------------------------------------------------------------ control


def test_error_propagation_bad_path(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "nonexistent" / "f"], path_type=1,
                        num_threads=2, num_dataset_threads=2,
                        block_size=4096, file_size=8192)
        try:
            with pytest.raises(pkg.EngineError) as exc:
                e.prepare_paths()
            return str(exc.value).replace(str(d), "<dir>")
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc)


def test_read_missing_file_fails(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "gone"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=4096,
                        file_size=8192)
        try:
            e.prepare()
            return run_phase(pkg, e, "READFILES"), \
                e.error().replace(str(d), "<dir>")
        finally:
            e.close()
    st, err = same(pkgs, bench_dir, sc)
    assert st == 2 and "open" in err


def test_stonewall_snapshot(pkgs, bench_dir):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=1 << 16,
                        file_size=1 << 22, do_trunc_to_size=1)
        try:
            e.prepare_paths()
            e.prepare()
            st = run_phase(pkg, e, "CREATEFILES")
            rs = [e.result(i) for i in range(2)]
            # the stonewall time follows the clock: held by invariant
            assert all(r.stonewall_us > 0 for r in rs), pkg.name
            return st, [r.have_stonewall for r in rs], \
                ops_tuple(total_ops(pkg, e))
        finally:
            e.close()
    st, have, _ = same(pkgs, bench_dir, sc)
    assert st == 1 and have == [True, True]


def _interrupted(pkg, d, **extra):
    """A 1 GiB write stopped early (by interrupt(), or by a time limit
    when `extra` sets one): status, error, time-limit flag and whether it
    stopped short."""
    e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                    num_dataset_threads=1, block_size=4096,
                    file_size=1 << 30, do_trunc_to_size=1)
    try:
        for k, v in extra.items():
            e.set_float(k, v)
        e.prepare_paths()
        e.prepare()
        e.start_phase(int(pkg.Phase.CREATEFILES))
        if not extra:
            time.sleep(0.05)
            e.interrupt()
        waited = 0
        while True:
            st = e.wait_done(500)
            if st:
                break
            waited += 1
            assert waited < 60
        # the bytes it got through follow the clock: held by invariant
        return st, e.error(), e.time_limit_hit(), \
            total_ops(pkg, e).bytes < 1 << 30
    finally:
        e.close()


def test_interrupt_stops_phase(pkgs, bench_dir):
    # a cooperative interrupt is not a worker error: the worker finishes
    # cleanly with partial results (reference: LocalWorker.cpp:139-151)
    assert same(pkgs, bench_dir, _interrupted) == (1, "", False, True)


def test_time_limit(pkgs, bench_dir):
    # the user-defined limit ends the phase cleanly with partial results
    # (reference: Coordinator.cpp:77-82)
    assert same(pkgs, bench_dir, lambda pkg, d: _interrupted(
        pkg, d, time_limit_secs=0.2)) == (1, "", True, True)


def test_hostsim_device_path(pkgs, bench_dir):
    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=1 << 16,
                        file_size=1 << 20, do_trunc_to_size=1,
                        dev_backend=1, num_devices=2, dev_write_path=1)
        try:
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES")
            r = run_phase(pkg, e, "READFILES")
            return w, r, ops_tuple(total_ops(pkg, e)), digest(path)
        finally:
            e.close()
    w, r, ops, _ = same(pkgs, bench_dir, sc)
    assert (w, r) == (1, 1) and ops[1] == 1 << 20


def test_callback_device_path(pkgs, bench_dir):
    def sc(pkg, d):
        seen = {"h2d": 0, "d2h": 0}

        def cb(rank, dev_idx, direction, buf, length, off):
            seen["h2d" if direction == 0 else "d2h"] += length
            return 0

        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 19, do_trunc_to_size=1,
                        dev_backend=2, num_devices=1, dev_write_path=1)
        try:
            e.set_dev_callback(cb)
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES"), dict(seen)
            return w, run_phase(pkg, e, "READFILES"), dict(seen)
        finally:
            e.close()
    w, r, seen = same(pkgs, bench_dir, sc)
    assert w == (1, {"h2d": 0, "d2h": 1 << 19})
    assert r == 1 and seen["h2d"] == 1 << 19


def _failing_callback(pkg, d, fail, **extra):
    e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                    num_dataset_threads=1, block_size=1 << 16,
                    file_size=1 << 18, do_trunc_to_size=1, dev_backend=2,
                    num_devices=1, **extra)
    try:
        e.set_dev_callback(fail)
        e.prepare_paths()
        e.prepare()
        return run_phase(pkg, e, "READFILES"), \
            e.error().replace(str(d), "<dir>")
    finally:
        e.close()


def test_callback_error_fails_phase(pkgs, bench_dir):
    # fail real copies but not the pre-reuse barrier (direction 2)
    st, err = same(pkgs, bench_dir, lambda pkg, d: _failing_callback(
        pkg, d, lambda rank, dev, direction, *a: 1 if direction != 2
        else 0))
    assert st == 2 and "device copy failed" in err


def test_barrier_error_fails_phase(pkgs, bench_dir):
    st, err = same(pkgs, bench_dir, lambda pkg, d: _failing_callback(
        pkg, d, lambda rank, dev, direction, *a: 1 if direction == 2
        else 0, dev_deferred=1))
    assert st == 2 and "completion failed" in err


def test_rwmix_accounting(pkgs, bench_dir):
    shares = []

    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 22, do_trunc_to_size=1,
                        rwmix_pct=30)
        try:
            e.prepare_paths()
            e.prepare()
            st = run_phase(pkg, e, "CREATEFILES")
            ops = total_ops(pkg, e)
            total = ops.iops + ops.read_iops
            shares.append(ops.read_iops / total)
            return st, total
        finally:
            e.close()
    st, total = same(pkgs, bench_dir, sc)
    assert st == 1 and total == (1 << 22) // (1 << 16)
    # read share within 15% of the requested 30%, in both
    assert all(abs(s - 0.30) < 0.15 for s in shares), shares


# ---------------------------------------------------------------- O_DIRECT


def _odirect(pkg, d, **kw):
    e = make_engine(pkg, [d / "df"], path_type=1, num_threads=1,
                    num_dataset_threads=1, file_size=1 << 20,
                    do_trunc_to_size=1, use_direct_io=1, **kw)
    try:
        e.prepare_paths()
        e.prepare()
        st = run_phase(pkg, e, "CREATEFILES")
        if st != 1 and "Invalid argument" in e.error():
            return "no O_DIRECT"
        out = [(st, total_ops(pkg, e).bytes)]
        if not kw.get("random_offsets"):
            out.append((run_phase(pkg, e, "READFILES"),
                        total_ops(pkg, e).bytes))
        return out, e.error()
    finally:
        e.close()


def test_odirect_seq_write_read(pkgs, tmp_path):
    """O_DIRECT end-to-end (tmp_path is disk-backed, not tmpfs)."""
    got = same(pkgs, tmp_path, lambda pkg, d: _odirect(
        pkg, d, block_size=1 << 16))
    if got == "no O_DIRECT":
        pytest.skip("filesystem does not support O_DIRECT")
    assert got == ([(1, 1 << 20), (1, 1 << 20)], "")


def test_odirect_random_aligned_aio(pkgs, tmp_path):
    got = same(pkgs, tmp_path, lambda pkg, d: _odirect(
        pkg, d, block_size=4096, random_offsets=1, rand_aligned=1,
        rand_amount=1 << 18, iodepth=8))
    if got == "no O_DIRECT":
        pytest.skip("filesystem does not support O_DIRECT")
    assert got == ([(1, 1 << 18)], "")


# -------------------------------------------------------- mmap device path


def test_mmap_seq_ingest_counts(pkgs, bench_dir):
    """dev_mmap hands page-cache pointers to the callback: byte and op
    counts per phase match."""
    def sc(pkg, d):
        seen = {"h2d": 0, "barriers": 0}

        def cb(rank, dev_idx, direction, buf, length, off):
            if direction == 0:
                seen["h2d"] += length
            elif direction == 2:
                seen["barriers"] += 1
            return 0

        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 19, do_trunc_to_size=1,
                        dev_backend=2, num_devices=1, dev_deferred=1,
                        dev_mmap=1)
        try:
            e.set_dev_callback(cb)
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES"), \
                ops_tuple(total_ops(pkg, e))
            r = run_phase(pkg, e, "READFILES"), ops_tuple(total_ops(pkg, e))
            return w, r, seen["h2d"]
        finally:
            e.close()
    w, r, h2d = same(pkgs, bench_dir, sc)
    blocks = (1 << 19) // (1 << 16)
    assert w[0] == r[0] == 1
    # live counters reset per phase
    assert w[1][1:3] == r[1][1:3] == (1 << 19, blocks)
    assert h2d == 1 << 19


def test_mmap_random_duplicate_offsets(pkgs, bench_dir):
    """A tiny file under a deep window repeats offsets: every block is
    still counted exactly once, and no pointer is in flight twice."""
    def sc(pkg, d):
        outstanding = set()
        dupes = []

        def cb(rank, dev_idx, direction, buf, length, off):
            if direction == 0:
                if buf in outstanding:
                    dupes.append(buf)
                outstanding.add(buf)
            elif direction == 2:
                outstanding.discard(buf)
            return 0

        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 17, do_trunc_to_size=1,
                        random_offsets=1, rand_aligned=1,
                        rand_amount=1 << 20, iodepth=8, dev_backend=2,
                        num_devices=1, dev_deferred=1, dev_mmap=1)
        try:
            e.set_dev_callback(cb)
            e.prepare_paths()
            e.prepare()
            sts = run_phase(pkg, e, "CREATEFILES"), run_phase(pkg, e,
                                                              "READFILES")
            return sts, total_ops(pkg, e).iops, dupes
        finally:
            e.close()
    sts, iops, dupes = same(pkgs, bench_dir, sc)
    assert sts == (1, 1) and iops == (1 << 20) // (1 << 16)
    assert dupes == [], "duplicate in-flight pointer"


def test_mmap_random_multifile_round_robin(pkgs, bench_dir):
    """Multi-path random mmap: offsets round-robin across both mappings,
    and byte accounting stays exact."""
    def sc(pkg, d):
        seen = {"h2d": 0}
        bases = set()

        def cb(rank, dev_idx, direction, buf, length, off):
            if direction == 0:
                seen["h2d"] += length
                bases.add(buf - off)  # mapping base = pointer - offset
            return 0

        e = make_engine(pkg, [d / "f1", d / "f2"], path_type=1,
                        num_threads=1, num_dataset_threads=1,
                        block_size=1 << 16, file_size=1 << 18,
                        do_trunc_to_size=1, random_offsets=1,
                        rand_aligned=1, rand_amount=1 << 20, iodepth=4,
                        dev_backend=2, num_devices=1, dev_deferred=1,
                        dev_mmap=1)
        try:
            e.set_dev_callback(cb)
            e.prepare_paths()
            e.prepare()
            sts = run_phase(pkg, e, "CREATEFILES"), run_phase(pkg, e,
                                                              "READFILES")
            return sts, seen["h2d"], len(bases)
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc) == ((1, 1), 1 << 20, 2)


def test_mmap_skipped_when_file_too_small(pkgs, bench_dir):
    """A claimed size beyond EOF: the mapping is refused and the buffered
    path reports a clean end-of-file error."""
    def sc(pkg, d):
        path = d / "f"
        with open(path, "wb") as f:
            f.truncate(1 << 17)
        e = make_engine(pkg, [path], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 19, dev_backend=2, num_devices=1,
                        dev_deferred=1, dev_mmap=1)
        try:
            e.set_dev_callback(lambda *a: 0)
            e.prepare()
            return run_phase(pkg, e, "READFILES"), \
                e.error().replace(str(d), "<dir>")
        finally:
            e.close()
    st, err = same(pkgs, bench_dir, sc)
    assert st == 2 and "end of file" in err


# ------------------------------------------------------------- NUMA zones


def _cpulist(path: str) -> set[int]:
    want = set()
    for part in open(path).read().strip().split(","):
        lo, _, hi = part.partition("-")
        want |= set(range(int(lo), int(hi or lo) + 1))
    return want


def test_bind_zone_numa_sets_affinity_and_mempolicy(pkgs):
    if not os.path.isdir("/sys/devices/system/node/node0"):
        pytest.skip("no NUMA sysfs on this host")
    if platform.machine() != "x86_64":
        # the raw get/set_mempolicy syscall numbers below are x86_64's
        pytest.skip("mempolicy readback uses x86_64 syscall numbers")
    libc = ctypes.CDLL(None, use_errno=True)
    got = []
    for pkg in pkgs:
        prev = os.sched_getaffinity(0)
        try:
            rc = pkg.engine.bind_zone_self(0)
            mode, mask = ctypes.c_int(-1), ctypes.c_ulong(0)
            assert libc.syscall(239, ctypes.byref(mode), ctypes.byref(mask),
                                65, None, 0) == 0
            got.append((rc, os.sched_getaffinity(0), mode.value,
                        mask.value & 1))
        finally:
            os.sched_setaffinity(0, prev)
            libc.syscall(238, 0, None, 0)  # MPOL_DEFAULT
    assert got[1] == got[0]
    # the NUMA path, node0's CPUs, MPOL_PREFERRED(node0)
    assert got[1] == (1, _cpulist("/sys/devices/system/node/node0/cpulist"),
                      1, 1)


def test_bind_zone_bad_id_raises(pkgs):
    msgs = []
    for pkg in pkgs:
        with pytest.raises(pkg.EngineError) as exc:
            pkg.engine.bind_zone_self(4096)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


def test_zones_run_end_to_end(pkgs, bench_dir):
    """A write+read cycle with zone binding completes with bound
    workers."""
    def sc(pkg, d):
        e = make_engine(pkg, [d / "zf"], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=1 << 16,
                        file_size=1 << 18, do_trunc_to_size=1)
        try:
            e.add_cpu(0)
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), \
                run_phase(pkg, e, "READFILES"), total_ops(pkg, e).bytes
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc) == (1, 1, 1 << 18)


# ---------------------------------------------------------------- io_uring


@pytest.fixture
def need_uring(pkgs):
    if not all(p.engine.load_lib().ebt_uring_supported() for p in pkgs):
        pytest.skip("kernel/seccomp without io_uring")


def test_uring_matches_sync_bytes(pkgs, bench_dir, need_uring):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 21, do_trunc_to_size=1, iodepth=8,
                        use_io_uring=1)
        try:
            e.prepare_paths()
            e.prepare()
            w = run_phase(pkg, e, "CREATEFILES"), total_ops(pkg, e).bytes
            r = run_phase(pkg, e, "READFILES"), total_ops(pkg, e).bytes
            return w, r, e.histogram(0, 0).count
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc) == ((1, 1 << 21), (1, 1 << 21),
                                         (1 << 21) // (1 << 16))


def test_uring_content_matches_verify_pattern(pkgs, bench_dir, need_uring):
    """The verify pattern written through io_uring passes the verify read,
    and a corruption is caught through the uring read path."""
    kw = dict(path_type=1, num_threads=2, num_dataset_threads=2,
              block_size=4096, file_size=1 << 18, do_trunc_to_size=1,
              iodepth=4, use_io_uring=1, verify_enabled=1, verify_salt=77)

    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], **kw)
        e.prepare_paths()
        e.prepare()
        clean = run_phase(pkg, e, "CREATEFILES"), run_phase(pkg, e,
                                                            "READFILES")
        e.close()
        written = digest(path)
        with open(path, "r+b") as f:
            f.seek(8192)
            f.write(b"\x5a")
        e = make_engine(pkg, [path], **kw)
        try:
            e.prepare()
            return clean, written, run_phase(pkg, e, "READFILES"), \
                "verification failed" in e.error()
        finally:
            e.close()
    clean, _, st, failed = same(pkgs, bench_dir, sc)
    assert clean == (1, 1) and st == 2 and failed


def test_uring_random_aligned_amount(pkgs, bench_dir, need_uring):
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=2,
                        num_dataset_threads=2, block_size=4096,
                        file_size=1 << 20, do_trunc_to_size=1,
                        random_offsets=1, rand_aligned=1,
                        rand_amount=1 << 20, iodepth=16, use_io_uring=1)
        try:
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), \
                [e.live(i).ops.bytes for i in range(2)]
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc) == (1, [(1 << 20) // 2] * 2)


def test_uring_device_path_hostsim(pkgs, bench_dir, need_uring):
    """The io_uring loop drives the device data path like the AIO loop."""
    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=1 << 16,
                        file_size=1 << 19, do_trunc_to_size=1, iodepth=8,
                        use_io_uring=1, dev_backend=1, num_devices=1,
                        dev_write_path=1)
        try:
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), \
                run_phase(pkg, e, "READFILES"), total_ops(pkg, e).bytes, \
                digest(path)
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc)[:3] == (1, 1, 1 << 19)


def test_uring_odirect_random(pkgs, tmp_path, need_uring):
    got = same(pkgs, tmp_path, lambda pkg, d: _odirect(
        pkg, d, block_size=4096, random_offsets=1, rand_aligned=1,
        rand_amount=1 << 18, iodepth=8, use_io_uring=1))
    if got == "no O_DIRECT":
        pytest.skip("filesystem does not support O_DIRECT")
    assert got == ([(1, 1 << 18)], "")
