"""Regression cases of the original (tests/test_regressions.py) held
against the port on the same inputs.

Engine-level cases run both packages' NativeEngine (see
test_torch_engine.py for the harness); the backend cases run the
original's TpuStagingPath on CPU jax and the port's TorchStagingPath with
EBT_TORCH_DEVICE=cpu, each on the same seeded file and arguments.

The three error paths of the direct backend fail the copy through a seam
each package has: the original swaps TpuStagingPath.jax for one whose
device_put raises; the port's seam is TorchStagingPath._copy_to_device,
monkeypatched inside the test. Both must give the same return codes at
submit and at the pre-reuse barrier, wait out the same chunks and surface
the same cause ("<TPU|GPU> copy error (rank 0): boom": the port names its
device kind, tests/test_torch_backend.py's header).

`test_tpu_stripe_across_devices` reads Array.devices() in the original;
the port holds each chunk's placement by the lane (selected-device index)
it records for it, on eight CPU "devices" where the original has eight CPU
jax devices. `test_verify_with_staged_jax_backend` runs the staged torch
backend on the CPU beside the staged jax backend.

Held by invariants, not by equality: nothing here follows the clock.

Every case of tests/test_regressions.py has a counterpart here under the
same name (the staged case as test_verify_with_staged_backend).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import elbencho_tpu.cli as jax_cli
import elbencho_tpu.config as jax_config
import elbencho_tpu.stats as jax_stats
import elbencho_tpu.tpu.backend as jax_backend
import elbencho_tpu.workers.base as jax_base
import elbencho_tpu.workers.local as jax_local
import elbencho_tpu_torch.cli as torch_cli
import elbencho_tpu_torch.config as torch_config
import elbencho_tpu_torch.cuda.backend as torch_backend
import elbencho_tpu_torch.stats as torch_stats
import elbencho_tpu_torch.workers.base as torch_base
import elbencho_tpu_torch.workers.local as torch_local
from test_torch_engine import (JAX, TORCH, digest, make_engine, run_phase,
                               same, total_ops)
from test_torch_worker_state import worker_state  # noqa: F401


def _pkg(engine_pkg, cli, config, stats, base, local) -> SimpleNamespace:
    """The engine harness's package namespace, with the modules the
    backend and CLI cases drive."""
    return SimpleNamespace(
        **vars(engine_pkg), main=cli.main,
        config_from_args=config.config_from_args,
        aggregate_results=stats.aggregate_results,
        WorkerPhaseResult=base.WorkerPhaseResult,
        Group=local.LocalWorkerGroup)


PKGS = (_pkg(JAX, jax_cli, jax_config, jax_stats, jax_base, jax_local),
        _pkg(TORCH, torch_cli, torch_config, torch_stats, torch_base,
             torch_local))


@pytest.fixture
def pkgs(monkeypatch):
    """(original, port); the port asked onto the CPU."""
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")
    return PKGS


# ------------------------------------------------------------ engine level


def test_rankoffset_beyond_dataset_threads_no_crash(pkgs, bench_dir):
    """fileModeSeq must not index paths out of bounds for ranks >= ndt."""
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, rank_offset=4,
                        block_size=4096, file_size=1 << 16,
                        do_trunc_to_size=1)
        try:
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), total_ops(pkg, e).bytes
        finally:
            e.close()
    # rank 4 of a 1-rank dataset owns nothing
    assert same(pkgs, bench_dir, sc) == (1, 0)


def test_verify_with_hostsim_device_path(pkgs, bench_dir):
    """The device write path preserves the verify pattern (round trip
    through the device), in both engines, with the same bytes."""
    def sc(pkg, d):
        path = d / "f"
        e = make_engine(pkg, [path], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=4096,
                        file_size=1 << 16, do_trunc_to_size=1,
                        verify_enabled=1, verify_salt=7, dev_backend=1,
                        num_devices=1, dev_write_path=1)
        try:
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), \
                run_phase(pkg, e, "READFILES"), e.error(), digest(path)
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc)[:3] == (1, 1, "")


def test_verifydirect_works_with_aio(pkgs, bench_dir):
    """--verifydirect verifies on the AIO path too."""
    def sc(pkg, d):
        e = make_engine(pkg, [d / "f"], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=4096,
                        file_size=1 << 16, do_trunc_to_size=1,
                        verify_direct=1, verify_enabled=1, verify_salt=3,
                        iodepth=4)
        try:
            e.prepare_paths()
            e.prepare()
            return run_phase(pkg, e, "CREATEFILES"), e.error(), \
                digest(d / "f")
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc)[:2] == (1, "")


def test_trunc_applies_in_file_mode(pkgs, bench_dir):
    def sc(pkg, d):
        path = d / "f"
        path.write_bytes(b"x" * (1 << 20))
        e = make_engine(pkg, [path], path_type=1, num_threads=1,
                        num_dataset_threads=1, block_size=4096,
                        file_size=8192, do_truncate=1)
        try:
            e.prepare_paths()
            return os.path.getsize(path)
        finally:
            e.close()
    assert same(pkgs, bench_dir, sc) == 0  # truncated before the write


# ------------------------------------------------------------ config / CLI


def test_verify_with_staged_backend(pkgs, bench_dir):
    """The round-trip guarantee through each package's staging path: the
    jax one on a CPU device, the torch one on the CPU."""
    def sc(pkg, d):
        p = str(d / "f")
        rc = pkg.main(["-w", "-r", "-t", "1", "-s", "256k", "-b", "64k",
                       "--verify", "11", "--gpuids", "0", "--nolive", p])
        return rc, digest(p)
    assert same(pkgs, bench_dir, sc)[0] == 0


def test_direct_random_auto_aligns(pkgs, tmp_path):
    p = tmp_path / "f"
    p.write_bytes(b"\0" * (1 << 20))
    got = [pkg.config_from_args(["-r", "--direct", "--rand", "-b", "4k",
                                 str(p)]).use_random_aligned
           for pkg in pkgs]
    assert got == [True, True]  # auto-corrected for O_DIRECT


def test_bad_unit_clean_error(pkgs, capsys):
    got = []
    for pkg in pkgs:
        rc = pkg.main(["-w", "-s", "8Q", "/tmp/x"])
        cap = capsys.readouterr()
        got.append((rc, cap.out, cap.err))
    assert got[1] == got[0]
    assert got[1][0] == 1


def test_0usec_warning_uses_fastest_worker_without_stonewall(pkgs):
    """Without stonewall data the 0-usec check considers the fastest worker
    (reference: Statistics.cpp:1130-1139)."""
    got = []
    for pkg in pkgs:
        R = pkg.WorkerPhaseResult
        agg = pkg.aggregate_results(pkg.Phase.READFILES, [
            R(elapsed_us_list=[0]), R(elapsed_us_list=[5000])])
        # remote-style result: per-thread list, the host max is not the
        # fastest thread
        agg2 = pkg.aggregate_results(pkg.Phase.READFILES,
                                     [R(elapsed_us_list=[0, 7000])])
        got.append((agg.have_first, agg.min_elapsed_us, agg.last_elapsed_us,
                    agg2.min_elapsed_us))
    assert got[1] == got[0] == (False, 0, 5000, 0)


# ------------------------------------------------------------ the backends


def _staging_path(group):
    return group._dev_callback.staging_path


def _read_phase(pkg, args):
    """A READ phase of a worker group built from `args`; the group, still
    prepared (the caller tears it down)."""
    group = pkg.Group(pkg.config_from_args(args))
    group.prepare()
    group.start_phase(pkg.Phase.READFILES, "t")
    while not group.wait_done(500):
        pass
    return group


def test_direct_backend_snapshot_isolation(pkgs, bench_dir):
    """The direct (deferred) backend snapshots buffers before enqueueing:
    the staged contents match the file although the engine reuses its I/O
    buffers at once."""
    data = np.random.default_rng(5).integers(0, 255, 1 << 18,
                                             dtype=np.uint8)

    def sc(pkg, d):
        p = d / "f"
        p.write_bytes(data.tobytes())
        group = _read_phase(pkg, ["-r", "-t", "1", "-b", "64k", "--gpuids",
                                  "0", "--tpubackend", "direct",
                                  "--iodepth", "4", "--nolive", str(p)])
        try:
            sp = _staging_path(group)
            if pkg.name == "jax":
                sp.drain()
            # the last staged block must equal the file's last 64k
            last = np.concatenate([np.asarray(a)
                                   for a in sp.last_staged_arrays(0)])
            return group.first_error(), last.tobytes(), \
                sp.transferred_bytes[0]
        finally:
            group.teardown()
    err, last, to_hbm = same(pkgs, bench_dir, sc)
    assert err == ""
    assert last == data[-(64 << 10):].tobytes() and to_hbm == 1 << 18


def _lanes(pkg, sp) -> list[int]:
    """The device each chunk of rank 0's last block went to: the jax
    array's device id, or the lane the port recorded for the chunk."""
    if pkg.name == "jax":
        return [a.devices().pop().id for a in sp.last_staged_arrays(0)]
    sp.last_staged_arrays(0)  # waits for the block's copies
    return [c.dev_idx for x in sp._last_h2d[0]
            for c in getattr(x, "chunks", [x])]


def test_tpu_stripe_across_devices(pkgs, bench_dir, monkeypatch):
    """--tpustripe fans a block's chunks over all eight devices."""
    data = np.random.default_rng(6).integers(0, 255, 1 << 20,
                                             dtype=np.uint8)
    # chunk smaller than the block so striping actually splits
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(128 << 10))

    def sc(pkg, d):
        p = d / "sf"
        p.write_bytes(data.tobytes())
        group = _read_phase(pkg, ["-r", "-t", "1", "-b", "1M", "--gpuids",
                                  "0,1,2,3,4,5,6,7", "--tpustripe",
                                  "--nolive", str(p)])
        try:
            sp = _staging_path(group)
            staged = np.concatenate([np.asarray(a)
                                     for a in sp.last_staged_arrays(0)])
            return group.first_error(), _lanes(pkg, sp), staged.tobytes()
        finally:
            group.teardown()
    err, lanes, staged = same(pkgs, bench_dir, sc)
    assert err == ""
    assert lanes == list(range(8))  # 1 MiB / 128 KiB: one chunk a device
    assert staged == data.tobytes()


class _Arr:
    """A chunk the failing seam hands back: the original's array waits
    with block_until_ready, the port's chunk with its event."""

    nbytes = 32 << 10

    def __init__(self, waited):
        self.waited = waited

    def block_until_ready(self):
        self.waited.append(self)

    synchronize = block_until_ready

    def query(self):
        return False


def _direct_path(pkg, d):
    p = d / "x"
    p.write_bytes(b"\0" * (64 << 10))
    cfg = pkg.config_from_args(["-r", "-t", "1", "-b", "64k", "--gpuids",
                                "0", "--tpubackend", "direct", "--nolive",
                                str(p)])
    if pkg.name == "jax":
        return jax_backend.TpuStagingPath(cfg)
    return torch_backend.TorchStagingPath(cfg)


def _fail_copies(pkg, sp, monkeypatch, put) -> None:
    """Make the package's device copy call `put(view)` (which raises or
    returns a fake chunk): the original's device_put through the .jax
    seam, the port's _copy_to_device."""
    if pkg.name == "jax":
        sp.jax = type("J", (), {"device_put": staticmethod(
            lambda *a, **k: put(a[0]))})()
        return

    def copy_to_device(view, dev_idx, dst=None):
        arr = put(view)
        return torch.from_numpy(np.array(view)), arr

    monkeypatch.setattr(sp, "_copy_to_device", copy_to_device)


def _boom(view):
    raise RuntimeError("boom")


def _copy_pair(pkg, sp, capfd) -> tuple[int, int, list[str]]:
    """rc of one submit (direction 0) and of the pre-reuse barrier
    (direction 2) on one 64 KiB buffer; the causes printed."""
    buf = np.zeros(64 << 10, dtype=np.uint8)
    try:
        rcs = (sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0),
               sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0))
    finally:
        sp.close()
    err = capfd.readouterr().err
    causes = [ln.split(" ", 1)[1] for ln in err.splitlines()
              if " copy error " in ln]
    return (*rcs, causes)


def test_direct_backend_submitter_error_surfaces(pkgs, bench_dir,
                                                 monkeypatch, capfd):
    """A copy failure inside the async submitter thread comes back as a
    worker error at the pre-reuse barrier, not lost and not hung."""
    monkeypatch.setenv("EBT_TPU_SUBMITTERS", "1")  # pin the threaded path

    def sc(pkg, d):
        sp = _direct_path(pkg, d)
        _fail_copies(pkg, sp, monkeypatch, _boom)
        return _copy_pair(pkg, sp, capfd)
    # async submit ok; the barrier reports the failure (engine -> worker
    # error)
    assert same(pkgs, bench_dir, sc) == (
        0, 1, ["copy error (rank 0): boom"])


def test_direct_backend_inline_partial_failure_registers_chunks(
        pkgs, bench_dir, monkeypatch, capfd):
    """If a later chunk's copy raises mid-block, the chunks already
    enqueued are registered so the pre-reuse barrier waits them out before
    the buffer is reused."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(32 << 10))  # 2 chunks

    def sc(pkg, d):
        sp = _direct_path(pkg, d)
        assert sp.inline_submit
        waited, calls = [], []

        def put(view):
            calls.append(view.nbytes)
            if len(calls) > 1:
                raise RuntimeError("boom on chunk 2")
            return _Arr(waited)

        _fail_copies(pkg, sp, monkeypatch, put)
        return (*_copy_pair(pkg, sp, capfd), calls, len(waited))
    # chunk 1 pending; the barrier waited it out
    assert same(pkgs, bench_dir, sc) == (
        1, 0, ["copy error (rank 0): boom on chunk 2"],
        [32 << 10, 32 << 10], 1)


def test_direct_backend_inline_error_surfaces(pkgs, bench_dir, monkeypatch,
                                              capfd):
    """Inline submission (the default direct path) reports a copy failure
    at submit time, and the barrier afterwards is clean."""
    def sc(pkg, d):
        sp = _direct_path(pkg, d)
        assert sp.inline_submit
        _fail_copies(pkg, sp, monkeypatch, _boom)
        return _copy_pair(pkg, sp, capfd)
    assert same(pkgs, bench_dir, sc) == (
        1, 0, ["copy error (rank 0): boom"])
