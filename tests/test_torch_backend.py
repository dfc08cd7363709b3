"""The port's staging path (cuda/backend.py) on the CPU device.

The failure cases mirror the original's (tests/test_regressions.py) with the
port's copy function monkeypatched. Byte-level results are held to the
original package on CPU jax with exact equality.
"""

import threading

import numpy as np
import pytest
import torch

from elbencho_tpu.config import config_from_args as jax_cfa
from elbencho_tpu.tpu.backend import TpuStagingPath
from elbencho_tpu_torch.config import config_from_args as cfa
from elbencho_tpu_torch.cuda.backend import TorchStagingPath, make_dev_callback
from elbencho_tpu_torch.cuda.devices import resolve_devices
from elbencho_tpu_torch.exceptions import ProgException
from elbencho_tpu_torch.ops import verify_kernel


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EBT_TORCH_DEVICE", "cpu")


def _cfg(path, backend="direct", extra=()):
    path.write_bytes(b"\0" * (64 << 10))
    return cfa(["-r", "-t", "1", "-b", "64k", "--gpuids", "0", "--tpubackend",
                backend, *extra, "--nolive", str(path)])


class _FakeEvent:
    def __init__(self, log, fail=False):
        self.log, self.fail = log, fail

    def synchronize(self):
        self.log.append(self)
        if self.fail:
            raise RuntimeError("boom in flight")

    def query(self):
        return False


def _pattern_bytes(n, off, salt):
    words = (np.arange(n // 8, dtype=np.uint64) * np.uint64(8)
             + np.uint64(off) + np.uint64(salt))
    return words.view(np.uint8).copy()


def test_threaded_submitters_refused(bench_dir, monkeypatch):
    """EBT_TPU_SUBMITTERS>0 runs the original's threaded mode, never the
    inline path: the copy is made by a submitter thread and waited for at
    the pre-reuse barrier."""
    monkeypatch.setenv("EBT_TPU_SUBMITTERS", "1")
    sp = TorchStagingPath(_cfg(bench_dir / "x"))
    try:
        assert sp.num_submitters == 1 and not sp.inline_submit
        threads = []
        real = sp._copy_to_device

        def put(view, dev_idx, dst=None):
            threads.append(threading.current_thread().name)
            return real(view, dev_idx, dst)

        monkeypatch.setattr(sp, "_copy_to_device", put)
        buf = np.arange(64 << 10, dtype=np.uint64).astype(np.uint8)
        assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 0
        assert sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0) == 0
        assert threads == ["ebt-gpu-submit-0"]
        assert sp.transferred_bytes[0] == buf.nbytes
        assert np.array_equal(
            torch.cat(sp.last_staged_arrays(0)).numpy(), buf)
    finally:
        sp.close()


def test_direct_inline_partial_failure_registers_chunks(bench_dir,
                                                        monkeypatch):
    """If a later chunk's copy raises mid-block, the chunks already
    enqueued must be registered so the pre-reuse barrier waits them out."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(32 << 10))  # 2 chunks
    sp = TorchStagingPath(_cfg(bench_dir / "x"))
    waited = []
    calls = {"n": 0}

    def put(view, device, dst=None):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("boom on chunk 2")
        return torch.from_numpy(view.copy()), _FakeEvent(waited)

    monkeypatch.setattr(sp, "_copy_to_device", put)
    buf = np.zeros(64 << 10, dtype=np.uint8)
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 1
    # chunk 1 must be pending; the barrier must wait it out
    assert sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0) == 0
    assert len(waited) == 1


def test_direct_inline_error_surfaces(bench_dir, monkeypatch):
    """Inline submission reports a copy failure at submit time, and the
    barrier afterwards is clean."""
    sp = TorchStagingPath(_cfg(bench_dir / "x"))

    def put(view, device, dst=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(sp, "_copy_to_device", put)
    buf = np.zeros(64 << 10, dtype=np.uint8)
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 1
    assert sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0) == 0


def test_direct_barrier_waits_all_before_raising(bench_dir, monkeypatch):
    """An in-flight failure surfaces at the barrier as rc 1 — after every
    sibling chunk was waited for — and its bytes are not counted."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))  # 4 chunks
    sp = TorchStagingPath(_cfg(bench_dir / "x"))
    waited = []
    calls = {"n": 0}

    def put(view, device, dst=None):
        calls["n"] += 1
        return (torch.from_numpy(view.copy()),
                _FakeEvent(waited, fail=calls["n"] == 2))

    monkeypatch.setattr(sp, "_copy_to_device", put)
    buf = np.zeros(64 << 10, dtype=np.uint8)
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 0
    assert sp.transferred_bytes[0] == 64 << 10
    assert sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0) == 1
    assert len(waited) == 4
    assert sp.transferred_bytes[0] == 48 << 10


def test_staged_waits_per_block(bench_dir, monkeypatch):
    """staged waits for every chunk inside the copy call; nothing is left
    for the barrier."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged"))
    waited = []
    monkeypatch.setattr(sp, "_copy_to_device", lambda v, d, dst=None: (
        torch.from_numpy(v.copy()), _FakeEvent(waited)))
    buf = np.zeros(64 << 10, dtype=np.uint8)
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 0
    assert len(waited) == 4
    assert sp.copy(0, 0, 2, buf.ctypes.data, buf.nbytes, 0) == 0
    assert len(waited) == 4
    assert sum(h.count for h in sp.device_latency_histograms().values()) == 4


def test_cpu_copy_is_a_snapshot(bench_dir):
    """On the CPU the staged tensor must not alias the engine buffer, which
    the engine overwrites after the barrier."""
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged"))
    buf = np.arange(64 << 10, dtype=np.uint64).astype(np.uint8)
    assert sp.copy(3, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 0
    staged = torch.cat(sp.last_staged_arrays(3)).numpy().copy()
    buf[:] = 0
    assert np.array_equal(torch.cat(sp.last_staged_arrays(3)).numpy(),
                          staged)


def test_round_trip_serves_the_staged_block(bench_dir):
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="direct"))
    src = np.random.default_rng(5).integers(0, 256, 64 << 10,
                                            dtype=np.uint8)
    assert sp.copy(1, 0, 3, src.ctypes.data, src.nbytes, 0) == 0
    out = np.zeros_like(src)
    assert sp.copy(1, 0, 1, out.ctypes.data, out.nbytes, 0) == 0
    assert np.array_equal(out, src)


@pytest.mark.parametrize("rank", [0, 3])
def test_write_source_bytes_match_jax(bench_dir, rank):
    """The rank-seeded write-source bytes equal the original's for the same
    rank, so both packages write the same data."""
    p = bench_dir / "x"
    p.write_bytes(b"\0" * (64 << 10))
    args = ["-r", "-t", "1", "-b", "64k", "--gpuids", "0", "--nolive", str(p)]
    ref = TpuStagingPath(jax_cfa(args))
    sp = TorchStagingPath(cfa(args))
    n = 48 << 10
    jref = np.asarray(ref._write_source(rank, ref.devices[0], n))[:n]
    ours = sp._write_source(rank, sp.devices[0], n)[:n].numpy()
    assert np.array_equal(ours, jref)
    out = np.zeros(n, dtype=np.uint8)
    assert sp.copy(rank, 0, 1, out.ctypes.data, n, 0) == 0
    assert np.array_equal(out, jref)


def test_staged_verify_pinpoints_offset_and_uses_verify_wrapper(
        bench_dir, monkeypatch):
    """--verify: a 4-chunk block goes through the verify wrapper once, at
    the block's file offset, and a corrupt byte is reported at its exact
    file offset."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged",
                               extra=("--verify", "42")))
    calls = []
    real = verify_kernel.verify_block_u32
    monkeypatch.setattr("elbencho_tpu_torch.cuda.backend.verify_block_u32",
                        lambda b, off, salt: calls.append((off, b.numel()))
                        or real(b, off, salt))
    file_off = 1 << 20
    buf = _pattern_bytes(64 << 10, file_off, 42)
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, file_off) == 0
    assert calls == [(file_off, 64 << 10)]
    buf[(40 << 10) + 5] ^= 0x77
    assert sp.copy(0, 0, 0, buf.ctypes.data, buf.nbytes, file_off) == 2
    assert sp.verify_errors[0] == (
        "on-device data verification failed at file offset "
        f"{file_off + (40 << 10) + 5}")


@pytest.mark.parametrize("bad", [
    [(48 << 10) + 1, (16 << 10) + 9000],   # chunks 4 and 2: the later
    [(32 << 10), (32 << 10) - 1],          # chunk first; a chunk boundary
    [7, (64 << 10) - 1],                   # first and last byte of the block
])
def test_staged_verify_reports_first_bad_byte_in_file_order(
        bench_dir, monkeypatch, bad):
    """Several corrupt bytes in one block, in different chunks: the
    reported offset is the first in file order, as the per-chunk checks of
    the original report it."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged",
                               extra=("--verify", "5")))
    file_off = 3 << 20
    buf = _pattern_bytes(64 << 10, file_off, 5)
    for b in bad:
        buf[b] ^= 0x40
    assert sp.copy(1, 0, 0, buf.ctypes.data, buf.nbytes, file_off) == 2
    assert sp.verify_errors[1].endswith(f"file offset {file_off + min(bad)}")


def test_staged_verify_block_round_trips_through_its_chunk_views(bench_dir,
                                                                 monkeypatch):
    """The staged chunks of a verified block are views of one block buffer;
    the write round trip still serves the staged bytes exactly, and every
    chunk gets a latency sample."""
    monkeypatch.setenv("EBT_TPU_CHUNK_BYTES", str(16 << 10))
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged",
                               extra=("--verify", "3")))
    buf = _pattern_bytes(64 << 10, 0, 3)
    assert sp.copy(2, 0, 0, buf.ctypes.data, buf.nbytes, 0) == 0
    arrs = sp.last_staged_arrays(2)
    assert [a.numel() for a in arrs] == [16 << 10] * 4
    assert len({a.untyped_storage().data_ptr() for a in arrs}) == 1
    assert sum(h.count for h in sp.device_latency_histograms().values()) == 4
    out = np.zeros_like(buf)
    assert sp.copy(2, 0, 1, out.ctypes.data, out.nbytes, 0) == 0
    assert np.array_equal(out, buf)


def test_staged_verify_sub_word_tail_checked_on_host(bench_dir):
    sp = TorchStagingPath(_cfg(bench_dir / "x", backend="staged",
                               extra=("--verify", "7")))
    n = (64 << 10) - 3  # a file tail block that is not whole words
    buf = _pattern_bytes(64 << 10, 0, 7)[:n].copy()
    assert sp.copy(0, 0, 0, buf.ctypes.data, n, 0) == 0
    buf[n - 1] ^= 1
    assert sp.copy(0, 0, 0, buf.ctypes.data, n, 0) == 2
    assert sp.verify_errors[0].endswith(f"file offset {n - 1}")


def test_no_cuda_and_no_cpu_request_raises(bench_dir, monkeypatch):
    monkeypatch.delenv("EBT_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ProgException, match="no CUDA device found"):
        resolve_devices([0])
    with pytest.raises(ProgException, match="EBT_TORCH_DEVICE=cpu"):
        make_dev_callback(_cfg(bench_dir / "x"))
    # an explicit device= is a request for the CPU
    cb = make_dev_callback(_cfg(bench_dir / "x"), device="cpu")
    assert cb.staging_path.devices == [torch.device("cpu")]


def test_gpu_id_out_of_range(monkeypatch):
    monkeypatch.delenv("EBT_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ProgException,
                       match=r"GPU device id 3 out of range \(found 1 "):
        resolve_devices([3])
