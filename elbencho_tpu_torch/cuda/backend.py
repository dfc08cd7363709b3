"""The storage -> GPU memory data path.

Port of the original package's TPU staging path (tpu/backend.py,
TpuStagingPath/make_dev_callback), itself the replacement of the
reference's GPU data path (cudaMemcpy staging copies and cuFile/GDS direct
DMA, LocalWorker.cpp:453-536,1054-1305). The native engine calls back into
this module per block from its worker threads; the callback moves the block
between the page-aligned host I/O buffer and device memory:

  direction 0 (post-read):  host buffer -> device memory
  direction 1 (pre-write):  device memory -> host buffer (the write source)
  direction 2 (pre-reuse):  barrier — engine is about to overwrite the buffer
  direction 3 (write round-trip): host -> device like 0, but the source is a
              host-generated write block, so on-device --verify skips it

Backends:
  staged  - each block's chunks are copied into device memory on a
            per-device side stream, and the callback waits for them before
            it returns (the cudaMemcpy-staging analogue).
  direct  - the same copies, but the wait is deferred: one CUDA event per
            chunk is recorded and the engine's per-buffer pre-reuse barrier
            (direction 2) waits for them, so a buffer is never overwritten
            while a copy may still read it. Copies from the engine's
            pageable buffers may be synchronous on the host; pinning them
            (cudaHostRegister) is later work (ROADMAP.md A4).
  hostsim - handled natively in the engine (no device), for CI.

On the CPU device, which the caller must ask for (EBT_TORCH_DEVICE=cpu or
device="cpu"), a chunk is snapshotted with clone(): a tensor made with
from_numpy aliases the engine buffer, which the engine reuses.

With --verify, each staged read block is copied chunk by chunk into one
device buffer and checked by one launch of the verify kernel
(ops/verify_kernel.py, csrc/verify.cu), whose result is read once per
block.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import sys
import threading
import time

import numpy as np
import torch

from ..config import Config
from ..exceptions import ProgException
from ..histogram import LatencyHistogram
from ..ops.verify_kernel import verify_block_u32
from .devices import resolve_devices


class VerifyFailure(Exception):
    """On-device --verify mismatch; message carries the exact corrupt byte
    offset, matching the host check's report (engine.cpp checkVerifyPattern,
    reference LocalWorker.cpp:902-940)."""


class _Chunk:
    """One chunk copy into device memory: the device tensor, the event that
    completes with the copy (None on the CPU) and the latency-clock state
    (enqueue timestamp, target device index, whether it was sampled)."""

    __slots__ = ("arr", "event", "dev_idx", "t0", "sampled")

    def __init__(self, arr, event, dev_idx: int, t0: float) -> None:
        self.arr = arr
        self.event = event
        self.dev_idx = dev_idx
        self.t0 = t0
        self.sampled = False

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class TorchStagingPath:
    """Per-process staging state: device handles, per-rank device buffers for
    the write path, and in-flight copy tracking for the direct backend."""

    # blocks are split into chunks of this size (the original's transport-
    # tuned default, auto-tuned at preparation); EBT_TPU_CHUNK_BYTES pins it
    DEFAULT_CHUNK = 2 << 20

    def __init__(self, cfg: Config,
                 device: str | torch.device | None = None) -> None:
        if int(os.environ.get("EBT_TPU_SUBMITTERS", "0") or 0) > 0:
            raise ProgException(
                "EBT_TPU_SUBMITTERS>0 (threaded submitters): not yet ported "
                "(see ROADMAP.md)")
        self.devices = resolve_devices(cfg.tpu_ids, device)
        self.block_size = cfg.block_size
        self.direct = cfg.tpu_backend_name == "direct"
        env_chunk = os.environ.get("EBT_TPU_CHUNK_BYTES")
        self.chunk_bytes = int(env_chunk) if env_chunk else self.DEFAULT_CHUNK
        self._autotune_chunk = env_chunk is None
        self._lock = threading.Lock()
        # per-rank state; worker ranks are stable across a run
        self._dev_src: dict[int, torch.Tensor] = {}  # device write source
        self._last_h2d: dict[int, list[_Chunk]] = {}  # last staged block
        # direct mode: copies still reading a given engine buffer, keyed by
        # buffer address; drained by the engine's pre-reuse barrier
        self._pending: dict[int, list[_Chunk]] = {}
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._bytes_to_hbm = 0
        self._bytes_from_hbm = 0
        # On-device --verify: staged read chunks are checked in device
        # memory by the verify kernel; the engine skips its host
        # postReadCheck when dev_verify is set.
        self.verify_salt = cfg.verify_salt
        self.device_verify = bool(cfg.verify_salt) and not cfg.tpu_host_verify
        self.verify_errors: dict[int, str] = {}  # global rank -> message
        # Per-chip copy latency (enqueue -> event completion per chunk, both
        # directions). Completion is observed exactly where the path waits
        # (staged, verify, d2h), by the event.query() sweep on deferred
        # direct copies (resolution = one engine block interval), or at the
        # pre-reuse barrier as the upper-bound fallback.
        self._dev_lat: dict[int, LatencyHistogram] = {}
        self._lat_watch: list[_Chunk] = []
        # bumped by reset/close so a sweep that raced past the clear can't
        # re-insert prior-phase entries
        self._lat_gen = 0
        self._warm()

    # -------------------------------------------------- per-chip latency

    def _add_dev_sample(self, dev_idx: int, t0: float) -> None:
        us = int((time.perf_counter() - t0) * 1e6)
        with self._lock:
            h = self._dev_lat.get(dev_idx)
            if h is None:
                h = self._dev_lat[dev_idx] = LatencyHistogram()
            h.add(us)

    def _sample_chunk(self, c: _Chunk, gen: int | None = None) -> None:
        # test-and-set under the lock: the sweep (any rank's callback
        # thread) and the pre-reuse barrier can race to sample the same
        # chunk — exactly one wins; a sweep from before a phase reset
        # (stale `gen`) records nothing
        us = int((time.perf_counter() - c.t0) * 1e6)
        with self._lock:
            if c.sampled:
                return
            c.sampled = True
            if gen is not None and self._lat_gen != gen:
                return
            h = self._dev_lat.get(c.dev_idx)
            if h is None:
                h = self._dev_lat[c.dev_idx] = LatencyHistogram()
            h.add(us)

    def _sweep_latency_watch(self) -> None:
        """Resolve completion times of deferred direct copies whose event
        has fired; called at each engine callback."""
        with self._lock:
            watch, self._lat_watch = self._lat_watch, []
            gen = self._lat_gen
        keep = []
        for c in watch:
            if c.sampled:
                continue
            try:
                if c.ready():
                    self._sample_chunk(c, gen)
                else:
                    keep.append(c)
            except Exception:
                # failed copy: no latency sample, stop watching it
                with self._lock:
                    c.sampled = True
        if keep:
            with self._lock:
                if self._lat_gen == gen:
                    self._lat_watch.extend(keep)

    def reset_device_latency(self) -> None:
        """Phase boundary: per-chip latency is phase-scoped like the
        engine's other histograms."""
        with self._lock:
            self._dev_lat.clear()
            self._lat_watch.clear()
            self._lat_gen += 1

    def device_latency_histograms(self) -> dict[int, LatencyHistogram]:
        """Keys are indices into the selected device list (--gpuids
        order)."""
        with self._lock:
            return {i: LatencyHistogram().merge(h)
                    for i, h in self._dev_lat.items() if h.count}

    # ------------------------------------------------------------ set-up

    def _warm(self) -> None:
        """Device init, the side streams and the first copy happen here,
        during benchmark preparation, so the measured phase starts on a hot
        path; the chunk size is auto-tuned like the original's."""
        probe = np.zeros(min(self.chunk_bytes, 1 << 20), dtype=np.uint8)
        for i in range(len(self.devices)):
            self._put(probe, i).wait()
        if self._autotune_chunk and self.block_size > self.DEFAULT_CHUNK:
            self.chunk_bytes = self._pick_chunk_size()

    def _pick_chunk_size(self, probe_bytes: int = 24 << 20) -> int:
        """Time candidate chunk sizes on the first device and keep the
        fastest. Runs once per staging path, during preparation."""
        best_c, best_r = self.chunk_bytes, 0.0
        for c in (2 << 20, 4 << 20, 8 << 20):
            if c > self.block_size:
                continue
            src = np.zeros(c, dtype=np.uint8)
            self._put(src, 0).wait()
            n = max(2, probe_bytes // c)
            t0 = time.perf_counter()
            chunks = [self._put(src, 0) for _ in range(n)]
            for ch in chunks:
                ch.wait()
            rate = n * c / (time.perf_counter() - t0)
            if rate > best_r:
                best_c, best_r = c, rate
        return best_c

    # ------------------------------------------------------------------ util

    def _np_view(self, buf_ptr: int, length: int) -> np.ndarray:
        ptr = ctypes.cast(buf_ptr, ctypes.POINTER(ctypes.c_uint8))
        return np.ctypeslib.as_array(ptr, shape=(length,))

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        with self._lock:
            s = self._streams.get(device)
            if s is None:
                s = self._streams[device] = torch.cuda.Stream(device)
            return s

    def _copy_to_device(self, view: np.ndarray, device: torch.device,
                        dst: torch.Tensor | None = None):
        """Enqueue one host -> device copy of `view`, into `dst` when it is
        given; returns (tensor, event). On the CPU the source is
        snapshotted and there is no event."""
        src = torch.from_numpy(view)
        if device.type == "cpu":
            return (src.clone() if dst is None else dst.copy_(src)), None
        stream = self._stream(device)
        with torch.cuda.stream(stream):
            if dst is None:
                dst = torch.empty(src.numel(), dtype=torch.uint8,
                                  device=device)
            dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return dst, event

    def _put(self, view: np.ndarray, dev_idx: int,
             dst: torch.Tensor | None = None) -> _Chunk:
        """Copy `view` to the selected device dev_idx (an index into the
        --gpuids list, which is also the latency row's key)."""
        t0 = time.perf_counter()  # enqueue timestamp (latency clock)
        arr, event = self._copy_to_device(view, self.devices[dev_idx], dst)
        return _Chunk(arr, event, dev_idx, t0)

    def _write_source(self, rank: int, device, length: int) -> torch.Tensor:
        """Device-resident data used as the source for the write path (the
        benchmark writes 'data that lives in device memory' to storage, like
        the reference writes GPU-resident buffers). Content is rank-seeded
        random data with the original's generator and seed, so both
        packages write the same bytes."""
        src = self._dev_src.get(rank)
        if src is None or src.shape[0] < length:
            rng = np.random.default_rng(0xA5A5_A5A5 ^ (rank + 1))
            host = rng.integers(0, 256, max(length, self.block_size),
                                dtype=np.uint8)
            src = torch.from_numpy(host).to(device)
            with self._lock:
                self._dev_src[rank] = src
        return src

    def _chunk_views(self, view: np.ndarray) -> list[np.ndarray]:
        c = self.chunk_bytes
        return [view[i:i + c] for i in range(0, view.shape[0], c)]

    # ------------------------------------------------------ on-device verify

    def _raise_verify(self, arr: torch.Tensor, off: int, word: int) -> None:
        """Pinpoint the corrupt byte within the first bad u64 word of `arr`
        (staged at file offset `off`; device slice fetch) and raise with
        the exact file offset, like the host check (engine.cpp
        checkVerifyPattern)."""
        expect = (off + 8 * word + self.verify_salt) & ((1 << 64) - 1)
        got = bytes(arr[8 * word:8 * word + 8].cpu().numpy())
        bad_byte = 0
        for b in range(len(got)):
            if got[b] != ((expect >> (8 * b)) & 0xFF):
                bad_byte = b
                break
        raise VerifyFailure(
            "on-device data verification failed at file offset "
            f"{off + 8 * word + bad_byte}")

    def _on_copy_stream(self, device: torch.device):
        if device.type == "cpu":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream(device))

    def _staged_verify(self, rank: int, file_off: int, view: np.ndarray,
                       dev_idx: int) -> None:
        """Stage a block chunk by chunk into one device buffer and verify
        it with one kernel launch, whose result is read once. Runs
        synchronously on the engine's callback thread: --verify is a
        correctness mode, not a throughput mode. The kernel and the read
        are queued on the copy stream behind the block's chunk copies."""
        n = view.shape[0]
        n8 = (n // 8) * 8
        device = self.devices[dev_idx]
        chunks: list[_Chunk] = []
        try:
            with self._on_copy_stream(device):
                block = torch.empty(n, dtype=torch.uint8, device=device)
            c = self.chunk_bytes
            for s in range(0, n, c):
                chunks.append(self._put(view[s:s + c], dev_idx,
                                        block[s:s + c]))
            num_bad = first_bad = 0
            if n8:
                with self._on_copy_stream(device):  # read after the kernel
                    num_bad, first_bad = verify_block_u32(
                        block[:n8], file_off, self.verify_salt).tolist()
            with self._lock:
                self._last_h2d[rank] = chunks
                self._bytes_to_hbm += n
            if num_bad:
                self._raise_verify(block, file_off, first_bad)
            # sub-word tail (<8 bytes, only at the end of a file): checked
            # from the host view — too small for a launch
            expect = (file_off + n8 + self.verify_salt) & ((1 << 64) - 1)
            for b in range(n8, n):
                if view[b] != ((expect >> (8 * (b - n8))) & 0xFF):
                    raise VerifyFailure(
                        "on-device data verification failed at file "
                        f"offset {file_off + b}")
            # a block without a launch (under 8 bytes) may still be
            # copying — wait before the engine may reuse the buffer
            for c in chunks:
                c.wait()
                self._sample_chunk(c)
        except BaseException:
            # any failure can leave earlier chunks' copies still reading the
            # engine buffer — wait them all out before the error lets the
            # engine reuse or unmap it
            for c in chunks:
                try:
                    c.wait()
                except Exception:
                    pass
            raise

    # -------------------------------------------------------------- the hook

    def _barrier(self, buf_ptr: int) -> None:
        """Direction 2: wait for every pending copy of this buffer — ALL of
        them before raising, so a failed chunk never leaves siblings still
        reading a buffer the engine reuses as soon as we return."""
        with self._lock:
            waiting = self._pending.pop(buf_ptr, ())
        first_err = None
        failed_bytes = 0
        for c in waiting:
            try:
                c.wait()
                self._sample_chunk(c)  # upper-bound fallback
            except Exception as e:
                c.sampled = True  # failed: no latency sample
                failed_bytes += int(c.arr.numel())
                if first_err is None:
                    first_err = e
        if failed_bytes:
            with self._lock:  # undo the optimistic submit-time count
                self._bytes_to_hbm -= failed_bytes
        if first_err is not None:
            raise first_err

    def _to_device(self, rank: int, buf_ptr: int, view: np.ndarray,
                   dev_idx: int) -> None:
        """Directions 0/3 without --verify: staged waits for the block's
        copies, direct registers them for the pre-reuse barrier."""
        chunks: list[_Chunk] = []
        try:
            for v in self._chunk_views(view):
                chunks.append(self._put(v, dev_idx))
        except Exception:
            # chunks enqueued before the failure may still be reading the
            # engine buffer — register them so the barrier waits them out
            with self._lock:
                self._pending.setdefault(buf_ptr, []).extend(chunks)
            raise
        if self.direct:
            with self._lock:
                self._pending.setdefault(buf_ptr, []).extend(chunks)
                self._last_h2d[rank] = chunks
                self._lat_watch.extend(chunks)
                # counted at enqueue; a failure at the barrier subtracts
                # its chunk back out
                self._bytes_to_hbm += view.shape[0]
            return
        for c in chunks:
            c.wait()
            self._sample_chunk(c)
        with self._lock:
            self._last_h2d[rank] = chunks
            self._bytes_to_hbm += view.shape[0]

    def _from_device(self, rank: int, view: np.ndarray,
                     dev_idx: int) -> None:
        """Direction 1: serve the block just staged (round-trip mode),
        else the rank-seeded write source, which lives on the rank's
        device."""
        t0 = time.perf_counter()
        host = torch.from_numpy(view)
        arrs = self.last_staged_arrays(rank)
        if arrs is not None and sum(a.shape[0] for a in arrs) == view.shape[0]:
            # round-trip mode (verify): serve back the block that was just
            # staged, preserving its contents byte-exactly
            pos = 0
            for a in arrs:
                n = a.shape[0]
                host[pos:pos + n].copy_(a)
                pos += n
        else:
            src = self._write_source(rank, self.devices[dev_idx],
                                     view.shape[0])
            host.copy_(src[:view.shape[0]])
        # d2h leg latency, attributed to the serving chip (synchronous
        # copy: the sample is exact)
        self._add_dev_sample(dev_idx, t0)
        with self._lock:
            self._bytes_from_hbm += view.shape[0]

    def copy(self, rank: int, dev_idx: int, direction: int, buf_ptr: int,
             length: int, file_off: int) -> int:
        try:
            self._sweep_latency_watch()
            # the engine assigns rank % num_devices; one side stream per
            # device, one latency row per --gpuids entry
            dev_idx %= len(self.devices)
            if direction == 2:  # engine is about to overwrite this buffer
                self._barrier(buf_ptr)
                return 0
            view = self._np_view(buf_ptr, length)
            if direction in (0, 3):  # host -> device (3 = write round-trip)
                if self.device_verify and direction == 0:
                    # only storage reads are verified on device; the write
                    # round-trip stages a pattern the host just generated
                    self._staged_verify(rank, file_off, view, dev_idx)
                else:
                    self._to_device(rank, buf_ptr, view, dev_idx)
            else:  # device -> host (write path source)
                self._from_device(rank, view, dev_idx)
            return 0
        except VerifyFailure as e:
            # recorded per rank so the framework can surface the exact
            # corrupt offset instead of the engine's generic rc message
            self.verify_errors[rank] = str(e)
            print(f"GPU verify error (rank {rank}): {e}", file=sys.stderr)
            return 2
        except Exception as e:  # propagated as a worker error by the engine
            print(f"GPU copy error (rank {rank}): {e}", file=sys.stderr)
            return 1

    def last_staged_arrays(self, rank: int) -> list | None:
        """Device tensors of the most recent h2d block for a rank (waits
        for in-flight direct-mode copies). Used by verify flows and tests."""
        last = self._last_h2d.get(rank)
        if last is None:
            return None
        for c in last:
            c.wait()
        return [c.arr for c in last]

    def close(self) -> None:
        """Wait out every in-flight copy (errors are swallowed: this is the
        cleanup path). The path can be reused afterwards."""
        with self._lock:
            waiting = [c for q in self._pending.values() for c in q]
            self._pending.clear()
            self._lat_watch.clear()
            self._lat_gen += 1
        for c in waiting:
            try:
                c.wait()
            except Exception:
                pass

    @property
    def transferred_bytes(self) -> tuple[int, int]:
        return self._bytes_to_hbm, self._bytes_from_hbm


def make_dev_callback(cfg: Config, device: str | torch.device | None = None):
    """Build the per-block device-copy callback for the native engine."""
    path = TorchStagingPath(cfg, device)

    def callback(rank: int, dev_idx: int, direction: int, buf_ptr: int,
                 length: int, file_off: int) -> int:
        return path.copy(rank, dev_idx, direction, buf_ptr, length, file_off)

    callback.staging_path = path
    return callback
