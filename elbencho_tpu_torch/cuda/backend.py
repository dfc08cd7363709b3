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

            Submission is inline on the engine's callback thread by
            default. EBT_TPU_SUBMITTERS=N>0 hands the copies to N submitter
            threads instead (the default with --tpustripe: one per device,
            2 to 8), each with its own stream per device; a submitter keeps
            PIPELINE_DEPTH blocks in flight and takes each copy's completion
            from the event recorded behind it.
  hostsim - handled natively in the engine (no device), for CI.

Placement across devices:
  --tpustripe  each block's chunks rotate over the selected devices (one
               submitter work item per chunk on direct);
  --stripe     (staged) the mesh fallback of the native stripe planner:
               each read block is split into contiguous per-device slices,
               the tail on the last device, copied and waited for.

On the CPU device, which the caller must ask for (EBT_TORCH_DEVICE=cpu or
device="cpu"), a chunk is snapshotted with clone(): a tensor made with
from_numpy aliases the engine buffer, which the engine reuses.

With --verify, each staged read block is copied chunk by chunk into one
device buffer and checked by one launch of the verify kernel
(ops/verify_kernel.py, csrc/verify.cu), whose result is read once per
block; under --tpustripe each chunk is copied to and checked on its own
device, one launch per chunk.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from ..config import Config
from ..histogram import LatencyHistogram
from ..logger import LOGGER
from ..ops.verify_kernel import verify_block_u32
from .devices import resolve_devices


# Process-global GIL switch-interval management for the threaded submitter
# mode: refcounted so overlapping staging paths (or reuse after close()) save
# and restore the true original interval exactly once.
_SWITCH_LOCK = threading.Lock()
_SWITCH_DEPTH = 0
_SWITCH_SAVED: float | None = None


def _tighten_switch_interval() -> None:
    global _SWITCH_DEPTH, _SWITCH_SAVED
    with _SWITCH_LOCK:
        if _SWITCH_DEPTH == 0:
            _SWITCH_SAVED = sys.getswitchinterval()
            sys.setswitchinterval(0.0005)
        _SWITCH_DEPTH += 1


def _restore_switch_interval() -> None:
    global _SWITCH_DEPTH, _SWITCH_SAVED
    with _SWITCH_LOCK:
        if _SWITCH_DEPTH == 0:
            return
        _SWITCH_DEPTH -= 1
        if _SWITCH_DEPTH == 0 and _SWITCH_SAVED is not None:
            sys.setswitchinterval(_SWITCH_SAVED)
            _SWITCH_SAVED = None


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


class _Xfer:
    """One submitter work item: a block's chunk copies (or, when striping,
    one chunk's), submitted by a submitter thread, done when all landed."""

    __slots__ = ("views", "targets", "chunks", "done", "error", "t0")

    def __init__(self, views, targets) -> None:
        self.views = views          # numpy views into the engine buffer
        self.targets = targets      # selected-device index per chunk
        self.chunks: list[_Chunk] = []
        self.done = threading.Event()
        self.error: Exception | None = None
        self.t0 = time.perf_counter()  # enqueue timestamp (latency clock)


class TorchStagingPath:
    """Per-process staging state: device handles, per-rank device buffers for
    the write path, and in-flight copy tracking for the direct backend."""

    # blocks are split into chunks of this size (the original's transport-
    # tuned default, auto-tuned at preparation); EBT_TPU_CHUNK_BYTES pins it
    DEFAULT_CHUNK = 2 << 20
    # blocks a submitter keeps in flight before it waits for the oldest
    PIPELINE_DEPTH = 6

    def __init__(self, cfg: Config,
                 device: str | torch.device | None = None) -> None:
        self.devices = resolve_devices(cfg.tpu_ids, device)
        self.block_size = cfg.block_size
        self.direct = cfg.tpu_backend_name == "direct"
        self.stripe = bool(cfg.tpu_stripe) and len(self.devices) > 1
        # --stripe mesh fallback (staged backend): each read block fills
        # the whole device set as contiguous per-device slices. The native
        # pjrt backend owns the planner/scatter/gather subsystem; this keeps
        # the slice-wide fill semantics on the staged backend.
        self.mesh_stripe = bool(cfg.stripe_policy) and \
            len(self.devices) > 1 and not self.direct
        if self.mesh_stripe:
            # the fallback is policy-agnostic (every block is split evenly
            # over the devices); rr-vs-contig placement is a native pjrt
            # planner concept — say so instead of letting an A/B on this
            # backend silently measure the same thing twice
            LOGGER.info(
                f"mesh-striped fill (staged fallback): each block is "
                f"device_put over a sharding tree spanning "
                f"{len(self.devices)} devices; the "
                f"{cfg.stripe_policy!r} placement policy applies to the "
                "native pjrt backend only")
        env_chunk = os.environ.get("EBT_TPU_CHUNK_BYTES")
        self.chunk_bytes = int(env_chunk) if env_chunk else self.DEFAULT_CHUNK
        self._autotune_chunk = env_chunk is None
        self._batch_blocks = os.environ.get("EBT_TPU_BATCH") != "0"
        # inline submission is the default; striping keeps a thread pool so
        # chunks land on the devices' streams in parallel
        default_submitters = 0
        if self.stripe:
            default_submitters = min(max(len(self.devices), 2), 8)
        self.num_submitters = max(0, int(os.environ.get(
            "EBT_TPU_SUBMITTERS", str(default_submitters)) or 0))
        self.inline_submit = self.direct and self.num_submitters == 0
        # threaded mode: callback and submitter threads hand blocks off on
        # few cores; the default 5 ms GIL switch interval can stall a
        # handoff for longer than a block's copy takes. Held while the
        # submitters run, released in close().
        self._switch_held = False
        self._lock = threading.Lock()
        self._tls = threading.local()  # .submitter: a submitter's index
        # per-rank state; worker ranks are stable across a run
        self._dev_src: dict[int, torch.Tensor] = {}  # device write source
        self._last_h2d: dict[int, list] = {}  # last staged block's chunks
        # direct mode: copies (chunks, or submitter work items) still
        # reading a given engine buffer, keyed by buffer address; drained
        # by the engine's pre-reuse barrier
        self._pending: dict[int, list] = {}
        self._submitq: queue.Queue | None = None
        self._submitters: list[threading.Thread] = []
        # (submitter, selected-device index) -> stream; -1 = the callback
        # threads. Keyed by index, so two lanes on one card (--gpuids 0,0)
        # get a stream each.
        self._streams: dict[tuple[int, int], torch.cuda.Stream] = {}
        self._bytes_to_hbm = 0
        self._bytes_from_hbm = 0
        # host -> device bytes per selected device
        self._dev_bytes = [0] * len(self.devices)
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
        self._add_dev_us(dev_idx, int((time.perf_counter() - t0) * 1e6))

    def _add_dev_us(self, dev_idx: int, us: int) -> None:
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
        path; the chunk size is auto-tuned like the original's, and the
        submitter threads of the threaded mode start here too."""
        probe = np.zeros(min(self.chunk_bytes, 1 << 20), dtype=np.uint8)
        for i in range(len(self.devices)):
            self._put(probe, i).wait()
        if self._autotune_chunk and self.block_size > self.DEFAULT_CHUNK:
            self.chunk_bytes = self._pick_chunk_size()
        if self.direct and not self.inline_submit:
            with self._lock:
                if self._submitq is None:
                    self._start_submitters_locked()

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

    def _stream(self, dev_idx: int) -> torch.cuda.Stream:
        """The calling thread's stream for selected device dev_idx: each
        submitter thread has its own per device, the callback threads
        share one per device."""
        key = (getattr(self._tls, "submitter", -1), dev_idx)
        with self._lock:
            s = self._streams.get(key)
            if s is None:
                s = self._streams[key] = torch.cuda.Stream(
                    self.devices[dev_idx])
            return s

    def _copy_to_device(self, view: np.ndarray, dev_idx: int,
                        dst: torch.Tensor | None = None):
        """Enqueue one host -> device copy of `view` to selected device
        dev_idx, into `dst` when it is given, on the calling thread's
        stream; returns (tensor, event recorded behind the copy). On the
        CPU the source is snapshotted and there is no event."""
        src = torch.from_numpy(view)
        device = self.devices[dev_idx]
        if device.type == "cpu":
            return (src.clone() if dst is None else dst.copy_(src)), None
        stream = self._stream(dev_idx)
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
        arr, event = self._copy_to_device(view, dev_idx, dst)
        return _Chunk(arr, event, dev_idx, t0)

    def _count_h2d(self, chunks: list[_Chunk]) -> None:
        """Count the chunks' bytes (total and per device); the caller
        holds the lock."""
        for c in chunks:
            n = int(c.arr.numel())
            self._bytes_to_hbm += n
            self._dev_bytes[c.dev_idx] += n

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

    def _chunk_plan(self, view: np.ndarray,
                    dev_idx: int) -> tuple[list[np.ndarray], list[int]]:
        """Split a block view into transfer chunks and the selected-device
        index each one targets: the rank's device, or under --tpustripe
        the devices in turn."""
        c = self.chunk_bytes
        views = [view[i:i + c] for i in range(0, view.shape[0], c)]
        if self.stripe:
            n = len(self.devices)
            targets = [j % n for j in range(len(views))]
        else:
            targets = [dev_idx] * len(views)
        return views, targets

    # ----------------------------------------------- mesh-striped fallback

    def _mesh_stripe_put(self, rank: int, view: np.ndarray) -> None:
        """One read block -> the whole device set as one coordinated
        transfer: contiguous per-device slices, the tail remainder on the
        last device (the original's sharding-tree form). Blocking like the
        staged path; bytes and per-chip latency are accounted per
        device."""
        ndev = len(self.devices)
        n = view.shape[0]
        t0 = time.perf_counter()
        per = n // ndev
        bounds = [(i * per, (i + 1) * per) for i in range(ndev - 1)]
        bounds.append(((ndev - 1) * per, n))
        chunks: list[_Chunk] = []
        try:
            for i, (a, b) in enumerate(bounds):
                chunks.append(self._put(view[a:b], i))
        finally:
            for c in chunks:  # also after a failure: the buffer is reused
                c.wait()
        with self._lock:
            self._last_h2d[rank] = chunks
            self._count_h2d(chunks)
        for i in range(ndev):
            self._add_dev_sample(i, t0)

    # ------------------------------------------------- direct-mode submitters

    def _start_submitters_locked(self) -> None:
        if not self._switch_held:
            _tighten_switch_interval()
            self._switch_held = True
        q: queue.Queue = queue.Queue()
        for i in range(self.num_submitters):
            t = threading.Thread(target=self._submit_loop, args=(q, i),
                                 name=f"ebt-gpu-submit-{i}", daemon=True)
            t.start()
            self._submitters.append(t)
        self._submitq = q

    def _submit(self, rank: int, buf_ptr: int, xfers: list[_Xfer]) -> None:
        """Register + enqueue work items atomically w.r.t. close(): the
        queue swap in close() takes the same lock, so every item enqueued
        here is ahead of close()'s sentinels and will be processed."""
        with self._lock:
            if self._submitq is None:
                self._start_submitters_locked()
            self._pending.setdefault(buf_ptr, []).extend(xfers)
            self._last_h2d[rank] = xfers
            for x in xfers:
                self._submitq.put(x)

    def _complete(self, xfer: _Xfer) -> None:
        """Wait for a work item's copies (each chunk's event, in order) and
        account it: each chunk's latency sample spans the item's enqueue to
        that chunk's completion, and samples and bytes are recorded only
        once the whole item proved clean."""
        try:
            stamps = []
            for c in xfer.chunks:
                c.wait()
                stamps.append((c.dev_idx, time.perf_counter()))
            with self._lock:
                self._count_h2d(xfer.chunks)
            for di, t1 in stamps:
                self._add_dev_us(di, int((t1 - xfer.t0) * 1e6))
        except Exception as e:
            xfer.error = e
        finally:
            xfer.done.set()

    def _submit_loop(self, q: queue.Queue, idx: int) -> None:
        self._tls.submitter = idx  # this thread's own streams
        inflight: list[_Xfer] = []
        while True:
            if inflight:
                try:
                    xfer = q.get_nowait()
                except queue.Empty:
                    self._complete(inflight.pop(0))
                    continue
            else:
                xfer = q.get()
            if xfer is None:
                for x in inflight:
                    self._complete(x)
                return
            try:
                for v, d in zip(xfer.views, xfer.targets):
                    xfer.chunks.append(self._put(v, d))
            except Exception as e:
                # copies enqueued before the failure may still read the
                # engine buffer: wait them out before the barrier may
                # release it
                for c in xfer.chunks:
                    try:
                        c.wait()
                    except Exception:
                        pass
                xfer.error = e
                xfer.done.set()
                continue
            inflight.append(xfer)
            while len(inflight) > self.PIPELINE_DEPTH:
                self._complete(inflight.pop(0))

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

    def _on_copy_stream(self, dev_idx: int):
        if self.devices[dev_idx].type == "cpu":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream(dev_idx))

    def _staged_verify(self, rank: int, file_off: int, view: np.ndarray,
                       views: list[np.ndarray], targets: list[int]) -> None:
        """Stage a block and verify it on the device(s) it landed on. Runs
        synchronously on the engine's callback thread: --verify is a
        correctness mode, not a throughput mode. Consecutive chunks bound
        for one device form a segment: its chunks are copied into one
        device buffer, checked by one kernel launch queued on the copy
        stream behind them, and the result read once. Without --tpustripe
        the block is one segment; with it each chunk is its own segment,
        checked on its own device. Every launch is queued before the first
        result is read."""
        segments: list[tuple[int, int, int]] = []  # (start, end, device)
        pos = 0
        for v, t in zip(views, targets):
            if segments and segments[-1][2] == t:
                segments[-1] = (segments[-1][0], pos + v.shape[0], t)
            else:
                segments.append((pos, pos + v.shape[0], t))
            pos += v.shape[0]
        chunks: list[_Chunk] = []
        # (segment buffer, its file offset, result or None, device)
        checks = []
        try:
            c = self.chunk_bytes
            for a, b, t in segments:
                with self._on_copy_stream(t):
                    buf = torch.empty(b - a, dtype=torch.uint8,
                                      device=self.devices[t])
                for s in range(a, b, c):
                    e = min(s + c, b)
                    chunks.append(self._put(view[s:e], t, buf[s - a:e - a]))
                n8 = (b - a) // 8 * 8
                res = None
                if n8:
                    with self._on_copy_stream(t):
                        res = verify_block_u32(buf[:n8], file_off + a,
                                               self.verify_salt)
                checks.append((buf, file_off + a, res, t))
            with self._lock:
                self._last_h2d[rank] = chunks
                self._count_h2d(chunks)
            for buf, off, res, t in checks:
                if res is None:
                    continue
                # read on the copy stream, behind the kernel: the current
                # stream is not ordered after it, and a read there can find
                # the result buffer before the kernel wrote it (a previous
                # block's result, or none)
                with self._on_copy_stream(t):
                    num_bad, first_bad = res.tolist()
                    if num_bad:
                        self._raise_verify(buf, off, first_bad)
            # sub-word tail (<8 bytes, only at the end of a file): checked
            # from the host view — too small for a launch
            n = view.shape[0]
            a = segments[-1][0] if segments else 0
            n8 = a + (n - a) // 8 * 8
            expect = (file_off + n8 + self.verify_salt) & ((1 << 64) - 1)
            for b in range(n8, n):
                if view[b] != ((expect >> (8 * (b - n8))) & 0xFF):
                    raise VerifyFailure(
                        "on-device data verification failed at file "
                        f"offset {file_off + b}")
            # a segment without a launch (under 8 bytes) may still be
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
        for x in waiting:
            if isinstance(x, _Xfer):
                # counted on success by its submitter: nothing to undo
                x.done.wait()
                if x.error is not None and first_err is None:
                    first_err = x.error
                continue
            try:
                x.wait()
                self._sample_chunk(x)  # upper-bound fallback
            except Exception as e:
                x.sampled = True  # failed: no latency sample
                failed_bytes += int(x.arr.numel())
                with self._lock:
                    self._dev_bytes[x.dev_idx] -= int(x.arr.numel())
                if first_err is None:
                    first_err = e
        if failed_bytes:
            with self._lock:  # undo the optimistic submit-time count
                self._bytes_to_hbm -= failed_bytes
        if first_err is not None:
            raise first_err

    def _to_device(self, rank: int, buf_ptr: int, views: list[np.ndarray],
                   targets: list[int]) -> None:
        """Directions 0/3 without --verify: staged waits for the block's
        copies; direct registers them for the pre-reuse barrier, inline
        or through the submitter threads."""
        if self.direct and not self.inline_submit:
            if self.stripe or not self._batch_blocks:
                # one work item per chunk, so chunks fan out across the
                # submitters (parallel per-device copies)
                xfers = [_Xfer([v], [t]) for v, t in zip(views, targets)]
            else:
                # one work item for the block: one queue handoff and one
                # submitter wakeup per block instead of per chunk
                xfers = [_Xfer(views, targets)]
            self._submit(rank, buf_ptr, xfers)
            return
        chunks: list[_Chunk] = []
        try:
            for v, t in zip(views, targets):
                chunks.append(self._put(v, t))
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
                self._count_h2d(chunks)
            return
        for c in chunks:
            c.wait()
            self._sample_chunk(c)
        with self._lock:
            self._last_h2d[rank] = chunks
            self._count_h2d(chunks)

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
                if self.mesh_stripe and direction == 0 and \
                        not self.device_verify:
                    # --stripe mesh fallback: the block fills the whole
                    # device set (verify mode keeps the per-chunk staged
                    # path: the check runs per segment on one device)
                    self._mesh_stripe_put(rank, view)
                    return 0
                views, targets = self._chunk_plan(view, dev_idx)
                if self.device_verify and direction == 0:
                    # only storage reads are verified on device; the write
                    # round-trip stages a pattern the host just generated
                    self._staged_verify(rank, file_off, view, views, targets)
                else:
                    self._to_device(rank, buf_ptr, views, targets)
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
        chunks: list[_Chunk] = []
        for x in last:
            if isinstance(x, _Xfer):
                x.done.wait()
                if x.error is not None:
                    raise x.error
                chunks.extend(x.chunks)
            else:
                chunks.append(x)
        for c in chunks:
            c.wait()
        return [c.arr for c in chunks]

    def device_bytes(self) -> list[int]:
        """Host -> device bytes per selected device (--gpuids order)."""
        with self._lock:
            return list(self._dev_bytes)

    def _drain(self) -> None:
        """Wait out every in-flight copy (errors are swallowed: this is the
        cleanup path)."""
        with self._lock:
            waiting = [x for q in self._pending.values() for x in q]
            self._pending.clear()
            self._lat_watch.clear()
            self._lat_gen += 1
        for x in waiting:
            if isinstance(x, _Xfer):
                x.done.wait()
                continue
            try:
                x.wait()
            except Exception:
                pass

    def close(self) -> None:
        """Drain in-flight copies and stop the submitter threads. The path
        can be reused afterwards (threads restart on the next submission).
        Safe against concurrent copy(): submissions hold the same lock as
        the queue swap below, so they either land ahead of the sentinels
        (and are processed before the threads exit) or start a fresh
        pool."""
        self._drain()
        with self._lock:
            q, threads = self._submitq, self._submitters
            self._submitq, self._submitters = None, []
            if q is not None:
                for _ in threads:
                    q.put(None)
        for t in threads:
            t.join()
        self._drain()  # anything submitted while the queue was swapped
        if self._switch_held:
            _restore_switch_interval()
            self._switch_held = False

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
