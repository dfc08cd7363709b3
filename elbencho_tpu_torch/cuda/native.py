"""Native CUDA transfer path: driver resolution + ctypes wrapper.

`--tpubackend pjrt` routes the storage <-> GPU data path through the port's
C++ transfer engine (csrc/cuda_path.cpp), which drives the card through the
CUDA driver API with no Python on the hot path. The flag keeps the original
package's name for CLI and result-tree parity; this module is the port's
counterpart of the original's tpu/native.py (NativePjrtPath) with its
stripe-tier, checkpoint-restore, reshard, serving-rotation and ingest
ledgers, its device fault policy, its transfer-manager tier and its
in-session raw transport ceilings.

This module resolves WHICH driver library the engine loads, makes sure the
kernel library is built when on-device verify or write generation is on,
and hands the engine's C function pointer to the storage engine:

  - on the card: EBT_CUDA_DRIVER if set, else libcuda.so.1 (the driver
    PyTorch's runtime uses in the same process); the kernels come from
    build/torch_kernels/libebt_torch_kernels.so (ops/kernel_build.py).
  - with EBT_TORCH_DEVICE=cpu: EBT_CUDA_DRIVER must name a library (the
    tests name the mock driver, build/torch_core/libebtcudamock.so, which
    also exports the kernels' C entries as their plain host versions).
    Nothing picks a CPU stand-in by itself.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..config import Config
from ..engine import load_lib
from ..exceptions import ProgException
from .devices import NO_CUDA_MESSAGE, requested_device_type

DEFAULT_DRIVER = "libcuda.so.1"


def resolve_driver() -> str:
    """The driver library the engine loads (see the module docstring)."""
    explicit = os.environ.get("EBT_CUDA_DRIVER", "")
    kind = requested_device_type()
    if kind == "cpu":
        if not explicit:
            raise ProgException(
                "--tpubackend pjrt with EBT_TORCH_DEVICE=cpu needs "
                "EBT_CUDA_DRIVER to name a driver library (for example the "
                "mock, build/torch_core/libebtcudamock.so)")
        return explicit
    if kind != "cuda":
        raise ProgException(
            f"unsupported device type {kind!r} (expected cuda or cpu)")
    if not torch.cuda.is_available():
        raise ProgException(NO_CUDA_MESSAGE)
    return explicit or DEFAULT_DRIVER


def kernel_launches() -> dict[str, int]:
    """Kernel launches the native engine made, over every path of the
    process since the last reset_kernel_launches() (the C++ counterpart of
    the Python wrappers' LAUNCHES)."""
    out = (ctypes.c_uint64 * 2)()
    load_lib().ebt_cuda_kernel_launches(out)
    return {"verify_u32": out[0], "fill_u64": out[1]}


def reset_kernel_launches() -> None:
    load_lib().ebt_cuda_reset_kernel_launches()


def _chunk_bytes() -> int:
    return int(os.environ.get("EBT_TPU_CHUNK_BYTES", 0) or 0)


class NativeCudaPath:
    """Owns one native CudaPath handle; exposes the raw DevCopyFn pointer
    and context for ebt_engine_set_dev_callback."""

    def __init__(self, cfg: Config) -> None:
        self._lib = load_lib()
        self._ingest_record_size = 0  # set by set_ingest_plan
        self.so_path = resolve_driver()
        nids = len(cfg.tpu_ids)
        ids = (ctypes.c_int * max(1, nids))(*cfg.tpu_ids)
        err = ctypes.create_string_buffer(1024)
        self._h = self._lib.ebt_cuda_create(
            self.so_path.encode(), _chunk_bytes(), cfg.block_size,
            1 if cfg.tpu_stripe else 0, ids, nids, err, len(err))
        if not self._h:
            raise ProgException(
                f"CUDA driver init failed ({self.so_path}): "
                f"{err.value.decode()}")

    def _kernel_lib(self) -> str:
        """The library exporting the kernels' C entries: on the CPU the mock
        driver itself, on the card the nvcc-built kernel library."""
        if requested_device_type() == "cpu":
            return self.so_path
        from ..ops.kernel_build import library

        return library()

    def _enable(self, enable_fn, salt: int, feature: str) -> None:
        err = ctypes.create_string_buffer(1024)
        if enable_fn(self._h, salt, self._kernel_lib().encode(), err,
                     len(err)) != 0:
            raise ProgException(f"{feature} unavailable: "
                                f"{err.value.decode()}")

    def enable_device_verify(self, cfg: Config) -> None:
        """Read blocks are checked on the device by the verify kernel
        (csrc/verify.cu), launched by the engine once per block."""
        self._enable(self._lib.ebt_cuda_enable_verify, cfg.verify_salt,
                     "on-device verify")

    def enable_device_write_gen(self, cfg: Config) -> None:
        """Verified writes source a pattern the fill kernel (csrc/fill.cu)
        generates in device memory, fetched to the host buffer."""
        self._enable(self._lib.ebt_cuda_enable_write_gen, cfg.verify_salt,
                     "device write generation")

    @property
    def num_devices(self) -> int:
        return self._lib.ebt_cuda_num_devices(self._h)

    # ---- registered-buffer tier (cuMemHostRegister; field names keep the
    # original's "zero-copy") ----

    @property
    def dma_supported(self) -> bool:
        """Registration probed at init (one register/unregister round
        trip) and not disabled by EBT_PJRT_NO_DMAMAP."""
        return bool(self._lib.ebt_cuda_dma_supported(self._h))

    def register_buffer(self, addr: int, length: int) -> bool:
        """Pin [addr, addr+length); False = staged fallback (cause in
        reg_error()). The engine drives this itself via DevCopyFn
        direction 4 — this export is for tests."""
        return self._lib.ebt_cuda_register(self._h, addr, length) == 0

    def deregister_buffer(self, addr: int) -> bool:
        return self._lib.ebt_cuda_deregister(self._h, addr) == 0

    def reg_error(self) -> str:
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_reg_error(self._h, buf, len(buf))
        return buf.value.decode()

    @property
    def zero_copy_count(self) -> int:
        """Chunks copied from registered (pinned) host memory so far."""
        return self._lib.ebt_cuda_zero_copy_count(self._h)

    @property
    def zero_copy_engaged(self) -> bool:
        """True when hot-path copies from registered memory take the
        registered tier (capability, not the transfer-manager tier and not
        the NO_READY diagnostic)."""
        return bool(self._lib.ebt_cuda_zero_copy_engaged(self._h))

    # ---- transfer-manager tier (EBT_PJRT_XFER_MGR) ----

    @property
    def xfer_mgr_active(self) -> bool:
        """Opt-in transfer-manager tier (EBT_PJRT_XFER_MGR=1, no
        --tpustripe, memory pools on every lane's device) that passed its
        init probe: one cuMemAllocAsync device buffer per block, the
        block's chunks copied into it. A downgrade leaves its cause in
        reg_error()."""
        return bool(self._lib.ebt_cuda_xfer_mgr(self._h))

    @property
    def xfer_mgr_count(self) -> int:
        """Blocks the hot path submitted through the transfer-manager
        tier (reset after the init probe, so no base to subtract)."""
        return self._lib.ebt_cuda_xfer_mgr_count(self._h)

    def set_reg_window(self, nbytes: int) -> None:
        """Byte budget of the bounded-registration LRU pin cache
        (--regwindow); 0 = unbounded."""
        self._lib.ebt_cuda_set_reg_window(self._h, int(nbytes))

    def reg_cache_stats(self) -> dict[str, int]:
        """Registration-cache counters: hits/misses/evictions, current and
        peak pinned bytes, and staged_fallbacks (window registrations that
        ended on the staged path)."""
        out = (ctypes.c_uint64 * 6)()
        self._lib.ebt_cuda_reg_cache_stats(self._h, out)
        return {"hits": out[0], "misses": out[1], "evictions": out[2],
                "pinned_bytes": out[3], "pinned_peak_bytes": out[4],
                "staged_fallbacks": out[5]}

    # ---- deferred D2H ----

    def set_d2h_depth(self, depth: int) -> None:
        """--d2hdepth: > 1 makes direction-1 fetches enqueue under the
        buffer's pending queue (awaited at the engine's pre-write barrier);
        1 keeps the serial fetch-then-write path."""
        self._lib.ebt_cuda_set_d2h_depth(self._h, int(depth))

    def d2h_stats(self) -> dict[str, int]:
        """Blocks submitted via the deferred engine, nanoseconds the
        pre-write barriers blocked, and bytes whose fetch had completed
        before its barrier started. Session-cumulative."""
        out = (ctypes.c_uint64 * 3)()
        self._lib.ebt_cuda_d2h_stats(self._h, out)
        return {"deferred_count": out[0], "await_wait_ns": out[1],
                "overlap_bytes": out[2]}

    # ---- stripe tier (--stripe) ----
    #
    # The engine's stripe planner maps each read block's file offset onto a
    # lane (round-robin or contiguous runs over stripe units), the lanes
    # copy the blocks concurrently, and the engine's direction-8 gather
    # barrier awaits every lane's pending units at the end of the read
    # phase: one file's block range fills every selected device.

    # the policy names of the config and their codes in the native plan
    STRIPE_POLICIES = {"rr": 1, "contig": 2}

    def set_stripe_plan(self, policy: str, total_blocks: int,
                        unit_blocks: int) -> None:
        """Install the stripe plan (before any transfer: the plan is read
        lock-free on the hot path). unit_blocks is the placement
        granularity in blocks, sized by the config so a unit never splits
        a --regwindow registration span."""
        code = self.STRIPE_POLICIES.get(policy)
        if code is None:
            raise ProgException(f"unknown stripe policy: {policy!r}")
        rc = self._lib.ebt_cuda_set_stripe_plan(
            self._h, code, int(total_blocks), int(unit_blocks))
        if rc != 0:
            raise ProgException(
                f"stripe plan rejected (policy={policy}, "
                f"blocks={total_blocks}, unit={unit_blocks}): the plan "
                "must precede the first transfer and cover >= 1 block")

    def stripe_device_for(self, file_offset: int) -> int:
        """The planner's lane for the block at file_offset, -1 when no
        stripe plan is active."""
        return self._lib.ebt_cuda_stripe_device_for(self._h,
                                                    int(file_offset))

    def stripe_stats(self) -> dict[str, int]:
        """Planner-routed block submissions, settled units, the gather
        barriers' await time and their count. Session-cumulative; per-lane
        fill bytes ride lane_stats() to_hbm."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.ebt_cuda_stripe_stats(self._h, out)
        return {"units_submitted": out[0], "units_awaited": out[1],
                "barrier_wait_ns": out[2], "barriers": out[3]}

    def stripe_barrier(self) -> bool:
        """Run the gather barrier explicitly (the engine's read workers run
        it as direction 8). False = a unit failed; cause in
        stripe_error()."""
        return self._lib.ebt_cuda_stripe_barrier(self._h) == 0

    def stripe_error(self) -> str:
        """First failed unit with its lane ("device N unit U: cause");
        empty when none."""
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_stripe_error(self._h, buf, len(buf))
        return buf.value.decode()

    # ---- checkpoint-restore ledger (--checkpoint) ----
    #
    # The engine owns shard->device placement (it submits each shard's
    # blocks to the manifest lanes); this ledger supplies the evidence:
    # per-shard submitted/resident byte reconciliation at the direction-10
    # all-resident barrier, shards_resident, resident bytes per lane and
    # "device N shard S: cause" attribution.

    def set_ckpt_plan(self, shards) -> None:
        """Install the restore plan before any transfer. `shards` is the
        config's CheckpointShard list (devices resolved, bytes known); a
        replicated shard contributes one entry per replica lane."""
        entries = [(i, d, s.bytes)
                   for i, s in enumerate(shards) for d in s.devices]
        n = len(entries)
        sh = (ctypes.c_int * n)(*[e[0] for e in entries])
        dv = (ctypes.c_int * n)(*[e[1] for e in entries])
        by = (ctypes.c_uint64 * n)(*[e[2] for e in entries])
        rc = self._lib.ebt_cuda_set_ckpt_plan(self._h, len(shards), sh, dv,
                                              by, n)
        if rc != 0:
            raise ProgException(
                f"checkpoint plan rejected ({len(shards)} shards, {n} "
                "placement entries): the plan must precede the first "
                "transfer and every entry must name an in-range shard/"
                "device with nonzero bytes")

    def ckpt_stats(self) -> dict[str, int]:
        """Manifest shard count, shards whose resident bytes equal the
        plan's (x replicas), the all-resident barriers' await time and
        their count. Session-cumulative."""
        out = (ctypes.c_uint64 * 4)()
        self._lib.ebt_cuda_ckpt_stats(self._h, out)
        return {"shards_total": out[0], "shards_resident": out[1],
                "resident_wait_ns": out[2], "barriers": out[3]}

    def ckpt_byte_totals(self) -> tuple[int, int]:
        """(submitted, resident) restore bytes; equal once every
        all-resident barrier returned clean."""
        out = (ctypes.c_uint64 * 2)()
        self._lib.ebt_cuda_ckpt_byte_totals(self._h, out)
        return out[0], out[1]

    def ckpt_dev_bytes(self) -> list[int]:
        """Resident checkpoint bytes per lane (selected-device order)."""
        n = self.num_devices
        out = (ctypes.c_uint64 * max(1, n))()
        got = self._lib.ebt_cuda_ckpt_dev_bytes(self._h, out, n)
        return [out[i] for i in range(min(n, got))]

    def ckpt_barrier(self) -> bool:
        """Run the all-resident barrier explicitly (the engine's restore
        workers run it as direction 10). False = a restore copy failed;
        cause in ckpt_error()."""
        return self._lib.ebt_cuda_ckpt_barrier(self._h) == 0

    def ckpt_error(self) -> str:
        """First failed restore copy with lane and shard ("device N shard
        S: cause"); empty when none."""
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_ckpt_error(self._h, buf, len(buf))
        return buf.value.decode()

    # ---- N->M reshard plan + the device-to-device tier (--reshard) ----
    #
    # The planner (checkpoint.plan_reshard) diffs the manifest's N-lane
    # placement against the M-lane target and emits one unit per (shard,
    # target) pair: already resident, a move src->dst, or a storage read.
    # The engine executes the plan (directions 13/14/15); this ledger owns
    # the move tier and the evidence: per-unit submitted/resident bytes,
    # the src->dst pair matrix and "unit U src A dst B: cause".

    # the reshard action codes of the native plan
    RESHARD_ACTIONS = {"resident": 0, "move": 1, "read": 2}

    def set_reshard_plan(self, units) -> None:
        """Install the reshard plan before any transfer. `units` is the
        planner's ReshardUnit list."""
        n = len(units)
        actions = (ctypes.c_int * n)(
            *[self.RESHARD_ACTIONS[u.action] for u in units])
        srcs = (ctypes.c_int * n)(*[u.src_dev for u in units])
        dsts = (ctypes.c_int * n)(*[u.dst_dev for u in units])
        nbytes = (ctypes.c_uint64 * n)(*[u.bytes for u in units])
        rc = self._lib.ebt_cuda_set_reshard_plan(self._h, actions, srcs,
                                                 dsts, nbytes, n)
        if rc != 0:
            raise ProgException(
                f"reshard plan rejected ({n} unit(s)): the plan must "
                "precede the first transfer and every unit must name "
                "in-range lanes with nonzero bytes")

    def reshard_preload(self) -> None:
        """Stage the move units' sources on their src lanes (the prior
        restore onto N lanes). Untimed set-up, idempotent; run at prepare,
        never inside the measured phase."""
        if self._lib.ebt_cuda_reshard_preload(self._h) != 0:
            raise ProgException(
                f"reshard preload failed: {self.last_error()}")

    def reshard_stats(self) -> dict[str, int]:
        """Reshard counters: unit outcomes, the move tier's submitted/
        resident bytes, chunk moves settled device to device (d2d_moves)
        and through the host bounce (bounce_moves), settle-time bounce
        recoveries, move units re-read from storage, storage-read bytes
        under unit tags and the direction-15 barriers. Session-
        cumulative."""
        out = (ctypes.c_uint64 * 13)()
        self._lib.ebt_cuda_reshard_stats(self._h, out)
        return {"units_total": out[0], "units_resident": out[1],
                "units_moved": out[2], "units_read": out[3],
                "d2d_submitted_bytes": out[4], "d2d_resident_bytes": out[5],
                "d2d_moves": out[6], "bounce_moves": out[7],
                "move_recovered": out[8], "move_fallback_reads": out[9],
                "reshard_read_bytes": out[10], "resident_wait_ns": out[11],
                "barriers": out[12]}

    def reshard_byte_totals(self) -> tuple[int, int]:
        """(submitted, resident) bytes under reshard unit tags (moves and
        storage reads); equal once every all-resharded barrier returned
        clean."""
        out = (ctypes.c_uint64 * 2)()
        self._lib.ebt_cuda_reshard_byte_totals(self._h, out)
        return out[0], out[1]

    def reshard_pair_matrix(self) -> list[dict[str, int]]:
        """The src->dst lane-pair matrix: one entry per pair that settled
        at least one chunk move, row-major over the lanes."""
        ndev = self.num_devices
        npairs = ndev * ndev
        out = (ctypes.c_uint64 * max(2, npairs * 2))()
        got = self._lib.ebt_cuda_reshard_pair_matrix(self._h, out, npairs)
        pairs = []
        for i in range(min(npairs, got * got)):
            if out[i * 2] == 0 and out[i * 2 + 1] == 0:
                continue
            pairs.append({"src": i // ndev, "dst": i % ndev,
                          "moves": out[i * 2], "bytes": out[i * 2 + 1]})
        return pairs

    def reshard_barrier(self) -> bool:
        """Run the all-resharded barrier explicitly (the engine's reshard
        workers run it as direction 15). False = a reshard transfer
        failed; cause in reshard_error()."""
        return self._lib.ebt_cuda_reshard_barrier(self._h) == 0

    def reshard_error(self) -> str:
        """First reshard failure ("unit U src A dst B: cause"); empty when
        none."""
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_reshard_error(self._h, buf, len(buf))
        return buf.value.decode()

    @property
    def d2d_supported(self) -> bool:
        """The driver has the device-to-device copy entries and
        EBT_D2D_DISABLE=1 does not force the bounce control."""
        return bool(self._lib.ebt_cuda_d2d_supported(self._h))

    @property
    def d2d_engaged(self) -> bool:
        """True when at least one reshard chunk move settled device to
        device (CudaPath::d2dEngaged)."""
        return bool(self._lib.ebt_cuda_d2d_engaged(self._h))

    def raw_d2d_ceiling(self, total_bytes: int, depth: int = 8,
                        src_device: int = 0, dst_device: int = 1,
                        chunk_bytes: int = 0) -> float:
        """Raw device-to-device ceiling (MiB/s): pre-staged chunk buffers
        on lane src_device copied onto lane dst_device, depth in flight,
        each arrival confirmed (CudaPath::rawD2DCeiling). Raises on failure,
        also under the EBT_D2D_DISABLE=1 bounce control, which has no
        device-to-device copy to price."""
        v = self._lib.ebt_cuda_raw_d2d(self._h, total_bytes, depth,
                                       src_device, dst_device, chunk_bytes)
        if v <= 0:
            raise ProgException(
                f"raw d2d ceiling transfer failed: {self.raw_last_error()}")
        return v

    def peer_access(self) -> tuple[int, int]:
        """(ordered pairs of distinct selected devices with peer access
        enabled at init, all such pairs)."""
        out = (ctypes.c_int * 2)()
        self._lib.ebt_cuda_peer_access(self._h, out)
        return out[0], out[1]

    # ---- serving rotation (--rotate): device-side ledger ----
    #
    # The engine's rotator thread owns the rotation lifecycle (directions
    # 16/17); this ledger supplies the device side: the lane-side
    # background token bucket, the two generations held in device memory
    # (one allocation per shard and placement lane) and the per-rotation
    # reconciliation records appended at each swap.

    def set_bg_budget(self, bytes_per_s: int) -> None:
        """Arm the lane-side background token bucket's ceiling (0 =
        unthrottled); each rotation begin re-syncs the rate so the
        engine's adaptive controller carries through."""
        self._lib.ebt_cuda_set_bg_budget(self._h, int(bytes_per_s))

    def rotation_state(self) -> dict[str, int]:
        """Live rotation gauges: the published (swapped) generation, a
        restore-in-flight flag, the lane bucket's current byte/s budget,
        the lane-side throttle time and background H2D bytes, and the
        retained pendings across both generations. The original's key
        set."""
        out = (ctypes.c_uint64 * 6)()
        self._lib.ebt_cuda_rotation_state(self._h, out)
        return {"rotation_generation": out[0], "rotation_restoring": out[1],
                "bg_lane_rate_bps": out[2], "bg_lane_throttle_ns": out[3],
                "bg_h2d_bytes": out[4], "rotation_retained_buffers": out[5]}

    def rotation_records(self) -> list[dict[str, int]]:
        """Per-rotation reconciliation records (one per completed swap):
        generation, shards_total == shards_resident and bytes_submitted ==
        bytes_resident on a clean rotation, the rotation's background H2D
        bytes, and the retained/released pending counts of the swap."""
        recs: list[dict[str, int]] = []
        out = (ctypes.c_uint64 * 8)()
        for i in range(self._lib.ebt_cuda_rotation_count(self._h)):
            if self._lib.ebt_cuda_rotation_record(self._h, i, out) != 0:
                break
            recs.append({"generation": out[0], "shards_total": out[1],
                         "shards_resident": out[2],
                         "bytes_submitted": out[3],
                         "bytes_resident": out[4], "bg_bytes": out[5],
                         "retained_buffers": out[6],
                         "released_buffers": out[7]})
        return recs

    def rotation_read(self, shard: int, offset: int, length: int,
                      replica: int = 0) -> bytes:
        """Test-only (like eject_device): bytes [offset, offset + length)
        of `shard` as the active generation holds them in device memory on
        the shard's replica-th placement lane. Call between phases. Raises
        when there is no active generation or the range is not held."""
        buf = ctypes.create_string_buffer(int(length))
        if self._lib.ebt_cuda_rotation_read(
                self._h, int(shard), int(replica), int(offset), int(length),
                buf) != 0:
            raise ProgException(
                f"rotation read-back of shard {shard} [{offset}, "
                f"{offset + length}) failed: {self.last_error()}")
        return buf.raw

    # ---- DL-ingestion ledger (--ingest phase family) ----
    #
    # The engine owns the shuffle and the prefetch pipeline (records
    # batched into blocks); this ledger supplies the evidence: per-epoch
    # read/submitted/resident/dropped byte reconciliation at the
    # direction-12 all-resident barrier, batch-coalescing and
    # prefetch-depth peaks, and "device N epoch E: cause" attribution.

    def set_ingest_plan(self, record_size: int, epochs: int) -> None:
        """Arm the ingest ledger before any transfer (records derive from
        the byte counters as bytes / record_size)."""
        rc = self._lib.ebt_cuda_set_ingest_plan(self._h, int(record_size),
                                                int(epochs))
        if rc != 0:
            raise ProgException(
                f"ingest plan rejected (record_size={record_size}, "
                f"epochs={epochs}): the plan must precede the first "
                "transfer with a positive record size and epoch count")
        self._ingest_record_size = int(record_size)

    def ingest_stats(self, block_size: int = 0) -> dict[str, int]:
        """Ingest evidence counters in records (the plan's record size):
        records_read/submitted/resident/dropped (read == resident +
        dropped once every barrier returned), batch_coalesce_count,
        prefetch_depth_peak (peak in-flight batches, from the byte gauge),
        resident_wait_ns and barriers. Phase-scoped via ingest_rearm. The
        original's key set."""
        out = (ctypes.c_uint64 * 8)()
        self._lib.ebt_cuda_ingest_stats(self._h, out)
        rs = self._ingest_record_size or 1
        bs = block_size or 1
        return {"records_read": out[0] // rs,
                "records_submitted": out[1] // rs,
                "records_resident": out[2] // rs,
                "records_dropped": out[3] // rs,
                "batch_coalesce_count": out[4],
                "prefetch_depth_peak": (out[5] + bs - 1) // bs,
                "resident_wait_ns": out[6],
                "barriers": out[7]}

    def ingest_epoch_records(self, epoch: int) -> dict[str, int]:
        """Per-epoch reconciliation in records: read/submitted/resident/
        dropped of one epoch. Raises for an epoch outside the plan."""
        out = (ctypes.c_uint64 * 4)()
        if self._lib.ebt_cuda_ingest_epoch_bytes(self._h, int(epoch),
                                                 out) != 0:
            raise ProgException(f"ingest epoch {epoch} outside the plan")
        rs = self._ingest_record_size or 1
        return {"read": out[0] // rs, "submitted": out[1] // rs,
                "resident": out[2] // rs, "dropped": out[3] // rs}

    @property
    def ingest_epochs(self) -> int:
        """The armed plan's epoch count (0 = no ingest plan)."""
        return self._lib.ebt_cuda_ingest_epochs(self._h)

    def ingest_barrier(self) -> bool:
        """Run the all-resident barrier explicitly (the engine's ingest
        workers run it as direction 12). False = an ingest transfer
        failed; cause in ingest_error()."""
        return self._lib.ebt_cuda_ingest_barrier(self._h) == 0

    def ingest_error(self) -> str:
        """First ingest failure ("device N epoch E: cause"); empty when
        none."""
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_ingest_error(self._h, buf, len(buf))
        return buf.value.decode()

    def ingest_rearm(self) -> None:
        """Zero the ingest counters and attribution for a fresh phase on
        the same plan."""
        self._lib.ebt_cuda_ingest_rearm(self._h)

    # ---- device faults: lane ejection + live replanning ----
    #
    # With a nonzero device error budget, a failed copy is resubmitted from
    # its host source onto survivor lanes with bounded backoff, a lane whose
    # budget trips is ejected (its bit lands in ejected_mask), and every
    # later placement replans onto survivors, so the stripe and checkpoint
    # ledgers reconcile through an ejection.

    def set_fault_policy(self, device_error_budget: int, retry_max: int,
                         backoff_ms: int) -> None:
        """Arm the recovery machinery (budget 0 = off, the default)."""
        self._lib.ebt_cuda_set_fault_policy(
            self._h, int(device_error_budget), int(retry_max),
            int(backoff_ms))

    def fault_stats(self) -> dict[str, int]:
        """Recovery resubmits tried/succeeded, time in backoff waits,
        lane-attributed failures, lanes ejected and placements replanned
        off ejected lanes. Session-cumulative (ejection is sticky)."""
        out = (ctypes.c_uint64 * 6)()
        self._lib.ebt_cuda_fault_stats(self._h, out)
        return {"dev_retry_attempts": out[0], "dev_retry_success": out[1],
                "dev_retry_backoff_ns": out[2], "dev_errors": out[3],
                "ejected_devices": out[4], "replanned_units": out[5]}

    def ejected_devices(self) -> str:
        """"device N: cause" of every ejection (N the lane), newline-joined
        in ejection order; empty when none."""
        buf = ctypes.create_string_buffer(4096)
        self._lib.ebt_cuda_ejected(self._h, buf, len(buf))
        return buf.value.decode()

    @property
    def ejected_mask(self) -> int:
        """Bitmask of ejected lanes (bit i = selected device i)."""
        return self._lib.ebt_cuda_ejected_mask(self._h)

    def eject_device(self, device: int, cause: str = "") -> bool:
        """Force-eject a lane; False when out of range, already ejected,
        or the last healthy lane."""
        return self._lib.ebt_cuda_eject_device(
            self._h, int(device), cause.encode()) == 0

    def set_interrupt_flag(self, flag_addr: int) -> None:
        """Wire the engine's interrupt flag (NativeEngine.interrupt_flag)
        so recovery backoff waits wake promptly on interrupt."""
        self._lib.ebt_cuda_set_interrupt_flag(self._h, flag_addr)

    # ---- per-device lanes and latency ----

    @property
    def num_lanes(self) -> int:
        return self._lib.ebt_cuda_num_lanes(self._h)

    @property
    def single_lane(self) -> bool:
        """True when EBT_PJRT_SINGLE_LANE=1 forced the single-shard ledger
        (the lane-split A/B control)."""
        return bool(self._lib.ebt_cuda_single_lane(self._h))

    def lane_stats(self) -> list[dict[str, int]]:
        """Per-lane counters, indexed like the selected device list.
        Session-cumulative."""
        out: list[dict[str, int]] = []
        buf = (ctypes.c_uint64 * 5)()
        for lane in range(self.num_lanes):
            if self._lib.ebt_cuda_lane_stats(self._h, lane, buf) != 0:
                continue
            out.append({"lane": lane, "submits": buf[0], "awaits": buf[1],
                        "lock_wait_ns": buf[2], "to_hbm": buf[3],
                        "from_hbm": buf[4]})
        return out

    @property
    def latency_clock(self) -> str:
        """'onready' = completion stamped by a host function behind each
        copy (cuLaunchHostFunc); 'await' = completion-await upper bounds
        (driver refused host functions, or a diagnostic disabled them)."""
        return "onready" if self._lib.ebt_cuda_onready_clock(self._h) \
            else "await"

    def reset_device_latency(self) -> None:
        """Zero the per-chip histograms (phase scoping)."""
        self._lib.ebt_cuda_reset_dev_histos(self._h)

    def device_latency_histograms(self) -> dict[int, "LatencyHistogram"]:
        """Per-chip transfer latency (enqueue -> copy complete per chunk,
        both directions), keyed by index into the selected device list.
        Devices with no transfers are omitted."""
        from ..histogram import NUM_BUCKETS, LatencyHistogram

        out: dict[int, LatencyHistogram] = {}
        for dev in range(self.num_devices):
            buckets = (ctypes.c_uint64 * NUM_BUCKETS)()
            meta = (ctypes.c_uint64 * 4)()
            if self._lib.ebt_cuda_dev_histo(self._h, dev, buckets, meta) != 0:
                continue
            if meta[0] == 0:
                continue
            out[dev] = LatencyHistogram.from_raw(
                list(buckets), meta[0], meta[1], meta[2], meta[3])
        return out

    # ---- engine hookup, counters, errors ----

    @property
    def copy_fn_ptr(self) -> int:
        return self._lib.ebt_cuda_copy_fn()

    @property
    def ctx(self) -> int:
        return self._h

    @property
    def transferred_bytes(self) -> tuple[int, int]:
        to_hbm = ctypes.c_uint64()
        from_hbm = ctypes.c_uint64()
        self._lib.ebt_cuda_stats(self._h, ctypes.byref(to_hbm),
                                 ctypes.byref(from_hbm))
        return to_hbm.value, from_hbm.value

    def last_error(self) -> str:
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_last_error(self._h, buf, len(buf))
        return buf.value.decode()

    def raw_last_error(self) -> str:
        """The last raw-ceiling failure, kept out of last_error() so a
        failed ceiling never stands as the cause of a later phase's
        error."""
        buf = ctypes.create_string_buffer(1024)
        self._lib.ebt_cuda_raw_last_error(self._h, buf, len(buf))
        return buf.value.decode()

    def drain(self) -> None:
        self._lib.ebt_cuda_drain(self._h)

    # the submission topology of each data-path tier a ceiling can price
    RAW_TIERS = {"staged": 0, "zero_copy": 1, "xfer_mgr": 2}

    def raw_h2d_ceiling(self, total_bytes: int, depth: int = 8,
                        device: int = 0, chunk_bytes: int = 0,
                        tier: str = "staged", streams: int = 1) -> float:
        """In-session host-to-device ceiling (MiB/s, CudaPath::
        rawH2DCeiling): chunk copies from distinct pre-faulted sources,
        depth in flight, each arrival confirmed, on this live path and
        between its phases, so it is the denominator of the phases' rates.
        tier picks the submission topology of the data-path tier it prices:
        "staged" (pageable sources), "zero_copy" (sources pinned with
        cuMemHostRegister) or "xfer_mgr" (one cuMemAllocAsync buffer per
        block). streams > 1 runs that many submitters, each its own
        pipeline, over the lanes in turn from device: the denominator of a
        -t N phase (staged and zero_copy only). chunk_bytes 0 takes the
        path's chunk. Raises on failure with the cause."""
        v = self._lib.ebt_cuda_raw_h2d(self._h, total_bytes, depth, device,
                                       chunk_bytes, self.RAW_TIERS[tier],
                                       max(1, int(streams)))
        if v <= 0:
            raise ProgException(
                f"raw ceiling transfer failed: {self.raw_last_error()}")
        return v

    def raw_d2h_ceiling(self, total_bytes: int, depth: int = 1,
                        device: int = 0, chunk_bytes: int = 0) -> float:
        """In-session device-to-host ceiling (MiB/s, CudaPath::
        rawD2HCeiling): device-resident chunk sources fetched into distinct
        host destinations, depth in flight, each completion confirmed."""
        v = self._lib.ebt_cuda_raw_d2h(self._h, total_bytes, depth, device,
                                       chunk_bytes)
        if v <= 0:
            raise ProgException(
                f"raw d2h ceiling transfer failed: {self.raw_last_error()}")
        return v

    def close(self) -> None:
        if self._h:
            self._lib.ebt_cuda_destroy(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
