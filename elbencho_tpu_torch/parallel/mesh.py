"""Multi-device execution: sharded ingest + the mesh statistics reduction.

Port of the original package's parallel/mesh.py. There, blocks staged by
the hosts of a slice are sharded over a JAX device mesh, each device
verifies and checksums its shard, and the stats are reduced across the
mesh by an XLA collective (psum over ICI). Here a "mesh" is an ordered list
of torch devices, and the same work runs on two hand-written kernels:

  - each device's ranks go through one batched launch of the ingest kernel
    (B4, csrc/ingest.cu, ops/ingest_kernel.ingest_verify_batch);
  - the per-rank or per-device counter rows are gathered onto the first
    device with peer copies (tensor.to(dev0, non_blocking=True), i.e.
    cudaMemcpyPeerAsync) and summed there by one launch of the reduction
    kernel (B5, csrc/mesh_reduce.cu, ops/ingest_kernel.sum_rows_u64).

Why a gather and not NCCL: the JAX mesh is one process over its local
devices, and torch.distributed has no single-process multi-device
collective; the totals are read on the host at once either way. CUDA has
u64 arithmetic, so the original's 16-bit limbs are not needed: u64 counters
of 2^63 and above ride in int64 storage with the same bits.

The names, arguments and return shapes are the original's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda.devices import resolve_devices
from ..ops.ingest_kernel import ingest_verify_batch, sum_rows_u64
from ..ops.integrity import U64_MASK, split_u64


def make_mesh(n_devices: int | None = None,
              devices=None) -> list[torch.device]:
    """The first n_devices devices (all when None): CUDA devices, or CPU
    devices when the caller asked for the CPU (EBT_TORCH_DEVICE=cpu)."""
    if devices is None:
        devices = resolve_devices(
            list(range(n_devices)) if n_devices is not None else [])
    return list(devices)


def _gather(rows: list[torch.Tensor], dev0: torch.device) -> torch.Tensor:
    """Stack per-device int64 rows [r_d, k] into one [sum r_d, k] tensor on
    dev0 with one (peer) copy per device. The sources stay referenced by
    the caller until the result has been read."""
    if len(rows) == 1 and rows[0].device == dev0:
        return rows[0]
    total = sum(r.shape[0] for r in rows)
    out = torch.empty((total, rows[0].shape[1]), dtype=torch.int64,
                      device=dev0)
    at = 0
    for r in rows:
        out[at:at + r.shape[0]].copy_(r, non_blocking=True)
        at += r.shape[0]
    return out


def _shards(blocks, devices: list[torch.device]) -> list[torch.Tensor]:
    """Per-device [ranks_d, lanes] int32 shards of one [ranks, lanes]
    array/tensor, its rows split evenly over the mesh (as the original's
    NamedSharding over the "hosts" axis)."""
    if isinstance(blocks, np.ndarray):
        blocks = torch.from_numpy(
            np.ascontiguousarray(blocks, dtype=np.uint32).view(np.int32))
    n = len(devices)
    if blocks.shape[0] % n:
        raise ValueError(f"{blocks.shape[0]} ranks do not shard evenly over "
                         f"{n} devices")
    per = blocks.shape[0] // n
    return [blocks[d * per:(d + 1) * per].to(dev)
            for d, dev in enumerate(devices)]


def sharded_ingest_step(mesh: list[torch.device]):
    """Build the multi-device ingest+verify+reduce step.

    Input: blocks [num_ranks, words_per_block*2] u32 lanes, offsets (lo, hi) [num_ranks] u32, salt (lo, hi) scalars;
    each device holds its ranks' staged blocks. Output: the global stats
    dict {ok_bytes, bad_words, iops, checksum} as float32 scalars: one
    ingest-kernel launch per device and one reduction launch per step."""
    devices = list(mesh)
    dev0 = devices[0]

    def step(blocks, offs_lo, offs_hi, salt_lo, salt_hi):
        shards = _shards(blocks, devices)
        offsets = (np.asarray(offs_lo, dtype=np.uint64) |
                   (np.asarray(offs_hi, dtype=np.uint64) << np.uint64(32)))
        salt = (int(salt_lo) & 0xFFFFFFFF) | ((int(salt_hi) & 0xFFFFFFFF)
                                              << 32)
        rows, at = [], 0
        for shard in shards:
            r = shard.shape[0]
            rows.append(ingest_verify_batch(shard, offsets[at:at + r], salt))
            at += r
        if at != offsets.shape[0]:
            raise ValueError(f"{at} ranks but {offsets.shape[0]} offsets")
        # {ok_bytes, bad_words, first_bad_word, checksum} per rank; the
        # first-bad column's sum is not used
        tot = [int(v) & U64_MASK for v in
               sum_rows_u64(_gather(rows, dev0)).tolist()]
        return {
            "ok_bytes": np.float32(tot[0]),
            "bad_words": np.float32(tot[1]),
            "iops": np.float32(at),
            "checksum": np.float32(tot[3]),
        }

    return step


class MeshStatsReducer:
    """Per-slice LiveOps reduction over the device list (service-mode tier).

    Each device of a slice is assigned the counters of the worker ranks that
    stage into it (rank % num_devices, the engine's device assignment). Row
    d is placed on device d, the rows are gathered onto the first device
    with peer copies, and one launch of the reduction kernel sums them
    exactly mod 2^64. The HTTP control plane above still aggregates across
    slices (the master's fan-in, workers/remote.py)."""

    def __init__(self, devices) -> None:
        self.devices = list(devices)

    def reduce(self, per_device: "list[list[int]]") -> list[int]:
        """per_device: one row of u64 counters per device. Returns exact
        element-wise totals, reduced on the devices."""
        n = len(self.devices)
        rows = np.asarray(per_device, dtype=np.uint64)
        assert rows.shape[0] == n, "one counter row per mesh device"
        host = torch.from_numpy(rows.view(np.int64).copy())
        placed = [host[d:d + 1].to(dev)
                  for d, dev in enumerate(self.devices)]
        tot = sum_rows_u64(_gather(placed, self.devices[0])).tolist()
        return [int(v) & U64_MASK for v in tot]


def run_sharded_ingest(mesh: list[torch.device], blocks_np: np.ndarray,
                       offsets: np.ndarray, salt: int):
    """Convenience wrapper: place host data on the mesh and run one step."""
    step = sharded_ingest_step(mesh)
    offsets = np.asarray(offsets, dtype=np.uint64)
    offs_lo = (offsets & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    offs_hi = (offsets >> np.uint64(32)).astype(np.uint32)
    salt_lo, salt_hi = split_u64(salt)
    out = step(blocks_np, offs_lo, offs_hi, salt_lo, salt_hi)
    return {k: float(v) for k, v in out.items()}
